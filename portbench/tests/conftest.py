"""Fixtures of the benchmark's tests: small cells the CPU can run, and the
card, looked for inside a fixture (never while a module is imported)."""

import copy

import pytest

from portbench import harness


@pytest.fixture
def cuda_card():
    """Skips the test without a CUDA device."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the benchmark's card tests)")
    return torch.device("cuda")


def small_cell(name: str, n: int = 700, d: int = 10, h: int = 12,
               k_hi: int = 4):
    """Cell ``name`` from the repository's files, cut to a CPU-sized run:
    the same engines and check, fewer items, features and resamples."""
    cell = copy.deepcopy(harness.load_cell(name))
    config, traffic = cell["config"], cell["traffic"]
    config["data"].update(n_samples=n, n_features=d, centers=4)
    fit = config["fit"]
    fit.update(n_iterations=h, K_range=[2, k_hi])
    # Lane groups of 4, in whichever file sets the grouping.
    grouping = traffic["fit"] if "cluster_batch" in traffic["fit"] else fit
    grouping["cluster_batch"] = 4
    if "n_pairs" in fit:
        fit.update(n_pairs=4000, mode="estimate", stream_h_block=8)
    if "stream_h_block" in traffic["fit"]:
        traffic["fit"]["stream_h_block"] = 8
    return cell


@pytest.fixture
def small():
    return small_cell
