"""The check on CPU-sized runs: a sound run is correct; a run with the
timed path broken underneath is not, for each fault a cell can have."""

import pytest

from portbench import faults, harness

CELLS = ("est100k", "blobs20k_stream", "blobs20k_dense")


def _run(cell, seed=2**31 + 77):
    return harness.run_cell(cell, seed, 0.0, False, device="cpu")


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(small, name):
    result = _run(small(name))
    assert result["correct"] is True
    numbers = result["check"]
    assert all(v["value"] <= v["limit"] for v in numbers.values())
    # On the CPU the program's plain versions and the reference agree
    # exactly: the curves, the choice and the parted lanes read 0.
    assert all(numbers[name]["value"] == 0 for name in numbers
               if name not in ("centroid_gap", "fixed_point_gap"))
    assert list(result)[-1] == "check"
    assert result["failed"] == 0 and result["attempted"] >= 1


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_refused(small, name, fault):
    cell = small(name)
    with faults.FAULTS[fault]():
        result = _run(cell)
    assert result["correct"] is False
    assert any(v["value"] > v["limit"] for v in result["check"].values())


def test_the_control_path_runs_the_reference_in_the_programs_place(small):
    # On the CPU TF32 does not exist, so the control's answers equal the
    # reference's; on the card the control test below must be refused.
    result = harness.run_cell(small("blobs20k_dense"), 5, 0.0, False,
                              device="cpu", precision="tf32")
    assert result["correct"] is True and result["attempted"] == 1


def test_the_control_is_refused_on_the_card(cuda_card, small):
    # A size a test run holds: the blobs20k cell at N=4,000, d=50, H=20,
    # K=2..10; TF32's rounding moves the centres past centroid_gap's limit.
    cell = small("blobs20k_dense", n=4000, d=50, h=20, k_hi=10)
    cell["config"]["data"]["centers"] = 8
    sound = harness.run_cell(cell, 11, 0.0, False)
    assert sound["correct"] is True
    refused = [harness.run_cell(cell, seed, 0.0, False, precision="tf32")
               for seed in (12, 13, 14)]
    assert all(r["correct"] is False for r in refused)


def _three_blobs(n=60):
    """Three tight blobs on a line, at 0, 10 and 20: with two centres,
    {0, 10} | {20} and {0} | {10, 20} are both fixed points of Lloyd's
    step.  Returns the rows (3n, 2), their blob (3n,) and three lanes'
    indices, each every row."""
    import torch

    g = torch.Generator().manual_seed(3)
    blob = torch.arange(3).repeat_interleave(n)
    x = torch.stack([10.0 * blob.float(), torch.zeros(3 * n)], 1)
    x = x + 0.1 * torch.randn(x.shape, generator=g)
    return x, blob, torch.arange(3 * n).repeat(3, 1)


def _means(x, labels, k_max=3):
    import torch

    out = torch.zeros((k_max, x.shape[1]))
    for c in range(int(labels.max()) + 1):
        out[c] = x[labels == c].double().mean(0).float()
    return out


def test_a_fixed_point_of_lloyds_step_reads_zero_and_a_moved_centre_not():
    import torch

    from portbench import check

    x, blob, indices = _three_blobs()
    split = (blob >= 1).long()  # {0} | {10, 20}
    fixed = _means(x, split)
    moved = fixed.clone()
    moved[0, 0] += 1.0
    empty = fixed.clone()
    empty[1] = torch.tensor([1e4, 1e4])
    gaps, labels = check.fixed_point_gaps(
        x, indices, torch.stack([fixed, moved, empty]), 2)
    assert gaps[0] < 1e-6 and gaps[1] > 1e-2 and torch.isinf(gaps[2])
    assert torch.equal(labels[0], split)


def test_a_lane_that_parted_ways_is_counted_with_its_own_labels():
    import torch

    from portbench import check

    x, blob, indices = _three_blobs()
    ref_labels = (blob >= 2).long().repeat(3, 1)  # {0, 10} | {20}
    ref_centres = _means(x, ref_labels[0]).repeat(3, 1, 1)
    other = (blob >= 1).long()  # the other fixed point
    program = ref_centres.clone()
    program[1] = _means(x, other)
    found = {}
    relabel = check.lane_judge({2: program}, found)
    labels = relabel(2, x, indices, ref_labels, ref_centres)
    assert found["parted_lanes"] == 1 and found["fixed_point_gap"] < 1e-6
    assert torch.equal(labels[1], other)
    assert torch.equal(labels[0], ref_labels[0])
    assert torch.equal(labels[2], ref_labels[2])
    # A parted lane that is no fixed point reads as one.
    program[1, 0, 0] += 1.0
    found = {}
    check.lane_judge({2: program}, found)(2, x, indices, ref_labels,
                                          ref_centres)
    assert found["parted_lanes"] == 1 and found["fixed_point_gap"] > 1e-2
