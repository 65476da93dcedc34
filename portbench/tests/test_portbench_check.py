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
    # exactly: the curves and the choice read 0.
    assert all(numbers[name]["value"] == 0 for name in numbers
               if name != "centroid_gap")
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
