"""What decides ``correct``, at the CPU size: a sound run passes; the
control (the reference at bfloat16 in the program's place) is not correct;
and nor is a run with a fault planted underneath the timed path: a keystep
that leaves its state unchanged, a tracker whose Adam step leaves the pose
unchanged, half of each batch left out with the mean taken over the rest,
and answers altered where they are produced (the tracked pose moved by 1
cm; the keystep's update doubled). Each number is held to the limit the
cell's workload file states."""

import pytest

from faults import FAULTS


def _fails(result):
    return [k for k, c in result["checks"].items() if c["value"] > c["limit"]]


CELLS = ["replica-slam"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_passes(tiny, cell):
    r = tiny(cell)
    assert r["correct"], _fails(r)
    assert r["attempted"] == 5 and r["failed"] == 0
    assert set(r["metrics"]) == {"fps", "setup_s"}
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny, cell):
    """With ``--control 1`` the control's numbers are judged, and fail."""
    r = tiny(cell, control=1)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(tiny, monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    r = tiny("replica-slam")
    assert not r["correct"], r["checks"]
