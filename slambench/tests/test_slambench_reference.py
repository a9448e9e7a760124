"""The check that decides ``correct``, driven on the CPU at a size a test
run holds (512 x 64 beams, 4 particles), with the port broken underneath by
each planted fault of ``control.py``. There a sound run agrees with the
reference less closely than at the cell's size (fewer points register less
firmly, and 4 particles give a rougher covariance), so the runs are judged
against this size's own limits: a sound run comes out correct under them,
and each fault and the TF32 control come out not correct."""
import pytest
import torch

from slambench import control, harness

from .conftest import CELL, small_cell

N_SWEEPS = 16  # warm-up (10 keyframes) and a short window
# sound runs at this size read up to 1.76 mm, 2.7e-4, 0 points and 0.054 mm
# (2 seeds); the cell's own limits are in reference/lo_svn.py
SMALL_SIZE_LIMITS = {"pose_gap_mm": 3.0, "cov_gap": 2e-3, "points_gap": 0, "ring_gap_mm": 0.2}
SEED = 2**31 + 77


def _run(cell):
    bench, cellw, cfg, traffic = small_cell(cell=cell)
    metrics = harness.cell_metrics(bench, cellw["name"], False)
    return harness.run_cell(cellw["name"], cfg, traffic, metrics, SEED, 1e9, False, "cpu", n_sweeps=N_SWEEPS,
                            limits=SMALL_SIZE_LIMITS)


def test_sound_run_matches_the_reference(cell=CELL):
    torch.set_num_threads(2)
    r = _run(cell)
    assert r["correct"], r["compared"]
    assert r["attempted"] >= 3 and r["failed"] == 0
    assert set(r["metrics"]) == {"rpe_mm", "setup_s", "keyframes_per_s", "pose_latency_p95_ms"}
    assert set(r["compared"]) == set(SMALL_SIZE_LIMITS)


@pytest.mark.parametrize("fault", sorted(control.FAULTS))
def test_fault_comes_out_incorrect(fault, cell=CELL):
    torch.set_num_threads(2)
    rows = control.fault_readings(small_cell(cell=cell), [SEED], 1e9, "cpu", [fault], limits=SMALL_SIZE_LIMITS,
                                  n_sweeps=N_SWEEPS)
    assert not rows[0]["correct"], rows[0]


def test_control_is_not_correct(cell=CELL):
    """The reference in TF32 in the port's place fails the comparison."""
    torch.set_num_threads(2)
    rows = control.control_readings(small_cell(cell=cell), [SEED + 1], 4, "cpu", limits=SMALL_SIZE_LIMITS)
    assert not rows[0]["correct"], rows[0]
