"""The check that decides ``correct`` for ``odom_ndt_berlin.stadium``,
driven on the CPU at a size a test run holds (512 x 64 beams), with the
port broken underneath by each planted fault below. There a sound run
agrees with the reference less closely than at the cell's size (fewer
points register less firmly), so the runs are judged against this size's
own limits: a sound run comes out correct under them, and each fault and
the TF32 control come out not correct.

The faults, each planted in the port's timed path by its function below:

- ``chordal``: the blend of slamtpu/fusion/robust.py, linear in the global
  Logmap coordinates, on a short lap whose second straight heads along +-pi
  with an exact INS, so that the seed and the registration straddle it;
- ``unblended``: the registration published unblended, the deviation gate
  left out (the pose is the registration's, its recorded weight 1);
- ``unsmoothed``: the window's Gauss-Newton solve skipped (the newest pose
  is the blend, the covariance the window's marginal where it starts);
- ``altered``: each published pose moved by 5 mm where the step produces it.

``fault_readings`` runs them through ``harness.run_cell`` as
``control.fault_readings`` does for lo_svn's faults.
"""
import json

import pytest
import torch

from slambench import control, harness
from slambench.apps import odom_ndt as adapter

from .conftest import small_cell

CELL = "odom_ndt_berlin.stadium"
N_SWEEPS = 16  # warm-up (10 keyframes) and a short window
# sound runs at this size (both seeds, the stadium and the short lap) read
# up to 0.42 mm, 23 urad, 6.0e-5, 0 points, 0.024 mm, 5.4e-4, and 0.058 mm
# and 1.5e-5 where the heading passes +-pi; the planted faults read from 3.7 mm
# (altered), 0.016 (unblended's weight), 168 mm (unsmoothed) and 670 mm
# (chordal, at +-pi); the cell's own limits are in reference/odom_ndt.py
SMALL_SIZE_LIMITS = {"pose_gap_mm": 1.5, "rot_gap_urad": 80.0, "cov_gap": 3e-4, "points_gap": 0,
                     "target_gap_mm": 0.2, "w_gap": 2e-3, "cross_pose_gap_mm": 1.5, "cross_rot_gap_urad": 80.0,
                     "cross_cov_gap": 3e-4}
SEEDS = (2**31 + 77, 2**32 + 5)
# a lap of 45.7 m (4 m straights, 6 m half turns on 3 m clothoids) at 8 m/s
# whose second straight, sweeps 29-33, heads along +-pi; the INS exact
SHORT_LAP = {"straight_m": 4.0, "radius_m": 6.0, "transition_m": 3.0, "sweeps_per_lap": 57}
SHORT_SWEEPS = 38


def short_lap_cell():
    bench, cellw, cfg, traffic = small_cell(cell=CELL)
    traffic = dict(traffic, course=dict(traffic["course"], **SHORT_LAP))
    traffic.pop("ins_error")
    return bench, cellw, cfg, traffic


# --- faults planted in the port's timed path; ``patch(obj, name, value)`` ---


def chordal(patch):
    from slamtpu_torch.core import se3, so3
    from slamtpu_torch.fusion import robust

    def blend(pred, meas, max_td=1.0, max_rd=0.1):
        dev = se3.between(pred, meas)
        w = torch.minimum(
            torch.clamp(1.0 - torch.linalg.vector_norm(dev.trans, dim=-1) / max_td, min=0.0),
            torch.clamp(1.0 - torch.linalg.vector_norm(so3.log(dev.rot), dim=-1) / max_rd, min=0.0))
        xp, xm = se3.logmap(pred), se3.logmap(meas)
        return se3.expmap(xp + w[..., None] * (xm - xp)), w

    patch(robust, "deviation_gated_blend", blend)


def unblended(patch):
    from slamtpu_torch.fusion import robust

    patch(robust, "deviation_gated_blend",
          lambda pred, meas, *a: (meas, torch.ones((), dtype=meas.trans.dtype, device=meas.trans.device)))


def unsmoothed(patch):
    from slamtpu_torch.apps import odom_ndt

    solve = odom_ndt.optimize_pose_window
    patch(odom_ndt, "optimize_pose_window", lambda *a, **k: solve(*a, **dict(k, iterations=0)))


def altered(patch):
    from slamtpu_torch.apps import odom_ndt

    step = odom_ndt._odom_fused_step

    def broken(*a, **k):
        carry, out = step(*a, **k)
        shift = torch.zeros_like(out)
        shift[9] = 0.005  # the published translation's x
        return carry, out + shift

    patch(odom_ndt, "_odom_fused_step", broken)


FAULTS = {"chordal": chordal, "unblended": unblended, "unsmoothed": unsmoothed, "altered": altered}


def fault_readings(cell, seeds, seconds, device, faults, limits=None, n_sweeps=None):
    """One run of the cell for each fault and seed with the fault planted:
    [{fault, seed, correct, compared}]."""
    bench, cellw, cfg, traffic = cell
    metrics = harness.cell_metrics(bench, cellw["name"], False)
    out = []
    for fault in faults:
        for seed in seeds:
            undo = []

            def patch(obj, name, value):
                undo.append((obj, name, getattr(obj, name)))
                setattr(obj, name, value)

            FAULTS[fault](patch)
            try:
                r = harness.run_cell(cellw["name"], cfg, traffic, metrics, seed, seconds, False, device,
                                     n_sweeps=n_sweeps, limits=limits)
            finally:
                for obj, name, value in reversed(undo):
                    setattr(obj, name, value)
            row = {"fault": fault, "seed": seed, "correct": r["correct"],
                   "compared": {k: v["value"] for k, v in r["compared"].items()}}
            out.append(row)
            print(json.dumps(row), flush=True)
    return out


def _run(cell, seed, n_sweeps=N_SWEEPS):
    bench, cellw, cfg, traffic = cell
    metrics = harness.cell_metrics(bench, cellw["name"], False)
    return harness.run_cell(cellw["name"], cfg, traffic, metrics, seed, 1e9, False, "cpu", n_sweeps=n_sweeps,
                            limits=SMALL_SIZE_LIMITS)


@pytest.mark.parametrize("seed", SEEDS)
def test_sound_run_matches_the_reference(seed):
    torch.set_num_threads(2)
    r = _run(small_cell(cell=CELL), seed)
    assert r["correct"], r["compared"]
    assert r["attempted"] >= 3 and r["failed"] == 0
    assert set(r["metrics"]) == {"rpe_mm", "setup_s", "keyframes_per_s", "pose_latency_p95_ms"}
    assert set(r["compared"]) == set(SMALL_SIZE_LIMITS)


@pytest.mark.parametrize("seed", SEEDS)
def test_sound_run_across_pi_matches_the_reference(seed):
    """The short lap's straight along +-pi, with the geodesic blend: every
    keyframe where the heading passes +-pi is checked, and agrees."""
    torch.set_num_threads(2)
    r = _run(short_lap_cell(), seed, SHORT_SWEEPS)
    assert r["correct"], r["compared"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_comes_out_incorrect(fault, seed):
    torch.set_num_threads(2)
    cell, n = (short_lap_cell(), SHORT_SWEEPS) if fault == "chordal" else (small_cell(cell=CELL), N_SWEEPS)
    rows = fault_readings(cell, [seed], 1e9, "cpu", [fault], limits=SMALL_SIZE_LIMITS, n_sweeps=n)
    assert not rows[0]["correct"], rows[0]


def test_control_is_not_correct():
    """The reference in TF32 in the port's place fails the comparison."""
    torch.set_num_threads(2)
    rows = control.control_readings(small_cell(cell=CELL), [SEEDS[0] + 1], 4, "cpu", limits=SMALL_SIZE_LIMITS)
    assert not rows[0]["correct"], rows[0]


def test_adapter_reads_nothing_from_the_device_and_holds_the_target(monkeypatch):
    """``published`` counts the trajectory on the host (no flush, no device
    read); ``state`` returns the kept counts with the blend weights, and the
    previous keyframe's cloud placed at its published pose."""
    torch.set_num_threads(2)
    bench, cellw, cfg, traffic = small_cell(cell=CELL)
    from slambench import sensor as sn
    from slambench import traffic as tr

    app = adapter.make(cfg, torch.device("cpu"))
    lap = tr.Lap(traffic, sn.Sensor.from_config(cfg["sensor"]), SEEDS[0], "cpu", n_sweeps=6)
    drv = harness.Driver(app, lap, adapter.published)
    for _ in range(5):
        drv.step()
    n_host = len(app._trajectory)

    def no_read(*_a, **_k):
        raise AssertionError("published() read the device or flushed")

    monkeypatch.setattr(type(app), "flush", no_read)
    monkeypatch.setattr(torch.Tensor, "cpu", no_read)
    assert adapter.published(app) == n_host < 4  # two keyframes still in flight
    monkeypatch.undo()
    traj = app.trajectory  # flushes
    kept, held = adapter.state(app)
    n = len(traj)
    assert set(held) == {n - 1} and sorted(kept) == list(range(1, n))
    pts, mask = held[n - 1]
    body = app._carry["prev_points"][0].double().numpy()
    R, t = traj[n - 1].pose
    assert pts.shape == body.shape and mask.sum() == kept[n - 1][0]
    assert abs(pts - (body @ R.T + t)).max() < 1e-9
    assert all(0.0 <= w <= 1.0 for _, w in kept.values())


def test_adapter_refuses_a_float32_target_map(monkeypatch):
    """The configuration states the target map's statistics in double; a
    port that builds them in float32 cannot run it, and ``make`` says so
    before any work."""
    from slamtpu_torch.apps import odom_ndt

    _, _, cfg, _ = small_cell(cell=CELL)
    monkeypatch.setattr(odom_ndt, "MAP_DTYPE", torch.float32)
    with pytest.raises(ValueError, match="statistics in torch.float32"):
        adapter.make(cfg, torch.device("cpu"))
    monkeypatch.delattr(odom_ndt, "MAP_DTYPE")
    with pytest.raises(ValueError, match="statistics in torch.float32"):
        adapter.make(cfg, torch.device("cpu"))


def test_reference_imports_nothing_of_the_port():
    """The odom reference, its check across +-pi included, loads neither the
    port nor JAX."""
    import os
    import subprocess
    import sys

    from .conftest import ROOT

    code = """
import json, sys, torch
from slambench import harness, sensor as sn, traffic as tr
from slambench.reference import odom_ndt
from slambench.tests.conftest import small_cell
bench, cell, cfg, traffic = small_cell(128, 32, cell="odom_ndt_berlin.stadium")
lap = tr.Lap(traffic, sn.Sensor.from_config(cfg["sensor"]), 5, "cpu", n_sweeps=14)
rec = harness.Record(lap, cfg, list(range(1, 14)), {}, torch.device("cpu"))
odom_ndt.published(rec, [11])
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr[-3000:]
    top = set(json.loads(r.stdout.strip().splitlines()[-1]))
    assert not {"slamtpu_torch", "slamtpu", "jax", "jaxlib", "flax"} & top
