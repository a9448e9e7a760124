"""The check that decides ``correct`` for ``ligo_tc_berlin.stadium``,
driven on the CPU at a size a test run holds (512 x 64 beams), with the
port broken underneath by each planted fault below. A sound run comes out
correct under this size's own limits, and each fault and the TF32
control come out not correct.

The faults, each planted in the port's timed path by its function below:

- ``imu_free``: the window solved with its IMU factors switched off;
- ``bias_ignored``: the preintegration run at a zero bias while its
  result claims the held one (the deltas then miss the bias's effect);
- ``unpulled``: the registration without the pull toward the IMU
  prediction (``reg_weight`` 0);
- ``altered``: each published pose moved by 5 mm where the re-solve
  returns it;
- ``stale_target``: the target rebuilt every 4 keyframes instead of every
  keyframe;
- ``unsmoothed_target``: the target fused at each keyframe's registration
  pose in place of its solved one (and recorded so);
- ``frozen_target``: the target fused at the poses the ring's keyframes
  had when they were inserted, not re-solved since.

``fault_readings`` runs them through ``harness.run_cell`` as
``control.fault_readings`` does for lo_svn's faults.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from slambench import control, harness
from slambench.apps import ligo_tc as adapter

from .conftest import small_cell

CELL = "ligo_tc_berlin.stadium"
N_SWEEPS = 16  # warm-up (10 keyframes) and a short window
# sound runs at this size (both seeds, the stadium and the short lap) read
# up to 0.03 mm, 0.5 urad, 3e-6, 0.11 mm/s, 0.03 mm, 0 points, 0.054 mm and
# a record 0.0022 mm off itself; the planted faults read from 1.8 mm
# (bias_ignored), 416 urad (imu_free), 9.6 mm/s (unpulled), 5.0 mm
# (altered) and a record 375 mm off (frozen_target), the control 8 mm,
# 1,308 urad (3.8e-4 from a float64 window over its steps); the cell's own
# limits are in reference/ligo_tc.py
SMALL_SIZE_LIMITS = {"pose_gap_mm": 0.5, "rot_gap_urad": 20.0, "cov_gap": 3e-5, "vel_gap_mm_s": 2.0,
                     "newton_gap_mm": 0.3, "points_gap": 0, "target_gap_mm": 0.5, "target_pose_gap_mm": 0.05,
                     "cross_pose_gap_mm": 0.5, "cross_rot_gap_urad": 20.0, "cross_cov_gap": 3e-5}
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


def imu_free(patch):
    from slamtpu_torch.apps import ligo_tc

    solve = ligo_tc.optimize

    def broken(state, factors, cfg):
        off = factors.imu._replace(active=torch.zeros_like(factors.imu.active))
        return solve(state, factors._replace(imu=off), cfg)

    patch(ligo_tc, "optimize", broken)


def bias_ignored(patch):
    from slamtpu_torch.apps import ligo_tc
    from slamtpu_torch.fusion.preintegration import ImuBias

    integrate = ligo_tc.integrate

    def broken(accel, gyro, dts, bias, noise):
        zero = ImuBias(torch.zeros_like(bias.accel), torch.zeros_like(bias.gyro))
        return integrate(accel, gyro, dts, zero, noise)._replace(bias_hat=bias)

    patch(ligo_tc, "integrate", broken)


def unpulled(patch):
    from slamtpu_torch.apps import ligo_tc

    step = ligo_tc._ligo_step

    def broken(*a, **k):
        a = list(a)
        a[11] = a[11]._replace(reg_weight=0.0)  # the NewtonConfig
        return step(*a, **k)

    patch(ligo_tc, "_ligo_step", broken)


def altered(patch):
    from slamtpu_torch.apps import ligo_tc
    from slamtpu_torch.core.se3 import Pose3

    fuse = ligo_tc.LigoTcApp._fuse

    def broken(self, *a, **k):
        pose, cov = fuse(self, *a, **k)
        return Pose3(pose.rot, pose.trans + np.array([0.005, 0.0, 0.0])), cov

    patch(ligo_tc.LigoTcApp, "_fuse", broken)


def stale_target(patch):
    from slamtpu_torch.apps import ligo_tc

    cadence = ligo_tc.MapRebuildCadence
    patch(ligo_tc, "MapRebuildCadence",
          lambda reg, *a, **k: cadence(dataclasses.replace(reg, map_rebuild_every=4), *a, **k))


def _fused_at(patch, key):
    """The target fused at each ring entry's ``key`` pose in place of its
    live solved one; the step records the poses it was fused at."""
    from slamtpu_torch.apps import ligo_tc

    window_poses = ligo_tc.LigoTcApp._window_poses

    def broken(self):
        live = [(e, e["pose"]) for e in self._kf_slots if e is not None and key in e]
        for e, _ in live:
            e["pose"] = e[key]
        try:
            return window_poses(self)
        finally:
            for e, pose in live:
                e["pose"] = pose

    patch(ligo_tc.LigoTcApp, "_window_poses", broken)


def unsmoothed_target(patch):
    from slamtpu_torch.apps import ligo_tc
    from slamtpu_torch.core.se3 import Pose3

    fuse = ligo_tc.LigoTcApp._fuse

    def keep(self, k, target_poses, newton):
        self._win[-1]["registered"] = Pose3(newton[0:9].reshape(3, 3), newton[9:12])
        return fuse(self, k, target_poses, newton)

    patch(ligo_tc.LigoTcApp, "_fuse", keep)
    _fused_at(patch, "registered")


def frozen_target(patch):
    from slamtpu_torch.apps import ligo_tc

    insert = ligo_tc.LigoTcApp._insert_keyframe

    def keep(self, points, mask, entry):
        entry["inserted"] = entry["pose"]
        return insert(self, points, mask, entry)

    patch(ligo_tc.LigoTcApp, "_insert_keyframe", keep)
    _fused_at(patch, "inserted")


FAULTS = {"imu_free": imu_free, "bias_ignored": bias_ignored, "unpulled": unpulled, "altered": altered,
          "stale_target": stale_target, "unsmoothed_target": unsmoothed_target, "frozen_target": frozen_target}


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
def test_sound_run_across_pi_matches_the_reference(seed, capsys):
    """The short lap's straight along +-pi: every keyframe where the INS
    heading passes +-pi is redone, and agrees."""
    torch.set_num_threads(2)
    r = _run(short_lap_cell(), seed, SHORT_SWEEPS)
    assert r["correct"], r["compared"]
    assert "cross_keyframes 1 " in capsys.readouterr().err


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_comes_out_incorrect(fault, seed):
    torch.set_num_threads(2)
    rows = fault_readings(small_cell(cell=CELL), [seed], 1e9, "cpu", [fault], limits=SMALL_SIZE_LIMITS,
                          n_sweeps=N_SWEEPS)
    assert not rows[0]["correct"], rows[0]


def test_control_is_not_correct():
    """The reference in TF32, redone from its own float64 chain, in the
    port's place fails the comparison; its window's marginal is NaN in
    float32, the float64 window's over its TF32 steps finite (printed)."""
    torch.set_num_threads(2)
    rows = control.control_readings(small_cell(cell=CELL), [SEEDS[0] + 1], 4, "cpu", limits=SMALL_SIZE_LIMITS)
    assert not rows[0]["correct"], rows[0]
    got = rows[0]["control"]
    assert got["pose_gap_mm"] > 3 * SMALL_SIZE_LIMITS["pose_gap_mm"]
    assert np.isnan(got["cov_gap"]) and 0.0 < got["cov_gap_f64_window"] < float("inf")
    assert got["target_pose_gap_mm"] == 0.0 and got["cross_keyframes"] == 0


def test_control_redoes_the_crossings():
    """A control window that reaches the short lap's straight along +-pi
    redoes the crossing at its precision, and reads over the limits
    there (its float64 window's marginal printed)."""
    torch.set_num_threads(2)
    bench, cellw, cfg, traffic = short_lap_cell()
    cfg["sensor"].update(columns_per_frame=256, pixels_per_column=32)
    rows = control.control_readings((bench, cellw, cfg, traffic), [SEEDS[1]], 25, "cpu", limits=SMALL_SIZE_LIMITS)
    got = rows[0]["control"]
    assert got["cross_keyframes"] == 1
    assert got["cross_pose_gap_mm"] > 3 * SMALL_SIZE_LIMITS["cross_pose_gap_mm"]
    assert 0.0 < got["cross_cov_gap_f64_window"] < float("inf")


def test_adapter_reads_nothing_from_the_device_and_hands_over_the_record(monkeypatch):
    """``published`` counts the trajectory on the host (no device read:
    every keyframe is on the host when ``process`` returns); ``state``
    returns the kept counts, the app's host record (one entry a keyframe,
    its newest state the published pose) and the ring's clouds placed at
    their published poses."""
    torch.set_num_threads(2)
    bench, cellw, cfg, traffic = small_cell(cell=CELL)
    from slambench import sensor as sn
    from slambench import traffic as tr

    app = adapter.make(cfg, torch.device("cpu"))
    lap = tr.Lap(traffic, sn.Sensor.from_config(cfg["sensor"]), SEEDS[0], "cpu", n_sweeps=9)
    drv = harness.Driver(app, lap, adapter.published)
    for _ in range(8):
        drv.step()

    def no_read(*_a, **_k):
        raise AssertionError("published() read the device")

    monkeypatch.setattr(torch.Tensor, "cpu", no_read)
    n = adapter.published(app)
    monkeypatch.undo()
    assert n == len(app.trajectory) == len(drv.kf_sweeps) == 6  # the last two sweeps not yet synced
    kept, held = adapter.state(app)
    record, ring = held["record"], held["ring"]
    assert sorted(kept) == list(range(1, n)) and sorted(record) == list(range(n))
    for j, e in enumerate(app.trajectory):
        states = record[j].states
        assert states.shape == (min(j + 1, app.window), 21)
        np.testing.assert_array_equal(states[-1, 0:9].reshape(3, 3), e.pose.rot)
        np.testing.assert_array_equal(states[-1, 9:12], e.pose.trans)
    K = int(cfg["register"]["keyframe_window"])
    assert sorted(ring) == list(range(n - K, n))
    for j, (pts, mask) in ring.items():
        R, t = app.trajectory[j].pose
        body = app._kf_clouds[j % K].double().numpy()
        assert abs(pts - (body @ np.asarray(R).T + np.asarray(t))).max() < 1e-9 and mask.sum() > 0


def test_adapter_refuses_settings_the_port_does_not_run():
    """The configuration's window iterations and velocity prior are the
    app's own constants; another value cannot run, and ``make`` says so."""
    _, _, cfg, _ = small_cell(cell=CELL)
    for block, key, value in (("fusion", "smoother_iters", 4), ("fusion", "prior_vel_sigma", 0.3),
                              ("imu", "integration_sigma", 1e-7)):
        bad = json.loads(json.dumps(cfg))
        bad[block][key] = value
        with pytest.raises(ValueError, match=key.split("_")[0]):
            adapter.make(bad, torch.device("cpu"))


def test_reference_imports_nothing_of_the_port():
    """The ligo reference and its control load neither the port nor JAX."""
    import os
    import subprocess
    import sys

    from .conftest import ROOT

    code = """
import json, sys, torch
from slambench import harness, sensor as sn, traffic as tr
from slambench.reference import ligo_tc
from slambench.tests.conftest import small_cell
bench, cell, cfg, traffic = small_cell(128, 32, cell="ligo_tc_berlin.stadium")
lap = tr.Lap(traffic, sn.Sensor.from_config(cfg["sensor"]), 5, "cpu", n_sweeps=14)
rec = harness.Record(lap, cfg, list(range(1, 14)), {}, torch.device("cpu"))
ligo_tc.gaps(ligo_tc.published(rec, [11], ligo_tc.c.TF32), ligo_tc.published(rec, [11]))
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr[-3000:]
    top = set(json.loads(r.stdout.strip().splitlines()[-1]))
    assert not {"slamtpu_torch", "slamtpu", "jax", "jaxlib", "flax"} & top
