"""The ligo_tc keyframe as a whole, port against reference, on the CPU.

Both packages run a 6-sweep skewed replay at 256 x 32 beams with deskew,
a 4-state window and a 3-cloud registration ring. On the CPU the
reference takes its XLA Newton loop, which evaluates the objective at the
current pose on every step; the port runs its fused driver over the NDT
pair kernel's plain version with ``fused_inner_iters=1`` (and
``final_eval=True`` where one step is compared), which does the same.

(a) One ``_ligo_step`` from the reference's own inputs (recorded on its
    third registration, through ``interop``), at rebuild cadence 1 (the
    step builds the map) and 3 (it reuses the cached RegMap):
    preintegration fields and the predicted velocity within 1e-9 (float64,
    the same formulas), pose within 1e-4 m / 1e-4 rad, Newton iterations
    within 1 and ``converged`` equal, Hessian diagonal within rtol 1e-2
    and score within rtol 1e-4 (float32 sums of the same pairs in another
    order).
(b) ``run_replay`` of both packages at rebuild cadence 1 and 3, the port's
    steps with ``final_eval=True``: per-keyframe poses within 5e-4 m, ATEs
    within 5e-4 m of each other, iterations within 1, every statistic and
    covariance finite. The port's app as it ships (the reference's fused
    contract): ATE within 5e-4 m of the reference's.
(c) The search modes. DIRECT1 runs DIRECT7 in both packages: the port's
    DIRECT1 run equals its DIRECT7 run bit for bit and the reference's
    DIRECT1 run at the bounds of (b). KDTREE runs in neither: the
    reference fails at its first registration (its rebuild ``lax.cond``
    meets a DIRECT7 map and a cache of KDTREE shape), the port at
    construction.
(d) The sorted-key path (``use_regmap=False``): ``run_replay`` of both
    packages at the bounds of (b), in DIRECT7, DIRECT1 and KDTREE (which
    run DIRECT7 in both packages there).
The reference builds its target maps as the port does (through odom_ndt's
``_register_step`` in both packages), their statistics in float64
(``float64_target_maps`` of tests/test_torch_odom_ndt.py).
"""
import functools

import numpy as np
import pytest
import torch

from slamtpu.apps import ligo_tc as jligo
from slamtpu.ins.imu_config import ImuConfig as JImu
from slamtpu.lidar.ouster import LidarParams as JLidar
from slamtpu.runtime import config as jconfig
from slamtpu_torch import interop
from slamtpu_torch.apps import ligo_tc as tligo
from slamtpu_torch.ins.imu_config import ImuConfig as TImu
from slamtpu_torch.lidar.ouster import LidarParams as TLidar
from slamtpu_torch.lidar.ouster import synthetic_os2_metadata
from slamtpu_torch.runtime import config as tconfig
from tests.simulator import simulate_replay, small_meta
from tests.test_torch_lo_svn import _assert_pose_close
from tests.test_torch_odom_ndt import _ate
from tests.test_torch_odom_ndt import reference_float64_target_maps  # noqa: F401  (autouse)

torch.set_num_threads(1)
N_SWEEPS = 6
WINDOW = 4
CADENCES = [1, 3]
REGISTER = dict(
    # float32 resolution: the reference builds its map in float32, as on its
    # accelerator, instead of widening to float64 under the tests' x64 mode
    ndt_resolution=np.float32(1.0), ndt_max_iterations=30, map_capacity=1 << 14,
    min_points_per_voxel=6, reg_grid_shape=(128, 128, 32), fused_inner_iters=1, keyframe_window=3,
)


def configs(every, **change):
    lidar = dict(channel_stride=1, range_filter=(0.5, 150.0))
    reg = dict(REGISTER, map_rebuild_every=every, **change)
    jcfg = jconfig.PipelineConfig(meta=small_meta(cols=256), lidar=JLidar(**lidar), imu=JImu(),
                                  register=jconfig.RegisterConfig(**reg), deskew=True)
    tcfg = tconfig.PipelineConfig(
        meta=synthetic_os2_metadata(columns_per_frame=256, pixels_per_column=32, columns_per_packet=16),
        lidar=TLidar(**lidar), imu=TImu(), register=tconfig.RegisterConfig(**reg), deskew=True,
    )
    return jcfg, tcfg


@pytest.fixture(scope="module")
def replay(tmp_path_factory):
    jcfg, _ = configs(1)
    path = str(tmp_path_factory.mktemp("ligo_tc") / "skewed.rpl")
    gt = simulate_replay(path, jcfg.meta, jcfg.lidar, n_sweeps=N_SWEEPS, skewed=True)
    return path, gt


@pytest.mark.parametrize("every", CADENCES)
def test_one_keyframe_step_matches(replay, every):
    path, _gt = replay
    jcfg, _ = configs(every)
    calls = []
    real_step = jligo._ligo_step

    def recording_step(*args):
        regmap, out = real_step(*args)
        calls.append(([None if a is None or not hasattr(a, "shape") else np.array(a) for a in args[:7]],
                      args[7], args[8:], np.array(out)))
        return regmap, out

    jligo._ligo_step = recording_step
    try:
        jligo.LigoTcApp(jcfg, window=WINDOW).run_replay(path, max_keyframes=4)
    finally:
        jligo._ligo_step = real_step
    assert len(calls) == 3
    (kf_points, kf_mask, kf_poses, points, mask, imu, flat), jregmap, rest, ref = calls[-1]
    jnoise, jnewton, capacity, min_points, grid, inner = rest
    rebuild = bool(flat[27] > 0.5)
    assert rebuild == (every == 1) and inner == 1 and int(kf_mask.any(1).sum()) == 3
    regmap_in = interop.regmap_from_numpy(
        {k: None if v is None else np.array(v) for k, v in jregmap._asdict().items()})
    T = torch.as_tensor
    regmap, out = tligo._ligo_step(
        T(kf_points), T(kf_mask), T(kf_poses), T(points), T(mask), T(imu[:, :6]), imu[:, 6],
        T(flat[:tligo.FLAT]), rebuild, regmap_in, interop.imu_noise_from_reference(jnoise),
        interop.newton_config_from_reference(jnewton), capacity, min_points, grid, inner_iters=1,
        final_eval=True,
    )
    out = out.numpy()
    assert out.dtype == np.float64 and out.shape == ref.shape == (346,) and np.isfinite(out).all()
    if not rebuild:  # the cache is carried forward untouched
        assert regmap is regmap_in
    np.testing.assert_allclose(out[:292], ref[:292], rtol=1e-9, atol=1e-9)  # preintegration
    np.testing.assert_allclose(out[292:295], ref[292:295], rtol=1e-9, atol=1e-9)  # predicted vel
    _assert_pose_close(out[295:304].reshape(3, 3), out[304:307], ref[295:304].reshape(3, 3), ref[304:307],
                       atol_m=1e-4, atol_rad=1e-4)
    assert abs(out[344] - ref[344]) <= 1 and out[345] == ref[345]  # iterations, converged
    np.testing.assert_allclose(np.diag(out[307:343].reshape(6, 6)), np.diag(ref[307:343].reshape(6, 6)),
                               rtol=1e-2)
    np.testing.assert_allclose(out[343], ref[343], rtol=1e-4)  # score


@pytest.fixture(scope="module")
def reference_runs(replay):
    """The reference app's run at each cadence: (trajectory, stats records)."""
    path, _ = replay
    out = {}
    for every in CADENCES:
        japp = jligo.LigoTcApp(configs(every)[0], window=WINDOW)
        out[every] = (japp.run_replay(path), japp.stats.records)
    return out


@pytest.mark.parametrize("every", CADENCES)
def test_run_replay_matches_reference(replay, reference_runs, every, monkeypatch):
    """The port's app with the CPU reference's Newton contract (score and
    Hessian at the returned pose)."""
    path, gt = replay
    _, tcfg = configs(every)
    jt, jrecs = reference_runs[every]
    monkeypatch.setattr(tligo, "_ligo_step", functools.partial(tligo._ligo_step, final_eval=True))
    tapp = tligo.LigoTcApp(tcfg, "cpu", window=WINDOW)
    tt = tapp.run_replay(path)
    assert len(tt) == len(jt) == N_SWEEPS - 1
    for a, b in zip(jt, tt):
        assert a.frame_id == b.frame_id
        _assert_pose_close(b.pose.rot, b.pose.trans, a.pose.rot, a.pose.trans)
        np.testing.assert_array_equal(np.asarray(b.ins_pose.trans), np.asarray(a.ins_pose.trans))
    ate = {"reference": _ate(jt, gt), "port": _ate(tt, gt)}
    print(f"cadence {every}: ATE reference {ate['reference']:.6f} m, port {ate['port']:.6f} m")
    assert abs(ate["port"] - ate["reference"]) < 5e-4
    assert ate["reference"] < 0.05
    recs = tapp.stats.records
    assert len(recs) == len(jrecs) == len(tt) - 1
    assert [r.converged for r in recs] == [r.converged for r in jrecs]
    assert all(abs(r.ndt_iterations - q.ndt_iterations) <= 1 for r, q in zip(recs, jrecs))
    assert [r.num_points for r in recs] == [q.num_points for q in jrecs]
    for r in recs:
        assert all(np.isfinite(getattr(r, k)).all() for k in ("lidar_sigma", "optimized_sigma", "score",
                                                            "optimized_pose", "scaled_sigma"))
    assert all(e.covariance is not None and e.covariance.shape == (15, 15) and np.isfinite(e.covariance).all()
               for e in tt[1:])
    assert set(tapp.device_timer.summary()) == {"project", "deskew", "preintegrate", "map_build",
                                                "newton", "fuse", "smoother"}
    # the map is built on rebuild keyframes only
    assert tapp.device_timer.summary()["map_build"]["n"] == len(range(0, len(tt) - 1, every))


@pytest.mark.parametrize("every", CADENCES)
def test_run_replay_default_contract(replay, reference_runs, every):
    """The port's app as it ships: the fused contract of the reference's
    accelerator path (score and Hessian of the last applied step, before
    its retract), which moves the LiDAR covariance slightly; at cadence 1
    that flips one registration's iteration count (7 vs 9) and its pose by
    ~0.2 mm. The ATE stays within 5e-4 m of the reference's."""
    path, gt = replay
    _, tcfg = configs(every)
    jt, _ = reference_runs[every]
    tt = tligo.LigoTcApp(tcfg, "cpu", window=WINDOW).run_replay(path)
    assert len(tt) == N_SWEEPS - 1
    assert abs(_ate(tt, gt) - _ate(jt, gt)) < 5e-4
    assert all(np.isfinite(np.asarray(e.pose.trans)).all() for e in tt)


def test_direct1_runs_direct7(replay, reference_runs, monkeypatch):
    path, gt = replay
    jcfg, tcfg = configs(1, search_method="DIRECT1")
    jt = jligo.LigoTcApp(jcfg, window=WINDOW).run_replay(path)
    monkeypatch.setattr(tligo, "_ligo_step", functools.partial(tligo._ligo_step, final_eval=True))
    tt = tligo.LigoTcApp(tcfg, "cpu", window=WINDOW).run_replay(path)
    t7 = tligo.LigoTcApp(configs(1)[1], "cpu", window=WINDOW).run_replay(path)
    assert len(tt) == len(t7) == len(jt) == N_SWEEPS - 1
    for a, b, c in zip(tt, t7, jt):
        np.testing.assert_array_equal(a.pose.trans, b.pose.trans)
        np.testing.assert_array_equal(a.pose.rot, b.pose.rot)
        _assert_pose_close(a.pose.rot, a.pose.trans, c.pose.rot, c.pose.trans)
    assert abs(_ate(tt, gt) - _ate(jt, gt)) < 5e-4


@pytest.mark.parametrize("field", ["search_method", "svn_search_method"])
def test_kdtree_fails_in_both_packages(replay, field):
    path, _ = replay
    jcfg, tcfg = configs(1, **{field: "KDTREE"})
    with pytest.raises(TypeError, match="shapes do not match"):
        jligo.LigoTcApp(jcfg, window=WINDOW).run_replay(path, max_keyframes=2)
    with pytest.raises(ValueError, match="shape mismatch"):
        tligo.LigoTcApp(tcfg, "cpu", window=WINDOW)


@pytest.mark.parametrize("search", ["DIRECT7", "DIRECT1", "KDTREE"])
def test_sorted_key_run_replay_matches_reference(replay, search):
    """``use_regmap=False``: the map every keyframe and ``newton_align`` with
    the pull toward the prediction, no RegMap. The reference's Newton
    config reads no search method, so DIRECT1 and KDTREE run DIRECT7 there
    (and KDTREE runs at all: with no RegMap there is no cache to mismatch);
    the port does the same and equals its DIRECT7 run bit for bit."""
    path, gt = replay
    jcfg, tcfg = configs(1, use_regmap=False, search_method=search)
    jt = jligo.LigoTcApp(jcfg, window=WINDOW).run_replay(path)
    tapp = tligo.LigoTcApp(tcfg, "cpu", window=WINDOW)
    assert tapp.grid_shape is None and tapp._cadence.regmap is None
    tt = tapp.run_replay(path)
    assert len(tt) == len(jt) == N_SWEEPS - 1
    for a, b in zip(jt, tt):
        assert a.frame_id == b.frame_id
        _assert_pose_close(b.pose.rot, b.pose.trans, a.pose.rot, a.pose.trans)
    assert abs(_ate(tt, gt) - _ate(jt, gt)) < 5e-4 and _ate(jt, gt) < 0.05
    recs = tapp.stats.records
    assert all(np.isfinite(r.lidar_sigma).all() and np.isfinite(r.optimized_sigma).all() for r in recs)
    # the map is built on every keyframe
    assert tapp.device_timer.summary()["map_build"]["n"] == len(tt) - 1
    if search != "DIRECT7":
        t7 = tligo.LigoTcApp(configs(1, use_regmap=False)[1], "cpu", window=WINDOW).run_replay(path)
        for a, b in zip(tt, t7):
            np.testing.assert_array_equal(a.pose.trans, b.pose.trans)
            np.testing.assert_array_equal(a.pose.rot, b.pose.rot)
    print(f"sorted-key {search}: ATE reference {_ate(jt, gt):.6f} m, port {_ate(tt, gt):.6f} m")


def test_no_cpu_fallback_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, tcfg = configs(1)
    with pytest.raises((RuntimeError, AssertionError)):
        tligo.LigoTcApp(tcfg, "cuda")


def test_imports_no_jax():
    """The port's ligo_tc module runs where JAX is absent."""
    import subprocess
    import sys

    code = "import sys; sys.modules['jax'] = None; import slamtpu_torch.apps.ligo_tc"
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
