"""The odom_ndt keyframe as a whole, port against reference, on the CPU.

Both packages run the NDT_OMP engine (Newton NDT) and the isotropic GICP
engine on a 5-sweep skewed replay with deskew. On the CPU the reference
takes its XLA Newton loop (``_use_fused`` is False off the TPU), which
evaluates the objective at the current pose on every step; the port runs
its fused driver over the pair kernels' plain versions with
``fused_inner_iters=1``, which does the same.

(a) One ``_odom_fused_step`` from the reference's own window carry (taken
    on its fourth keyframe, through ``interop.odom_carry_from_numpy``):
    published pose within 1e-4 m / 1e-4 rad, Newton iterations equal
    within 1, LiDAR covariance diagonal within rtol 1e-2 (the two Hessians
    sum the same pairs in another float32 order), score within rtol 1e-4.
    The reference's XLA loop returns score and Hessian at the returned
    pose, so the port step runs with ``final_eval=True`` for the like
    comparison; its default (the evaluation before the last retract, the
    reference's fused contract) registers to the same pose and moves the
    score by 1e-4 to 1e-3 on this replay (a step under trans_eps still
    moves points across voxel faces).
(b) ``run_replay`` of both packages: per-keyframe poses within 5e-4 m and
    both ATEs within 5e-4 m of each other.
(c) The same ``run_replay`` of NDT_OMP with the card's segment sums
    (``gaussian_map.segment_sum_scan``) in the port's map build, at the
    bounds of (b).
(d) The search modes. NDT_OMP with KDTREE: ``run_replay`` of both
    packages at the bounds of (b) (the reference's CPU path gates at each
    step's pose, as the port with one Newton step per lookup). Isotropic
    GICP with KDTREE: the reference's CPU app path skips the gate, so one
    registration of the port's app step (``_register_step``, on a map
    the port builds) is held against the reference's fused Newton in
    interpret mode on the reference's map: iterations and ``converged``
    equal, pose within 1e-5 m / 1e-5 rad. DIRECT1 runs DIRECT7 in both
    packages: the port's DIRECT1 run equals its DIRECT7 run bit for bit
    and the reference's DIRECT1 run at the bounds of (b).
(e) The sorted-key path (``use_regmap=False``): ``run_replay`` of both
    packages with NDT_OMP in DIRECT7 and DIRECT1 (``newton_align``),
    isotropic GICP (``gicp_align`` on the fixed (256, 256, 64) grid) and
    NDT_OMP with loop closure, at the bounds of (b) and (f); KDTREE runs
    DIRECT7 there in both packages. An unknown method raises.
(f) Loop closure: ``run_replay`` of both packages with ``loop_closure=True``
    on a circle replay that revisits its start, then
    ``refine_loop_closures``: the same (i, j) closures; per-keyframe poses
    before the refinement within 1e-3 m / 1e-4 rad (measured 5.2e-4 m:
    over 17 keyframes the registrations' float32 roundings add up past
    (b)'s 5e-4); the refined poses within 1e-3 m / 1e-3 rad of the
    reference's (they inherit that gap, and the closures' relative poses
    differ by the rounding of two Newton runs).

The reference builds its odom target maps in float32; the port computes
their voxel statistics in float64 from the same float32 cloud
(``todom.MAP_DTYPE``: float32 rounding rejects at random the voxels whose
points lie nearly on a line). So every reference run here builds them as
the port does (``float64_target_maps``, applied to each test of this
module and of tests/test_torch_odom_engines.py): the same statistics in
float64 under the tests' x64, handed to the registration in float32.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamtpu.apps import odom_ndt as jodom
from slamtpu.ins.imu_config import ImuConfig as JImu
from slamtpu.lidar.ouster import LidarParams as JLidar
from slamtpu.mapping import gaussian_map as jgm
from slamtpu.ndt import multires as jmultires
from slamtpu.runtime import config as jconfig
from slamtpu_torch import interop
from slamtpu_torch.apps import odom_ndt as todom
from slamtpu_torch.apps.common import ate_rmse, np_between
from slamtpu_torch.core.se3 import Pose3
from slamtpu_torch.mapping import gaussian_map
from slamtpu_torch.ins.imu_config import ImuConfig as TImu
from slamtpu_torch.lidar.ouster import LidarParams as TLidar
from slamtpu_torch.lidar.ouster import synthetic_os2_metadata
from slamtpu_torch.runtime import config as tconfig
from tests.simulator import simulate_replay, small_meta
from tests.test_torch_lo_svn import _assert_pose_close

torch.set_num_threads(1)
N_SWEEPS = 5
WINDOW = 3  # the window fills and rolls within the replay
ENGINES = ["NDT_OMP", "GICP"]
REGISTER = dict(
    # float32 resolution: the reference builds its map in float32, as on its
    # accelerator, instead of widening to float64 under the tests' x64 mode
    ndt_resolution=np.float32(1.0), ndt_max_iterations=30, map_capacity=1 << 14,
    min_points_per_voxel=6, reg_grid_shape=(128, 128, 32), fused_inner_iters=1,
)


class Float64Statistics:
    """The reference's ``gaussian_map`` as its odom app and its pyramid see
    it inside ``float64_target_maps``: ``build_map`` computes the voxel
    statistics of the float32 target cloud in float64 and hands the map
    back in float32, as the port's app (``gaussian_map.to_float32``)."""

    def __getattr__(self, name):
        return getattr(jgm, name)

    @staticmethod
    def build_map(points, *args, **kwargs):
        gmap = jgm.build_map(points.astype(jnp.float64), *args, **kwargs)
        return jax.tree.map(lambda a: a.astype(jnp.float32) if jnp.issubdtype(a.dtype, jnp.floating) else a,
                            gmap)


@contextlib.contextmanager
def float64_target_maps():
    """Inside, the reference's odom app and pyramid build their target maps
    as the port's app does (``Float64Statistics``). Jitted functions are
    traced afresh on entry and on exit, so no trace crosses the boundary."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jodom, "gaussian_map", Float64Statistics())
    mp.setattr(jmultires, "gaussian_map", Float64Statistics())
    jax.clear_caches()
    try:
        yield
    finally:
        mp.undo()
        jax.clear_caches()


@pytest.fixture(scope="module", autouse=True)
def reference_float64_target_maps():
    with float64_target_maps():
        yield


def configs(method):
    lidar = dict(channel_stride=1, range_filter=(0.5, 150.0))
    reg = dict(REGISTER, method=method)
    jcfg = jconfig.PipelineConfig(meta=small_meta(cols=256), lidar=JLidar(**lidar), imu=JImu(),
                                  register=jconfig.RegisterConfig(**reg), deskew=True)
    tcfg = tconfig.PipelineConfig(
        meta=synthetic_os2_metadata(columns_per_frame=256, pixels_per_column=32, columns_per_packet=16),
        lidar=TLidar(**lidar), imu=TImu(), register=tconfig.RegisterConfig(**reg), deskew=True,
    )
    return jcfg, tcfg


@pytest.fixture(scope="module")
def replay(tmp_path_factory):
    jcfg, _ = configs("NDT_OMP")
    path = str(tmp_path_factory.mktemp("odom_ndt") / "skewed.rpl")
    gt = simulate_replay(path, jcfg.meta, jcfg.lidar, n_sweeps=N_SWEEPS, skewed=True)
    return path, gt


def _ate(traj, gt):
    gtp = [Pose3(np.asarray(R), np.asarray(p)) for R, p in gt[1:]]
    return ate_rmse([np_between(traj[0].pose, e.pose) for e in traj],
                    [np_between(gtp[0], g) for g in gtp[: len(traj)]])


@pytest.mark.parametrize("method", ENGINES)
def test_one_keyframe_step_matches(replay, method):
    path, _gt = replay
    jcfg, tcfg = configs(method)
    calls = []
    real_step = jodom._odom_fused_step

    def recording_step(carry, points, mask, flat, *args, **kwargs):
        # copies first: the reference step donates its carry
        calls.append(({k: np.array(v) for k, v in carry.items()}, np.array(points), np.array(mask),
                      np.array(flat), args, kwargs))
        new_carry, out = real_step(carry, points, mask, flat, *args, **kwargs)
        calls[-1] += (np.array(out),)
        return new_carry, out

    jodom._odom_fused_step = recording_step
    try:
        japp = jodom.OdomNdtApp(jcfg, window=WINDOW)
        japp.run_replay(path, max_keyframes=4)
    finally:
        jodom._odom_fused_step = real_step
    carry, points, mask, flat, args, kwargs, ref = calls[-1]  # the window is full here
    assert int(carry["n"]) == WINDOW and kwargs["method"] == method
    jnewton, capacity, min_points, grid, max_td, max_rd = args
    outs = [todom._odom_fused_step(
        interop.odom_carry_from_numpy(carry), torch.as_tensor(points), torch.as_tensor(mask),
        torch.as_tensor(flat), interop.newton_config_from_reference(jnewton), capacity, min_points,
        grid, max_td, max_rd, method=method, inner_iters=1, window=WINDOW,
        smoother_iters=kwargs["smoother_iters"], final_eval=final_eval,
    )[1].numpy() for final_eval in (True, False)]
    out, default = outs
    # the same registration (the relative motion), another evaluation
    np.testing.assert_array_equal(default[84:96], out[84:96])
    assert out.dtype == np.float64 and np.isfinite(out).all()
    _assert_pose_close(out[0:9].reshape(3, 3), out[9:12], ref[0:9].reshape(3, 3), ref[9:12],
                       atol_m=1e-4, atol_rad=1e-4)
    assert abs(out[97] - ref[97]) <= 1 and out[98] == ref[98] == 1.0  # iterations, converged
    np.testing.assert_allclose(np.diag(out[48:84].reshape(6, 6)), np.diag(ref[48:84].reshape(6, 6)),
                               rtol=1e-2)
    np.testing.assert_allclose(out[96], ref[96], rtol=1e-4)  # score
    np.testing.assert_allclose(out[99], ref[99], atol=1e-6)  # blend weight


@pytest.mark.parametrize("method", ENGINES)
def test_run_replay_matches_reference(replay, method):
    path, gt = replay
    jcfg, tcfg = configs(method)
    japp = jodom.OdomNdtApp(jcfg, window=WINDOW)
    jt = japp.run_replay(path)
    tapp = todom.OdomNdtApp(tcfg, "cpu", window=WINDOW)
    tt = tapp.run_replay(path)
    assert len(tt) == len(jt) == N_SWEEPS - 1
    for a, b in zip(jt, tt):
        assert a.frame_id == b.frame_id
        _assert_pose_close(b.pose.rot, b.pose.trans, a.pose.rot, a.pose.trans)
        np.testing.assert_array_equal(np.asarray(b.ins_pose.trans), np.asarray(a.ins_pose.trans))
    ate = {"reference": _ate(jt, gt), "port": _ate(tt, gt)}
    print(f"{method}: ATE reference {ate['reference']:.6f} m, port {ate['port']:.6f} m")
    assert abs(ate["port"] - ate["reference"]) < 5e-4
    assert ate["reference"] < 0.05  # the fixture registers (scan-to-previous at 256 x 32 beams)
    recs = tapp.stats.records
    jrecs = japp.stats.records
    assert len(recs) == len(jrecs) == len(tt) - 1
    assert [r.converged for r in recs] == [r.converged for r in jrecs]
    assert all(abs(r.ndt_iterations - q.ndt_iterations) <= 1 for r, q in zip(recs, jrecs))
    assert all(np.isfinite(r.lidar_sigma).all() and np.isfinite(r.optimized_sigma).all() for r in recs)
    assert all(e.covariance is not None and np.isfinite(e.covariance).all() for e in tt[1:])
    assert set(tapp.device_timer.summary()) >= {"project", "deskew", "map_build", "newton", "blend",
                                                 "covariance", "smoother"}


def test_run_replay_with_scan_sums_matches_reference(replay, monkeypatch):
    """On the card the map build sums in float64 prefix sums, not the CPU's
    float32 ``index_add_``; run here, they register as the reference does."""
    monkeypatch.setattr(gaussian_map, "segment_sum", gaussian_map.segment_sum_scan)
    path, gt = replay
    jcfg, tcfg = configs("NDT_OMP")
    jt = jodom.OdomNdtApp(jcfg, window=WINDOW).run_replay(path)
    tt = todom.OdomNdtApp(tcfg, "cpu", window=WINDOW).run_replay(path)
    assert len(tt) == len(jt) == N_SWEEPS - 1
    for a, b in zip(jt, tt):
        assert a.frame_id == b.frame_id
        _assert_pose_close(b.pose.rot, b.pose.trans, a.pose.rot, a.pose.trans)
    assert abs(_ate(tt, gt) - _ate(jt, gt)) < 5e-4


def _with(cfg, **change):
    return dataclasses.replace(cfg, register=dataclasses.replace(cfg.register, **change))


def _assert_runs_match(path, gt, jt, tt):
    assert len(tt) == len(jt) == N_SWEEPS - 1
    for a, b in zip(jt, tt):
        assert a.frame_id == b.frame_id
        _assert_pose_close(b.pose.rot, b.pose.trans, a.pose.rot, a.pose.trans)
    assert abs(_ate(tt, gt) - _ate(jt, gt)) < 5e-4
    assert _ate(jt, gt) < 0.05


def test_ndt_omp_kdtree_run_replay_matches_reference(replay):
    path, gt = replay
    jcfg, tcfg = (_with(c, search_method="KDTREE") for c in configs("NDT_OMP"))
    jt = jodom.OdomNdtApp(jcfg, window=WINDOW).run_replay(path)
    tapp = todom.OdomNdtApp(tcfg, "cpu", window=WINDOW)
    assert tapp.newton_cfg.kd_radius == 1.0
    tt = tapp.run_replay(path)
    _assert_runs_match(path, gt, jt, tt)


def test_gicp_kdtree_step_matches_reference_fused(replay):
    """The port's GICP registration with the gate against the reference's
    fused Newton (interpret mode), from the inputs of the port app's last
    registration."""
    from slamtpu.core import se3 as jse3
    from slamtpu.ndt import build_regmap as jbuild_regmap
    from slamtpu.ndt import gicp_map as jgicp_map
    from slamtpu.ndt.pallas_math import gicp_align_fused

    path, _ = replay
    jcfg, tcfg = (_with(c, search_method="KDTREE") for c in configs("GICP"))
    calls = []
    real = todom._register_step

    def spy(*args, **kwargs):
        res = real(*args, **kwargs)
        calls.append((args, kwargs, res))
        return res

    todom._register_step = spy
    try:
        tapp = todom.OdomNdtApp(tcfg, "cpu", window=WINDOW)
        tapp.run_replay(path, max_keyframes=3)
    finally:
        todom._register_step = real
    (target, tmask, pts, mask, guess, origin, cfg, capacity, min_points, grid), kwargs, res = calls[-1]
    assert kwargs["method"] == "GICP" and cfg.kd_radius == 1.0 and kwargs["inner_iters"] == 1
    gmap = Float64Statistics.build_map(jnp.asarray(target.numpy()), jnp.asarray(tmask.numpy()),
                                       jnp.asarray(origin.numpy()), cfg.resolution, capacity=capacity,
                                       min_points_per_voxel=min_points)
    jreg = jbuild_regmap(jgicp_map(gmap), grid_shape=grid)
    jnewton_cfg = jodom.OdomNdtApp(jcfg, window=WINDOW).newton_cfg
    assert jnewton_cfg.kd_radius == cfg.kd_radius
    ref = jax.jit(gicp_align_fused, static_argnames=("cfg", "grid_shape", "inner_iters", "interpret"))(
        jnp.asarray(pts.numpy()), jnp.asarray(mask.numpy()), jreg,
        jse3.Pose3(jnp.asarray(guess.rot.numpy()), jnp.asarray(guess.trans.numpy())), jnewton_cfg, grid,
        inner_iters=1, interpret=True)
    assert int(res.iterations) == int(ref.iterations)
    assert bool(res.converged) == bool(ref.converged)
    _assert_pose_close(res.pose.rot.numpy(), res.pose.trans.numpy(), np.asarray(ref.pose.rot),
                       np.asarray(ref.pose.trans), atol_m=1e-5, atol_rad=1e-5)
    assert int(res.n_contrib) == int(ref.n_contrib)


def test_direct1_runs_direct7(replay):
    path, gt = replay
    jcfg, tcfg = configs("NDT_OMP")
    jt = jodom.OdomNdtApp(_with(jcfg, search_method="DIRECT1"), window=WINDOW).run_replay(path)
    tt = todom.OdomNdtApp(_with(tcfg, search_method="DIRECT1"), "cpu", window=WINDOW).run_replay(path)
    t7 = todom.OdomNdtApp(tcfg, "cpu", window=WINDOW).run_replay(path)
    for a, b in zip(tt, t7):
        np.testing.assert_array_equal(a.pose.trans, b.pose.trans)
        np.testing.assert_array_equal(a.pose.rot, b.pose.rot)
        np.testing.assert_array_equal(a.covariance, b.covariance)
    _assert_runs_match(path, gt, jt, tt)


def test_unknown_method_raises():
    _, tcfg = configs("NDT_OMP")
    with pytest.raises(ValueError):
        todom.OdomNdtApp(tcfg, "cpu", method="ICP")


# the sorted-key path (use_regmap=False): NDT_OMP on newton_align in DIRECT7
# and DIRECT1 (one voxel), isotropic GICP on gicp_align over the fixed
# (256, 256, 64) grid
SORTED_KEY = {
    "NDT_OMP": ("NDT_OMP", {}),
    "NDT_OMP_DIRECT1": ("NDT_OMP", dict(search_method="DIRECT1")),
    "GICP": ("GICP", {}),
}


def _sorted_key_runs(path, method, **change):
    jcfg, tcfg = (_with(c, use_regmap=False, **change) for c in configs(method))
    japp = jodom.OdomNdtApp(jcfg, window=WINDOW)
    tapp = todom.OdomNdtApp(tcfg, "cpu", window=WINDOW)
    assert tapp.grid_shape is None
    return japp, japp.run_replay(path), tapp, tapp.run_replay(path)


@pytest.mark.parametrize("case", list(SORTED_KEY))
def test_sorted_key_run_replay_matches_reference(replay, case, monkeypatch):
    path, gt = replay
    method, change = SORTED_KEY[case]
    calls = []
    for name in ("newton_align", "gicp_align", "newton_align_fused"):
        real = getattr(todom, name)
        monkeypatch.setattr(todom, name, lambda *a, _n=name, _f=real, **k: calls.append(_n) or _f(*a, **k))
    japp, jt, tapp, tt = _sorted_key_runs(path, method, **change)
    assert set(calls) == {"gicp_align" if method == "GICP" else "newton_align"}
    _assert_runs_match(path, gt, jt, tt)
    recs, jrecs = tapp.stats.records, japp.stats.records
    assert [r.converged for r in recs] == [r.converged for r in jrecs]
    assert all(abs(r.ndt_iterations - q.ndt_iterations) <= 1 for r, q in zip(recs, jrecs))
    assert all(np.isfinite(r.lidar_sigma).all() for r in recs)
    print(f"sorted-key {case}: ATE reference {_ate(jt, gt):.6f} m, port {_ate(tt, gt):.6f} m")


def test_sorted_key_kdtree_runs_direct7(replay):
    """KDTREE on the sorted-key path runs DIRECT7 in both packages (the
    reference's sorted-key objective reads no radius): the port's KDTREE
    run equals its DIRECT7 run bit for bit and the reference's KDTREE run
    at the bounds of (b)."""
    path, gt = replay
    _, jt, tapp, tt = _sorted_key_runs(path, "NDT_OMP", search_method="KDTREE")
    assert tapp.newton_cfg.kd_radius == 1.0
    _, _, _, t7 = _sorted_key_runs(path, "NDT_OMP")
    for a, b in zip(tt, t7):
        np.testing.assert_array_equal(a.pose.trans, b.pose.trans)
        np.testing.assert_array_equal(a.pose.rot, b.pose.rot)
        np.testing.assert_array_equal(a.covariance, b.covariance)
    _assert_runs_match(path, gt, jt, tt)


# tests/test_e2e.py's loop-closure settings with the temporal gap cut from 30
# to 15 keyframes, on a skewed 18-sweep replay along a circle of radius
# 0.95 m (1 m/s, 6 s a turn: every keyframe lies within the 2 m search
# radius of the first ones), which closes twice: (0, 15) and (1, 16)
LOOP_CFG = dict(search_radius=2.0, min_keyframe_gap=15, max_candidates_per_keyframe=1,
                resolution=2.0, min_contrib_ratio=0.05)
LOOP_SWEEPS, LOOP_SPEED, LOOP_PERIOD_S = 18, 1.0, 6.0


@pytest.fixture(scope="module")
def loop_replay(tmp_path_factory):
    from tests.simulator import ArcTrajectory

    jcfg, _ = configs("NDT_OMP")
    path = str(tmp_path_factory.mktemp("odom_loop") / "circle.rpl")
    gt = simulate_replay(path, jcfg.meta, jcfg.lidar, n_sweeps=LOOP_SWEEPS, skewed=True,
                         traj=ArcTrajectory(v=LOOP_SPEED, yaw_rate=2 * np.pi / LOOP_PERIOD_S))
    return path, gt


def test_loop_closure_run_replay_matches_reference(loop_replay):
    from slamtpu.fusion.loop_closure import LoopClosureConfig as JLoop
    from slamtpu_torch.fusion.loop_closure import LoopClosureConfig as TLoop

    path, gt = loop_replay
    jcfg, tcfg = configs("NDT_OMP")
    japp = jodom.OdomNdtApp(jcfg, window=6, loop_closure=True, loop_cfg=JLoop(**LOOP_CFG))
    tapp = todom.OdomNdtApp(tcfg, "cpu", window=6, loop_closure=True, loop_cfg=TLoop(**LOOP_CFG))
    jt, tt = japp.run_replay(path), tapp.run_replay(path)
    assert len(tt) == len(jt) == LOOP_SWEEPS - 1
    for a, b in zip(jt, tt):
        _assert_pose_close(b.pose.rot, b.pose.trans, a.pose.rot, a.pose.trans, atol_m=1e-3)
    pairs = [(c.i, c.j) for c in tapp._closures]
    assert pairs == [(c.i, c.j) for c in japp._closures]
    assert pairs and all(j - i >= LOOP_CFG["min_keyframe_gap"] for i, j in pairs)
    ate_before = _ate(tt, gt)
    jrefined, _ = japp.refine_loop_closures()
    refined, closures = tapp.refine_loop_closures()
    assert [(c.i, c.j) for c in closures] == pairs
    gap = max(np.abs(b.trans - np.asarray(a.trans)).max() for a, b in zip(jrefined, refined))
    print(f"refined poses: max {gap:.3g} m from the reference's")
    for a, b in zip(jrefined, refined):
        _assert_pose_close(b.rot, b.trans, np.asarray(a.rot), np.asarray(a.trans), atol_m=1e-3, atol_rad=1e-3)
    for e, p in zip(tapp.trajectory, refined):  # rewritten in place, host float64
        assert e.pose is p and p.trans.dtype == np.float64
    ate_after = _ate(tt, gt)
    print(f"loop closure: {len(pairs)} closures, ATE {ate_before:.6f} -> {ate_after:.6f} m "
          f"(reference {_ate(jt, gt):.6f} m after)")
    assert np.isfinite(ate_after) and ate_after < max(2.0 * ate_before, 0.05)


def test_sorted_key_loop_closure_matches_reference(loop_replay):
    """NDT_OMP on the sorted-key path with loop closure: the verifications
    keep their own RegMap and the NDT pair kernel's plain version."""
    from slamtpu.fusion.loop_closure import LoopClosureConfig as JLoop
    from slamtpu_torch.fusion.loop_closure import LoopClosureConfig as TLoop

    path, gt = loop_replay
    jcfg, tcfg = (_with(c, use_regmap=False) for c in configs("NDT_OMP"))
    japp = jodom.OdomNdtApp(jcfg, window=6, loop_closure=True, loop_cfg=JLoop(**LOOP_CFG))
    tapp = todom.OdomNdtApp(tcfg, "cpu", window=6, loop_closure=True, loop_cfg=TLoop(**LOOP_CFG))
    jt, tt = japp.run_replay(path), tapp.run_replay(path)
    assert len(tt) == len(jt) == LOOP_SWEEPS - 1
    for a, b in zip(jt, tt):
        _assert_pose_close(b.pose.rot, b.pose.trans, a.pose.rot, a.pose.trans, atol_m=1e-3)
    pairs = [(c.i, c.j) for c in tapp._closures]
    assert pairs and pairs == [(c.i, c.j) for c in japp._closures]
    jrefined, _ = japp.refine_loop_closures()
    refined, _ = tapp.refine_loop_closures()
    for a, b in zip(jrefined, refined):
        _assert_pose_close(b.rot, b.trans, np.asarray(a.rot), np.asarray(a.trans), atol_m=1e-3, atol_rad=1e-3)
    print(f"sorted-key loop closure: {len(pairs)} closures, ATE after {_ate(tt, gt):.6f} m "
          f"(reference {_ate(jt, gt):.6f} m)")


def test_loop_closure_without_closures_leaves_the_trajectory(replay):
    from slamtpu_torch.fusion.loop_closure import LoopClosureConfig

    path, _ = replay
    _, tcfg = configs("NDT_OMP")
    app = todom.OdomNdtApp(tcfg, "cpu", window=WINDOW, loop_closure=True, loop_cfg=LoopClosureConfig())
    traj = app.run_replay(path)
    before = [e.pose.trans.copy() for e in traj]
    assert len(app._odo_rels) == len(traj) - 1 and len(app._detector.poses) == len(traj)
    poses, closures = app.refine_loop_closures()
    assert closures == [] and all(np.array_equal(p.trans, b) for p, b in zip(poses, before))
    with pytest.raises(RuntimeError, match="loop_closure=True"):
        todom.OdomNdtApp(tcfg, "cpu").refine_loop_closures()


def test_float64_target_map_keeps_line_voxels():
    """The app computes its target map's statistics in float64 from the
    float32 cloud: 300 voxels of 2 m, each crossed by 12 points on a line
    with 0.1 mm of noise (one scan ring on the ground). Their covariances'
    two small eigenvalues lie at float32's rounding of the largest, so a
    float32 build (the JAX package's) rejects most of them at random by a
    negative eigenvalue, where a float64 build keeps every one; both come
    back in float32, the registration's dtype."""
    g = torch.Generator().manual_seed(7)
    V = 300
    f64 = torch.float64
    centers = torch.stack([torch.arange(V, dtype=f64) * 2.0 + 1.0, torch.full((V,), 31.0, dtype=f64),
                           torch.full((V,), 3.0, dtype=f64)], 1)
    t = torch.linspace(-0.9, 0.9, 12, dtype=f64)
    d = torch.nn.functional.normalize(
        torch.randn(V, 3, generator=g, dtype=f64) * torch.tensor([1.0, 1.0, 0.05], dtype=f64), dim=1)
    pts = (centers[:, None] + t[None, :, None] * d[:, None] + 1e-4 * torch.randn(V, 12, 3, generator=g, dtype=f64))
    pts = pts.reshape(-1, 3).to(torch.float32)  # the app's target cloud is float32
    mask = torch.ones(pts.shape[0], dtype=torch.bool)
    maps = {dt: gaussian_map.to_float32(gaussian_map.build_map(pts.to(dt), mask, torch.zeros(3), 2.0,
                                                               capacity=1024, min_points_per_voxel=6))
            for dt in (torch.float32, todom.MAP_DTYPE)}
    assert todom.MAP_DTYPE == torch.float64
    assert all(m.mean.dtype == m.icov.dtype == torch.float32 for m in maps.values())
    assert int(maps[torch.float64].num_valid()) == V
    assert int(maps[torch.float32].num_valid()) < V // 2
    jmap = jgm.build_map(jnp.asarray(pts.numpy()), jnp.asarray(mask.numpy()),
                         jnp.zeros(3, jnp.float32), 2.0, capacity=1024, min_points_per_voxel=6)
    assert int(np.sum(np.asarray(jmap.valid))) < V // 2
