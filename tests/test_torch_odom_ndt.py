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
(d) The options the port does not carry raise.
"""
import dataclasses

import numpy as np
import pytest
import torch

from slamtpu.apps import odom_ndt as jodom
from slamtpu.ins.imu_config import ImuConfig as JImu
from slamtpu.lidar.ouster import LidarParams as JLidar
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
    assert set(tapp.device_timer.summary()) >= {"project", "deskew", "map_build", "newton",
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


@pytest.mark.parametrize("change", [
    dict(search_method="KDTREE"), dict(search_method="DIRECT1"), dict(use_regmap=False),
    dict(loop_closure=True),
])
def test_unported_engines_raise(change):
    _, tcfg = configs("NDT_OMP")
    change = dict(change)
    app_kw = {"loop_closure": change.pop("loop_closure")} if "loop_closure" in change else {}
    cfg = dataclasses.replace(tcfg, register=dataclasses.replace(tcfg.register, **change))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        todom.OdomNdtApp(cfg, "cpu", **app_kw)
    with pytest.raises(ValueError):
        todom.OdomNdtApp(tcfg, "cpu", method="ICP")
