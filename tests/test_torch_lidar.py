"""Parity of the port's sweep path with slamtpu: ``project_frame_packed``,
``deskew_points`` and ``stencil_point_covariances`` on a decoded, skewed
simulated sweep (float32 on both sides)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamtpu.apps.common import IngestPipeline as JIngest
from slamtpu.apps.common import ins_pose_ned as jins_pose_ned
from slamtpu.core import se3 as jse3
from slamtpu.ins.imu_config import ImuConfig
from slamtpu.lidar.deskew import deskew_points as jdeskew
from slamtpu.lidar.ouster import LidarParams
from slamtpu.lidar.project import project_frame_packed as jproject
from slamtpu.ndt.gicp import stencil_point_covariances as jstencil
from slamtpu.runtime.config import PipelineConfig, RegisterConfig
from slamtpu.runtime.sync import interpolate_at
from slamtpu_torch import interop
from slamtpu_torch.lidar.deskew import deskew_points
from slamtpu_torch.lidar.project import filters_from_params, pack_frame, project_frame_packed
from slamtpu_torch.ndt.gicp import stencil_point_covariances
from tests.simulator import ArcTrajectory, simulate_replay, small_meta

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    meta = small_meta()
    cfg = PipelineConfig(meta=meta, lidar=LidarParams(channel_stride=2, range_filter=(0.5, 150.0)),
                         imu=ImuConfig(), register=RegisterConfig())
    path = str(tmp_path_factory.mktemp("lidar") / "skewed.rpl")
    simulate_replay(path, meta, cfg.lidar, n_sweeps=3, traj=ArcTrajectory(v=6.0, yaw_rate=0.5),
                    skewed=True)
    ing = JIngest(cfg)
    synced = next(iter(ing.synced_frames(path)))
    fr = synced.scan
    packed = pack_frame(fr.ranges_m, fr.reflectivity, fr.col_timestamp_s, fr.col_valid,
                        signal=fr.signal, nir=fr.nir)
    ref = np.asarray(synced.ins[-1].lla)
    poses = [jins_pose_ned(interpolate_at(synced.ins, t), ref)
             for t in (fr.timestamp, fr.timestamp_end)]
    return ing, packed, poses


def test_project_frame_packed(sweep):
    ing, packed, _ = sweep
    j = jproject(jnp.asarray(packed), ing._dir, ing._off, ing.filters)
    t = project_frame_packed(torch.as_tensor(packed), torch.as_tensor(ing.luts.direction),
                             torch.as_tensor(ing.luts.offset), filters_from_params(ing.cfg.lidar))
    assert tuple(filters_from_params(ing.cfg.lidar)) == tuple(ing.filters)
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    assert int(t.num_points) == int(j.num_points) > 1000
    np.testing.assert_array_equal(t.points.numpy(), np.asarray(j.points))
    np.testing.assert_array_equal(t.reflectivity.numpy(), np.asarray(j.reflectivity))
    np.testing.assert_array_equal(t.signal.numpy(), np.asarray(j.signal))
    # alpha in float64 then cast, as the reference computes it under x64
    np.testing.assert_allclose(t.alpha.numpy(), np.asarray(j.alpha), atol=1e-7)


def test_deskew_and_stencil_covariances(sweep):
    ing, packed, (pose_s, pose_e) = sweep
    j = jproject(jnp.asarray(packed), ing._dir, ing._off, ing.filters)
    f32 = lambda p: jse3.cast(jse3.Pose3(jnp.asarray(p.rot), jnp.asarray(p.trans)), jnp.float32)  # noqa: E731
    jd = jdeskew(j.points, j.alpha, f32(pose_s), f32(pose_e))
    td = deskew_points(torch.as_tensor(np.asarray(j.points)), torch.as_tensor(np.asarray(j.alpha)),
                       interop.pose_from_numpy(pose_s.rot, pose_s.trans),
                       interop.pose_from_numpy(pose_e.rot, pose_e.trans))
    assert np.abs(np.asarray(jd) - np.asarray(j.points)).max() > 0.01  # the sweep is skewed
    # per-point Expmap in float32: sin/cos differ by an ulp between libraries
    # (points up to ~100 m: 1e-5 m)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=2e-5)
    cols, sub = ing.cfg.meta.columns_per_frame, ing.luts.subset_channels
    jc = np.asarray(jstencil(jd, j.mask, (cols, sub)))
    # the same deskewed points on both sides isolate the stencil arithmetic
    tc = stencil_point_covariances(torch.as_tensor(np.asarray(jd)), torch.as_tensor(np.asarray(j.mask)),
                                   (cols, sub)).numpy()
    # plane model I - (1 - eps) n n^T: entries in [-1, 1]; the normal n
    # comes through arccos/cos, good to ~1e-5 in float32. Where the two
    # smallest eigenvalues nearly tie (line-like neighborhoods) the normal is
    # ill-conditioned and an ulp of input moves it further: allow 1e-3 there,
    # for at most 0.5% of the entries
    err = np.abs(tc - jc)
    assert err.max() < 1e-3, err.max()
    assert (err > 5e-5).mean() < 5e-3, (err > 5e-5).mean()
    m = np.asarray(j.mask)
    assert (np.abs(tc[m] - 0.0025 * np.eye(3)).max(axis=(1, 2)) > 0.1).mean() > 0.5  # mostly planes
