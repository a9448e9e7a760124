"""The port's live viewer (``runtime.viewer.LiveViewer``) and ``VizHook``:
tests/test_viewer.py's loopback cases on the port, the hook's subsample of
a port ScanBuffer (one host copy, masked rows, reflectivity as intensity),
and the apps' ``viz`` attribute: lo_svn, odom_ndt, ligo_tc and ins_map
push one cloud and one trajectory vertex a keyframe (with the INS overlay
where the reference draws it). Loopback HTTP only, on ephemeral ports."""
import struct
import urllib.request

import numpy as np
import pytest
import torch

from slamtpu_torch.apps.common import VizHook
from slamtpu_torch.core.se3 import Pose3
from slamtpu_torch.lidar.project import ScanBuffer
from slamtpu_torch.runtime.viewer import LiveViewer

torch.set_num_threads(1)


@pytest.fixture()
def viewer():
    v = LiveViewer(port=0)
    yield v
    v.close()


def _fetch(viewer, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{viewer.port}{path}", timeout=5) as r:
        return r.read()


def _parse(blob):
    seq, n_traj, n_ins, n_pts = struct.unpack_from("<IIII", blob, 0)
    traj = np.frombuffer(blob, "<f4", n_traj * 3, 16).reshape(-1, 3)
    ins = np.frombuffer(blob, "<f4", n_ins * 3, 16 + n_traj * 12).reshape(-1, 3)
    pts = np.frombuffer(blob, "<f4", n_pts * 4, 16 + (n_traj + n_ins) * 12).reshape(-1, 4)
    return seq, traj, ins, pts


def test_index_page_served(viewer):
    body = _fetch(viewer, "/")
    assert b"slamtpu" in body and b"canvas" in body
    assert b"http://" not in body and b"https://" not in body  # no external assets


def test_snapshot_roundtrip(viewer):
    cloud = np.random.default_rng(0).normal(size=(100, 3)).astype(np.float32)
    viewer.push_cloud(cloud, frame_id=7)
    viewer.push_pose([1.0, 2.0, 3.0])
    seq, traj, ins, pts = _parse(_fetch(viewer, "/data?seq=-1"))
    assert seq == 2
    np.testing.assert_allclose(traj, [[1, 2, 3]])
    assert ins.shape == (0, 3)
    np.testing.assert_allclose(pts[:, :3], cloud, rtol=1e-6)
    blob = _fetch(viewer, f"/data?seq={seq}")  # unchanged: the header alone
    assert len(blob) == 16 and struct.unpack_from("<IIII", blob)[0] == seq


def test_dual_trajectory_overlay(viewer):
    viewer.push_pose([1.0, 0.0, 0.0], ins_xyz=[1.1, 0.05, 0.0])
    viewer.push_pose([2.0, 0.0, 0.0], ins_xyz=[2.2, 0.10, 0.0])
    _, traj, ins, _ = _parse(_fetch(viewer, "/data?seq=-1"))
    np.testing.assert_allclose(traj, [[1, 0, 0], [2, 0, 0]])
    np.testing.assert_allclose(ins, [[1.1, 0.05, 0], [2.2, 0.1, 0]], rtol=1e-6)
    page = _fetch(viewer, "/")
    assert b"#ff5b5b" in page and b"#58d68d" in page


def test_intensity_channel_transported(viewer):
    pts4 = np.concatenate([np.zeros((5, 3), np.float32), np.arange(5, dtype=np.float32)[:, None] * 50], axis=1)
    viewer.push_cloud(pts4)
    _, _, _, pts = _parse(_fetch(viewer, "/data?seq=-1"))
    np.testing.assert_allclose(pts[:, 3], [0, 50, 100, 150, 200])


def test_window_eviction():
    v = LiveViewer(port=0, max_clouds=3, max_points_per_cloud=10)
    try:
        for i in range(5):
            v.push_cloud(np.full((4, 3), float(i), np.float32), frame_id=i)
        _, _, _, pts = _parse(_fetch(v, "/data?seq=-1"))
        assert pts.shape[0] == 12 and pts[:, 0].min() == 2.0
    finally:
        v.close()


def test_per_cloud_point_cap():
    v = LiveViewer(port=0, max_points_per_cloud=16)
    try:
        v.push_cloud(np.zeros((1000, 3), np.float32))
        _, _, _, pts = _parse(_fetch(v, "/data?seq=-1"))
        assert pts.shape[0] <= 16
    finally:
        v.close()


def test_vizhook_world_transform(viewer):
    hook = VizHook(viewer, stride=1)
    body = np.array([[1.0, 0.0, 0.0], [0.0, 2.0, 0.0]], np.float32)
    R = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])  # 90 deg about z
    hook.push(body, Pose3(R, np.array([10.0, 0.0, -1.0])), frame_id=1)
    _, traj, _, pts = _parse(_fetch(viewer, "/data?seq=-1"))
    np.testing.assert_allclose(traj, [[10, 0, -1]])
    np.testing.assert_allclose(pts[:, :3], [[10, 1, -1], [8, 0, -1]], atol=1e-5)


def test_vizhook_subsample_masks_and_strides(viewer):
    n = 64
    refl = (torch.arange(n) % 7).to(torch.uint8)
    sb = ScanBuffer(points=torch.arange(n * 3, dtype=torch.float32).reshape(n, 3),
                    mask=torch.arange(n) % 3 != 1, alpha=torch.zeros(n), reflectivity=refl,
                    num_points=torch.tensor(32, dtype=torch.int32))
    out = VizHook(viewer, stride=4).subsample(sb)
    rows = [r for r in range(0, n, 4) if r % 3 != 1]
    assert out.shape == (len(rows), 4) and out.dtype == np.float32
    np.testing.assert_array_equal(out[:, :3], sb.points[rows].numpy())
    np.testing.assert_array_equal(out[:, 3], refl[rows].numpy().astype(np.float32))
    assert VizHook(viewer, stride=4).subsample(sb._replace(reflectivity=None)).shape == (len(rows), 3)


@pytest.fixture(scope="module")
def small_replay(tmp_path_factory):
    from tests.test_torch_cli import REGISTER
    from slamtpu_torch.ins.imu_config import ImuConfig
    from slamtpu_torch.lidar.ouster import LidarParams, synthetic_os2_metadata
    from slamtpu_torch.runtime.config import PipelineConfig, RegisterConfig
    from tests.simulator_np import simulate_replay

    cfg = PipelineConfig(
        meta=synthetic_os2_metadata(columns_per_frame=256, pixels_per_column=32, columns_per_packet=16),
        lidar=LidarParams(channel_stride=1, range_filter=(0.5, 150.0)), imu=ImuConfig(),
        register=RegisterConfig.from_json({"register_parameter": REGISTER}))
    path = str(tmp_path_factory.mktemp("viz") / "run.rpl")
    simulate_replay(path, cfg.meta, cfg.lidar, n_sweeps=5)
    return cfg, path


@pytest.mark.parametrize("app", ["lo_svn", "odom_ndt", "ligo_tc", "ins_map"])
def test_apps_feed_the_viewer(viewer, small_replay, app):
    from slamtpu_torch import apps

    cfg, path = small_replay
    cls = {"lo_svn": apps.LoSvnApp, "odom_ndt": apps.OdomNdtApp, "ligo_tc": apps.LigoTcApp,
           "ins_map": apps.InsMapApp}[app]
    a = cls(cfg, "cpu")
    a.viz = VizHook(viewer)
    traj = a.run_replay(path, 3)
    assert len(traj) == 3
    seq, vtraj, ins, pts = _parse(_fetch(viewer, "/data?seq=-1"))
    assert seq == 2 * len(traj)  # a cloud and a vertex a keyframe
    np.testing.assert_allclose(vtraj, [e.pose.trans for e in traj], atol=1e-4)
    assert ins.shape[0] == (0 if app == "ins_map" else len(traj))
    assert pts.shape[0] > 0 and np.isfinite(pts).all()
