"""The ins_map pipeline of the port and its export and host apps, against
the reference, on the CPU.

The reference's tests run in float64 (x64 mode), where its ``_accumulate``
widens the sweep to the float64 INS pose; on its accelerator, as in the
port, the pose and the statistics are float32. The app-level comparisons
give the reference's ``_accumulate`` the float32 pose, so that both
packages sum the same float32 points.

- ``merge_stats``: the port's against the reference's on the same two
  statistics sets, with and without capacity overflow: keys, counts and
  overflow exact, sums at rtol 1e-5; and the port's merge equals one
  ``stats_from_points`` over the joint cloud.
- ``_accumulate``: the same, and its out-of-range count.
- ``InsMapApp.run_replay`` on a 5-sweep replay, then
  ``finalize_and_export``: trajectory equal, statistics as above, the
  finalized map's validity equal and means within 1e-5 m, the same files
  with the same line counts.
- Checkpoints: a file of either package resumed by the other, the arrays
  equal; split run == continuous run, bit for bit, in the port.
- The writers (``write_ndt_data``, ``write_ply``, ``write_compass_csv``,
  ``write_trajectory_tum``) byte for byte the reference's on the same
  numpy inputs; ``voxel_downsample`` and ``axis_crop``; the CSV of
  ``CalibCompassApp`` byte for byte; the PLY of ``VizLidarApp`` within
  1e-5 m.
- The apps import without JAX.
"""
import dataclasses
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamtpu.apps import ins_map as jins
from slamtpu.apps.calib_compass import CalibCompassApp as JCompass
from slamtpu.apps.viz_lidar import VizLidarApp as JViz
from slamtpu.core import se3 as jse3
from slamtpu.mapping import downsample as jdown
from slamtpu.mapping import gaussian_map as jgm
from slamtpu.runtime import checkpoint as jckpt
from slamtpu.runtime import export as jexport
from slamtpu_torch.apps import ins_map as tins
from slamtpu_torch.apps.calib_compass import CalibCompassApp as TCompass
from slamtpu_torch.apps.viz_lidar import VizLidarApp as TViz
from slamtpu_torch.core.se3 import Pose3
from slamtpu_torch.mapping import downsample as tdown
from slamtpu_torch.mapping import gaussian_map as tgm
from slamtpu_torch.runtime import checkpoint as tckpt
from slamtpu_torch.runtime import export as texport
from tests.simulator import simulate_replay
from tests.test_torch_odom_ndt import configs as odom_configs

torch.set_num_threads(1)
RNG = np.random.default_rng(41)
N_SWEEPS = 5
RES = 1.0
CAPACITY = 1 << 13


def configs():
    jcfg, tcfg = odom_configs("NDT_OMP")
    change = dict(map_voxel_size=RES, map_capacity=CAPACITY)
    return (dataclasses.replace(jcfg, register=dataclasses.replace(jcfg.register, **change)),
            dataclasses.replace(tcfg, register=dataclasses.replace(tcfg.register, **change)))


@pytest.fixture(scope="module")
def replay(tmp_path_factory):
    jcfg, _ = configs()
    path = str(tmp_path_factory.mktemp("ins_map") / "skewed.rpl")
    gt = simulate_replay(path, jcfg.meta, jcfg.lidar, n_sweeps=N_SWEEPS, skewed=True)
    return path, gt


@pytest.fixture
def reference_f32(monkeypatch):
    """The reference's ``_accumulate`` at the float32 pose (its accelerator's
    arithmetic)."""
    real = jins._accumulate

    def accumulate(stats, points, mask, pose, capacity):
        pose32 = jse3.Pose3(jnp.asarray(pose.rot, jnp.float32), jnp.asarray(pose.trans, jnp.float32))
        return real(stats, points, mask, pose32, capacity)

    monkeypatch.setattr(jins, "_accumulate", accumulate)


def _assert_stats(t, j, exact_sums=False):
    np.testing.assert_array_equal(t.keys.numpy(), np.asarray(j.keys))
    np.testing.assert_array_equal(t.n.numpy(), np.asarray(j.n))
    assert int(t.overflow) == int(j.overflow)
    assert t.sx.dtype == torch.float32 and np.asarray(j.sx).dtype == np.float32
    check = np.testing.assert_array_equal if exact_sums else (
        lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5))
    check(t.sx.numpy(), np.asarray(j.sx))
    check(t.sxx.numpy(), np.asarray(j.sxx))


def _cloud(n, spread=20.0):
    pts = RNG.uniform(-spread, spread, size=(n, 3)).astype(np.float32)
    mask = RNG.random(n) < 0.95
    pts[RNG.random(n) < 0.01] = np.nan
    return pts, mask


def _stats_pair(pts, mask, origin, capacity):
    j = jgm.stats_from_points(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(origin),
                              jnp.asarray(RES, jnp.float32), capacity)
    t = tgm.stats_from_points(torch.as_tensor(pts), torch.as_tensor(mask), torch.as_tensor(origin),
                              np.float32(RES), capacity)
    return t, j


@pytest.mark.parametrize("capacity", [8192, 300])
def test_merge_stats_matches_reference(capacity):
    origin = np.full(3, -50.0, np.float32)
    (pa, ma), (pb, mb) = _cloud(3000, spread=10.0), _cloud(2000, spread=10.0)
    ta, ja = _stats_pair(pa, ma, origin, capacity)
    tb, jb = _stats_pair(pb, mb, origin, capacity)
    _assert_stats(ta, ja)
    merged_t = tgm.merge_stats(ta, tb, capacity)
    merged_j = jgm.merge_stats(ja, jb, capacity)
    _assert_stats(merged_t, merged_j)
    assert (int(merged_t.overflow) > 0) == (capacity < 8192)
    if capacity == 8192:  # the merge equals one pass over the joint cloud
        joint = tgm.stats_from_points(torch.as_tensor(np.concatenate([pa, pb])),
                                      torch.as_tensor(np.concatenate([ma, mb])),
                                      torch.as_tensor(origin), np.float32(RES), capacity)
        np.testing.assert_array_equal(merged_t.keys.numpy(), joint.keys.numpy())
        np.testing.assert_array_equal(merged_t.n.numpy(), joint.n.numpy())
        np.testing.assert_allclose(merged_t.sx.numpy(), joint.sx.numpy(), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(merged_t.sxx.numpy(), joint.sxx.numpy(), rtol=1e-5, atol=1e-4)


def test_merge_stats_with_scan_sums_matches_reference(monkeypatch):
    """The card's fixed-order float64 prefix sums, run here."""
    monkeypatch.setattr(tgm, "segment_sum", tgm.segment_sum_scan)
    origin = np.full(3, -50.0, np.float32)
    ta, ja = _stats_pair(*_cloud(3000), origin, 4096)
    tb, jb = _stats_pair(*_cloud(2000), origin, 4096)
    _assert_stats(tgm.merge_stats(ta, tb, 4096), jgm.merge_stats(ja, jb, 4096))


def test_accumulate_counts_out_of_range_points():
    origin = np.zeros(3, np.float32)
    n = 64
    pts = np.zeros((n, 3), np.float32)
    pts[: n // 2] = RNG.uniform(5, 50, size=(n // 2, 3))  # in range
    pts[n // 2:] = RNG.uniform(5000, 6000, size=(n // 2, 3))  # beyond the key range
    tbase, jbase = _stats_pair(np.zeros((1, 3), np.float32), np.zeros(1, bool), origin, 256)
    rot = np.array(jse3.expmap(jnp.asarray([0.01, -0.02, 0.03, 0.5, -0.2, 0.1], jnp.float32)).rot)
    trans = np.float32([0.5, -0.2, 0.1])
    js, joor = jins._accumulate(jbase, jnp.asarray(pts), jnp.ones(n, bool),
                                jse3.Pose3(jnp.asarray(rot), jnp.asarray(trans)), 256)
    ts, toor = tins._accumulate(tbase, torch.as_tensor(pts), torch.ones(n, dtype=torch.bool),
                                Pose3(torch.as_tensor(rot), torch.as_tensor(trans)), 256)
    assert int(toor) == int(joor) == n // 2
    assert int(ts.n.sum()) == n // 2
    _assert_stats(ts, js)


def _run_both(path):
    jcfg, tcfg = configs()
    japp = jins.InsMapApp(jcfg)
    jt = japp.run_replay(path)
    tapp = tins.InsMapApp(tcfg, "cpu")
    tt = tapp.run_replay(path)
    return japp, jt, tapp, tt


def test_run_replay_matches_reference(replay, reference_f32, tmp_path):
    path, _ = replay
    japp, jt, tapp, tt = _run_both(path)
    assert len(tt) == len(jt) == N_SWEEPS - 1
    for a, b in zip(tt, jt):
        assert a.frame_id == b.frame_id
        np.testing.assert_array_equal(np.asarray(a.pose.trans), np.asarray(b.pose.trans))
    assert tapp.res == RES and int(tapp.stats.n.sum()) > 10000
    _assert_stats(tapp.stats, japp._stats)
    jmap = japp.finalize_and_export(str(tmp_path / "j"), min_points_per_voxel=4)
    tmap = tapp.finalize_and_export(str(tmp_path / "t"), min_points_per_voxel=4)
    valid = np.asarray(jmap.valid)
    np.testing.assert_array_equal(tmap.valid.numpy(), valid)
    assert valid.sum() > 50
    np.testing.assert_allclose(tmap.mean.numpy()[valid], np.asarray(jmap.mean)[valid], atol=1e-5)
    assert tapp.out_of_range_points == japp.out_of_range_points
    for suffix in ("_ellipsoids.txt", "_voxels.txt", "_summary.txt", "_means.ply"):
        a = (tmp_path / f"t{suffix}").read_text().splitlines()
        b = (tmp_path / f"j{suffix}").read_text().splitlines()
        assert len(a) == len(b) > 1 and a[0] == b[0], suffix
    assert (tmp_path / "t_summary.txt").read_text() == (tmp_path / "j_summary.txt").read_text()
    assert set(tapp.device_timer.summary()) == {"project", "accumulate", "finalize"}


def test_out_of_range_count_is_read_every_16_keyframes(replay):
    path, _ = replay
    _, tcfg = configs()
    app = tins.InsMapApp(tcfg, "cpu")
    frames = list(app.ingest.synced_frames(path))
    for k in range(tins.OOR_READ_EVERY - 1):
        app.process(frames[k % len(frames)])
    assert len(app._oor_pending) == tins.OOR_READ_EVERY - 1
    app.process(frames[0])
    assert app._oor_pending == []


def test_checkpoints_cross_between_packages(replay, reference_f32, tmp_path):
    path, _ = replay
    jcfg, tcfg = configs()
    japp, tapp = jins.InsMapApp(jcfg), tins.InsMapApp(tcfg, "cpu")
    japp.run_replay(path, max_keyframes=3)
    tapp.run_replay(path, max_keyframes=3)
    jfile, tfile = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    japp.save_checkpoint(jfile)
    tapp.save_checkpoint(tfile)
    assert int(np.load(tfile)["layout"]) == tckpt.LAYOUT
    # the port reads the reference's file, the reference the port's
    t_from_j = tins.InsMapApp(tcfg, "cpu").resume_from(jfile)
    _assert_stats(t_from_j.stats, japp._stats, exact_sums=True)
    np.testing.assert_array_equal(t_from_j._ref_lla, japp._ref_lla)
    j_stats, j_lla = jckpt.load_ins_map(tfile)
    _assert_stats(tapp.stats, j_stats, exact_sums=True)
    np.testing.assert_array_equal(j_lla, tapp._ref_lla)
    # a run resumed from the reference's file goes on merging
    frames = list(t_from_j.ingest.synced_frames(path))
    for s in frames[3:]:
        t_from_j.process(s)
    assert int(t_from_j.stats.n.sum()) > int(japp._stats.n.sum())


def test_split_run_equals_continuous(replay, tmp_path):
    path, _ = replay
    _, tcfg = configs()
    full = tins.InsMapApp(tcfg, "cpu")
    frames = list(full.ingest.synced_frames(path))
    for s in frames:
        full.process(s)
    a = tins.InsMapApp(tcfg, "cpu")
    for s in frames[:2]:
        a.process(s)
    ckpt = str(tmp_path / "map.npz")
    a.save_checkpoint(ckpt)
    b = tins.InsMapApp(tcfg, "cpu").resume_from(ckpt)
    for s in frames[2:]:
        b.process(s)
    for k in tgm.VoxelStats._fields:
        assert torch.equal(getattr(b.stats, k), getattr(full.stats, k)), k


def test_ndt_data_writers_are_byte_equal(tmp_path):
    V = 40
    a = RNG.normal(size=(V, 3, 3))
    evals, evecs = np.linalg.eigh(a @ a.transpose(0, 2, 1))
    data = dict(means=RNG.normal(scale=50, size=(V, 3)).astype(np.float32), evals=evals.astype(np.float32),
                evecs=evecs.astype(np.float32), counts=RNG.integers(3, 400, V).astype(np.int32))
    jexport.write_ndt_data(jexport.NdtExportData(**data), str(tmp_path / "j"))
    texport.write_ndt_data(texport.NdtExportData(**data), str(tmp_path / "t"))
    for suffix in ("_ellipsoids.txt", "_voxels.txt", "_summary.txt"):
        assert (tmp_path / f"t{suffix}").read_bytes() == (tmp_path / f"j{suffix}").read_bytes()
    pts = RNG.normal(scale=30, size=(200, 3)).astype(np.float32)
    mask = RNG.random(200) < 0.7
    jexport.write_ply(pts, str(tmp_path / "j.ply"), mask=mask)
    texport.write_ply(pts, str(tmp_path / "t.ply"), mask=mask)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


def test_trajectory_tum_is_byte_equal(tmp_path):
    xi = RNG.normal(scale=[1.0, 1.0, 3.0, 20.0, 20.0, 2.0], size=(30, 6))
    jposes = [jse3.expmap(jnp.asarray(x)) for x in xi]
    poses = [Pose3(np.asarray(p.rot), np.asarray(p.trans)) for p in jposes]
    stamps = 1000.0 + 0.1 * np.arange(30)
    jexport.write_trajectory_tum(str(tmp_path / "j.tum"), stamps, poses)
    texport.write_trajectory_tum(str(tmp_path / "t.tum"), stamps, poses)
    assert (tmp_path / "t.tum").read_bytes() == (tmp_path / "j.tum").read_bytes()


def test_compass_csv_is_byte_equal(replay, tmp_path):
    path, _ = replay
    jframes = JCompass().run_replay(path)
    tapp = TCompass()
    tframes = tapp.run_replay(path)
    assert len(tframes) == len(jframes) > N_SWEEPS * 4
    JCompass.export(type("A", (), {"frames": jframes})(), str(tmp_path / "j.csv"))
    tapp.export(str(tmp_path / "t.csv"))
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    # the port's writer on the reference's frames, too
    texport.write_compass_csv(jframes, str(tmp_path / "tj.csv"))
    assert (tmp_path / "tj.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


def test_viz_lidar_ply_matches_reference(replay, tmp_path):
    path, _ = replay
    jcfg, tcfg = configs()
    japp, tapp = JViz(jcfg), TViz(tcfg, "cpu")
    jf, tf = japp.run_replay(path), tapp.run_replay(path)
    assert len(tf) == len(jf) >= N_SWEEPS - 1
    n_t = tapp.export_frame(tf[1], str(tmp_path / "t.ply"))
    n_j = japp.export_frame(jf[1], str(tmp_path / "j.ply"))
    assert n_t == n_j > 1000
    a = (tmp_path / "t.ply").read_text().splitlines()
    b = (tmp_path / "j.ply").read_text().splitlines()
    assert a[:8] == b[:8]
    np.testing.assert_allclose(np.loadtxt(a[8:]), np.loadtxt(b[8:]), atol=1e-5 + 1e-5)


def test_voxel_downsample_matches_reference():
    pts, mask = _cloud(3000)
    origin = np.full(3, -50.0, np.float32)
    for capacity in (4096, 16):
        jc, jm, jo = jdown.voxel_downsample(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(origin),
                                            RES, capacity)
        tc, tm, to = tdown.voxel_downsample(torch.as_tensor(pts), torch.as_tensor(mask),
                                            torch.as_tensor(origin), RES, capacity)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        assert int(to) == int(jo) and (int(to) > 0) == (capacity == 16)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
    keep = tdown.axis_crop(torch.as_tensor(pts), torch.as_tensor(mask), 2, -5.0, 5.0)
    want = jdown.axis_crop(jnp.asarray(pts), jnp.asarray(mask), 2, -5.0, 5.0)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want))


def test_imports_no_jax():
    """The port's new apps and modules run where JAX is absent."""
    code = ("import sys; sys.modules['jax'] = None; import slamtpu_torch.apps; "
            "import slamtpu_torch.apps.ins_map, slamtpu_torch.runtime.export, "
            "slamtpu_torch.mapping.downsample")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
