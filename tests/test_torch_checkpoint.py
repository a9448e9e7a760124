"""Checkpoints and resume of the port's apps (slamtpu_torch.runtime.checkpoint),
on the CPU, mirroring the reference's split-run tests (tests/test_e2e.py
TestLoSvnResume, TestOdomResume, TestLigoResume).

(a) Split == continuous in the port: half the replay, ``save_checkpoint``,
    ``resume_from`` in a new app, the rest; every pose within 1e-5 m and
    1e-5 rad of the continuous run (lo_svn; odom_ndt with NDT_OMP and with
    SVNNDT, whose particle generator the file carries; ligo_tc rebuilding
    its map every keyframe, as the reference's test requires).
(b) Files cross between the packages: the port resumes from files the
    reference wrote (all three apps) and the reference from files the port
    wrote (odom_ndt, ligo_tc); each continuation is held within 5e-4 m and
    1e-4 rad of the other package's continuation from the same file (the
    bound of the replay parity tests). An odom file without ``prev_ins``
    resumes in both packages and they agree. (a) also runs on the
    sorted-key path (``use_regmap=False``) for the three apps.
(c) The file format: map statistics and trajectories cross in both
    directions, a file without the ``layout`` marker is read as this
    layout, another layout raises, and a generator state is restored only
    on a generator of its own device type.
The reference's odom_ndt and ligo_tc build their target maps as the
port's do, their statistics in float64 (``float64_target_maps`` of
tests/test_torch_odom_ndt.py).
"""
import dataclasses
import functools
import logging

import jax
import numpy as np
import pytest
import torch

from slamtpu.apps import ligo_tc as jligo
from slamtpu.apps import lo_svn as jlo
from slamtpu.apps import odom_ndt as jodom
from slamtpu.core.se3 import Pose3 as JPose3
from slamtpu.mapping import gaussian_map as jgm
from slamtpu.runtime import checkpoint as jckpt
from slamtpu_torch.apps import ligo_tc as tligo
from slamtpu_torch.apps import lo_svn as tlo
from slamtpu_torch.apps import odom_ndt as todom
from slamtpu_torch.apps.common import MapRebuildCadence
from slamtpu_torch.core import se3
from slamtpu_torch.core.se3 import Pose3
from slamtpu_torch.mapping import gaussian_map
from slamtpu_torch.runtime import checkpoint
from tests.simulator import simulate_replay
from tests.test_torch_ligo_tc import configs as ligo_configs
from tests.test_torch_lo_svn import _assert_pose_close
from tests.test_torch_lo_svn import configs as lo_configs
from tests.test_torch_odom_engines import configs as engine_configs
from tests.test_torch_odom_ndt import configs as odom_configs
from tests.test_torch_odom_ndt import reference_float64_target_maps  # noqa: F401  (autouse)

torch.set_num_threads(1)
N_SWEEPS = 6
WINDOW = {"odom": 3, "ligo": 4}


def _configs(name, **change):
    """(reference config, port config, port app factory, reference app
    factory); ``change`` updates both register configs."""
    if name == "lo_svn":
        jcfg, tcfg = lo_configs()
    elif name.startswith("odom"):
        method = name.split("_", 1)[1]
        jcfg, tcfg = engine_configs(method) if method == "SVNNDT" else odom_configs(method)
    else:
        jcfg, tcfg = ligo_configs(1)
    jcfg, tcfg = (dataclasses.replace(c, register=dataclasses.replace(c.register, **change)) for c in (jcfg, tcfg))
    if name == "lo_svn":
        return jcfg, tcfg, lambda: tlo.LoSvnApp(tcfg, "cpu"), lambda: jlo.LoSvnApp(jcfg)
    if name.startswith("odom"):
        W = WINDOW["odom"]
        return (jcfg, tcfg, lambda: todom.OdomNdtApp(tcfg, "cpu", window=W),
                lambda: jodom.OdomNdtApp(jcfg, window=W))
    W = WINDOW["ligo"]
    return jcfg, tcfg, lambda: tligo.LigoTcApp(tcfg, "cpu", window=W), lambda: jligo.LigoTcApp(jcfg, window=W)


@pytest.fixture(scope="module")
def replay(tmp_path_factory):
    jcfg, _ = odom_configs("NDT_OMP")  # the same sensor as the lo_svn and ligo configs
    path = str(tmp_path_factory.mktemp("checkpoint") / "skewed.rpl")
    simulate_replay(path, jcfg.meta, jcfg.lidar, n_sweeps=N_SWEEPS, skewed=True)
    return path


@pytest.fixture
def like_contract(monkeypatch):
    """The port's ligo step with the CPU reference's Newton contract (score
    and Hessian at the returned pose), as tests/test_torch_ligo_tc.py
    compares them."""
    monkeypatch.setattr(tligo, "_ligo_step", functools.partial(tligo._ligo_step, final_eval=True))


def _frames(app, path):
    return list(app.ingest.synced_frames(path))


def _run(app, frames):
    for s in frames:
        app.process(s)
    return list(app.trajectory)


def _close(a, b, atol_m, atol_rad):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.frame_id == y.frame_id
        _assert_pose_close(x.pose.rot, x.pose.trans, y.pose.rot, y.pose.trans, atol_m=atol_m,
                           atol_rad=atol_rad)


def _split_equals_continuous(replay, tmp_path, name, **change):
    _, _, make, _ = _configs(name, **change)
    full = make()
    frames = _frames(full, replay)
    traj_full = _run(full, frames)
    half = len(frames) // 2
    a = make()
    head = _run(a, frames[:half])
    ckpt = str(tmp_path / "app.npz")
    a.save_checkpoint(ckpt)
    b = make()
    assert b.resume_from(ckpt) is b
    tail = _run(b, frames[half:])
    assert len(head) + len(tail) == len(traj_full) == N_SWEEPS - 1
    _close(head + tail, traj_full, atol_m=1e-5, atol_rad=1e-5)
    return b


@pytest.mark.parametrize("name", ["lo_svn", "odom_NDT_OMP", "odom_SVNNDT", "ligo"])
def test_split_run_equals_continuous(replay, tmp_path, name):
    _split_equals_continuous(replay, tmp_path, name)


@pytest.mark.parametrize("name", ["lo_svn", "odom_NDT_OMP", "ligo"])
def test_sorted_key_split_run_equals_continuous(replay, tmp_path, name):
    """``use_regmap=False``: the file carries no RegMap on either path, and
    on this one the apps keep none, so a resumed run equals a continuous
    one as on the RegMap path."""
    resumed = _split_equals_continuous(replay, tmp_path, name, use_regmap=False)
    assert resumed.grid_shape is None


@pytest.mark.parametrize("name", ["lo_svn", "odom_NDT_OMP", "ligo"])
def test_port_resumes_reference_file(replay, tmp_path, like_contract, name):
    """The reference runs half the replay and saves; both packages resume
    from its file and run the rest. (lo_svn: the file's JAX key cannot
    drive torch draws, so the port draws from its own generator; the
    published pose does not depend on the draws.)"""
    _, _, make, make_ref = _configs(name)
    ref = make_ref()
    frames = list(ref.ingest.synced_frames(replay))
    half = len(frames) // 2
    _run(ref, frames[:half])
    ckpt = str(tmp_path / "reference.npz")
    ref.save_checkpoint(ckpt)
    assert "layout" not in np.load(ckpt).files
    ref_tail = _run(make_ref().resume_from(ckpt), frames[half:])
    port = make()
    port.resume_from(ckpt)
    port_tail = _run(port, _frames(port, replay)[half:])
    assert len(port_tail) == len(ref_tail) == len(frames) - half
    _close(port_tail, ref_tail, atol_m=5e-4, atol_rad=1e-4)


@pytest.mark.parametrize("name", ["odom_NDT_OMP", "ligo"])
def test_reference_resumes_port_file(replay, tmp_path, like_contract, name):
    _, _, make, make_ref = _configs(name)
    port = make()
    frames = _frames(port, replay)
    half = len(frames) // 2
    _run(port, frames[:half])
    ckpt = str(tmp_path / "port.npz")
    port.save_checkpoint(ckpt)
    assert int(np.load(ckpt)["layout"]) == checkpoint.LAYOUT
    port_tail = _run(make().resume_from(ckpt), frames[half:])
    ref = make_ref().resume_from(ckpt)
    ref_tail = _run(ref, list(ref.ingest.synced_frames(replay))[half:])
    _close(port_tail, ref_tail, atol_m=5e-4, atol_rad=1e-4)


def test_odom_file_without_prev_ins_resumes_in_both(replay, tmp_path):
    """The reference's older odom files carry no ``prev_ins``: the first
    resumed keyframe then takes the constant-velocity seed, in both
    packages."""
    _, _, make, make_ref = _configs("odom_NDT_OMP")
    port = make()
    frames = _frames(port, replay)
    half = len(frames) // 2
    _run(port, frames[:half])
    ckpt = str(tmp_path / "odom.npz")
    port.save_checkpoint(ckpt)
    with np.load(ckpt) as z:
        data = {k: z[k] for k in z.files if k != "prev_ins"}
    old = str(tmp_path / "odom_without_prev_ins.npz")
    np.savez(old, **data)
    resumed = make().resume_from(old)
    assert resumed._prev_ins is None
    port_tail = _run(resumed, frames[half:])
    ref = make_ref().resume_from(old)
    assert ref._prev_ins is None
    ref_tail = _run(ref, list(ref.ingest.synced_frames(replay))[half:])
    _close(port_tail, ref_tail, atol_m=5e-4, atol_rad=1e-4)
    # the INS seed is back from the second resumed keyframe on
    assert resumed._prev_ins is not None


def test_svnndt_file_without_a_torch_generator(replay, tmp_path, monkeypatch, caplog):
    """A file without a torch generator state (the reference's files carry a
    JAX key) leaves the app's own seeded generator in place and says so
    once; a generator state is restored only on its own device type."""
    _, _, make, _ = _configs("odom_SVNNDT")
    app = make()
    frames = _frames(app, replay)
    _run(app, frames[:3])
    ckpt = str(tmp_path / "svnndt.npz")
    app.save_checkpoint(ckpt)
    with np.load(ckpt) as z:
        data = {k: z[k] for k in z.files}
    assert str(data[checkpoint.GEN_DEVICE]) == "cpu"
    assert data["key"].tolist() == [0, todom.PARTICLE_SEED]
    # the restored generator continues the saved one's draws
    resumed = make().resume_from(ckpt)
    assert torch.equal(resumed._particle_noise(), app._particle_noise())

    no_gen = str(tmp_path / "no_generator.npz")
    np.savez(no_gen, **{k: v for k, v in data.items() if not k.startswith("torch_generator")})
    monkeypatch.setattr(checkpoint, "_logged_jax_key", False)
    fresh = make()
    with caplog.at_level(logging.INFO, logger="slamtpu_torch.checkpoint"):
        make().resume_from(no_gen)
        resumed = make().resume_from(no_gen)
    assert sum("JAX key" in r.getMessage() for r in caplog.records) == 1
    assert torch.equal(resumed._particle_noise(), fresh._particle_noise())

    other = str(tmp_path / "cuda_generator.npz")
    np.savez(other, **{**data, checkpoint.GEN_DEVICE: np.asarray("cuda")})
    with pytest.raises(ValueError, match="cuda generator state"):
        make().resume_from(other)


def test_lo_svn_generator_state_on_another_device_raises(replay, tmp_path):
    _, _, make, _ = _configs("lo_svn")
    app = make()
    _run(app, _frames(app, replay)[:2])
    ckpt = str(tmp_path / "lo.npz")
    app.save_checkpoint(ckpt)
    with np.load(ckpt) as z:
        data = dict(z)
    np.savez(ckpt, **{**data, checkpoint.GEN_DEVICE: np.asarray("cuda")})
    with pytest.raises(ValueError, match="cannot be restored"):
        make().resume_from(ckpt)


@pytest.mark.parametrize("name", ["lo_svn", "odom_NDT_OMP", "ligo"])
def test_nothing_to_checkpoint_before_the_first_keyframe(tmp_path, name):
    with pytest.raises(ValueError, match="first keyframe"):
        _configs(name)[2]().save_checkpoint(str(tmp_path / "empty.npz"))


def _map_stats():
    rng = np.random.default_rng(4)
    pts = (rng.normal(scale=3.0, size=(2000, 3)) + 200.0).astype(np.float32)
    origin = np.full(3, 150.0, np.float32)
    return pts, origin


def test_map_stats_cross_packages_and_layout_marker(tmp_path):
    pts, origin = _map_stats()
    jstats = jgm.stats_from_points(jax.numpy.asarray(pts), jax.numpy.ones(len(pts), bool),
                                   jax.numpy.asarray(origin), np.float32(1.0), 512)
    ref_file = str(tmp_path / "reference_stats.npz")
    jckpt.save_map_stats(ref_file, jstats)
    # a file without the marker: the voxel-corner-relative layout
    a = checkpoint.load_map_stats(ref_file, "cpu")
    for k in ("keys", "n", "sx", "sxx", "origin", "overflow"):
        np.testing.assert_array_equal(getattr(a, k).numpy(), np.asarray(getattr(jstats, k)))
    assert float(a.resolution) == 1.0 and a.resolution.device.type == "cpu"
    tstats = gaussian_map.stats_from_points(torch.as_tensor(pts), torch.ones(len(pts), dtype=torch.bool),
                                            torch.as_tensor(origin), 1.0, 512)
    np.testing.assert_allclose(a.sxx.numpy(), tstats.sxx.numpy(), rtol=1e-5, atol=1e-4)
    # the port's file: the reference reads it, and the maps agree
    port_file = str(tmp_path / "port_stats.npz")
    checkpoint.save_map_stats(port_file, tstats)
    b = jckpt.load_map_stats(port_file)
    for k in ("keys", "n"):
        np.testing.assert_array_equal(np.asarray(getattr(b, k)), getattr(tstats, k).numpy())
    gm_ref = jgm.finalize(b, 4)
    gm_port = gaussian_map.finalize(checkpoint.load_map_stats(port_file, "cpu"), 4)
    np.testing.assert_allclose(gm_port.mean.numpy(), np.asarray(gm_ref.mean), atol=1e-5)
    # another layout is refused
    with np.load(port_file) as z:
        data = dict(z)
    np.savez(port_file, **{**data, "layout": np.asarray(checkpoint.LAYOUT + 1, np.int32)})
    with pytest.raises(ValueError, match="layout"):
        checkpoint.load_map_stats(port_file, "cpu")


def test_trajectory_cross_packages(tmp_path):
    rng = np.random.default_rng(9)
    xi = torch.as_tensor(rng.normal(scale=0.5, size=(4, 6)))
    poses = [Pose3(*(t.numpy() for t in se3.expmap(x))) for x in xi]
    ts = np.arange(4) * 0.1 + 1000.0
    port_file = str(tmp_path / "port_traj.npz")
    checkpoint.save_trajectory(port_file, ts, poses)
    jts, jposes, jids = jckpt.load_trajectory(port_file)
    np.testing.assert_array_equal(jts, ts)
    assert list(jids) == [0, 1, 2, 3]
    for p, q in zip(poses, jposes):
        np.testing.assert_allclose(np.asarray(q.rot), p.rot, atol=1e-12)
        np.testing.assert_allclose(np.asarray(q.trans), p.trans, atol=0)
    ref_file = str(tmp_path / "ref_traj.npz")
    jckpt.save_trajectory(ref_file, ts, [JPose3(jax.numpy.asarray(p.rot), jax.numpy.asarray(p.trans))
                                         for p in poses], frame_ids=[5, 6, 7, 8])
    tts, tposes, tids = checkpoint.load_trajectory(ref_file)
    assert list(tids) == [5, 6, 7, 8]
    for p, q in zip(poses, tposes):
        np.testing.assert_allclose(q.rot, p.rot, atol=1e-12)


def test_rebuild_cadence_forced_once_after_resume():
    _, tcfg = odom_configs("NDT_OMP")
    reg = dataclasses.replace(tcfg.register, map_rebuild_every=3)
    cad = MapRebuildCadence(reg, (8, 8, 8), "cpu")
    assert [cad.tick() for _ in range(4)] == [True, False, False, True]
    cad.force_next = True
    assert [cad.tick() for _ in range(3)] == [True, False, True]
    assert not cad.force_next
