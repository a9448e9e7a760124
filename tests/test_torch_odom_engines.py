"""odom_ndt's anisotropic GICP, SVNNDT and NDT_OMP_MULTIRES engines as whole
keyframes, port against reference, on the CPU (their pieces are in
tests/test_torch_odom_pieces.py).

One ``_odom_fused_step`` per engine from the reference's own window carry
(``interop.odom_carry_from_numpy``; SVNNDT with the reference's particle
draws), held as tests/test_torch_odom_ndt.py holds the others (pose 1e-4 m
/ 1e-4 rad, iterations within 1, LiDAR covariance diagonal rtol 1e-2),
and ``run_replay`` of both packages (per-keyframe poses within 5e-4 m,
ATEs within 5e-4 m; SVNNDT with the reference's per-keyframe draws
injected). The anisotropic engine runs with the stencil source
covariances (the default) and with the voxel ones.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamtpu.apps import odom_ndt as jodom
from slamtpu_torch import interop
from slamtpu_torch.apps import odom_ndt as todom
from slamtpu_torch.ndt import fused_math
from tests.test_torch_lo_svn import _assert_pose_close
from tests.test_torch_odom_ndt import WINDOW, _ate
from tests.test_torch_odom_ndt import configs as odom_configs
from tests.test_torch_odom_ndt import replay  # noqa: F401  (the shared 5-sweep replay)

torch.set_num_threads(1)
ENGINES = {
    "GICP_aniso": dict(method="GICP", gicp_source_cov="anisotropic"),
    "GICP_aniso_voxel": dict(method="GICP", gicp_source_cov="anisotropic", svn_src_cov="voxel"),
    # float32 resolution, as the other engines' (tests/test_torch_odom_ndt.py)
    "SVNNDT": dict(method="SVNNDT", svn_resolution=np.float32(1.0), svn_particles=6,
                   svn_max_iterations=8, svn_kernel_h=1.0, svn_step_size=1.0),
    "NDT_OMP_MULTIRES": dict(method="NDT_OMP_MULTIRES"),
}
SEED_KEY = 1234  # the reference app's PRNGKey of the SVNNDT engine


def configs(engine):
    jcfg, tcfg = odom_configs("NDT_OMP")
    change = ENGINES[engine]
    return (dataclasses.replace(jcfg, register=dataclasses.replace(jcfg.register, **change)),
            dataclasses.replace(tcfg, register=dataclasses.replace(tcfg.register, **change)))


def reference_draws(K, dtype=jnp.float32):
    """The reference app's per-keyframe particle draws (``_next_key``)."""
    key = jax.random.PRNGKey(SEED_KEY)
    while True:
        key, sub = jax.random.split(key)
        yield torch.as_tensor(np.array(jax.random.normal(sub, (K, 6), dtype=dtype)))


@pytest.fixture(scope="module")
def reference_runs(replay):  # noqa: F811
    """Per engine, the reference app's run over the replay: (trajectory,
    stats records, the recorded ``_odom_fused_step`` calls)."""
    path, _ = replay
    out = {}
    real_step = jodom._odom_fused_step
    for engine in ENGINES:
        calls = []

        def recording_step(carry, points, mask, flat, *args, **kwargs):
            # copies first: the reference step donates its carry
            calls.append(({k: np.array(v) for k, v in carry.items()}, np.array(points), np.array(mask),
                          np.array(flat), args, kwargs))
            new_carry, out_ = real_step(carry, points, mask, flat, *args, **kwargs)
            calls[-1] += (np.array(out_),)
            return new_carry, out_

        jodom._odom_fused_step = recording_step
        try:
            japp = jodom.OdomNdtApp(configs(engine)[0], window=WINDOW)
            out[engine] = (japp.run_replay(path), japp.stats.records, calls)
        finally:
            jodom._odom_fused_step = real_step
    return out


@pytest.mark.parametrize("engine", list(ENGINES))
def test_one_keyframe_step_matches(reference_runs, engine):
    _, tcfg = configs(engine)
    carry, points, mask, flat, args, kwargs, ref = reference_runs[engine][2][-1]
    assert int(carry["n"]) == WINDOW and kwargs["method"] == ENGINES[engine]["method"]
    jnewton, capacity, min_points, grid, max_td, max_rd = args
    extra = {}
    if engine == "SVNNDT":
        K = kwargs["svn_cfg"].num_particles
        extra = dict(svn_cfg=interop.svn_config_from_fields(kwargs["svn_cfg"]._asdict()),
                     init_noise=torch.as_tensor(np.array(jax.random.normal(kwargs["key"], (K, 6),
                                                                           dtype=jnp.float32))))
    if kwargs.get("scan_grid") is not None:
        extra["scan_grid"] = kwargs["scan_grid"]
    assert (engine == "GICP_aniso") == ("scan_grid" in extra)
    before = dict(fused_math.LAUNCHES)
    _, out = todom._odom_fused_step(
        interop.odom_carry_from_numpy(carry), torch.as_tensor(points), torch.as_tensor(mask),
        torch.as_tensor(flat), interop.newton_config_from_reference(jnewton), capacity, min_points,
        grid, max_td, max_rd, method=kwargs["method"], inner_iters=1, window=WINDOW,
        smoother_iters=kwargs["smoother_iters"], **extra,
    )
    assert fused_math.LAUNCHES == before
    out = out.numpy()
    assert out.dtype == np.float64 and np.isfinite(out).all()
    _assert_pose_close(out[0:9].reshape(3, 3), out[9:12], ref[0:9].reshape(3, 3), ref[9:12],
                       atol_m=1e-4, atol_rad=1e-4)
    assert abs(out[97] - ref[97]) <= 1 and out[98] == ref[98]  # iterations, converged
    np.testing.assert_allclose(np.diag(out[48:84].reshape(6, 6)), np.diag(ref[48:84].reshape(6, 6)),
                               rtol=1e-2)
    np.testing.assert_allclose(out[96], ref[96], rtol=1e-4)  # score
    np.testing.assert_allclose(out[99], ref[99], atol=1e-6)  # blend weight


@pytest.mark.parametrize("engine", list(ENGINES))
def test_run_replay_matches_reference(replay, reference_runs, engine):  # noqa: F811
    path, gt = replay
    _, tcfg = configs(engine)
    jt, jrecs, _ = reference_runs[engine]
    tapp = todom.OdomNdtApp(tcfg, "cpu", window=WINDOW)
    if engine == "SVNNDT":
        draws = reference_draws(tapp.svn_cfg.num_particles)
        tapp._particle_noise = lambda: next(draws)
    tt = tapp.run_replay(path)
    assert len(tt) == len(jt) == 4
    for a, b in zip(jt, tt):
        assert a.frame_id == b.frame_id
        _assert_pose_close(b.pose.rot, b.pose.trans, a.pose.rot, a.pose.trans)
    ate = {"reference": _ate(jt, gt), "port": _ate(tt, gt)}
    print(f"{engine}: ATE reference {ate['reference']:.6f} m, port {ate['port']:.6f} m")
    assert abs(ate["port"] - ate["reference"]) < 5e-4
    assert ate["reference"] < 0.05
    recs = tapp.stats.records
    assert len(recs) == len(jrecs) == len(tt) - 1
    assert [r.converged for r in recs] == [r.converged for r in jrecs]
    assert all(abs(r.ndt_iterations - q.ndt_iterations) <= 1 for r, q in zip(recs, jrecs))
    assert all(np.isfinite(r.lidar_sigma).all() and np.isfinite(r.optimized_sigma).all() for r in recs)
    stages = set(tapp.device_timer.summary())
    assert stages >= {"project", "deskew", "map_build", "covariance", "smoother"}
    assert ("svn" in stages) == (engine == "SVNNDT")
    assert ("src_covariances" in stages) == engine.startswith("GICP_aniso")


def test_svnndt_draws_from_its_seeded_generator(replay):  # noqa: F811
    """Without injected draws the app draws one (K, 6) block a keyframe
    from its own generator, seeded by ``PARTICLE_SEED``: two apps agree
    draw for draw, and each draw moves the generator on."""
    path, _ = replay
    _, tcfg = configs("SVNNDT")
    runs = [todom.OdomNdtApp(tcfg, "cpu", window=WINDOW) for _ in range(2)]
    assert runs[0].generator.device.type == "cpu"
    assert runs[0].generator.initial_seed() == todom.PARTICLE_SEED
    draws = [[app._particle_noise() for _ in range(2)] for app in runs]
    assert draws[0][0].shape == (6, 6)
    assert all(torch.equal(a, b) for a, b in zip(*draws))
    assert not torch.equal(draws[0][0], draws[0][1])
    assert todom.OdomNdtApp(configs("GICP_aniso")[1], "cpu")._particle_noise() is None
