"""Parity of slamtpu_torch.ndt.svn.svn_align_reg with slamtpu's, on the fused
shared-gather path (N = 4096 points, a multiple of the reference's 2048
block, so the reference runs its Pallas kernels, interpreted on the CPU).

Both packages get the same RegMap (built by the reference, carried over
with interop) and the same particle draws (the reference's
``jax.random.normal`` draws, injected into the port). Tolerances: pose
1e-4 m / 1e-5 rad and equal iteration counts (the flow is deterministic
given the draws; the two sum the pair terms in a different float32 order);
covariance diagonal rtol 1e-2, since the sample covariance of a handful
of particles amplifies that float32 noise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamtpu.core import se3 as jse3
from slamtpu.mapping import gaussian_map as jgm
from slamtpu.ndt import SvnConfig as JSvnConfig
from slamtpu.ndt import build_regmap as jbuild_regmap
from slamtpu.ndt import regularize_plane_covariance, svn_align_reg as jsvn
from slamtpu_torch import interop
from slamtpu_torch.ndt.svn import svn_align_reg
from tests.oracles import two_plane_cloud

torch.set_num_threads(1)
RNG = np.random.default_rng(21)
RES = np.float32(1.0)
GRID = (64, 64, 32)
N = 4096


@pytest.fixture(scope="module")
def scene():
    base = two_plane_cloud(extent=8.0, pitch=0.12)
    target = (base + RNG.normal(scale=0.01, size=base.shape)).astype(np.float32)
    origin = (np.floor(target.min(0)) - 8.0).astype(np.float32)
    gmap = jgm.build_map(jnp.asarray(target), jnp.ones(len(target), bool), jnp.asarray(origin), RES,
                         capacity=2048)
    aux = jnp.concatenate([gmap.mean, regularize_plane_covariance(gmap.cov).reshape(-1, 9)], axis=1)
    jreg = jbuild_regmap(gmap, grid_shape=GRID, aux_payload=aux)
    treg = interop.regmap_from_numpy({k: (None if v is None else np.asarray(v))
                                      for k, v in jreg._asdict().items()})
    src = two_plane_cloud(extent=8.0, pitch=0.18)
    take = RNG.choice(len(src), size=3900, replace=False)
    pts = np.zeros((N, 3), np.float32)
    pts[:3900] = src[take] + RNG.normal(scale=0.01, size=(3900, 3))
    mask = np.zeros(N, bool)
    mask[:3900] = True
    # source covariances: the plane model of each point's own plane
    normal = np.where((np.abs(pts[:, 2]) < 0.05)[:, None], [0.0, 0.0, 1.0], [1.0, 0.0, 0.0])
    scov = (np.eye(3) - (1 - 1e-3) * normal[:, :, None] * normal[:, None, :]).astype(np.float32)
    # the prior: a small known offset from the true (identity) pose
    prior = jse3.expmap(jnp.asarray([0.004, -0.003, 0.006, 0.04, -0.03, 0.02], jnp.float32))
    return jreg, treg, pts, mask, scov, prior


CASES = {
    "flow_only": dict(num_particles=8, max_iterations=10, kernel_h=1.0, step_size=1.0),
    "aniso_polish_from_prior": dict(num_particles=8, max_iterations=6, kernel_h=1.0, step_size=1.0,
                                    polish_iters=4, polish_objective="gicp_aniso"),
    "aniso_polish_from_mean": dict(num_particles=6, max_iterations=4, kernel_h=5.0, step_size=1.0,
                                   polish_iters=2, polish_objective="gicp_aniso", polish_from="mean",
                                   polish_pre_iters=2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_svn_align_reg_matches_reference(scene, case):
    jreg, treg, pts, mask, scov, prior = scene
    jcfg = JSvnConfig(resolution=float(RES), **CASES[case])
    key = jax.random.PRNGKey(7)
    j = jax.jit(jsvn, static_argnames=("cfg", "grid_shape"))(
        jnp.asarray(pts), jnp.asarray(mask), jreg, prior, key, jcfg, GRID,
        src_cov=jnp.asarray(scov) if jcfg.polish_iters else None,
    )
    # the reference draws xi0 = sigmas * normal(key, (K, 6)) in float32
    noise = np.array(jax.random.normal(key, (jcfg.num_particles, 6), dtype=jnp.float32))
    t = svn_align_reg(
        torch.as_tensor(pts), torch.as_tensor(mask), treg,
        interop.pose_from_numpy(np.asarray(prior.rot), np.asarray(prior.trans)),
        interop.svn_config_from_fields(jcfg._asdict()), GRID,
        src_cov=torch.as_tensor(scov) if jcfg.polish_iters else None,
        init_noise=torch.as_tensor(noise),
    )
    assert int(t.iterations) == int(j.iterations)
    assert bool(t.converged) == bool(j.converged)
    np.testing.assert_allclose(t.pose.trans.numpy(), np.asarray(j.pose.trans), atol=1e-4)
    rot_err = np.asarray(jse3.local(j.pose, jse3.Pose3(jnp.asarray(t.pose.rot.numpy()),
                                                       jnp.asarray(t.pose.trans.numpy()))))[:3]
    assert np.abs(rot_err).max() < 1e-5, rot_err
    np.testing.assert_allclose(np.diag(t.covariance.numpy()), np.diag(np.asarray(j.covariance)), rtol=1e-2)
    np.testing.assert_allclose(float(t.score), float(j.score), rtol=1e-4)
    # the posterior is a real one: the registration moved off the prior
    assert np.linalg.norm(np.asarray(j.pose.trans) - np.asarray(prior.trans)) > 1e-3
