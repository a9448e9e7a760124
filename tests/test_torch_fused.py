"""Parity of the pair kernels' plain versions (slamtpu_torch.ndt.fused_math)
with the reference's Pallas kernels, run in interpret mode on the CPU
through slamtpu.ndt.pallas_math.fused_objective: NDT mode (B1) and the
plane-to-plane mode (B3) on the same megaT / ptsT / scovT, N = 2 blocks of
2048 points.

Tolerances are those of the reference's own fused-vs-XLA check
(tests/test_regmap.py TestFusedKernel): n_contrib exact; score rtol 2e-6;
grad rtol 1e-4 / atol 1e-2 and Hessian rtol 1e-4 / atol 1e-1, because the
two sum ~29k pair terms in a different float32 order.

The CUDA kernels themselves run only on the card (chip_smoke.py compares
them with these plain versions there)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamtpu.core import se3 as jse3
from slamtpu.mapping import gaussian_map as jgm
from slamtpu.ndt import build_regmap as jbuild_regmap
from slamtpu.ndt import gauss_constants, regularize_plane_covariance
from slamtpu.ndt.pallas_math import fused_objective as jfused
from slamtpu.ndt.pallas_math import gather_megaT as jgather
from slamtpu_torch import interop
from slamtpu_torch.ndt import fused_math
from tests.oracles import two_plane_cloud

torch.set_num_threads(1)
RNG = np.random.default_rng(5)
RES = np.float32(1.0)
GRID = (64, 64, 32)
N = 4096


@pytest.fixture(scope="module")
def inputs():
    base = two_plane_cloud(extent=8.0, pitch=0.15)
    target = (base + RNG.normal(scale=0.02, size=base.shape)).astype(np.float32)
    origin = (np.floor(target.min(0)) - 8.0).astype(np.float32)
    gmap = jgm.build_map(jnp.asarray(target), jnp.ones(len(target), bool), jnp.asarray(origin), RES,
                         capacity=2048)
    aux = jnp.concatenate([gmap.mean, regularize_plane_covariance(gmap.cov).reshape(-1, 9)], axis=1)
    regmap = jbuild_regmap(gmap, grid_shape=GRID, aux_payload=aux)
    src = two_plane_cloud(extent=8.0, pitch=0.2)
    pts = np.zeros((N, 3), np.float32)
    pts[: len(src)] = src[:N] + RNG.normal(scale=0.01, size=src[:N].shape)
    mask = np.zeros(N, bool)
    mask[: len(src)] = True  # the tail pads with masked points (sentinel rows)
    ident = jse3.Pose3(jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32))
    megaT = np.array(jgather(jnp.asarray(pts), jnp.asarray(mask), ident, regmap, GRID))
    megaT_aux = np.array(jgather(jnp.asarray(pts), jnp.asarray(mask), ident, regmap, GRID, table="aux"))
    c = RNG.normal(scale=0.05, size=(N, 3, 3))
    scov = np.asarray(regularize_plane_covariance(jnp.asarray(c @ c.transpose(0, 2, 1)))).astype(np.float32)
    return pts, megaT, megaT_aux, scov.reshape(N, 9).T.copy()


def _poses(k):
    xi = RNG.normal(scale=[0.01, 0.01, 0.02, 0.05, 0.05, 0.05], size=(k, 6))
    p = jse3.expmap(jnp.asarray(xi, jnp.float32))
    return np.asarray(p.rot, np.float32), np.asarray(p.trans, np.float32)


def _check(a, b):
    assert int(a.n_contrib) == int(b.n_contrib) > 0
    np.testing.assert_allclose(float(a.score), float(b.score), rtol=2e-6)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(b.grad), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(a.hess.numpy(), np.asarray(b.hess), rtol=1e-4, atol=1e-1)


@pytest.mark.parametrize("mode", ["ndt", "aniso"])
def test_plain_matches_pallas(inputs, mode):
    pts, megaT, megaT_aux, scovT = inputs
    d1, d2, _ = gauss_constants(float(RES), 0.55)
    rot, trans = _poses(3)
    for i in range(3):
        jpose = jse3.Pose3(jnp.asarray(rot[i]), jnp.asarray(trans[i]))
        tpose = interop.pose_from_numpy(rot[i], trans[i])
        if mode == "ndt":
            b = jfused(jnp.asarray(pts.T), jnp.asarray(megaT), jpose, d1, d2, 1e-6, interpret=True)
            a = fused_math.fused_objective(torch.as_tensor(pts.T.copy()), torch.as_tensor(megaT), tpose,
                                           d1, d2, 1e-6)
        else:
            b = jfused(jnp.asarray(pts.T), jnp.asarray(megaT_aux), jpose, 0.0, 25.0, 1e-6,
                       interpret=True, src_covT=jnp.asarray(scovT))
            a = fused_math.fused_objective(torch.as_tensor(pts.T.copy()), torch.as_tensor(megaT_aux),
                                           tpose, 0.0, 25.0, 1e-6, src_covT=torch.as_tensor(scovT))
        _check(a, b)


def test_batched_call_equals_single_calls(inputs):
    """K poses in one call give the K single-pose results (the plain version
    sums each pose independently, so they are bitwise equal)."""
    pts, megaT, _, _ = inputs
    d1, d2, _ = gauss_constants(float(RES), 0.55)
    rot, trans = _poses(5)
    ptsT = torch.as_tensor(pts.T.copy())
    batch = fused_math.fused_objective(ptsT, torch.as_tensor(megaT), interop.pose_from_numpy(rot, trans), d1, d2)
    assert batch.grad.shape == (5, 6) and batch.hess.shape == (5, 6, 6)
    for i in range(5):
        one = fused_math.fused_objective(ptsT, torch.as_tensor(megaT), interop.pose_from_numpy(rot[i], trans[i]),
                                         d1, d2)
        for f_b, f_1 in zip(batch, one):
            np.testing.assert_allclose(f_b[i].numpy(), f_1.numpy(), rtol=1e-6, atol=1e-6)


def test_wrapper_checks_inputs(inputs):
    pts, megaT, _, _ = inputs
    params = torch.zeros((1, 16))
    with pytest.raises(ValueError):  # not contiguous
        fused_math.ndt_pair(params, torch.as_tensor(pts).t(), torch.as_tensor(megaT))
    with pytest.raises(ValueError):  # wrong dtype
        fused_math.ndt_pair(params.double(), torch.as_tensor(pts.T.copy()), torch.as_tensor(megaT))
    # CPU tensors take the plain version and launch nothing
    before = dict(fused_math.LAUNCHES)
    fused_math.ndt_pair(params, torch.as_tensor(pts.T.copy()), torch.as_tensor(megaT))
    assert fused_math.LAUNCHES == before
