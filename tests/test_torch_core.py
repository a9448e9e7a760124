"""Parity of slamtpu_torch.core (so3, se3, linalg) with slamtpu.core.

Same numpy inputs through both packages. The JAX side runs in float64 (x64
is on in the tests) where the port is asked for float64 too, and both in
float32 where the 3x3 Jacobi and the 6x6 eigen floor run on the map path.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamtpu.core import linalg as jlinalg
from slamtpu.core import se3 as jse3
from slamtpu.core import so3 as jso3
from slamtpu_torch.core import linalg, se3, so3

torch.set_num_threads(1)
RNG = np.random.default_rng(1337)


def random_rotvecs(n, scale=np.pi * 0.9):
    w = RNG.normal(size=(n, 3))
    w = w / np.linalg.norm(w, axis=-1, keepdims=True)
    return w * RNG.uniform(1e-9, scale, size=(n, 1))


def T(a):
    return torch.as_tensor(np.array(a))


def N(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# float64 on both sides: the formulas are the same, so they agree to ~1e-12
F64 = dict(atol=1e-11, rtol=1e-11)


@pytest.mark.parametrize("name", ["exp", "left_jacobian", "left_jacobian_inv", "hat"])
def test_so3_tangent_functions(name):
    w = np.concatenate([random_rotvecs(64), [[1e-12, 0, 0], [0, 0, 0]]])
    np.testing.assert_allclose(N(getattr(so3, name)(T(w))), N(getattr(jso3, name)(jnp.asarray(w))), **F64)


def test_so3_log_quat_rpy():
    R = np.asarray(jso3.exp(jnp.asarray(random_rotvecs(128))))
    R = np.concatenate([R, np.asarray(jso3.exp(jnp.asarray([[np.pi - 1e-7, 0, 0]])))])
    np.testing.assert_allclose(N(so3.log(T(R))), N(jso3.log(jnp.asarray(R))), atol=1e-9)
    np.testing.assert_allclose(N(so3.rot_to_quat(T(R))), N(jso3.rot_to_quat(jnp.asarray(R))), **F64)
    rpy = RNG.uniform(-1.2, 1.2, size=(64, 3))
    np.testing.assert_allclose(N(so3.rpy_to_rot(T(rpy))), N(jso3.rpy_to_rot(jnp.asarray(rpy))), **F64)
    np.testing.assert_allclose(N(so3.rot_to_rpy(T(R[:64]))), N(jso3.rot_to_rpy(jnp.asarray(R[:64]))), **F64)
    q = RNG.normal(size=(32, 4))
    np.testing.assert_allclose(N(so3.quat_to_rot(T(q))), N(jso3.quat_to_rot(jnp.asarray(q))), **F64)


def _poses(n):
    rot = np.asarray(jso3.exp(jnp.asarray(random_rotvecs(n))))
    return rot, RNG.normal(scale=5.0, size=(n, 3))


def test_se3_group_ops():
    (ra, ta), (rb, tb) = _poses(32), _poses(32)
    ja, jb = jse3.Pose3(jnp.asarray(ra), jnp.asarray(ta)), jse3.Pose3(jnp.asarray(rb), jnp.asarray(tb))
    pa, pb = se3.Pose3(T(ra), T(ta)), se3.Pose3(T(rb), T(tb))
    for name in ("compose", "between"):
        a, b = getattr(se3, name)(pa, pb), getattr(jse3, name)(ja, jb)
        np.testing.assert_allclose(N(a.rot), N(b.rot), **F64)
        np.testing.assert_allclose(N(a.trans), N(b.trans), **F64)
    np.testing.assert_allclose(N(se3.local(pa, pb)), N(jse3.local(ja, jb)), atol=1e-9)
    np.testing.assert_allclose(N(se3.logmap(pa)), N(jse3.logmap(ja)), atol=1e-9)
    xi = RNG.normal(scale=0.5, size=(32, 6))
    for a, b in ((se3.expmap(T(xi)), jse3.expmap(jnp.asarray(xi))),
                 (se3.retract(pa, T(xi)), jse3.retract(ja, jnp.asarray(xi))),
                 (se3.inverse(pa), jse3.inverse(ja)),
                 (se3.interpolate(pa, pb, T(np.full(32, 0.3))),
                  jse3.interpolate(ja, jb, jnp.full(32, 0.3)))):
        np.testing.assert_allclose(N(a.rot), N(b.rot), atol=1e-9)
        np.testing.assert_allclose(N(a.trans), N(b.trans), atol=1e-9)
    pts = RNG.normal(scale=20.0, size=(32, 50, 3))
    np.testing.assert_allclose(N(se3.transform_points(pa, T(pts))),
                               N(jse3.transform_points(ja, jnp.asarray(pts))), **F64)
    c = se3.cast(pa, torch.float32)
    assert c.rot.dtype == torch.float32 and c.trans.dtype == torch.float32


def test_sym_eig3x3_float32_matches_reference():
    """The map path runs the 6-sweep Jacobi in float32: same rotation
    sequence, so eigenvalues agree to float32 rounding (rtol 1e-5 of the
    largest), eigenvectors up to sign."""
    A = RNG.normal(size=(256, 3, 3))
    A = (A @ A.transpose(0, 2, 1)).astype(np.float32)
    A[:8] = np.diag([1e-4, 0.3, 0.3]).astype(np.float32)  # repeated eigenvalues
    ev, V = linalg.sym_eig3x3(T(A))
    jev, jV = jlinalg.sym_eig3x3(jnp.asarray(A))
    scale = np.abs(N(jev)).max(axis=-1, keepdims=True)
    assert np.all(np.abs(N(ev) - N(jev)) <= 1e-5 * scale + 1e-12)
    recon = N((V * ev[..., None, :]) @ V.transpose(-1, -2))
    np.testing.assert_allclose(recon, A, atol=1e-5 * scale.max())


def test_inv3x3_and_eig_floor():
    A = RNG.normal(size=(64, 3, 3))
    np.testing.assert_allclose(N(linalg.inv3x3(T(A))), N(jlinalg.inv3x3(jnp.asarray(A))), rtol=1e-9, atol=1e-9)
    C = RNG.normal(size=(6, 6))
    C = C @ C.T
    C[0, :] = C[:, 0] = 0.0  # a zero eigenvalue below the floor
    np.testing.assert_allclose(N(linalg.eig_floor_psd(T(C), 1e-3)),
                               N(jlinalg.eig_floor_psd(jnp.asarray(C), 1e-3)), atol=1e-10)
