"""Parity of slamtpu_torch.fusion (graph, robust, smoother) with
slamtpu.fusion on the CPU.

The inputs are a seeded 6-state pose window with one inactive slot, made
with numpy and fed to both packages in float64 (x64 is on in the tests, as
the reference runs its window there; the port keeps its window in float64
on every device). Tolerance: atol 1e-9 on every float64 output, the same
formulas in another order; the trust-gain twins are held exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamtpu.core import se3 as jse3
from slamtpu.fusion import graph as jgraph
from slamtpu.fusion import robust as jrobust
from slamtpu.fusion import smoother as jsmoother
from slamtpu_torch.core import se3
from slamtpu_torch.core.se3 import Pose3
from slamtpu_torch.fusion import graph, robust, smoother

torch.set_num_threads(1)
F64 = dict(atol=1e-9, rtol=0.0)
W = 6
IDX = 4  # the newest active state; slot 5 is inactive
# jitted: the eager reference re-traces jacfwd at every call
j_optimize = jax.jit(jsmoother.optimize_pose_window, static_argnames=("iterations",))


def _poses(rng, n, rot_scale, trans_scale):
    xi = np.concatenate([rng.normal(scale=rot_scale, size=(n, 3)),
                         rng.normal(scale=trans_scale, size=(n, 3))], axis=1)
    p = jse3.expmap(jnp.asarray(xi))
    return np.array(p.rot), np.array(p.trans)


def _spd(rng, n, d, scale):
    a = rng.normal(scale=scale, size=(n, d, d))
    return a @ a.transpose(0, 2, 1) + (scale ** 2) * np.eye(d)


@pytest.fixture(scope="module")
def window():
    """A window along a straight path: states, INS priors (noisy), between
    measurements (noisy relatives), sqrt-information of both."""
    rng = np.random.default_rng(2024)
    rot, trans = _poses(rng, W, 0.05, 0.3)
    trans = trans + np.arange(W)[:, None] * np.array([1.0, 0.2, 0.0])
    rot[IDX + 1:], trans[IDX + 1:] = np.eye(3), 0.0  # the empty slot
    nr, nt = _poses(rng, W, 0.01, 0.05)
    fp_rot, fp_trans = rot @ nr, trans + nt
    fp_sig = np.concatenate([rng.uniform(0.005, 0.02, (W, 3)), rng.uniform(0.02, 0.1, (W, 3))], 1)
    rel_rot = rot[:-1].transpose(0, 2, 1) @ rot[1:]
    rel_trans = np.einsum("kji,kj->ki", rot[:-1], trans[1:] - trans[:-1])
    mr, mt = _poses(rng, W - 1, 0.002, 0.01)
    fb_rot, fb_trans = rel_rot @ mr, rel_trans + mt
    fb_cov = _spd(rng, W - 1, 6, 0.01)
    # perturb the states away from the optimum
    pr, pt = _poses(rng, W, 0.02, 0.1)
    active = np.arange(W) <= IDX
    b_active = (np.arange(1, W) <= IDX)
    return dict(rot=rot @ pr, trans=trans + pt * active[:, None], active=active, fp_rot=fp_rot,
                fp_trans=fp_trans, fp_sig=fp_sig, fb_rot=fb_rot, fb_trans=fb_trans, fb_cov=fb_cov,
                b_active=b_active)


def T(a):
    return torch.as_tensor(np.array(a))


def test_sqrt_info_from_cov(window):
    cov = window["fb_cov"]
    a = graph.sqrt_info_from_cov(T(cov))
    b = jgraph.sqrt_info_from_cov(jnp.asarray(cov))
    np.testing.assert_allclose(a.numpy(), np.asarray(b), **F64)
    # S^T S == cov^-1
    StS = a.transpose(-1, -2) @ a
    np.testing.assert_allclose(StS.numpy(), np.linalg.inv(cov), rtol=1e-5)


def test_optimize_pose_window_and_marginal(window):
    w = window
    fp_si = np.stack([np.diag(1.0 / s) for s in w["fp_sig"]])
    fb_si = np.asarray(jgraph.sqrt_info_from_cov(jnp.asarray(w["fb_cov"])))
    args = [w["rot"], w["trans"], w["active"], w["fp_rot"], w["fp_trans"], fp_si,
            w["fb_rot"], w["fb_trans"], fb_si, w["b_active"]]
    ref = j_optimize(*[jnp.asarray(a) for a in args], iterations=4)
    out = smoother.optimize_pose_window(*[T(a) for a in args], iterations=4)
    assert out.rot.dtype == torch.float64
    for name in ("rot", "trans", "error"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)), **F64)
    # the normal matrix carries information up to ~1e6: relative 1e-9
    np.testing.assert_allclose(out.hessian.numpy(), np.asarray(ref.hessian),
                               atol=1e-9 * float(np.abs(np.asarray(ref.hessian)).max()))
    # the inactive slot stays where it was
    np.testing.assert_array_equal(out.trans[IDX + 1].numpy(), w["trans"][IDX + 1])
    assert float(out.error) < 0.1 * float(smoother.optimize_pose_window(*[T(a) for a in args],
                                                                          iterations=0).error)
    for idx in (0, IDX):
        c_ref = np.asarray(jsmoother.pose_marginal_covariance(ref.hessian, idx))
        c = smoother.pose_marginal_covariance(out.hessian, idx).numpy()
        np.testing.assert_allclose(c, c_ref, atol=1e-9 * float(np.abs(c_ref).max()))


@pytest.mark.parametrize("angle", [1e-7, 1e-3, 0.09, 0.11, 1.0, 2.5])
def test_logmap_derivative_and_adjoint(angle):
    """The smoother's written-out Jacobian blocks against forward-mode
    differentiation of the port's own se3 (both Taylor branches and the
    closed form)."""
    rng = np.random.default_rng(int(angle * 1e7) % 1000)
    w = rng.normal(size=3)
    xi = torch.as_tensor(np.concatenate([angle * w / np.linalg.norm(w), rng.normal(size=3)]))
    A = se3.expmap(xi)
    jac = torch.func.jacfwd(lambda d: se3.logmap(se3.compose(A, se3.expmap(d))))(
        torch.zeros(6, dtype=torch.float64))
    np.testing.assert_allclose(smoother.logmap_derivative(xi).numpy(), jac.numpy(), atol=1e-10)
    d = torch.as_tensor(rng.normal(scale=0.1, size=6))
    lhs = se3.expmap(smoother.adjoint(A) @ d)
    rhs = se3.compose(se3.compose(A, se3.expmap(d)), se3.inverse(A))
    np.testing.assert_allclose(lhs.rot.numpy(), rhs.rot.numpy(), atol=1e-12)
    np.testing.assert_allclose(lhs.trans.numpy(), rhs.trans.numpy(), atol=1e-12)


def test_deviation_gated_blend_and_prediction(window):
    w = window
    for k, (max_td, max_rd) in enumerate([(1.0, 0.1), (0.05, 0.1), (1.0, 0.005), (1e-4, 1e-4)]):
        pred = (w["rot"][k], w["trans"][k])
        meas = (w["fp_rot"][k], w["fp_trans"][k])
        jb, jw = jrobust.deviation_gated_blend(jse3.Pose3(*map(jnp.asarray, pred)),
                                               jse3.Pose3(*map(jnp.asarray, meas)), max_td, max_rd)
        tb, tw = robust.deviation_gated_blend(Pose3(*map(T, pred)), Pose3(*map(T, meas)), max_td, max_rd)
        np.testing.assert_allclose(float(tw), float(jw), **F64)
        np.testing.assert_allclose(tb.rot.numpy(), np.asarray(jb.rot), **F64)
        np.testing.assert_allclose(tb.trans.numpy(), np.asarray(jb.trans), **F64)
    # batched over the window
    a = Pose3(T(w["rot"][:-1]), T(w["trans"][:-1]))
    b = Pose3(T(w["rot"][1:]), T(w["trans"][1:]))
    jp = jrobust.constant_velocity_predict(jse3.Pose3(jnp.asarray(w["rot"][:-1]), jnp.asarray(w["trans"][:-1])),
                                           jse3.Pose3(jnp.asarray(w["rot"][1:]), jnp.asarray(w["trans"][1:])))
    tp = robust.constant_velocity_predict(a, b)
    np.testing.assert_allclose(tp.rot.numpy(), np.asarray(jp.rot), **F64)
    np.testing.assert_allclose(tp.trans.numpy(), np.asarray(jp.trans), **F64)
    # the prediction repeats the last relative motion
    rel_then = se3.between(a, b)
    rel_next = se3.between(b, tp)
    np.testing.assert_allclose(rel_next.trans.numpy(), rel_then.trans.numpy(), atol=1e-12)


def test_trust_gain_twins():
    """A GPS outage and recovery through the host twin and the tensor
    version of both packages: equal states and scales at every step."""
    norms = [0.01, 0.02, 0.5, 0.7, 0.03, 0.03, 0.04, 0.2, 0.01] + [0.01] * 5
    j_np, t_np = jrobust.trust_gain_init_np(), robust.trust_gain_init_np()
    j_st, t_st = jrobust.trust_gain_init(), robust.trust_gain_init()
    for s in norms:
        j_np, j_scale = jrobust.trust_gain_update_np(j_np, s)
        t_np, t_scale = robust.trust_gain_update_np(t_np, s)
        assert t_np == j_np and t_scale == j_scale
        j_st, j_sc = jrobust.trust_gain_update(j_st, jnp.asarray(s))
        t_st, t_sc = robust.trust_gain_update(t_st, torch.tensor(s, dtype=torch.float64))
        assert bool(t_st.was_denied) == bool(j_st.was_denied)
        assert float(t_st.trust) == float(j_st.trust) and float(t_sc) == float(j_sc) == t_scale
