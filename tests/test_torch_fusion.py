"""Parity of slamtpu_torch.fusion (graph, robust, smoother) with
slamtpu.fusion on the CPU.

The inputs are a seeded 6-state pose window with one inactive slot, made
with numpy and fed to both packages in float64 (x64 is on in the tests, as
the reference runs its window there; the port keeps its window in float64
on every device). Tolerance: atol 1e-9 on every float64 output, the same
formulas in another order; the trust-gain twins are held exactly.

The deviation-gated blend is the exception: the port blends along the
SE(3) geodesic, the JAX package linearly in the global Logmap
coordinates, so the two are held to each other only where the weight is 0
or 1, and the port's blend elsewhere to a float64 geodesic oracle written
here (also across heading +-pi, where the two packages part).
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


def _so3_exp(w):
    th = np.linalg.norm(w)
    K = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])
    if th < 1e-12:
        return np.eye(3) + K
    return np.eye(3) + np.sin(th) / th * K + (1.0 - np.cos(th)) / th ** 2 * (K @ K)


def _so3_left_jacobian(w):
    th = np.linalg.norm(w)
    K = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])
    if th < 1e-12:
        return np.eye(3) + 0.5 * K
    return np.eye(3) + (1.0 - np.cos(th)) / th ** 2 * K + (th - np.sin(th)) / th ** 3 * (K @ K)


def _so3_log(R):
    """Rotation vector of R for angles well below pi (the relative
    rotations here)."""
    th = np.arccos(np.clip(0.5 * (np.trace(R) - 1.0), -1.0, 1.0))
    vee = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return vee * (th / np.sin(th) if th > 1e-12 else 1.0)


def _geodesic_blend(pred, meas, w):
    """Float64 oracle: pred * Exp(w Log(pred^-1 meas)), the SE(3) geodesic
    from pred (w = 0) to meas (w = 1), with tangent [omega, v]."""
    Rp, tp = pred
    Rm, tm = meas
    dR, dt = Rp.T @ Rm, Rp.T @ (tm - tp)
    om = _so3_log(dR)
    v = np.linalg.solve(_so3_left_jacobian(om), dt)
    return Rp @ _so3_exp(w * om), tp + Rp @ (_so3_left_jacobian(w * om) @ (w * v))


def _rot_angle(Ra, Rb):
    return float(np.linalg.norm(_so3_log(Ra.T @ Rb)))


def test_deviation_gated_blend_and_prediction(window):
    """The blend weight against the JAX package; the blended pose against
    the JAX package where w is 0 or 1 (both blends return an end of the
    pair there) and against the float64 geodesic oracle where 0 < w < 1:
    the port blends along the geodesic, the JAX package linearly in the
    global Logmap coordinates."""
    w = window
    seen = set()
    for k, (max_td, max_rd) in enumerate([(1.0, 0.1), (0.05, 0.1), (1.0, 0.005), (1e-4, 1e-4), (np.inf, np.inf)]):
        pred = (w["rot"][k], w["trans"][k])
        meas = (w["fp_rot"][k], w["fp_trans"][k])
        jb, jw = jrobust.deviation_gated_blend(jse3.Pose3(*map(jnp.asarray, pred)),
                                               jse3.Pose3(*map(jnp.asarray, meas)), max_td, max_rd)
        tb, tw = robust.deviation_gated_blend(Pose3(*map(T, pred)), Pose3(*map(T, meas)), max_td, max_rd)
        np.testing.assert_allclose(float(tw), float(jw), **F64)
        if float(tw) in (0.0, 1.0):
            seen.add("end")
            np.testing.assert_allclose(tb.rot.numpy(), np.asarray(jb.rot), **F64)
            np.testing.assert_allclose(tb.trans.numpy(), np.asarray(jb.trans), **F64)
        else:
            seen.add("inside")
            ob_rot, ob_trans = _geodesic_blend(pred, meas, float(tw))
            np.testing.assert_allclose(tb.rot.numpy(), ob_rot, **F64)
            np.testing.assert_allclose(tb.trans.numpy(), ob_trans, **F64)
    assert seen == {"end", "inside"}
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


def _yaw_pose(yaw, roll, trans):
    c, s = np.cos(yaw), np.sin(yaw)
    Rz = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return Rz @ _so3_exp(np.array([roll, 0.0, 0.0])), np.asarray(trans, np.float64)


@pytest.mark.parametrize("w", [0.0, 0.25, 0.5, 0.9, 0.998, 1.0])
def test_blend_straddling_pi_stays_on_the_short_arc(w):
    """A pair that straddles heading +-pi (yaw pi - 0.01 against -pi +
    0.01, 0.02 rad apart the short way), as a closed lap meets every time
    round: the blend turns a share w of the 0.02 rad toward the
    measurement, and lands within 1e-9 m and 1e-9 rad of the float64
    geodesic oracle. The rotation threshold sets w; the translation's is
    wide enough not to bind."""
    pred = _yaw_pose(np.pi - 0.01, 0.003, [41.7, -23.2, 1.5])
    meas = _yaw_pose(-np.pi + 0.01, 0.003, [41.45, -23.15, 1.52])
    gap = _rot_angle(pred[0], meas[0])
    assert gap < 0.021  # the short way round
    max_rd = np.inf if w == 1.0 else gap / (1.0 - w)
    tb, tw = robust.deviation_gated_blend(Pose3(*map(T, pred)), Pose3(*map(T, meas)), 1e3, max_rd)
    assert float(tw) == pytest.approx(w, abs=1e-3)
    Rb, tb_ = tb.rot.numpy(), tb.trans.numpy()
    ob_rot, ob_trans = _geodesic_blend(pred, meas, float(tw))
    assert _rot_angle(Rb, ob_rot) < 1e-9
    np.testing.assert_allclose(tb_, ob_trans, atol=1e-9, rtol=0.0)
    # on the arc between the two: the turns from pred and to meas add up
    # to the gap, split w : 1 - w
    to_b, from_b = _rot_angle(pred[0], Rb), _rot_angle(Rb, meas[0])
    assert abs(to_b + from_b - gap) < 1e-9
    assert abs(to_b - float(tw) * gap) < 1e-9


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
