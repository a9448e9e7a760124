"""Parity of slamtpu_torch's 15-dof window graph and smoother with slamtpu
on the CPU.

Inputs are made with numpy from a seed, built as the reference's own
``Factors``/``WindowState`` and handed to the port through ``interop``, in
float64 (x64 is on in the tests; the port keeps its window in float64 on
every device).

- ``residuals`` on a random W = 4 window with every factor type active and
  some slots masked: within 1e-10.
- The written-out Jacobian against ``torch.func.jacfwd`` of the port's own
  ``residuals`` through the retract: within 1e-9 of each row's largest
  entry; its unobserved-column mask (all-zero columns, which the final
  Hessian pins) equals that of the reference's ``jax.jacfwd`` exactly.
- ``optimize`` with both solvers against the reference on the three
  fixtures of tests/test_fusion.py (prior + between chain, prior-only
  marginal, IMU factor window) and on a ligo-like W = 6 window: states
  within 1e-8, Hessian within rtol 1e-8 (entries below 1e-8 of the
  largest one held to that floor: the normal matrix spans ~12 orders of
  magnitude between the IMU and the pins), ``marginal_covariance`` within
  rtol 1e-8 (with a floor of 1e-8 of the largest entry of H^-1, see the
  test).
- The reference's own ``chol`` branch against its ``qr`` branch
  (JAX only) on the prior + between chain: within 1e-8.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamtpu.core import se3 as jse3
from slamtpu.fusion import graph as jgraph
from slamtpu.fusion import preintegration as jpre
from slamtpu.fusion import smoother as jsmoother
from slamtpu.apps.common import np_sqrt_info_from_cov as j_np_sqrt_info_from_cov
from slamtpu_torch import interop
from slamtpu_torch.apps import common
from slamtpu_torch.fusion import graph, smoother

torch.set_num_threads(1)
SOLVERS = ["qr", "chol"]
# jitted: eager JAX dispatches every op of the graph (and of jacfwd) anew
j_optimize = jax.jit(jsmoother.optimize, static_argnames=("cfg",))
j_residuals = jax.jit(jgraph.residuals)
j_linearize = jax.jit(jsmoother._linearize)
GRAVITY = np.array([0.0, 0.0, 9.81])


def _poses(rng, n, rot_scale, trans_scale):
    xi = np.concatenate([rng.normal(scale=rot_scale, size=(n, 3)),
                         rng.normal(scale=trans_scale, size=(n, 3))], axis=1)
    p = jse3.expmap(jnp.asarray(xi))
    return np.array(p.rot), np.array(p.trans)


def _whitening(rng, n, d, scale):
    a = rng.normal(scale=scale, size=(n, d, d))
    return np.asarray(jgraph.sqrt_info_from_cov(jnp.asarray(a @ a.transpose(0, 2, 1) + scale ** 2 * np.eye(d))))


def _i32(a):
    return jnp.asarray(np.asarray(a, np.int32))


@functools.cache
def random_window():
    """W = 4 (slot 3 padded), every factor type, some slots masked; the
    IMU factor 1 -> 2 is masked, so no active IMU factor reaches state 2's
    bias."""
    rng = np.random.default_rng(7)
    W = 4
    rot, trans = _poses(rng, W, 0.4, 3.0)
    state = jgraph.WindowState(jnp.asarray(rot), jnp.asarray(trans),
                               jnp.asarray(rng.normal(size=(W, 3))),
                               jnp.asarray(rng.normal(scale=0.01, size=(W, 6))),
                               jnp.asarray([True, True, True, False]))
    f = jgraph.empty_factors(5, 3, 4, 1, 3, 2)
    pr, pt = _poses(rng, 5, 0.3, 2.0)
    br, bt = _poses(rng, 3, 0.3, 2.0)
    dR, _ = _poses(rng, 3, 0.2, 1.0)
    f = f._replace(
        prior_pose=jgraph.PriorPoseFactors(_i32([0, 1, 2, 3, 1]), jnp.asarray(pr), jnp.asarray(pt),
                                           jnp.asarray(_whitening(rng, 5, 6, 0.1)),
                                           jnp.asarray([True, True, True, False, True])),
        between=jgraph.BetweenFactors(_i32([0, 1, 2]), _i32([1, 2, 3]), jnp.asarray(br), jnp.asarray(bt),
                                      jnp.asarray(_whitening(rng, 3, 6, 0.05)),
                                      jnp.asarray([True, True, False])),
        prior_vel=jgraph.VecPriorFactors(_i32([0, 1, 2, 3]), jnp.asarray(rng.normal(size=(4, 3))),
                                         jnp.asarray(_whitening(rng, 4, 3, 0.5)),
                                         jnp.asarray([True, False, True, False])),
        prior_bias=jgraph.VecPriorFactors(_i32([0]), jnp.asarray(rng.normal(scale=0.01, size=(1, 6))),
                                          jnp.asarray(_whitening(rng, 1, 6, 0.05)), jnp.asarray([True])),
        imu=jgraph.ImuFactors(
            _i32([0, 1, 2]), _i32([1, 2, 3]), jnp.asarray(dR), jnp.asarray(rng.normal(size=(3, 3))),
            jnp.asarray(rng.normal(size=(3, 3))), jnp.asarray([0.1, 0.11, 0.09]),
            *(jnp.asarray(rng.normal(scale=0.05, size=(3, 3, 3))) for _ in range(5)),
            jnp.asarray(rng.normal(scale=0.01, size=(3, 6))), jnp.asarray(_whitening(rng, 3, 15, 0.05)),
            jnp.asarray([True, False, False])),
        position=jgraph.PositionFactors(_i32([1, 2]), jnp.asarray(rng.normal(size=(2, 3))),
                                        jnp.asarray(_whitening(rng, 2, 3, 0.2)), jnp.asarray([True, False])),
        gravity=jnp.asarray(GRAVITY),
    )
    return state, f


def port(state, factors):
    return interop.window_state_from_numpy(state), interop.factors_from_numpy(factors)


def test_residuals_match_reference():
    jstate, jf = random_window()
    state, f = port(jstate, jf)
    ref = np.asarray(j_residuals(jstate, jf))
    out = graph.residuals(state, f)
    assert out.dtype == torch.float64 and out.shape == ref.shape == (30 + 18 + 12 + 6 + 45 + 6,)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-10, atol=1e-10)
    # inactive slots give exact zeros (prior 3, between 2, velocity prior 1)
    assert (out[18:24] == 0).all() and (out[42:48] == 0).all() and (out[51:54] == 0).all()


def _jacobians(jstate, jf, state, f):
    W = state.window
    r, J = smoother._linearize(state, f)
    zero = torch.zeros(W * 15, dtype=torch.float64)
    J_fwd = torch.func.jacfwd(lambda d: graph.residuals(state.retract(d.reshape(W, 15)), f))(zero)
    _, J_ref = j_linearize(jstate, jf)
    return r, J.numpy(), J_fwd.numpy(), np.asarray(J_ref)


def _assert_jacobian(J, J_fwd, J_ref):
    rowmax = np.abs(J_fwd).max(axis=1, keepdims=True)
    assert (np.abs(J - J_fwd) <= 1e-9 * rowmax).all(), np.abs(J - J_fwd).max()
    unobserved = ~(np.abs(J) > 0).any(axis=0)
    np.testing.assert_array_equal(unobserved, ~(np.abs(J_ref) > 0).any(axis=0))
    return unobserved


def test_written_jacobian_matches_forward_mode_and_mask():
    jstate, jf = random_window()
    state, f = port(jstate, jf)
    r, J, J_fwd, J_ref = _jacobians(jstate, jf, state, f)
    np.testing.assert_allclose(r.numpy(), np.asarray(j_residuals(jstate, jf)), rtol=1e-10, atol=1e-10)
    unobserved = _assert_jacobian(J, J_fwd, J_ref)
    # the padded state, and the bias of state 2 (its IMU factors are masked)
    assert unobserved.reshape(4, 15)[3].all() and unobserved.reshape(4, 15)[2, 9:].all()
    assert unobserved.sum() == 15 + 6


@pytest.mark.parametrize("angle", [1e-6, 0.5, 2.0])
def test_written_jacobian_at_rotation_scales(angle):
    """Each IMU rotation error at a given angle (the right-Jacobian series
    and closed forms), every factor active."""
    jstate, jf = random_window()
    rng = np.random.default_rng(int(angle * 1e6) % 997)
    Ri, Rj = np.asarray(jstate.rot[:3]), np.asarray(jstate.rot[1:])
    w = rng.normal(size=(3, 3))
    err = np.asarray(jse3.expmap(jnp.asarray(np.concatenate(
        [angle * w / np.linalg.norm(w, axis=1, keepdims=True), np.zeros((3, 3))], 1))).rot)
    # dR chosen so that dR^T Ri^T Rj = Exp(err) at the linearization bias
    dR = np.einsum("fji,fjk,fkl->fil", Ri, Rj, err.transpose(0, 2, 1))
    everyone = lambda t: jnp.ones_like(t)  # noqa: E731
    jf = jf._replace(
        imu=jf.imu._replace(dR=jnp.asarray(dR), bias_hat=jstate.bias[:3], active=everyone(jf.imu.active)),
        **{k: getattr(jf, k)._replace(active=everyone(getattr(jf, k).active))
           for k in ("prior_pose", "between", "prior_vel", "position")})
    jstate = jstate._replace(active=jnp.ones(4, bool))
    state, f = port(jstate, jf)
    r_R = graph.factor_errors(state, f)["imu"][:, :3].numpy()
    np.testing.assert_allclose(np.linalg.norm(r_R, axis=1), angle, rtol=1e-9)
    _, J, J_fwd, J_ref = _jacobians(jstate, jf, state, f)
    assert not _assert_jacobian(J, J_fwd, J_ref).any()


# --- optimize: the three fixtures of tests/test_fusion.py and a ligo-like window ---


def chain_fixture():
    W = 4
    gt = [jse3.from_rpy_xyz(jnp.asarray([0, 0, 0.1 * i]), jnp.asarray([float(i), 0, 0])) for i in range(W)]
    factors = jgraph.empty_factors(1, W - 1, 1, 1, 0, 0)
    fp = factors.prior_pose._replace(idx=_i32([0]), rot=gt[0].rot[None], trans=gt[0].trans[None],
                                     sqrt_info=jnp.eye(6)[None] * 100.0, active=jnp.asarray([True]))
    rels = [jse3.between(gt[i], gt[i + 1]) for i in range(W - 1)]
    fb = factors.between._replace(
        i=jnp.arange(W - 1, dtype=jnp.int32), j=jnp.arange(1, W, dtype=jnp.int32),
        rot=jnp.stack([r.rot for r in rels]), trans=jnp.stack([r.trans for r in rels]),
        sqrt_info=jnp.broadcast_to(jnp.eye(6) * 10.0, (W - 1, 6, 6)), active=jnp.ones(W - 1, bool))
    state = jgraph.WindowState.identity(W)._replace(active=jnp.ones(W, bool))
    return state, factors._replace(prior_pose=fp, between=fb), 10


def prior_only_fixture():
    factors = jgraph.empty_factors(1, 0, 1, 1, 0, 0)
    sigmas = jnp.asarray([0.1, 0.1, 0.1, 0.2, 0.2, 0.2])
    factors = factors._replace(
        prior_pose=factors.prior_pose._replace(idx=_i32([0]), sqrt_info=jgraph.sqrt_info_from_sigmas(sigmas)[None],
                                               active=jnp.asarray([True])),
        prior_vel=factors.prior_vel._replace(idx=_i32([0]), active=jnp.asarray([True])),
        prior_bias=factors.prior_bias._replace(idx=_i32([0]), active=jnp.asarray([True])))
    return jgraph.WindowState.identity(2)._replace(active=jnp.asarray([True, False])), factors, 3


def imu_fixture():
    n, dt = 100, 0.01
    noise = jpre.ImuNoise(jnp.full(3, 1e-3), jnp.full(3, 1e-4), jnp.full(3, 1e-5), jnp.full(3, 1e-6))
    accel = np.tile(np.array([0.0, 0.0, -9.81]), (n, 1))
    pim = jpre.integrate(jnp.asarray(accel + [0.5, 0, 0]), jnp.zeros((n, 3)), jnp.full(n, dt),
                         jpre.ImuBias.zero(), noise)
    f = jgraph.empty_factors(1, 0, 1, 1, 1, 0)
    on = jnp.asarray([True])
    f = f._replace(
        prior_pose=f.prior_pose._replace(idx=_i32([0]), sqrt_info=jnp.eye(6)[None] * 1e3, active=on),
        prior_vel=f.prior_vel._replace(idx=_i32([0]), sqrt_info=jnp.eye(3)[None] * 1e3, active=on),
        prior_bias=f.prior_bias._replace(idx=_i32([0]), sqrt_info=jnp.eye(6)[None] * 1e3, active=on),
        imu=f.imu._replace(i=_i32([0]), j=_i32([1]), dR=pim.dR[None], dv=pim.dv[None], dp=pim.dp[None],
                           dt=pim.dt[None], dR_dbg=pim.dR_dbg[None], dv_dba=pim.dv_dba[None],
                           dv_dbg=pim.dv_dbg[None], dp_dba=pim.dp_dba[None], dp_dbg=pim.dp_dbg[None],
                           bias_hat=jnp.zeros((1, 6)), sqrt_info=jnp.eye(15)[None] * 10.0, active=on),
        gravity=jnp.asarray(GRAVITY))
    return jgraph.WindowState.identity(2)._replace(active=jnp.ones(2, bool)), f, 10


@functools.cache
def ligo_fixture():
    """The ligo_tc window at W = 6 with 4 states filled: the app's factor
    template (INS pose priors on every slot, LiDAR betweens and IMU factors
    on the chain, velocity priors, one bias prior), preintegrated 50 Hz
    windows along a moving path, states perturbed from it."""
    rng = np.random.default_rng(11)
    W, n = 6, 4
    noise = jpre.ImuNoise(jnp.full(3, 1e-3), jnp.full(3, 1e-4), jnp.full(3, 1e-5), jnp.full(3, 1e-6))
    rot, trans = _poses(rng, W, 0.05, 0.2)
    trans = trans + np.arange(W)[:, None] * np.array([1.0, 0.1, 0.0])
    vel = np.tile([10.0, 1.0, 0.0], (W, 1)) + rng.normal(scale=0.1, size=(W, 3))
    pims = [jpre.integrate(jnp.asarray(rng.normal(scale=0.3, size=(6, 3)) + [0, 0, -9.81]),
                           jnp.asarray(rng.normal(scale=0.05, size=(6, 3))), jnp.full(6, 0.02),
                           jpre.ImuBias(jnp.asarray(rng.normal(scale=1e-3, size=3)), jnp.zeros(3)), noise)
            for _ in range(W - 1)]
    active = np.arange(W) < n
    b_active = np.arange(W - 1) < n - 1
    f = jgraph.empty_factors(W, W - 1, W, 1, W - 1, 0)
    pr, pt = _poses(rng, W, 0.01, 0.05)
    mr, mt = _poses(rng, W - 1, 0.002, 0.01)
    rel_rot = rot[:-1].transpose(0, 2, 1) @ rot[1:] @ mr
    rel_trans = np.einsum("kji,kj->ki", rot[:-1], trans[1:] - trans[:-1]) + mt

    def stack(key):
        return jnp.stack([getattr(p, key) for p in pims])

    f = f._replace(
        prior_pose=jgraph.PriorPoseFactors(jnp.arange(W, dtype=jnp.int32), jnp.asarray(rot @ pr),
                                           jnp.asarray(trans + pt),
                                           jnp.asarray(np.stack([np.diag(1 / s) for s in rng.uniform(0.01, 0.1, (W, 6))])),
                                           jnp.asarray(active)),
        between=jgraph.BetweenFactors(jnp.arange(W - 1, dtype=jnp.int32), jnp.arange(1, W, dtype=jnp.int32),
                                      jnp.asarray(rel_rot), jnp.asarray(rel_trans),
                                      jnp.asarray(_whitening(rng, W - 1, 6, 0.01)), jnp.asarray(b_active)),
        prior_vel=f.prior_vel._replace(idx=jnp.arange(W, dtype=jnp.int32), value=jnp.asarray(vel),
                                       sqrt_info=jnp.broadcast_to(jnp.eye(3) / 0.5, (W, 3, 3)),
                                       active=jnp.asarray(active)),
        prior_bias=f.prior_bias._replace(idx=_i32([0]), sqrt_info=(jnp.eye(6) / 0.05)[None],
                                         active=jnp.asarray([True])),
        imu=jgraph.ImuFactors(
            jnp.arange(W - 1, dtype=jnp.int32), jnp.arange(1, W, dtype=jnp.int32),
            *(stack(k) for k in ("dR", "dv", "dp", "dt", "dR_dbg", "dv_dba", "dv_dbg", "dp_dba", "dp_dbg")),
            jnp.stack([p.bias_hat.vec() for p in pims]),
            jnp.asarray(np.stack([j_np_sqrt_info_from_cov(np.asarray(p.cov)) for p in pims])),
            jnp.asarray(b_active)),
        gravity=jnp.asarray(GRAVITY))
    xr, xt = _poses(rng, W, 0.01, 0.1)
    state = jgraph.WindowState(jnp.asarray(rot @ xr), jnp.asarray(trans + xt * active[:, None]),
                               jnp.asarray(vel + rng.normal(scale=0.2, size=(W, 3))),
                               jnp.zeros((W, 6)), jnp.asarray(active))
    return state, f, 6


FIXTURES = {"chain": chain_fixture, "prior_only": prior_only_fixture, "imu": imu_fixture,
            "ligo": ligo_fixture}


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("fixture", list(FIXTURES))
def test_optimize_matches_reference(fixture, solver):
    jstate, jf, iterations = FIXTURES[fixture]()
    jcfg = jsmoother.SmootherConfig(iterations=iterations, solver=solver)
    ref = j_optimize(jstate, jf, jcfg)
    state, f = port(jstate, jf)
    out = smoother.optimize(state, f, interop.smoother_config_from_reference(jcfg))
    for name in ("rot", "trans", "vel", "bias"):
        np.testing.assert_allclose(getattr(out.state, name).numpy(), np.asarray(getattr(ref.state, name)),
                                   rtol=0, atol=1e-8, err_msg=name)
    np.testing.assert_array_equal(out.state.active.numpy(), np.asarray(ref.state.active))
    H, H_ref = out.hessian.numpy(), np.asarray(ref.hessian)
    np.testing.assert_allclose(H, H_ref, rtol=1e-8, atol=1e-8 * np.abs(H_ref).max())
    np.testing.assert_allclose(float(out.error), float(ref.error), rtol=1e-8, atol=1e-12)
    assert int(out.iterations) == int(ref.iterations) == iterations
    # floor: 1e-8 of the largest entry of H^-1 (the unit variance of a pinned
    # dof): on the ligo window (cond(H) ~3e12) two LU inversions of the same
    # H, LAPACK's and torch's, differ by 3e-9 of it
    inv_max = np.abs(np.linalg.inv(H_ref + 1e-12 * np.eye(H_ref.shape[0]))).max()
    for idx in range(state.window):
        c_ref = np.asarray(jsmoother.marginal_covariance(ref.hessian, idx))
        c = smoother.marginal_covariance(out.hessian, idx).numpy()
        np.testing.assert_allclose(c, c_ref, rtol=1e-8, atol=1e-8 * inv_max)
    if fixture == "ligo":  # the IMU chain and priors pull the window in
        err0 = float(smoother.optimize(state, f, smoother.SmootherConfig(iterations=0)).error)
        assert float(out.error) < 0.01 * err0
        _, J, J_fwd, J_ref = _jacobians(ref.state, jf, port(ref.state, jf)[0], f)
        unobserved = _assert_jacobian(J, J_fwd, J_ref).reshape(6, 15)
        assert unobserved[4:].all() and not unobserved[:4].any()


def test_reference_chol_matches_its_qr():
    """The reference's ``chol`` branch (ligo_tc's default) against its
    ``qr`` branch, JAX only."""
    state, factors, iterations = chain_fixture()
    res = {s: j_optimize(state, factors, jsmoother.SmootherConfig(iterations=iterations, solver=s))
           for s in SOLVERS}
    for name in ("rot", "trans", "vel", "bias"):
        np.testing.assert_allclose(np.asarray(getattr(res["chol"].state, name)),
                                   np.asarray(getattr(res["qr"].state, name)), rtol=0, atol=1e-8)
    np.testing.assert_allclose(np.asarray(res["chol"].hessian), np.asarray(res["qr"].hessian),
                               rtol=1e-8, atol=1e-8)


def test_numpy_whitening_helpers():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(15, 15))
    cov = a @ a.T * 1e-4 + 1e-6 * np.eye(15)
    S = common.np_sqrt_info_from_cov(cov)
    np.testing.assert_array_equal(S, j_np_sqrt_info_from_cov(cov))
    np.testing.assert_allclose(S.T @ S @ (cov + 1e-12 * np.eye(15)), np.eye(15), atol=1e-8)
    np.testing.assert_allclose(S, graph.sqrt_info_from_cov(torch.as_tensor(cov)).numpy(), rtol=1e-9,
                               atol=1e-9 * np.abs(S).max())
    sig = rng.uniform(0.01, 1.0, 6)
    np.testing.assert_array_equal(common.np_sqrt_info_from_sigmas(sig), np.diag(1.0 / sig))
    np.testing.assert_array_equal(graph.sqrt_info_from_sigmas(torch.as_tensor(sig)).numpy(),
                                  np.asarray(jgraph.sqrt_info_from_sigmas(jnp.asarray(sig))))
    cov6 = rng.normal(size=(6, 6))
    out = graph.reorder_covariance_trans_rot(torch.as_tensor(cov6)).numpy()
    np.testing.assert_array_equal(out, np.asarray(jgraph.reorder_covariance_trans_rot(jnp.asarray(cov6))))


def test_window_state_and_empty_factors_match_reference():
    """WindowState.identity, its retract and empty_factors, field for field."""
    rng = np.random.default_rng(5)
    delta = rng.normal(scale=0.3, size=(5, 15))
    jstate = jgraph.WindowState.identity(5)
    state = graph.WindowState.identity(5)
    assert state.window == 5
    for a, b in ((state, jstate), (state.retract(torch.as_tensor(delta)), jstate.retract(jnp.asarray(delta)))):
        for name in graph.WindowState._fields:
            np.testing.assert_allclose(getattr(a, name).numpy(), np.asarray(getattr(b, name)), rtol=0,
                                       atol=1e-12, err_msg=name)
    ref = interop.factors_from_numpy(jgraph.empty_factors(3, 2, 3, 1, 2, 1))
    out = graph.empty_factors(3, 2, 3, 1, 2, 1)
    for name in graph.Factors._fields:
        a, b = getattr(out, name), getattr(ref, name)
        for x, y in zip(a if name != "gravity" else [a], b if name != "gravity" else [b]):
            assert x.dtype == y.dtype and torch.equal(x, y), name
