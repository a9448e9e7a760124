"""Parity of slamtpu_torch.fusion.pose_graph with slamtpu.fusion.pose_graph
on the CPU.

Graphs are made with numpy from a seed and given to both packages (the
reference's through ``make_graph``, the port's through
``interop.pose_graph_from_numpy`` of the reference's graph).

- The written-out Jacobians (between and prior factors, with inactive
  factors) against ``torch.func.jacfwd`` of the port's own residuals and
  against the reference's ``_linearize``/``_linearize_priors`` (its
  ``jax.jacfwd``): float64, atol 1e-10.
- ``optimize`` on the circle graph of tests/test_fusion.py, on a graph with
  priors and three anchored nodes, and with Huber on and one corrupted
  closure. Float64: poses and ``error`` within 1e-8. Float32: poses within
  1e-4 m / 1e-4 rad (measured: at most ~2e-6 m on these graphs, the two
  packages' float32 roundings in another order through up to 500 CG
  iterations) and ``error`` within rtol 1e-3.
- bench.py's pose-graph construction at 500 poses in float32 (8 GN x 60
  CG, three chained solves, as the benchmark runs it): the end drift after
  within 1e-3 m of the reference's.
- A block whose Cholesky fails (a node no factor touches, under negative
  damping): the reference's NaN runs through its CG into a zero step on
  every node; the port's ``cholesky_ex`` + NaN rule gives the same, poses
  unchanged bit for bit in both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamtpu.core import se3 as jse3
from slamtpu.fusion import PoseGraphConfig as JConfig
from slamtpu.fusion import make_graph as jmake_graph
from slamtpu.fusion import pose_graph as jpg
from slamtpu_torch import interop
from slamtpu_torch.core import se3
from slamtpu_torch.core.se3 import Pose3
from slamtpu_torch.fusion import pose_graph as pg

torch.set_num_threads(1)
j_optimize = jax.jit(jpg.optimize, static_argnames=("cfg",))
F64 = dict(atol=1e-8, rtol=0.0)
F32_M, F32_RAD = 1e-4, 1e-4


def _exp(xi):
    p = se3.expmap(torch.as_tensor(np.asarray(xi, np.float64)))
    return p.rot.numpy(), p.trans.numpy()


def _chain(rel_R, rel_t, R0, t0):
    R, t = [R0], [t0]
    for a, b in zip(rel_R, rel_t):
        t.append(t[-1] + R[-1] @ b)
        R.append(R[-1] @ a)
    return np.stack(R), np.stack(t)


def _between(Ra, ta, Rb, tb):
    return np.einsum("nji,njk->nik", Ra, Rb), np.einsum("nji,nj->ni", Ra, tb - ta)


def circle_graph(rng, n=16, priors=False, anchored=(0,), corrupt=False):
    """The square loop of tests/test_fusion.py: n poses on a circle, a noisy
    odometry chain and one exact closure n-1 -> 0 at 10x information; with
    ``priors``, noisy absolute priors on every other node; with
    ``corrupt``, a second closure 0 -> n/2 that is 2 m off (at 10 I)."""
    step_R, step_t = _exp([0.0, 0.0, 2 * np.pi / n, 2.0, 0.0, 0.0])
    gt_R, gt_t = _chain([step_R] * (n - 1), [step_t] * (n - 1), np.eye(3), np.zeros(3))
    noise = rng.normal(size=(n - 1, 6)) * np.array([0.002] * 3 + [0.03] * 3)
    rel_R, rel_t = _between(gt_R[:-1], gt_t[:-1], gt_R[1:], gt_t[1:])
    nR, nt = zip(*(_exp(x) for x in noise))
    rel_R, rel_t = rel_R @ np.stack(nR), rel_t + np.einsum("nij,nj->ni", rel_R, np.stack(nt))
    init_R, init_t = _chain(rel_R, rel_t, gt_R[0], gt_t[0])
    i, j = list(range(n - 1)) + [n - 1], list(range(1, n)) + [0]
    lR, lt = _between(gt_R[[n - 1]], gt_t[[n - 1]], gt_R[[0]], gt_t[[0]])
    R_all, t_all = np.concatenate([rel_R, lR]), np.concatenate([rel_t, lt])
    # with a corrupt closure, odometry at about its noise (30 I), so that
    # the optimum leaves the corrupt closure beyond the Huber threshold
    si = np.tile(np.eye(6), (n, 1, 1)) * (30.0 if corrupt else 1.0)
    si[n - 1] *= 10.0
    if corrupt:
        cR, ct = _between(gt_R[[0]], gt_t[[0]], gt_R[[n // 2]], gt_t[[n // 2]])
        i, j = i + [0], j + [n // 2]
        R_all, t_all = np.concatenate([R_all, cR]), np.concatenate([t_all, ct + [2.0, 0.0, 0.0]])
        si = np.concatenate([si, 10.0 * np.eye(6)[None]])
    g = dict(poses=(init_R, init_t), i=np.asarray(i), j=np.asarray(j), rel=(R_all, t_all), si=si,
             anchored=np.isin(np.arange(n), anchored), active=np.ones(len(i), bool))
    if priors:
        pn = rng.normal(size=(n, 6)) * np.array([0.01] * 3 + [0.1] * 3)
        pR, pt = zip(*(_exp(x) for x in pn))
        g["prior"] = (gt_R @ np.stack(pR), gt_t + np.stack(pt))
        g["prior_si"] = np.tile(np.diag(1.0 / np.array([0.01] * 3 + [0.1] * 3)), (n, 1, 1))
        g["prior_active"] = np.arange(n) % 2 == 1
        g["active"][2] = False  # and one inactive odometry factor
    return g, (gt_R, gt_t)


def reference_graph(g, dtype):
    def P(rt):
        return jse3.Pose3(jnp.asarray(rt[0], dtype), jnp.asarray(rt[1], dtype))

    prior = P(g["prior"]) if "prior" in g else None
    return jmake_graph(
        P(g["poses"]), jnp.asarray(g["i"]), jnp.asarray(g["j"]), P(g["rel"]),
        jnp.asarray(g["si"], dtype), active=jnp.asarray(g["active"]), anchored=jnp.asarray(g["anchored"]),
        prior=prior, prior_sqrt_info=None if prior is None else jnp.asarray(g["prior_si"], dtype),
        prior_active=None if prior is None else jnp.asarray(g["prior_active"]))


def both(g, dtype, cfg: JConfig):
    jg = reference_graph(g, dtype)
    ref = j_optimize(jg, cfg)
    res = pg.optimize(interop.pose_graph_from_numpy(jg), pg.PoseGraphConfig(**cfg._asdict()))
    return ref, res


def _rot_err(Ra, Rb):
    dR = np.einsum("nji,njk->nik", Ra, Rb)
    W = 0.5 * (dR - dR.transpose(0, 2, 1))
    return np.linalg.norm(np.stack([W[:, 2, 1], W[:, 0, 2], W[:, 1, 0]], -1), axis=-1).max()


def test_interop_graph_fields():
    g, _ = circle_graph(np.random.default_rng(1), priors=True)
    jg = reference_graph(g, jnp.float64)
    tg = interop.pose_graph_from_numpy(jg)
    assert tg.i.dtype == torch.int32 and tg.active.dtype == torch.bool
    assert tg.poses.trans.dtype == torch.float64 and tg.num_nodes == 16
    for k in ("rel_rot", "sqrt_info", "anchored", "prior_trans", "prior_active"):
        np.testing.assert_array_equal(getattr(tg, k).numpy(), np.asarray(getattr(jg, k)))


def test_jacobians_match_jacfwd_and_reference():
    g, _ = circle_graph(np.random.default_rng(2), priors=True)
    jg = reference_graph(g, jnp.float64)
    tg = interop.pose_graph_from_numpy(jg)
    N, F = tg.num_nodes, tg.i.shape[0]
    r, Ji, Jj = pg._linearize(tg)
    rp, Jp = pg._linearize_priors(tg)
    jr, jJi, jJj = jax.jit(jpg._linearize)(jg)
    jrp, jJp = jax.jit(jpg._linearize_priors)(jg)
    tol = dict(atol=1e-10, rtol=0.0)
    for a, b in ((r, jr), (Ji, jJi), (Jj, jJj), (rp, jrp), (Jp, jJp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
    assert not Ji[2].any() and not Jj[2].any() and not Jp[0].any()  # inactive: exact zeros

    def residuals(d):
        moved = tg._replace(poses=se3.retract(tg.poses, d.reshape(N, 6)))
        return torch.cat([pg._linearize(moved)[0].reshape(-1), pg._linearize_priors(moved)[0].reshape(-1)])

    J_fwd = torch.func.jacfwd(residuals)(torch.zeros(N * 6, dtype=torch.float64)).reshape(F + N, 6, N, 6)
    dense = torch.zeros_like(J_fwd)
    for f in range(F):
        dense[f, :, int(tg.i[f])] += Ji[f]
        dense[f, :, int(tg.j[f])] += Jj[f]
    for k in range(N):
        dense[F + k, :, k] = Jp[k]
    np.testing.assert_allclose(dense.numpy(), J_fwd.numpy(), **tol)


CASES = {
    "circle": dict(),
    "priors_anchored": dict(priors=True, anchored=(0, 5, 11)),
    "huber_corrupt_closure": dict(corrupt=True),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_optimize_matches_reference(case, dtype):
    g, (gt_R, gt_t) = circle_graph(np.random.default_rng(3), **CASES[case])
    cfg = JConfig(gn_iterations=10, cg_iterations=40, huber_delta=2.0 if "huber" in case else 0.0)
    ref, res = both(g, getattr(jnp, dtype), cfg)
    R, t = res.poses.rot.numpy(), res.poses.trans.numpy()
    jR, jt = np.asarray(ref.poses.rot), np.asarray(ref.poses.trans)
    assert res.poses.trans.dtype == getattr(torch, dtype)
    assert int(res.iterations) == 10
    if dtype == "float64":
        np.testing.assert_allclose(t, jt, **F64)
        np.testing.assert_allclose(R, jR, **F64)
        np.testing.assert_allclose(float(res.error), float(ref.error), **F64)
    else:
        print(f"{case} float32: max {np.abs(t - jt).max():.3g} m, {_rot_err(R, jR):.3g} rad")
        assert np.abs(t - jt).max() <= F32_M and _rot_err(R, jR) <= F32_RAD
        np.testing.assert_allclose(float(res.error), float(ref.error), rtol=1e-3)
    # anchored nodes do not move; the solve improves on the odometry chain
    anchored = g["anchored"]
    np.testing.assert_array_equal(t[anchored], g["poses"][1][anchored].astype(dtype))
    init_err = np.linalg.norm(g["poses"][1][-1] - gt_t[-1])
    if case == "circle":
        assert np.linalg.norm(t[-1] - gt_t[-1]) < 0.5 * init_err


def test_huber_downweights_the_corrupt_closure():
    g, (gt_R, gt_t) = circle_graph(np.random.default_rng(3), corrupt=True)
    cfg = JConfig(gn_iterations=10, cg_iterations=40)
    plain = both(g, jnp.float64, cfg)[1]
    robust = both(g, jnp.float64, cfg._replace(huber_delta=2.0))[1]
    err = [np.abs(r.poses.trans.numpy() - gt_t).max() for r in (plain, robust)]
    assert err[1] < err[0], err


def test_consistent_graph_zero_error():
    rng = np.random.default_rng(4)
    N = 5
    R, t = zip(*(_exp(rng.normal(size=6) * 0.3) for _ in range(N)))
    R, t = np.stack(R), np.stack(t)
    rR, rt = _between(R[:-1], t[:-1], R[1:], t[1:])
    g = dict(poses=(R, t), i=np.arange(N - 1), j=np.arange(1, N), rel=(rR, rt),
             si=np.tile(np.eye(6), (N - 1, 1, 1)), anchored=np.arange(N) == 0, active=np.ones(N - 1, bool))
    ref, res = both(g, jnp.float64, JConfig(gn_iterations=3, cg_iterations=20))
    assert float(res.error) < 1e-20 and float(ref.error) < 1e-20


def bench_graph(n_poses, seed=7):
    """bench.py:43-96's graph in numpy (float64 closed forms, the odometry
    noise applied by the port's float64 retract), cast to float32."""
    rng = np.random.default_rng(seed)
    radius = 500.0
    yaw = 2 * np.pi * np.arange(n_poses) / n_poses
    gt_t = np.stack([radius * np.sin(yaw), radius * (1 - np.cos(yaw)), np.zeros(n_poses)], -1)
    cy, sy, z, o = np.cos(yaw), np.sin(yaw), np.zeros(n_poses), np.ones(n_poses)
    gt_R = np.stack([np.stack([cy, -sy, z], -1), np.stack([sy, cy, z], -1), np.stack([z, z, o], -1)], 1)
    rel_R, rel_t = _between(gt_R[:-1], gt_t[:-1], gt_R[1:], gt_t[1:])
    noise = rng.normal(size=(n_poses - 1, 6)) * np.array([1e-4] * 3 + [3e-3] * 3)
    rel = se3.retract(Pose3(torch.as_tensor(rel_R), torch.as_tensor(rel_t)), torch.as_tensor(noise))
    rel_R, rel_t = rel.rot.numpy(), rel.trans.numpy()
    init_R, init_t = _chain(rel_R, rel_t, gt_R[0], gt_t[0])
    n_mid = 150 if n_poses > 1000 else 15
    li_mid = rng.integers(0, n_poses - n_poses // 10, n_mid)
    lj_mid = li_mid + rng.integers(n_poses // 20, n_poses // 10 - 1, n_mid)
    li_end = rng.integers(0, 50, 50)
    lj_end = n_poses - 50 + rng.integers(0, 50, 50)
    li, lj = np.concatenate([li_mid, li_end]), np.concatenate([lj_mid, lj_end])
    lR, lt = _between(gt_R[li], gt_t[li], gt_R[lj], gt_t[lj])
    i = np.concatenate([np.arange(n_poses - 1), li])
    j = np.concatenate([np.arange(1, n_poses), lj])
    return dict(poses=(init_R, init_t), i=i, j=j, rel=(np.concatenate([rel_R, lR]), np.concatenate([rel_t, lt])),
                si=np.tile(100.0 * np.eye(6), (len(i), 1, 1)), anchored=np.arange(n_poses) == 0,
                active=np.ones(len(i), bool)), (gt_R, gt_t)


def test_bench_graph_500_poses_float32():
    g, (gt_R, gt_t) = bench_graph(500)
    cfg = JConfig(gn_iterations=8, cg_iterations=60)
    jg = reference_graph(g, jnp.float32)
    tg = interop.pose_graph_from_numpy(jg)
    tcfg = pg.PoseGraphConfig(**cfg._asdict())
    for _ in range(3):  # chained, as bench.py times it
        ref = j_optimize(jg, cfg)
        jg = jg._replace(poses=ref.poses)
        res = pg.optimize(tg, tcfg)
        tg = tg._replace(poses=res.poses)
    before = np.linalg.norm(g["poses"][1][-1].astype(np.float32) - gt_t[-1].astype(np.float32))
    after = {"reference": float(np.linalg.norm(np.asarray(ref.poses.trans[-1]) - gt_t[-1].astype(np.float32))),
             "port": float(np.linalg.norm(res.poses.trans[-1].numpy() - gt_t[-1].astype(np.float32)))}
    print(f"500 poses: end drift {before:.4f} m before, after {after}")
    assert after["reference"] < 0.2 * before
    assert abs(after["port"] - after["reference"]) <= 1e-3


def test_failed_block_gets_the_reference_zero_step():
    g, _ = circle_graph(np.random.default_rng(5))
    n = 16
    # one more node that no factor touches: under negative damping its
    # diagonal block is -I, which no Cholesky factors
    g["poses"] = tuple(np.concatenate([a, a[-1:]]) for a in g["poses"])
    g["anchored"] = np.arange(n + 1) == 0
    cfg = JConfig(gn_iterations=3, cg_iterations=10, damping=-1.0)
    for dtype in ("float64", "float32"):
        ref, res = both(g, getattr(jnp, dtype), cfg)
        init = g["poses"][1].astype(dtype)
        np.testing.assert_array_equal(np.asarray(ref.poses.trans), init)
        np.testing.assert_array_equal(res.poses.trans.numpy(), init)
        np.testing.assert_allclose(float(res.error), float(ref.error), rtol=1e-6)
