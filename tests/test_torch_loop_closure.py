"""Parity of slamtpu_torch.fusion.loop_closure with slamtpu.fusion.loop_closure
on the CPU, on the pillar scene of tests/test_loop_closure.py (12 pillars on
an 18 m circle, 3000 points a scan, made with numpy from a seed, float32
body-frame points in both packages).

- ``_candidates`` on scripted positions (bucket edges, the temporal gap,
  ties in distance): the same candidate lists, in the same order.
- ``verify_pair`` (the map of candidate k, Newton with one step per lookup
  and the evaluation at the returned pose, which on the CPU runs the NDT
  pair kernel's plain version): the same accept/reject decision, the
  Newton iterations equal, ``n_contrib`` exactly equal and the port's
  objective count at the reference's returned pose equal to the
  reference's XLA objective's there (the contribution-ratio gate reads
  it), relative pose within 1e-4 m / 1e-4 rad, covariance within rtol 1e-3
  of its largest entry, score within rtol 1e-4.
- The whole ``add_keyframe`` sequence of the drifting 30-keyframe circle:
  the same (i, j) closures; ``refine_trajectory`` on the reference's
  closures (``interop.loop_closures_from_reference``) within 1e-7 m and
  1e-7 rad of the reference's refined poses and its error within rtol
  1e-6 (float64 graph; measured 1.2e-8 m, 1.5e-9 rad and 7.5e-8: the
  closures' covariances reach the 1e-9 eigenvalue floor, so the normal
  equations span ~1e9 and the CG's rounding in another summation order
  shows), and on the port's own closures within 1e-4 m.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamtpu.core import se3 as jse3
from slamtpu.fusion import loop_closure as jlc
from slamtpu.ndt.constants import gauss_constants
from slamtpu.ndt.regmap import score_grad_hess_reg
from slamtpu_torch import interop
from slamtpu_torch.core import se3
from slamtpu_torch.core.se3 import Pose3
from slamtpu_torch.fusion import loop_closure as tlc
from slamtpu_torch.ndt import fused_math

torch.set_num_threads(1)
N_KF = 30
CFG = dict(min_keyframe_gap=15, search_radius=8.0, resolution=1.0, max_fitness_error=2.0,
           min_contrib_ratio=0.1)
PILLARS = np.stack([np.cos(np.linspace(0, 2 * np.pi, 13)[:-1]) * 18,
                    np.sin(np.linspace(0, 2 * np.pi, 13)[:-1]) * 18, np.zeros(12)], -1)


def _pose(xi):
    p = se3.expmap(torch.as_tensor(np.asarray(xi, np.float64)))
    return p.rot.numpy(), p.trans.numpy()


def _compose(a, b):
    return a[0] @ b[0], a[0] @ b[1] + a[1]


def _between(a, b):
    return a[0].T @ b[0], a[0].T @ (b[1] - a[1])


def scan(rng, pose, n=3000):
    """Body-frame float32 scan of the pillar field from ``pose`` (numpy)."""
    world = PILLARS[rng.integers(0, 12, n)] + rng.normal(0, 0.4, (n, 3)) * [0.3, 0.3, 1.5]
    body = (world - pose[1]) @ pose[0]
    return body.astype(np.float32), np.ones(n, bool)


@pytest.fixture(scope="module")
def circle():
    return make_circle()


def make_circle():
    """Ground truth on a 10 m circle, the drifting odometry chain, the
    odometry relatives and each keyframe's scan from its true pose."""
    rng = np.random.default_rng(31)
    step = _pose([0.0, 0.0, 2 * np.pi / N_KF, 2 * np.pi * 10 / N_KF, 0.0, 0.0])
    gt = [(np.eye(3), np.zeros(3))]
    for _ in range(N_KF - 1):
        gt.append(_compose(gt[-1], step))
    bias = _pose([0, 0, 0.004, 0.02, 0.01, 0.0])
    rels = [_compose(_between(gt[k], gt[k + 1]), bias) for k in range(N_KF - 1)]
    noisy = [gt[0]]
    for r in rels:
        noisy.append(_compose(noisy[-1], r))
    scans = [scan(rng, g) for g in gt]
    return gt, noisy, rels, scans


def jpose(p):
    return jse3.Pose3(jnp.asarray(p[0]), jnp.asarray(p[1]))


def tpose(p):
    return Pose3(np.asarray(p[0]), np.asarray(p[1]))


def detectors(cfg):
    return jlc.LoopDetector(jlc.LoopClosureConfig(**cfg)), tlc.LoopDetector(tlc.LoopClosureConfig(**cfg))


def test_candidates_on_scripted_positions():
    pos = np.array([[0.0, 0.0, 0.0], [9.9, 0.0, 0.0], [10.1, 0.0, 0.0], [-3.0, 4.0, 0.0],
                    [3.0, -4.0, 0.0], [0.0, 0.0, 12.0], [25.0, 0.0, 0.0], [4.0, 3.0, 0.0],
                    [-4.0, -3.0, 0.5], [1.0, 1.0, 1.0]])
    jdet, tdet = detectors(dict(min_keyframe_gap=10**9, search_radius=6.0))
    for p in pos:  # no candidate can verify: nothing is registered
        assert jdet.add_keyframe(jpose((np.eye(3), p)), None, None) == []
        assert tdet.add_keyframe(tpose((np.eye(3), p)), None, None) == []
    assert {k: list(v) for k, v in jdet.buckets.items()} == dict(tdet.buckets)
    for gap in (1, 3, 6):
        jdet.cfg.min_keyframe_gap = tdet.cfg.min_keyframe_gap = gap
        for q in ([0.0, 0.0, 0.0], [5.0, 0.0, 0.0], [0.5, 0.5, 0.0], [-9.0, -9.0, 0.0]):
            q = np.asarray(q)
            got = tdet._candidates(q, len(pos))
            assert got == jdet._candidates(q, len(pos)), (gap, q)
    # ties (keyframes 3, 4, 7 at 5 m from the origin) keep bucket order
    jdet.cfg.min_keyframe_gap = tdet.cfg.min_keyframe_gap = 1
    ties = [k for k in tdet._candidates(np.zeros(3), len(pos)) if k in (3, 4, 7)]
    assert ties == [k for k in jdet._candidates(np.zeros(3), len(pos)) if k in (3, 4, 7)]
    assert sorted(ties) == [3, 4, 7]


def _rot_err(Ra, Rb):
    dR = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    W = 0.5 * (dR - dR.T)
    return float(np.linalg.norm([W[2, 1], W[0, 2], W[1, 0]]))


@pytest.mark.parametrize("case", ["accepted", "rejected_by_distance", "rejected_by_ratio"])
def test_verify_pair_matches_reference(circle, monkeypatch, case):
    gt, noisy, _rels, scans = circle
    cfg = dict(CFG)
    k, j = 0, N_KF - 1
    guess = noisy[j]
    if case == "rejected_by_distance":
        cfg["max_fitness_error"] = 0.05
    if case == "rejected_by_ratio":
        cfg["min_contrib_ratio"] = 0.9
    jdet, tdet = detectors(cfg)
    jdet.clouds, jdet.poses = [tuple(map(jnp.asarray, scans[k]))], [jpose(noisy[k])]
    tdet.clouds, tdet.poses = [tuple(map(torch.as_tensor, scans[k]))], [tpose(noisy[k])]
    seen = {}
    real_j, real_t = jlc.newton_align_reg, tlc.newton_align_fused

    def spy_j(pts, mask, regmap, *a, **kw):
        seen["ref"] = res = real_j(pts, mask, regmap, *a, **kw)
        seen["ref_regmap"] = regmap
        return res

    def spy_t(pts, mask, regmap, *a, **kw):
        seen["port"] = res = real_t(pts, mask, regmap, *a, **kw)
        seen["port_regmap"] = regmap
        return res

    monkeypatch.setattr(jlc, "newton_align_reg", spy_j)
    monkeypatch.setattr(tlc, "newton_align_fused", spy_t)
    ref = jdet.verify_pair(k, jpose(guess), *map(jnp.asarray, scans[j]))
    out = tdet.verify_pair(k, tpose(guess), *map(torch.as_tensor, scans[j]))
    r, p = seen["ref"], seen["port"]
    assert int(p.iterations) == int(r.iterations)
    assert int(p.n_contrib) == int(r.n_contrib)
    # the gate's count: the port's objective at the reference's pose on the
    # port's map == the reference's XLA objective there on its own map
    pose = jse3.Pose3(r.pose.rot, r.pose.trans)
    d1, d2, _ = gauss_constants(cfg["resolution"], tlc.NewtonConfig().outlier_ratio)
    jobj = score_grad_hess_reg(jnp.asarray(scans[j][0]), jnp.asarray(scans[j][1]), pose, seen["ref_regmap"],
                               d1, d2, tlc.LoopClosureConfig().reg_grid_shape)
    tobj = fused_math.score_grad_hess_fused(
        torch.as_tensor(scans[j][0]), torch.as_tensor(scans[j][1]),
        Pose3(torch.as_tensor(np.array(r.pose.rot)), torch.as_tensor(np.array(r.pose.trans))),
        seen["port_regmap"], d1, d2, tlc.LoopClosureConfig().reg_grid_shape)
    assert int(tobj.n_contrib) == int(jobj.n_contrib) > 0
    assert (out is None) == (ref is None) == (case != "accepted")
    if ref is None:
        return
    assert (out.i, out.j) == (ref.i, ref.j) == (0, 1)
    rel_t, rel_R = out.relative.trans.numpy(), out.relative.rot.numpy()
    assert out.relative.trans.dtype == torch.float32
    assert np.abs(rel_t - np.asarray(ref.relative.trans)).max() <= 1e-4
    assert _rot_err(rel_R, np.asarray(ref.relative.rot)) <= 1e-4
    np.testing.assert_allclose(out.covariance, ref.covariance, rtol=0,
                               atol=1e-3 * np.abs(ref.covariance).max())
    np.testing.assert_allclose(out.score, ref.score, rtol=1e-4)
    # the registration recovers the true relative
    true = _between(gt[k], gt[j])
    assert np.linalg.norm(rel_t - true[1]) < 0.2


def test_sequence_closures_and_refinement_match(circle):
    gt, noisy, rels, scans = circle
    jdet, tdet = detectors(CFG)
    jcl, tcl = [], []
    for k in range(N_KF):
        jcl += jdet.add_keyframe(jpose(noisy[k]), *map(jnp.asarray, scans[k]))
        tcl += tdet.add_keyframe(tpose(noisy[k]), *map(torch.as_tensor, scans[k]))
    assert [(c.i, c.j) for c in tcl] == [(c.i, c.j) for c in jcl]
    assert len(tcl) >= 1 and all(c.j - c.i >= 15 for c in tcl)
    assert len(tdet.verify_ms) >= len(tcl)
    covs = [np.eye(6) * 1e-4 for _ in rels]
    jref, jres = jlc.refine_trajectory([jpose(p) for p in noisy], [jpose(r) for r in rels], covs, jcl)
    t_in = ([tpose(p) for p in noisy], [tpose(r) for r in rels], covs)
    same, res = tlc.refine_trajectory(*t_in, interop.loop_closures_from_reference(jcl), device="cpu")
    own, _ = tlc.refine_trajectory(*t_in, tcl, device="cpu")
    assert res.poses.trans.dtype == torch.float64
    np.testing.assert_allclose(float(res.error), float(jres.error), rtol=1e-6)
    for a, b, c in zip(same, own, jref):
        np.testing.assert_allclose(a.trans.numpy(), np.asarray(c.trans), atol=1e-7, rtol=0)
        assert _rot_err(a.rot.numpy(), np.asarray(c.rot)) <= 1e-7
        assert np.abs(b.trans.numpy() - np.asarray(c.trans)).max() <= 1e-4
    # the refinement pulls the end of the loop back toward the truth
    before = np.linalg.norm(noisy[-1][1] - gt[-1][1])
    after = np.linalg.norm(own[-1].trans.numpy() - gt[-1][1])
    assert after < 0.6 * before, (before, after)


def test_refine_trajectory_checks_the_chain_length(circle):
    _gt, noisy, rels, _ = circle
    with pytest.raises(ValueError, match="odometry factors"):
        tlc.refine_trajectory([tpose(p) for p in noisy], [tpose(r) for r in rels[1:]],
                              [np.eye(6)] * (len(rels) - 1), [], device="cpu")
