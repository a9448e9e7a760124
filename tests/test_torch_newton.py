"""The Newton driver and the VGICP pair kernel (B2) of the port against the
reference, on the CPU (the port runs the pair kernels' plain versions; the
reference runs its Pallas kernel in interpret mode).

- B2's plain version against ``fused_objective(..., gicp=True,
  interpret=True)`` on the test_torch_fused.py fixture (N = 4096):
  n_contrib exact, score rtol 2e-6, grad rtol 1e-4 / atol 1e-2, Hessian
  rtol 1e-4 / atol 1e-1 (the reference's own fused-kernel tolerances,
  tests/test_regmap.py: the two sum ~29k pair terms in another float32
  order).
- ``newton_align_fused`` (NDT) and ``gicp_align_fused`` against the same
  reference functions from the same offset initial pose, at inner_iters 1
  and 2, final_eval False and True, on a three-plane scene (every dof
  observed). A small staleness budget makes the inner steps freeze and
  resume. Iterations and ``converged`` equal, pose within 1e-5 m /
  1e-5 rad, Hessian within rtol 1e-3 (plus atol 1e-3 of its largest entry,
  for entries that cancel).
- ``regularize_step`` on the toy problem of its docstring.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamtpu.core import se3 as jse3
from slamtpu.mapping import gaussian_map as jgm
from slamtpu.ndt import NewtonConfig as JNewtonConfig
from slamtpu.ndt import build_regmap as jbuild_regmap
from slamtpu.ndt import gauss_constants
from slamtpu.ndt import score_grad_hess_fused as jscore_grad_hess_fused
from slamtpu.ndt import gicp_map as jgicp_map
from slamtpu.ndt.pallas_math import fused_objective
from slamtpu.ndt.pallas_math import newton_align_fused
from slamtpu_torch import interop
from slamtpu_torch.core import se3
from slamtpu_torch.ndt import fused_math, gicp
from slamtpu_torch.ndt.newton import NewtonConfig, regularize_step
from tests.oracles import two_plane_cloud
from tests.test_torch_fused import RES, inputs  # noqa: F401  (the shared fixture)

torch.set_num_threads(1)
GRID = (64, 64, 32)
N = 4096
# jitted, so that the reference's interpret-mode kernel is traced once per
# configuration (eager calls re-trace it at every evaluation)
jfused = jax.jit(fused_objective, static_argnames=("gicp", "interpret"))
jnewton = jax.jit(newton_align_fused, static_argnames=(
    "cfg", "grid_shape", "inner_iters", "interpret", "final_eval", "_gicp"))


def _check_objective(a, b):
    assert int(a.n_contrib) == int(b.n_contrib) > 0
    np.testing.assert_allclose(float(a.score), float(b.score), rtol=2e-6)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(b.grad), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(a.hess.numpy(), np.asarray(b.hess), rtol=1e-4, atol=1e-1)


def test_gicp_plain_matches_pallas(inputs):  # noqa: F811
    """B2 on the NDT fixture's rows (the icov slots stand in for the VGICP
    map's (C + s^2 I)^-1: the cost reads them the same way)."""
    pts, megaT, _, _ = inputs
    rng = np.random.default_rng(7)
    xi = rng.normal(scale=[0.01, 0.01, 0.02, 0.05, 0.05, 0.05], size=(3, 6))
    poses = jse3.expmap(jnp.asarray(xi, jnp.float32))
    for i in range(3):
        rot, trans = np.asarray(poses.rot[i]), np.asarray(poses.trans[i])
        for corr2 in (25.0, 0.04):  # the 5 m default gate, and one that bites
            b = jfused(jnp.asarray(pts.T), jnp.asarray(megaT), jse3.Pose3(jnp.asarray(rot), jnp.asarray(trans)),
                       0.0, corr2, 1e-6, gicp=True, gicp_max_mahal=9.0, interpret=True)
            a = fused_math.fused_objective(torch.as_tensor(pts.T.copy()), torch.as_tensor(megaT),
                                           interop.pose_from_numpy(rot, trans), 0.0, corr2, 1e-6,
                                           gicp=True, gicp_max_mahal=9.0)
            _check_objective(a, b)


def _box_cloud(extent, pitch):
    """Three perpendicular planes (a box corner): every dof is observed."""
    two = two_plane_cloud(extent=extent, pitch=pitch)
    ax = np.arange(0.0, extent, pitch)
    g1, g2 = np.meshgrid(ax, ax, indexing="ij")
    xz = np.stack([g1.ravel(), np.zeros(g1.size), g2.ravel()], axis=-1)
    return np.concatenate([two, xz])


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(11)
    target = (_box_cloud(6.0, 0.15) + rng.normal(scale=0.02, size=(3 * 40 * 40, 3))).astype(np.float32)
    origin = (np.floor(target.min(0)) - 8.0).astype(np.float32)
    gmap = jgm.build_map(jnp.asarray(target), jnp.ones(len(target), bool), jnp.asarray(origin), RES,
                         capacity=2048)
    maps = {"ndt": jbuild_regmap(gmap, grid_shape=GRID), "gicp": jbuild_regmap(jgicp_map(gmap), grid_shape=GRID)}
    src = _box_cloud(6.0, 0.25) + rng.normal(scale=0.01, size=(3 * 24 * 24, 3))
    pts = np.zeros((N, 3), np.float32)
    pts[: len(src)] = src
    mask = np.zeros(N, bool)
    mask[: len(src)] = True
    init_xi = np.array([0.02, -0.03, 0.05, 0.2, -0.15, 0.1])
    init = jse3.cast(jse3.expmap(jnp.asarray(init_xi)), jnp.float32)
    return maps, pts, mask, init


def _regmap_fields(regmap):
    return {k: (None if v is None else np.asarray(v)) for k, v in regmap._asdict().items()}


@pytest.mark.parametrize("mode", ["ndt", "gicp"])
@pytest.mark.parametrize("inner_iters", [1, 2])
def test_newton_matches_reference(scene, mode, inner_iters):
    maps, pts, mask, init = scene
    jcfg = JNewtonConfig(resolution=float(RES), max_iterations=30, trans_eps=1e-4,
                         gather_stale_frac=0.1)
    tcfg = interop.newton_config_from_reference(jcfg)
    assert tcfg == NewtonConfig(**jcfg._asdict())
    tmap = interop.regmap_from_numpy(_regmap_fields(maps[mode]))
    tinit = interop.pose_from_numpy(np.asarray(init.rot), np.asarray(init.trans))
    results = {}
    for final_eval in (False, True):
        b = jnewton(jnp.asarray(pts), jnp.asarray(mask), maps[mode], init, cfg=jcfg, grid_shape=GRID,
                    inner_iters=inner_iters, interpret=True, final_eval=final_eval, _gicp=mode == "gicp")
        args = (torch.as_tensor(pts), torch.as_tensor(mask), tmap, tinit, tcfg, GRID, inner_iters)
        if mode == "ndt":
            a = fused_math.newton_align_fused(*args, final_eval=final_eval)
        elif not final_eval:
            a = fused_math.gicp_align_fused(*args)
        else:  # gicp_align_fused keeps the default contract
            a = fused_math.newton_align_fused(*args, final_eval=True, _gicp=True)
        assert int(a.iterations) == int(b.iterations)
        assert bool(a.converged) == bool(b.converged) is True
        np.testing.assert_allclose(a.pose.trans.numpy(), np.asarray(b.pose.trans), atol=1e-5)
        dR = np.asarray(b.pose.rot, np.float64).T @ a.pose.rot.numpy().astype(np.float64)
        assert np.linalg.norm([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]]) / 2 < 1e-5
        H = np.asarray(b.hessian)
        np.testing.assert_allclose(a.hessian.numpy(), H, rtol=1e-3, atol=1e-3 * np.abs(H).max())
        np.testing.assert_allclose(float(a.score), float(b.score), rtol=1e-4)
        assert int(a.n_contrib) == int(b.n_contrib)
        results[final_eval] = a
    # final_eval does not perturb the optimization, only the evaluation
    assert torch.equal(results[False].pose.trans, results[True].pose.trans)
    assert int(results[False].iterations) == int(results[True].iterations)


def test_newton_registers_and_counts_host_reads(scene):
    """From the offset start the port recovers the identity pose, and its
    loop reads the device state once per outer iteration."""
    maps, pts, mask, init = scene
    tmap = interop.regmap_from_numpy(_regmap_fields(maps["ndt"]))
    tinit = interop.pose_from_numpy(np.asarray(init.rot), np.asarray(init.trans))
    before = fused_math.HOST_READS["newton"]
    res = fused_math.newton_align_fused(torch.as_tensor(pts), torch.as_tensor(mask), tmap, tinit,
                                        NewtonConfig(resolution=float(RES), max_iterations=30), GRID)
    assert bool(res.converged)
    assert float(torch.linalg.vector_norm(res.pose.trans)) < 0.02
    assert fused_math.HOST_READS["newton"] - before == int(res.iterations)  # inner_iters=1


def test_score_grad_hess_fused_matches_reference(scene):
    """The gather + NDT pair kernel at the offset start pose."""
    maps, pts, mask, init = scene
    d1, d2, _ = gauss_constants(float(RES), 0.55)
    b = jscore_grad_hess_fused(jnp.asarray(pts), jnp.asarray(mask), init, maps["ndt"], d1, d2, GRID)
    a = fused_math.score_grad_hess_fused(
        torch.as_tensor(pts), torch.as_tensor(mask),
        interop.pose_from_numpy(np.asarray(init.rot), np.asarray(init.trans)),
        interop.regmap_from_numpy(_regmap_fields(maps["ndt"])), d1, d2, GRID)
    _check_objective(a, b)


def test_gicp_map_matches_reference(scene):
    maps, _, _, _ = scene
    rng = np.random.default_rng(3)
    pts = rng.normal(scale=2.0, size=(3000, 3)).astype(np.float32)
    origin = np.full(3, -10.0, np.float32)
    jmap = jgm.build_map(jnp.asarray(pts), jnp.ones(3000, bool), jnp.asarray(origin), RES, capacity=1024,
                         min_points_per_voxel=4)
    tmap = interop.gaussian_map_from_numpy({k: np.asarray(v) for k, v in jmap._asdict().items()})
    a = gicp.gicp_map(tmap, 0.05)
    b = jgicp_map(jmap, 0.05)
    assert int(np.asarray(jmap.valid).sum()) > 20
    np.testing.assert_allclose(a.icov.numpy(), np.asarray(b.icov), rtol=1e-5,
                               atol=1e-5 * float(np.abs(np.asarray(b.icov)).max()))
    assert not a.icov[~a.valid].any()


def test_regularize_step_toy():
    """Data optimum 1.0, prior 0, h = 4, w = 1: the penalized Newton step
    from 0 lands at 0.8 (the score is maximized: H = -h)."""
    cfg = NewtonConfig(reg_weight=1.0)
    pose = se3.expmap(torch.zeros(6, dtype=torch.float64))
    h = 4.0
    grad = torch.zeros(6, dtype=torch.float64)
    grad[3] = h * 1.0  # d score / dx at x = 0 for score = -h/2 (x - 1)^2
    hess = -h * torch.eye(6, dtype=torch.float64)
    g, H = regularize_step(pose, grad, hess, torch.tensor(1), cfg, reg_pose=pose)
    step = torch.linalg.solve(H, -g)
    np.testing.assert_allclose(float(step[3]), 0.8, rtol=1e-12)
    # no penalty without a prior pose or with zero weight
    assert regularize_step(pose, grad, hess, torch.tensor(1), NewtonConfig(), pose)[0] is grad
    assert regularize_step(pose, grad, hess, torch.tensor(1), cfg, None)[1] is hess
