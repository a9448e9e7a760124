"""The pieces of odom_ndt's anisotropic GICP and NDT_OMP_MULTIRES engines,
port against reference, on the CPU.

``gicp_map_aniso`` (within 1e-6), the sort-based
``source_point_covariances`` (within 1e-5 of the largest entry, with the
sparse-voxel and capacity fallbacks and non-finite points), one
plane-to-plane evaluation (the plain B3 on ``grid_rows``) against the
reference's XLA objective and its Pallas kernel in interpret mode (the
tolerances of tests/test_torch_fused.py), ``gicp_align_aniso`` against the
reference's Newton loop, and ``multires_align`` against the reference's
pyramid (pose within 1e-4 m / 1e-4 rad, iterations within 1). The
keyframes of the engines are in tests/test_torch_odom_engines.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamtpu.core import se3 as jse3
from slamtpu.mapping import gaussian_map as jgm
from slamtpu.ndt import NewtonConfig as JNewtonConfig
from slamtpu.ndt import build_regmap as jbuild_regmap
from slamtpu.ndt import gicp as jgicp
from slamtpu.ndt import multires as jmultires
from slamtpu.ndt.pallas_math import fused_objective as jfused
from slamtpu.ndt.pallas_math import gather_megaT as jgather
from slamtpu_torch import interop
from slamtpu_torch.ndt import fused_math, gicp, multires
from slamtpu_torch.ndt.regmap import grid_rows
from tests.test_torch_lo_svn import _assert_pose_close
from tests.test_torch_newton import _box_cloud, _check_objective, _regmap_fields

torch.set_num_threads(1)
RES = np.float32(1.0)
GRID = (64, 64, 32)
N = 4096

@pytest.fixture(scope="module")
def scene():
    """A box-corner target as a plane-to-plane RegMap (both packages), and
    a box-corner source with its voxel covariances, offset from the
    target."""
    rng = np.random.default_rng(13)
    target = (_box_cloud(6.0, 0.15) + rng.normal(scale=0.02, size=(3 * 40 * 40, 3))).astype(np.float32)
    origin = (np.floor(target.min(0)) - 8.0).astype(np.float32)
    gmap = jgm.build_map(jnp.asarray(target), jnp.ones(len(target), bool), jnp.asarray(origin), RES,
                         capacity=2048, min_points_per_voxel=4)
    jregmap = jbuild_regmap(jgicp.gicp_map_aniso(gmap), grid_shape=GRID)
    src = _box_cloud(6.0, 0.25) + rng.normal(scale=0.01, size=(3 * 24 * 24, 3))
    pts = np.zeros((N, 3), np.float32)
    pts[: len(src)] = src
    mask = np.zeros(N, bool)
    mask[: len(src)] = True
    scov = np.array(jgicp.source_point_covariances(jnp.asarray(pts), jnp.asarray(mask), RES, capacity=1024))
    init_xi = np.array([0.01, -0.02, 0.03, 0.15, -0.1, 0.08])
    init = jse3.cast(jse3.expmap(jnp.asarray(init_xi)), jnp.float32)
    return dict(gmap=gmap, jregmap=jregmap, regmap=interop.regmap_from_numpy(_regmap_fields(jregmap)),
                pts=pts, mask=mask, scov=scov, init=init, target=target, origin=origin,
                tinit=interop.pose_from_numpy(np.asarray(init.rot), np.asarray(init.trans)))


def test_gicp_map_aniso_matches_reference(scene):
    jmap = scene["gmap"]
    tmap = interop.gaussian_map_from_numpy({k: np.asarray(v) for k, v in jmap._asdict().items()})
    a = gicp.gicp_map_aniso(tmap)
    b = jgicp.gicp_map_aniso(jmap)
    assert 20 < int(np.asarray(jmap.valid).sum()) < jmap.keys.shape[0]
    np.testing.assert_allclose(a.icov.numpy(), np.asarray(b.icov), rtol=0, atol=1e-6)
    assert not a.icov[~a.valid].any()
    for k in ("mean", "cov", "valid"):  # the rest of the map is untouched
        assert torch.equal(getattr(a, k), getattr(tmap, k))


@pytest.mark.parametrize("case", ["dense", "sparse", "nonfinite"])
def test_source_point_covariances_matches_reference(scene, case):
    pts, mask = scene["pts"].copy(), scene["mask"].copy()
    kw = dict(capacity=1024, min_points_per_voxel=4)
    if case == "sparse":  # most voxels below the point floor, the rest past capacity
        kw = dict(capacity=40, min_points_per_voxel=12)
    elif case == "nonfinite":
        pts[[3, 50, 700]] = [np.nan, 1.0, 2.0], [np.inf, 0.0, 0.0], [0.0, -np.inf, np.nan]
        mask[[3, 50, 700]] = True
    a = gicp.source_point_covariances(torch.as_tensor(pts), torch.as_tensor(mask), RES, **kw).numpy()
    b = np.asarray(jgicp.source_point_covariances(jnp.asarray(pts), jnp.asarray(mask), RES, **kw))
    assert a.shape == b.shape == (N, 3, 3) and np.isfinite(a).all()
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())
    # the points that took the isotropic fallback
    iso = np.all(np.isclose(a, np.float32(0.05 ** 2) * np.eye(3), rtol=0, atol=1e-9), axis=(1, 2))
    assert iso[~mask].all()  # masked points take the fallback
    if case == "sparse":
        assert iso[mask].mean() > 0.5 and not iso[mask].all()
    else:
        assert iso[mask].mean() < 0.5
    if case == "nonfinite":
        assert iso[[3, 50, 700]].all()


def test_aniso_objective_matches_reference(scene):
    """One plane-to-plane evaluation: the port's row lookup + plain B3
    against the reference's XLA objective and against its Pallas kernel in
    interpret mode on the pre-gathered rows of the same pose."""
    pts, mask, scov = scene["pts"], scene["mask"], scene["scov"]
    pose, tpose = scene["init"], scene["tinit"]
    scovT = torch.as_tensor(scov.reshape(N, 9).T.copy())
    for corr in (5.0, 0.3):  # the default gate, and one that bites
        rows = grid_rows(torch.as_tensor(pts), torch.as_tensor(mask), tpose, scene["regmap"], GRID)
        a = fused_math.rows_objective(torch.as_tensor(pts.T.copy()), scene["regmap"].packed, rows, tpose,
                                      0.0, corr * corr, 1e-6, src_covT=scovT)
        b_xla = jgicp.score_grad_hess_gicp_aniso(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(scov),
                                                  pose, scene["jregmap"], GRID, 1e-6, max_corr_dist=corr)
        megaT = jgather(jnp.asarray(pts), jnp.asarray(mask), pose, scene["jregmap"], GRID)
        b_pallas = jfused(jnp.asarray(pts.T), megaT, pose, 0.0, corr * corr, 1e-6, interpret=True,
                          src_covT=jnp.asarray(scovT.numpy()))
        _check_objective(a, b_pallas)
        _check_objective(a, b_xla)


def test_gicp_align_aniso_matches_reference(scene):
    jcfg = JNewtonConfig(resolution=float(RES), max_iterations=30, trans_eps=1e-4, gicp_aniso=True)
    tcfg = interop.newton_config_from_reference(jcfg)
    pts, mask, scov = scene["pts"], scene["mask"], scene["scov"]
    b = jgicp.gicp_align_aniso(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(scov), scene["jregmap"],
                               scene["init"], jcfg, GRID)
    before = dict(fused_math.LAUNCHES)
    a = fused_math.gicp_align_aniso(torch.as_tensor(pts), torch.as_tensor(mask), torch.as_tensor(scov),
                                    scene["regmap"], scene["tinit"], tcfg, GRID)
    assert fused_math.LAUNCHES == before  # CPU tensors: the plain version
    assert bool(a.converged) == bool(b.converged) is True
    assert abs(int(a.iterations) - int(b.iterations)) <= 1
    _assert_pose_close(a.pose.rot.numpy(), a.pose.trans.numpy(), np.asarray(b.pose.rot),
                       np.asarray(b.pose.trans), atol_m=1e-5, atol_rad=1e-5)
    assert float(torch.linalg.vector_norm(a.pose.trans)) < 0.02  # registered from the offset start
    H = np.asarray(b.hessian)
    np.testing.assert_allclose(a.hessian.numpy(), H, rtol=1e-3, atol=1e-3 * np.abs(H).max())
    np.testing.assert_allclose(float(a.score), float(b.score), rtol=1e-4)
    assert int(a.n_contrib) == int(b.n_contrib)


def test_multires_align_matches_reference(scene):
    target, origin = scene["target"], scene["origin"]
    tmask = np.ones(len(target), bool)
    kw = dict(resolutions=[2.0 * RES, RES], capacity=2048, grid_shape=GRID, min_points_per_voxel=4,
              max_iterations=[10, 30])
    jlevels = jmultires.build_pyramid(jnp.asarray(target), jnp.asarray(tmask), jnp.asarray(origin), **kw)
    tlevels = multires.build_pyramid(torch.as_tensor(target), torch.as_tensor(tmask),
                                     torch.as_tensor(origin), **kw)
    assert [lv.cfg.resolution for lv in tlevels] == [2.0 * RES, RES]
    assert [lv.cfg.max_iterations for lv in tlevels] == [10, 30]
    for t, j in zip(tlevels, jlevels):
        assert t.cfg == interop.newton_config_from_reference(j.cfg)
        assert int(t.regmap.num_valid) == int(j.regmap.num_valid)
    pts, mask = scene["pts"], scene["mask"]
    b = jmultires.multires_align(jnp.asarray(pts), jnp.asarray(mask), jlevels, scene["init"])
    a = multires.multires_align(torch.as_tensor(pts), torch.as_tensor(mask), tlevels, scene["tinit"])
    assert abs(int(a.iterations) - int(b.iterations)) <= 1
    assert bool(a.converged) == bool(b.converged)
    _assert_pose_close(a.pose.rot.numpy(), a.pose.trans.numpy(), np.asarray(b.pose.rot),
                       np.asarray(b.pose.trans), atol_m=1e-4, atol_rad=1e-4)
    np.testing.assert_allclose(float(a.score), float(b.score), rtol=1e-4)


def test_build_pyramid_rejects_a_length_mismatch(scene):
    target = torch.as_tensor(scene["target"])
    with pytest.raises(ValueError, match="max_iterations"):
        multires.build_pyramid(target, torch.ones(len(target), dtype=torch.bool),
                               torch.as_tensor(scene["origin"]), [2.0, 1.0], 2048, GRID,
                               max_iterations=[10])
