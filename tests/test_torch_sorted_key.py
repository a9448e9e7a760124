"""The sorted-key registration path of the port (``voxel.lookup``, the
sorted-key objective, ``newton_align``, ``svn_align``) against the JAX
package's, on the CPU with x64 on.

The scene is tests/test_regmap.py's: a two-plane target posed by a yaw of
15 deg, a pitch of 5 deg and a 0.5 m offset, with 2 cm noise; its Gaussian
map built by the JAX package in float64 and carried into the port
(``interop``); a sparser two-plane source. The same numpy inputs go
through both packages.

Tolerances: the objective in float64 as tests/test_regmap.py:80-95 holds
the reference's RegMap objective to its sorted-key one (``n_contrib``
exact, score rtol 1e-12, gradient and Hessian rtol 1e-10), at three poses
in DIRECT7 and DIRECT1; ``full_hessian`` rtol 1e-8; ``point_jacobian``
rtol 1e-12. ``newton_align`` and ``svn_align`` at tests/test_torch_svn.py's
tolerances (translation 1e-4 m, score rtol 1e-4, covariance diagonal rtol
1e-2), with iteration counts equal and the reference's particle draws
injected. The port's own oracle: its sorted-key objective equals its plain
NDT pair kernel (B1's plain version) on the rows of a RegMap of the same
map, at the objective's tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamtpu.core import se3 as jse3
from slamtpu.core import so3 as jso3
from slamtpu.mapping import gaussian_map as jgm
from slamtpu.mapping import voxel as jvoxel
from slamtpu.ndt import NewtonConfig as JNewtonConfig
from slamtpu.ndt import SvnConfig as JSvnConfig
from slamtpu.ndt import gauss_constants
from slamtpu.ndt import newton_align as jnewton
from slamtpu.ndt import objective as jobj
from slamtpu.ndt import svn_align as jsvn
from slamtpu_torch import interop
from slamtpu_torch.mapping import gaussian_map as tgm
from slamtpu_torch.mapping import voxel as tvoxel
from slamtpu_torch.ndt import fused_math
from slamtpu_torch.ndt import objective as tobj
from slamtpu_torch.ndt.newton import NewtonConfig, newton_align
from slamtpu_torch.ndt.regmap import build_regmap, grid_rows
from slamtpu_torch.ndt.svn import svn_align
from tests.oracles import two_plane_cloud

torch.set_num_threads(1)
RES = 1.0
GRID = (128, 128, 32)
POSES = {  # tangent offsets from the true pose (tests/test_regmap.py:83-84)
    "at_truth": [0.0] * 6,
    "near": [0.02, -0.01, 0.03, 0.1, -0.05, 0.08],
    "far": [0.1, 0.05, -0.1, 0.5, 0.4, -0.3],
}
OFFSETS = {"DIRECT7": (jvoxel.DIRECT7_OFFSETS, tvoxel.DIRECT7_OFFSETS),
           "DIRECT1": (jvoxel.DIRECT1_OFFSETS, tvoxel.DIRECT1_OFFSETS)}


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(77)
    base = two_plane_cloud(extent=8.0, pitch=0.15)
    R = np.asarray(jso3.rpy_to_rot(jnp.asarray([0.0, np.deg2rad(5.0), np.deg2rad(15.0)])))
    t = np.array([0.5, 0.0, 0.3])
    target = base @ R.T + t + rng.normal(scale=0.02, size=base.shape)
    origin = np.floor(target.min(0)) - 8.0
    jmap = jgm.build_map(jnp.asarray(target), jnp.ones(len(target), bool), jnp.asarray(origin), RES,
                         capacity=2048)
    tmap = interop.gaussian_map_from_numpy({k: np.asarray(v) for k, v in jmap._asdict().items()})
    source = two_plane_cloud(extent=8.0, pitch=0.3)
    # padded rows (masked), and real points far outside the map
    pts = np.concatenate([source, np.full((7, 3), 1e7), np.full((5, 3), -1e7)])
    mask = np.ones(len(pts), bool)
    mask[len(source):len(source) + 7] = False
    gt = jse3.Pose3(jnp.asarray(R), jnp.asarray(t))
    return dict(jmap=jmap, tmap=tmap, pts=pts, mask=mask, gt=gt, target=target, origin=origin)


def _tpose(p):
    return interop.pose_from_numpy(np.asarray(p.rot), np.asarray(p.trans), dtype=torch.float64)


def _pose_at(scene, name):
    return jse3.retract(scene["gt"], jnp.asarray(POSES[name]))


def test_lookup_matches_reference(scene):
    """Map keys, their neighbors, keys between and beyond them, INVALID_KEY
    and the map's own INVALID padding."""
    keys = np.asarray(scene["jmap"].keys)
    valid_keys = keys[keys != jvoxel.INVALID_KEY]
    assert keys[-1] == jvoxel.INVALID_KEY and len(valid_keys) > 100  # padding sorts last
    rng = np.random.default_rng(5)
    queries = np.concatenate([
        valid_keys, valid_keys + 1, valid_keys - 1, rng.integers(0, 2 ** 30, 500),
        [jvoxel.INVALID_KEY, 0, -1, valid_keys.min() - 5, valid_keys.max() + 5, 2 ** 30],
    ]).astype(np.int32)
    j_slot, j_found = jvoxel.lookup(jnp.asarray(keys), jnp.asarray(queries))
    t_slot, t_found = tvoxel.lookup(torch.as_tensor(keys), torch.as_tensor(queries))
    np.testing.assert_array_equal(t_slot.numpy(), np.asarray(j_slot))
    np.testing.assert_array_equal(t_found.numpy(), np.asarray(j_found))
    assert t_found[:len(valid_keys)].all() and not t_found[-6]  # INVALID_KEY is never found
    # the keys of points, with a validity mask (out-of-range points pack INVALID)
    pts, origin = scene["pts"], scene["origin"]
    valid = rng.random(len(pts)) > 0.3
    jk = jvoxel.key_of_points(jnp.asarray(pts), jnp.asarray(origin), 1.0 / RES, jnp.asarray(valid))
    tk = tvoxel.key_of_points(torch.as_tensor(pts), torch.as_tensor(origin), 1.0 / RES, torch.as_tensor(valid))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert (tk.numpy() == jvoxel.INVALID_KEY).sum() > (~valid).sum()


def test_port_map_keys_sort_as_the_reference(scene):
    """The port's own build of the same points: the same sorted keys, with
    the INVALID_KEY padding last."""
    tmap = tgm.build_map(torch.as_tensor(scene["target"]), torch.ones(len(scene["target"]), dtype=torch.bool),
                         torch.as_tensor(scene["origin"]), RES, capacity=2048)
    np.testing.assert_array_equal(tmap.keys.numpy(), np.asarray(scene["jmap"].keys))
    k = tmap.keys.numpy()
    assert (np.diff(k.astype(np.int64)) >= 0).all() and k[-1] == tvoxel.INVALID_KEY


def _assert_objective(t, j, n_contrib=None):
    assert int(t.n_contrib) == int(j.n_contrib if n_contrib is None else n_contrib)
    np.testing.assert_allclose(float(t.score), float(j.score), rtol=1e-12)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(j.grad), rtol=1e-10)
    np.testing.assert_allclose(t.hess.numpy(), np.asarray(j.hess), rtol=1e-10)


@pytest.mark.parametrize("pose", list(POSES))
@pytest.mark.parametrize("search", list(OFFSETS))
def test_objective_matches_reference(scene, search, pose):
    d1, d2, _ = gauss_constants(RES, 0.55)
    joff, toff = OFFSETS[search]
    jp = _pose_at(scene, pose)
    args_j = (jnp.asarray(scene["pts"]), jnp.asarray(scene["mask"]), jp, scene["jmap"], d1, d2, joff)
    args_t = (torch.as_tensor(scene["pts"]), torch.as_tensor(scene["mask"]), _tpose(jp), scene["tmap"], d1, d2,
              toff)
    j = jobj.score_grad_hess(*args_j)
    t = tobj.score_grad_hess(*args_t)
    _assert_objective(t, j)
    assert int(t.n_contrib) > (40 if search == "DIRECT1" else 200)
    np.testing.assert_allclose(float(tobj.score_only(*args_t)), float(jobj.score_only(*args_j)), rtol=1e-12)


def test_direct1_searches_one_voxel(scene):
    """DIRECT1's pairs are the DIRECT7 pairs of the point's own voxel."""
    d1, d2, _ = gauss_constants(RES, 0.55)
    args = (torch.as_tensor(scene["pts"]), torch.as_tensor(scene["mask"]), _tpose(scene["gt"]), scene["tmap"],
            d1, d2)
    one = tobj.score_grad_hess(*args, tvoxel.DIRECT1_OFFSETS)
    seven = tobj.score_grad_hess(*args, tvoxel.DIRECT7_OFFSETS)
    assert 0 < int(one.n_contrib) < int(seven.n_contrib)


def test_full_hessian_matches_reference(scene):
    d1, d2, _ = gauss_constants(RES, 0.55)
    jp = _pose_at(scene, "near")
    jg, jh = jobj.full_hessian(jnp.asarray(scene["pts"]), jnp.asarray(scene["mask"]), jp, scene["jmap"], d1, d2)
    tg, th = tobj.full_hessian(torch.as_tensor(scene["pts"]), torch.as_tensor(scene["mask"]), _tpose(jp),
                               scene["tmap"], d1, d2)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-8)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-8)
    # the autodiff gradient is the Gauss-Newton evaluation's
    gn = tobj.score_grad_hess(torch.as_tensor(scene["pts"]), torch.as_tensor(scene["mask"]), _tpose(jp),
                              scene["tmap"], d1, d2)
    np.testing.assert_allclose(tg.numpy(), gn.grad.numpy(), rtol=1e-8)


def test_point_jacobian_matches_reference(scene):
    jp = _pose_at(scene, "far")
    pts = scene["pts"][:200]
    j = jobj.point_jacobian(jnp.asarray(pts), jp)
    t = tobj.point_jacobian(torch.as_tensor(pts), _tpose(jp))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12, atol=1e-12)
    # a (K,)-batched pose gives each pose's Jacobian
    jq = _pose_at(scene, "near")
    both = interop.pose_from_numpy(np.stack([np.asarray(jp.rot), np.asarray(jq.rot)]),
                                   np.stack([np.asarray(jp.trans), np.asarray(jq.trans)]), dtype=torch.float64)
    tb = tobj.point_jacobian(torch.as_tensor(pts), both)
    np.testing.assert_array_equal(tb[0].numpy(), t.numpy())


def test_batched_poses_equal_one_at_a_time(scene):
    """svn_align's K particles in one pass equal K evaluations."""
    d1, d2, _ = gauss_constants(RES, 0.55)
    poses = [_tpose(_pose_at(scene, name)) for name in POSES]
    batch = interop.pose_from_numpy(np.stack([p.rot.numpy() for p in poses]),
                                    np.stack([p.trans.numpy() for p in poses]), dtype=torch.float64)
    pts, mask = torch.as_tensor(scene["pts"]), torch.as_tensor(scene["mask"])
    b = tobj.score_grad_hess(pts, mask, batch, scene["tmap"], d1, d2)
    for i, p in enumerate(poses):
        one = tobj.score_grad_hess(pts, mask, p, scene["tmap"], d1, d2)
        for fb, f1 in zip(b, one):
            np.testing.assert_allclose(fb[i].numpy(), f1.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("pose", list(POSES))
def test_regmap_plain_kernel_equals_sorted_key(scene, pose):
    """The port's own oracle: B1's plain version on the rows of a RegMap of
    the same map (float64 table, params written by hand) sums what the
    sorted-key DIRECT7 objective sums."""
    d1, d2, _ = gauss_constants(RES, 0.55)
    pts, mask = tobj.sanitize_points(torch.as_tensor(scene["pts"]), torch.as_tensor(scene["mask"]))
    regmap = build_regmap(scene["tmap"], grid_shape=GRID)
    assert int(regmap.overflow) == 0 and regmap.packed.dtype == torch.float64
    p = _tpose(_pose_at(scene, pose))
    rows = grid_rows(pts, mask, p, regmap, GRID)
    params = torch.cat([p.rot.reshape(9), p.trans, torch.tensor([d1, d2, 0.0, 9.0], dtype=torch.float64)])[None]
    out = fused_math._ndt_pair_plain(params, pts.t().contiguous(), regmap.packed, rows)
    b1 = fused_math._objective(out, False, 0.0)
    sk = tobj.score_grad_hess(pts, mask, p, scene["tmap"], d1, d2, hess_lambda=0.0)
    _assert_objective(b1, sk)


def _newton_cfg(**kw):
    return dict(resolution=RES, max_iterations=50, trans_eps=5e-3, **kw)  # tests/test_regmap.py:111


@pytest.mark.parametrize("case", ["plain", "direct1", "reg_pose"])
def test_newton_align_matches_reference(scene, case):
    pts, mask = scene["pts"], scene["mask"]
    init = jse3.retract(scene["gt"], jnp.asarray([0.02, -0.03, 0.05, 0.2, -0.15, 0.1]))
    kw = dict(use_direct1=True) if case == "direct1" else {}
    reg = None
    if case == "reg_pose":  # pulled toward a prior 5 cm off the truth
        kw = dict(reg_weight=0.05)
        reg = jse3.retract(scene["gt"], jnp.asarray([0.0, 0.0, 0.0, 0.05, 0.0, 0.0]))
    jcfg = JNewtonConfig(**_newton_cfg(**kw))
    j = jnewton(jnp.asarray(pts), jnp.asarray(mask), scene["jmap"], init, jcfg, reg_pose=reg)
    t = newton_align(torch.as_tensor(pts), torch.as_tensor(mask), scene["tmap"], _tpose(init),
                     NewtonConfig(**_newton_cfg(**kw)), reg_pose=None if reg is None else _tpose(reg))
    assert int(t.iterations) == int(j.iterations) and bool(t.converged) == bool(j.converged)
    assert int(t.n_contrib) == int(j.n_contrib)
    np.testing.assert_allclose(t.pose.trans.numpy(), np.asarray(j.pose.trans), atol=1e-4)
    rot_err = np.asarray(jse3.local(j.pose, jse3.Pose3(jnp.asarray(t.pose.rot.numpy()),
                                                       jnp.asarray(t.pose.trans.numpy()))))[:3]
    assert np.abs(rot_err).max() < 1e-5, rot_err
    np.testing.assert_allclose(float(t.score), float(j.score), rtol=1e-4)
    np.testing.assert_allclose(np.diag(t.hessian.numpy()), np.diag(np.asarray(j.hessian)), rtol=1e-4)
    # registered: DIRECT7 within tests/test_regmap.py's bounds of the truth;
    # DIRECT1's one-voxel basin stops 5.3 cm off it in both packages
    err = np.asarray(jse3.local(scene["gt"], j.pose))
    bound = 0.1 if case == "direct1" else 0.05
    assert np.linalg.norm(err[3:]) < bound and np.linalg.norm(err[:3]) < 0.035
    if case == "reg_pose":  # the pull moved the result toward the prior
        free = jnewton(jnp.asarray(pts), jnp.asarray(mask), scene["jmap"], init, JNewtonConfig(**_newton_cfg()))
        assert not np.allclose(np.asarray(free.pose.trans), np.asarray(j.pose.trans), atol=1e-6)


@pytest.mark.parametrize("polish", [0, 4])
@pytest.mark.parametrize("search", ["DIRECT7", "DIRECT1"])
def test_svn_align_matches_reference(scene, polish, search):
    pts, mask = scene["pts"], scene["mask"]
    prior = jse3.retract(scene["gt"], jnp.asarray([0.004, -0.003, 0.006, 0.04, -0.03, 0.02]))
    jcfg = JSvnConfig(resolution=RES, num_particles=6, max_iterations=10, kernel_h=1.0, step_size=1.0,
                      polish_iters=polish, use_direct1=search == "DIRECT1")
    key = jax.random.PRNGKey(11)
    j = jax.jit(jsvn, static_argnames=("cfg",))(jnp.asarray(pts), jnp.asarray(mask), scene["jmap"], prior, key,
                                                 jcfg)
    # the reference draws xi0 = sigmas * normal(key, (K, 6)) in the points' dtype
    noise = np.array(jax.random.normal(key, (jcfg.num_particles, 6), dtype=jnp.float64))
    t = svn_align(torch.as_tensor(pts), torch.as_tensor(mask), scene["tmap"], _tpose(prior),
                  interop.svn_config_from_fields(jcfg._asdict()), init_noise=torch.as_tensor(noise))
    assert int(t.iterations) == int(j.iterations) and bool(t.converged) == bool(j.converged)
    np.testing.assert_allclose(t.pose.trans.numpy(), np.asarray(j.pose.trans), atol=1e-4)
    rot_err = np.asarray(jse3.local(j.pose, jse3.Pose3(jnp.asarray(t.pose.rot.numpy()),
                                                       jnp.asarray(t.pose.trans.numpy()))))[:3]
    assert np.abs(rot_err).max() < 1e-5, rot_err
    np.testing.assert_allclose(np.diag(t.covariance.numpy()), np.diag(np.asarray(j.covariance)), rtol=1e-2)
    np.testing.assert_allclose(float(t.score), float(j.score), rtol=1e-4)
    np.testing.assert_allclose(t.particles.trans.numpy(), np.asarray(j.particles.trans), atol=1e-4)
    # the posterior is a real one: the registration moved off the prior
    assert np.linalg.norm(np.asarray(j.pose.trans) - np.asarray(prior.trans)) > 1e-3
