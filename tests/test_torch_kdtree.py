"""The KDTREE search mode of the port against the reference, on the CPU.

- ``build_regmap_kdtree`` on the reference's sparse-blob fixture
  (tests/test_regmap.py ``TestKdtreeMode``) and on a noisy two-plane
  cloud: grid, ``bbox_min``, overflow and ``num_valid`` exact; each row's
  slots as a set of (payload, flag) at rtol 1e-6 (sets, because the
  order of slots at equal distance may differ).
- ``radius_gate`` exactly; ``gather_megaT(kd_radius=...)`` exactly; the
  gated plain B1 (one pose and K poses) and B2 against the reference's
  ``gather_megaT(kd_radius=...)`` + ``fused_objective(interpret=True)``,
  the rows and the gate taken at one pose and the objective evaluated at
  others: count exact, score, gradient and Hessian at rtol 1e-4 (plus an
  atol of 1e-4 of the largest entry, for entries that cancel).
- The reference's own KDTREE checks, held against the port: the
  brute-force radius-search oracle, a point that only KDTREE reaches, and
  a radius that gates every slot.
- ``newton_align_fused`` (NDT, and VGICP over a DIRECT7 ``gicp_map``
  table, as odom_ndt's GICP engine runs it) and ``svn_align_reg`` in the
  KDTREE mode, against the reference's fused paths (Pallas in interpret
  mode; the SVN with the reference's particle draws injected): poses
  within 1e-5 m / 1e-5 rad, iterations and ``converged`` equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamtpu.core import se3 as jse3
from slamtpu.mapping import gaussian_map as jgm
from slamtpu.ndt import NewtonConfig as JNewtonConfig
from slamtpu.ndt import SvnConfig as JSvnConfig
from slamtpu.ndt import build_regmap as jbuild_regmap
from slamtpu.ndt import build_regmap_kdtree as jbuild_kd
from slamtpu.ndt import gauss_constants
from slamtpu.ndt import gicp_map as jgicp_map
from slamtpu.ndt import regmap as jregmap_mod
from slamtpu.ndt import svn_align_reg as jsvn
from slamtpu.ndt.objective import MAX_EXPONENT_ARG
from slamtpu.ndt.pallas_math import fused_objective, gather_megaT, newton_align_fused
from slamtpu_torch import interop
from slamtpu_torch.core.se3 import Pose3
from slamtpu_torch.ndt import fused_math, regmap
from slamtpu_torch.ndt.svn import svn_align_reg
from tests.oracles import two_plane_cloud
from tests.test_torch_newton import _box_cloud

torch.set_num_threads(1)
RES = np.float32(1.0)
GRID = (64, 64, 32)
SPARSE_GRID = (64, 64, 16)
N = 4096
jfused = jax.jit(fused_objective, static_argnames=("gicp", "interpret"))
jgather = jax.jit(gather_megaT, static_argnames=("grid_shape", "kd_radius", "table"))
jnewton = jax.jit(newton_align_fused, static_argnames=(
    "cfg", "grid_shape", "inner_iters", "interpret", "final_eval", "_gicp"))


def _fields(nt):
    return {k: (None if v is None else np.asarray(v)) for k, v in nt._asdict().items()}


def _tpose(p):
    return interop.pose_from_numpy(np.asarray(p.rot), np.asarray(p.trans))


@pytest.fixture(scope="module")
def sparse():
    """The reference's sparse-blob fixture: every point has at most 7 leaves
    within one resolution, so the slot cap never truncates."""
    rng = np.random.default_rng(5)
    centers = np.array([[0.5, 0.5, 0.5], [3.5, 0.5, 0.5], [0.5, 3.5, 0.5], [3.5, 3.5, 0.5],
                        [1.5, 1.5, 2.5]])
    pts = np.concatenate([c + rng.normal(0, 0.15, (40, 3)) for c in centers]).astype(np.float64)
    gmap = jgm.build_map(jnp.asarray(pts), jnp.ones(len(pts), bool), jnp.asarray([-8.0, -8.0, -8.0]),
                         float(RES), capacity=256, min_points_per_voxel=3)
    jk = jbuild_kd(gmap, grid_shape=SPARSE_GRID)
    tk = regmap.build_regmap_kdtree(interop.gaussian_map_from_numpy(_fields(gmap)),
                                    grid_shape=SPARSE_GRID)
    assert int(jk.overflow) == 0
    return gmap, jk, tk


@pytest.fixture(scope="module")
def planes():
    """A noisy two-plane target in float32 (the apps' type), its KDTREE
    RegMap and its DIRECT7 ``gicp_map`` RegMap from the reference, and a
    4096-point source scan with a masked tail."""
    rng = np.random.default_rng(31)
    base = two_plane_cloud(extent=8.0, pitch=0.15)
    target = (base + rng.normal(scale=0.02, size=base.shape)).astype(np.float32)
    origin = (np.floor(target.min(0)) - 8.0).astype(np.float32)
    gmap = jgm.build_map(jnp.asarray(target), jnp.ones(len(target), bool), jnp.asarray(origin), RES,
                         capacity=2048)
    src = two_plane_cloud(extent=8.0, pitch=0.2)
    pts = np.zeros((N, 3), np.float32)
    pts[: len(src)] = src[:N] + rng.normal(scale=0.01, size=src[:N].shape)
    mask = np.zeros(N, bool)
    mask[: len(src)] = True
    return gmap, jbuild_kd(gmap, grid_shape=GRID), jbuild_regmap(jgicp_map(gmap), grid_shape=GRID), pts, mask


def _slot_sets(packed):
    """Per row, the sorted list of its valid slots' 12-float payloads."""
    p = np.asarray(packed, np.float64)
    out = []
    for row in p:
        slots = [tuple(row[12 * s:12 * s + 12]) for s in range(7) if row[84 + s] > 0.5]
        out.append((sorted(slots), int(sum(row[84:91] > 0.5))))
    return out


def _check_build(jk, tk):
    for k in ("grid", "bbox_min", "overflow", "num_valid"):
        np.testing.assert_array_equal(tk._asdict()[k].numpy(), np.asarray(jk._asdict()[k]), err_msg=k)
    assert tk.packed.shape == jk.packed.shape and tk.packed_aux is None
    a, b = _slot_sets(tk.packed.numpy()), _slot_sets(jk.packed)
    assert [n for _, n in a] == [n for _, n in b]
    for (sa, _), (sb, _) in zip(a, b):
        if sa:
            np.testing.assert_allclose(np.array(sa), np.array(sb), rtol=1e-6, atol=1e-12)
    np.testing.assert_array_equal(tk.packed.numpy()[:, 91:], 0.0)


def test_build_matches_reference_on_sparse_blobs(sparse):
    _, jk, tk = sparse
    _check_build(jk, tk)
    assert int((tk.packed[:, 84:91] > 0.5).sum()) > 0


def test_build_matches_reference_on_planes(planes):
    gmap, jk, _, _, _ = planes
    tk = regmap.build_regmap_kdtree(interop.gaussian_map_from_numpy(_fields(gmap)), grid_shape=GRID)
    _check_build(jk, tk)
    # the default capacity is 6V rows, as the cached empty map of the apps
    assert tk.packed.shape[0] == 6 * gmap.capacity + 1
    empty = regmap.empty_regmap(gmap.capacity, GRID, "cpu", dilated_capacity=6 * gmap.capacity)
    assert all(a.shape == b.shape for a, b in zip(tk[:7], empty[:7]))


def test_radius_gate_matches_reference():
    rng = np.random.default_rng(3)
    tp = rng.normal(size=(500, 3)).astype(np.float32)
    mu = (tp[:, None, :] + rng.normal(scale=0.6, size=(500, 7, 3))).astype(np.float32)
    act = rng.random((500, 7)) < 0.8
    for r in (0.0, 0.5, 1.0):
        want = np.asarray(jregmap_mod.radius_gate(jnp.asarray(tp), jnp.asarray(mu), jnp.asarray(act), r))
        got = regmap.radius_gate(torch.as_tensor(tp), torch.as_tensor(mu), torch.as_tensor(act), r)
        np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() < act.sum()


def _pose_pair(rng, k):
    """The gather pose near identity, and k evaluation poses around it."""
    g = jse3.expmap(jnp.asarray(rng.normal(scale=[0.01, 0.01, 0.02, 0.05, 0.05, 0.05]), jnp.float32))
    xi = rng.normal(scale=[0.01, 0.01, 0.02, 0.05, 0.05, 0.05], size=(k, 6))
    ev = jse3.compose(jse3.Pose3(g.rot[None], g.trans[None]), jse3.expmap(jnp.asarray(xi, jnp.float32)))
    return g, ev


def _check_objective(a, b):
    assert int(a.n_contrib) == int(b.n_contrib) > 0
    np.testing.assert_allclose(float(a.score), float(b.score), rtol=1e-4)
    g, H = np.asarray(b.grad), np.asarray(b.hess)
    np.testing.assert_allclose(a.grad.numpy(), g, rtol=1e-4, atol=1e-4 * np.abs(g).max())
    np.testing.assert_allclose(a.hess.numpy(), H, rtol=1e-4, atol=1e-4 * np.abs(H).max())


@pytest.mark.parametrize("mode", ["ndt", "ndt K=4", "gicp"])
def test_gated_plain_matches_reference(planes, mode):
    """Rows and gate at the gather pose, the objective at other poses."""
    _, jk, jg, pts, mask = planes
    jmap = jg if mode == "gicp" else jk
    tmap = interop.regmap_from_numpy(_fields(jmap))
    rng = np.random.default_rng(len(mode))
    g, ev = _pose_pair(rng, 4 if mode == "ndt K=4" else 1)
    d1, d2, _ = gauss_constants(float(RES), 0.55)
    if mode == "gicp":
        d1, d2 = 0.0, 0.49  # a correspondence gate that bites, beside the radius
    r = float(RES)
    megaT = jgather(jnp.asarray(pts), jnp.asarray(mask), g, jmap, GRID, kd_radius=r)
    t_megaT = fused_math.gather_megaT(torch.as_tensor(pts), torch.as_tensor(mask), _tpose(g), tmap,
                                      GRID, kd_radius=r)
    np.testing.assert_array_equal(t_megaT.numpy(), np.asarray(megaT))
    ungated = fused_math.gather_megaT(torch.as_tensor(pts), torch.as_tensor(mask), _tpose(g), tmap, GRID)
    assert int((t_megaT[84:91] > 0.5).sum()) < int((ungated[84:91] > 0.5).sum())  # the gate cuts
    rows = regmap.grid_rows(torch.as_tensor(pts), torch.as_tensor(mask), _tpose(g), tmap, GRID)
    gate = fused_math.gate_params(_tpose(g), r)
    ptsT = torch.as_tensor(pts.T.copy())
    tev = _tpose(ev)
    a = fused_math.rows_objective(ptsT, tmap.packed, rows, tev, d1, d2, gicp=mode == "gicp",
                                  gate=gate)
    for i in range(ev.rot.shape[0]):
        b = jfused(jnp.asarray(pts.T), megaT, jse3.Pose3(ev.rot[i], ev.trans[i]), d1, d2, 1e-6,
                   gicp=mode == "gicp", gicp_max_mahal=9.0, interpret=True)
        _check_objective(type(a)(*(f[i] for f in a)), b)


def _plain_at_identity(tk, q, r):
    """The gated plain B1 at the identity for query points q (float32)."""
    d1, d2, _ = gauss_constants(float(RES), 0.55)
    qt = torch.as_tensor(q, dtype=torch.float32)
    eye = Pose3(torch.eye(3), torch.zeros(3))
    table = tk.packed.to(torch.float32)
    tk32 = tk._replace(packed=table)
    rows = regmap.grid_rows(qt, torch.ones(len(q), dtype=torch.bool), eye, tk32, SPARSE_GRID)
    return fused_math.rows_objective(qt.t().contiguous(), table, rows, eye, d1, d2,
                                     gate=fused_math.gate_params(eye, r))


def test_matches_radius_search_oracle(sparse):
    """The reference's brute-force radiusSearch oracle over the valid leaf
    centroids (in float64), against the port's gated B1 (float32)."""
    gmap, _, tk = sparse
    d1, d2, _ = gauss_constants(float(RES), 0.55)
    rng = np.random.default_rng(9)
    q = np.concatenate([rng.uniform(-0.5, 4.5, (200, 3)), np.array([[1.45, 1.45, 0.5]])])
    obj = _plain_at_identity(tk, q, float(RES))
    valid = np.asarray(gmap.valid)
    mus, icovs = np.asarray(gmap.mean)[valid], np.asarray(gmap.icov)[valid]
    score, n_contrib = 0.0, 0
    for p in q.astype(np.float32).astype(np.float64):
        d = np.linalg.norm(mus - p, axis=1)
        for mu, ic in zip(mus[d <= RES], icovs[d <= RES]):
            ex = 0.5 * d2 * (p - mu) @ ic @ (p - mu)
            if ex <= MAX_EXPONENT_ARG:
                score += -d1 * np.exp(-ex)
                n_contrib += 1
    assert int(obj.n_contrib) == n_contrib > 0
    np.testing.assert_allclose(float(obj.score), score, rtol=1e-5)


def test_reaches_beyond_direct7(sparse):
    """A point in a diagonally adjacent empty cell: DIRECT7 finds nothing
    (its dilation is face-only), the KDTREE layout does."""
    gmap, _, tk = sparse
    tmap = interop.gaussian_map_from_numpy(_fields(gmap))
    d7 = regmap.build_regmap(tmap, grid_shape=SPARSE_GRID)
    q = np.array([[2.1, 2.1, 2.5]])
    assert int(_plain_at_identity(d7, q, 0.0).n_contrib) == 0
    assert int(_plain_at_identity(tk, q, float(RES)).n_contrib) >= 1


def test_radius_gates_contributions(sparse):
    _, _, tk = sparse
    q = np.array([[1.2, 0.5, 0.5]])  # 0.7 from the (0.5,)^3 centroid
    assert int(_plain_at_identity(tk, q, float(RES)).n_contrib) >= 1
    assert int(_plain_at_identity(tk, q, 0.3).n_contrib) == 0


def _assert_pose(a, b, tol=1e-5):
    np.testing.assert_allclose(a.trans.numpy(), np.asarray(b.trans), atol=tol)
    rot = np.asarray(jse3.local(b, jse3.Pose3(jnp.asarray(a.rot.numpy()), jnp.asarray(a.trans.numpy()))))
    assert np.abs(rot[:3]).max() < tol, rot


@pytest.fixture(scope="module")
def box():
    """A three-plane target (every dof observed), its KDTREE and DIRECT7
    ``gicp_map`` RegMaps, and a source scan offset from the truth."""
    rng = np.random.default_rng(11)
    target = (_box_cloud(6.0, 0.15) + rng.normal(scale=0.02, size=(3 * 40 * 40, 3))).astype(np.float32)
    origin = (np.floor(target.min(0)) - 8.0).astype(np.float32)
    gmap = jgm.build_map(jnp.asarray(target), jnp.ones(len(target), bool), jnp.asarray(origin), RES,
                         capacity=2048)
    maps = {"ndt": jbuild_kd(gmap, grid_shape=GRID),
            "gicp": jbuild_regmap(jgicp_map(gmap), grid_shape=GRID)}
    src = _box_cloud(6.0, 0.25) + rng.normal(scale=0.01, size=(3 * 24 * 24, 3))
    pts = np.zeros((N, 3), np.float32)
    pts[: len(src)] = src
    mask = np.zeros(N, bool)
    mask[: len(src)] = True
    init = jse3.cast(jse3.expmap(jnp.asarray([0.02, -0.03, 0.05, 0.2, -0.15, 0.1])), jnp.float32)
    return maps, pts, mask, init


@pytest.mark.parametrize("mode", ["ndt", "gicp"])
@pytest.mark.parametrize("inner_iters", [1, 2])
def test_newton_kdtree_matches_reference(box, mode, inner_iters):
    maps, pts, mask, init = box
    jcfg = JNewtonConfig(resolution=float(RES), max_iterations=30, trans_eps=1e-4,
                         gather_stale_frac=0.1, kd_radius=float(RES))
    tcfg = interop.newton_config_from_reference(jcfg)
    b = jnewton(jnp.asarray(pts), jnp.asarray(mask), maps[mode], init, cfg=jcfg, grid_shape=GRID,
                inner_iters=inner_iters, interpret=True, _gicp=mode == "gicp")
    tmap = interop.regmap_from_numpy(_fields(maps[mode]))
    args = (torch.as_tensor(pts), torch.as_tensor(mask), tmap, _tpose(init), tcfg, GRID, inner_iters)
    a = (fused_math.gicp_align_fused if mode == "gicp" else fused_math.newton_align_fused)(*args)
    assert int(a.iterations) == int(b.iterations)
    assert bool(a.converged) == bool(b.converged) is True
    _assert_pose(a.pose, b.pose)
    assert int(a.n_contrib) == int(b.n_contrib)
    np.testing.assert_allclose(float(a.score), float(b.score), rtol=1e-4)


def test_newton_kdtree_launches_the_gated_kernel(box, monkeypatch):
    """Every evaluation of the KDTREE Newton goes through the gate, at the
    pose of its lookup: with inner steps, a step evaluates at its own pose
    with the gate of the outer iteration."""
    maps, pts, mask, init = box
    tmap = interop.regmap_from_numpy(_fields(maps["ndt"]))
    seen = []
    real = fused_math.ndt_pair

    def spy(params, ptsT, table, rows, gate=None):
        seen.append((params[0, 9:12].clone(), None if gate is None else gate[9:12].clone()))
        return real(params, ptsT, table, rows, gate)

    monkeypatch.setattr(fused_math, "ndt_pair", spy)
    cfg = interop.newton_config_from_reference(JNewtonConfig(resolution=float(RES), max_iterations=6,
                                                             kd_radius=float(RES)))
    fused_math.newton_align_fused(torch.as_tensor(pts), torch.as_tensor(mask), tmap, _tpose(init), cfg,
                                  GRID, inner_iters=2)
    assert seen and all(g is not None for _, g in seen)
    first_eval, first_gate = seen[0]
    assert torch.equal(first_eval, first_gate)  # the first step evaluates at the lookup pose
    assert torch.equal(seen[1][1], first_gate) and not torch.equal(seen[1][0], first_gate)


@pytest.mark.parametrize("polish", [0, 3])
def test_svn_kdtree_matches_reference(box, polish):
    maps, pts, mask, init = box
    jcfg = JSvnConfig(resolution=float(RES), num_particles=8, max_iterations=6, kernel_h=1.0,
                      step_size=1.0, kd_radius=float(RES), polish_iters=polish)
    key = jax.random.PRNGKey(3)
    j = jax.jit(jsvn, static_argnames=("cfg", "grid_shape"))(
        jnp.asarray(pts), jnp.asarray(mask), maps["ndt"], init, key, jcfg, GRID)
    noise = np.array(jax.random.normal(key, (jcfg.num_particles, 6), dtype=jnp.float32))
    tcfg = interop.svn_config_from_fields(jcfg._asdict())
    assert tcfg.kd_radius == float(RES)
    t = svn_align_reg(torch.as_tensor(pts), torch.as_tensor(mask),
                      interop.regmap_from_numpy(_fields(maps["ndt"])), _tpose(init), tcfg, GRID,
                      init_noise=torch.as_tensor(noise))
    assert int(t.iterations) == int(j.iterations)
    assert bool(t.converged) == bool(j.converged)
    _assert_pose(t.pose, j.pose)
    np.testing.assert_allclose(float(t.score), float(j.score), rtol=1e-4)
