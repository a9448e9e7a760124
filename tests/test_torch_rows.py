"""The pair kernels' row-index inputs (B1 NDT, B2 VGICP, B3 plane-to-plane
on the aux table) on the CPU: the plain version on the RegMap table and
each point's row index (``grid_rows``), against the same plain version on
the pre-gathered rows of ``gather_megaT`` and against the reference's
Pallas kernel (``slamtpu.ndt.pallas_math.fused_objective``, interpret
mode) on the reference's own ``gather_megaT``.

Tolerances against the reference are test_torch_fused.py's (the reference's
fused-vs-XLA check): n_contrib exact, score rtol 2e-6, grad rtol 1e-4 /
atol 1e-2, Hessian rtol 1e-4 / atol 1e-1, float32 sums of the same pair
terms in another order. Against the pre-gathered rows the comparison is
exact: the same numbers go through the same arithmetic."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamtpu.core import se3 as jse3
from slamtpu.mapping import gaussian_map as jgm
from slamtpu.ndt import build_regmap as jbuild_regmap
from slamtpu.ndt import gauss_constants, regularize_plane_covariance
from slamtpu.ndt.pallas_math import fused_objective as jfused_objective
from slamtpu.ndt.pallas_math import gather_megaT as jgather
from slamtpu.ndt.regmap import point_rows as jpoint_rows
from slamtpu_torch import interop
from slamtpu_torch.ndt import fused_math
from slamtpu_torch.ndt.regmap import grid_rows
from tests.oracles import two_plane_cloud

torch.set_num_threads(1)
RNG = np.random.default_rng(23)
RES = np.float32(1.0)
GRID = (64, 64, 32)
N = 4096
jfused = jax.jit(jfused_objective, static_argnames=("gicp", "interpret"))


@pytest.fixture(scope="module")
def scene():
    base = two_plane_cloud(extent=8.0, pitch=0.15)
    target = (base + RNG.normal(scale=0.02, size=base.shape)).astype(np.float32)
    origin = (np.floor(target.min(0)) - 8.0).astype(np.float32)
    gmap = jgm.build_map(jnp.asarray(target), jnp.ones(len(target), bool), jnp.asarray(origin), RES,
                         capacity=2048)
    # the aux payload of the lo_svn map: mean + plane-regularized covariance
    aux = jnp.concatenate([gmap.mean, regularize_plane_covariance(gmap.cov).reshape(-1, 9)], axis=1)
    jr = jbuild_regmap(gmap, grid_shape=GRID, aux_payload=aux)
    tr = interop.regmap_from_numpy({k: (None if v is None else np.asarray(v))
                                    for k, v in jr._asdict().items()})
    src = two_plane_cloud(extent=8.0, pitch=0.2)
    pts = np.zeros((N, 3), np.float32)
    pts[: len(src)] = src[:N] + RNG.normal(scale=0.01, size=src[:N].shape)
    pts[len(src):] = RNG.uniform(-40.0, 40.0, size=(N - len(src), 3))  # off the map
    mask = np.zeros(N, bool)
    mask[: len(src) + 200] = True
    mask[::17] = False  # masked points read the sentinel row
    return jr, tr, pts, mask


@pytest.fixture(scope="module")
def scovT():
    """Body-frame source covariances (9, N), plane-regularized as the lo_svn
    path's stencil covariances are."""
    c = np.random.default_rng(29).normal(scale=0.05, size=(N, 3, 3))
    scov = np.asarray(regularize_plane_covariance(jnp.asarray(c @ c.transpose(0, 2, 1))), np.float32)
    return scov.reshape(N, 9).T.copy()


def _poses(k, seed):
    xi = np.random.default_rng(seed).normal(scale=[0.01, 0.01, 0.02, 0.05, 0.05, 0.05], size=(k, 6))
    p = jse3.expmap(jnp.asarray(xi, jnp.float32))
    return np.asarray(p.rot, np.float32), np.asarray(p.trans, np.float32)


# per mode: (d1, d2) of the kernel parameters (the VGICP gate bites; the
# plane-to-plane cost at the polish's 5 m gate), the reference's table name
MODES = {"ndt": (None, "packed"), "gicp": ((0.0, 0.04), "packed"), "aniso": ((0.0, 25.0), "aux")}


def _d(mode):
    if MODES[mode][0] is None:
        d1, d2, _ = gauss_constants(float(RES), 0.55)
        return d1, d2
    return MODES[mode][0]


def _params(mode, rot, trans, scovT=None):
    """(params, plain version called as plain(params, ptsT, table, rows),
    the mode's table of the port's RegMap ``tr``)."""
    pose = interop.pose_from_numpy(rot, trans)
    params = fused_math.pose_params(pose, *_d(mode), 9.0, gicp=mode == "gicp")
    if mode == "aniso":
        s = torch.as_tensor(scovT)
        return params, lambda p, ptsT, t, r: fused_math._aniso_pair_plain(p, ptsT, t, r, s), "packed_aux"
    plain = fused_math._ndt_pair_plain if mode == "ndt" else fused_math._gicp_pair_plain
    return params, plain, "packed"


@pytest.mark.parametrize("mode", list(MODES))
def test_rows_plain_equals_pregathered_plain(scene, scovT, mode):
    """(table, rows) and gather_megaT's (96, N) give the same sums, bit for
    bit, for K = 4 poses in one call."""
    _, tr, pts, mask = scene
    rot, trans = _poses(4, 1)
    params, plain, table = _params(mode, rot, trans, scovT)
    tp, tm = torch.as_tensor(pts), torch.as_tensor(mask)
    ident = interop.pose_from_numpy(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    rows = grid_rows(tp, tm, ident, tr, GRID)
    assert rows.dtype == torch.int32 and rows.shape == (N,)
    assert int(rows.max()) == tr.packed.shape[0] - 1  # some points read the sentinel
    megaT = fused_math.gather_megaT(tp, tm, ident, tr, GRID, table=MODES[mode][1])
    ptsT = tp.t().contiguous()
    a = plain(params, ptsT, getattr(tr, table), rows)
    b = plain(params, ptsT, *fused_math.pregathered_table(megaT))
    assert torch.equal(a, b)
    assert (a[:, 43] > 0).all()


@pytest.mark.parametrize("mode", list(MODES))
def test_rows_objective_matches_pallas(scene, scovT, mode):
    """``rows_objective`` on the RegMap table (the aux table with the
    source covariances for the plane-to-plane cost) and ``grid_rows``
    against the reference's kernel on its ``gather_megaT``, at three poses."""
    jr, tr, pts, mask = scene
    d1, d2 = _d(mode)
    aniso = mode == "aniso"
    rot, trans = _poses(3, 2)
    tp, tm = torch.as_tensor(pts), torch.as_tensor(mask)
    for i in range(3):
        jpose = jse3.Pose3(jnp.asarray(rot[i]), jnp.asarray(trans[i]))
        tpose = interop.pose_from_numpy(rot[i], trans[i])
        megaT = jgather(jnp.asarray(pts), jnp.asarray(mask), jpose, jr, GRID, table=MODES[mode][1])
        b = jfused(jnp.asarray(pts.T), megaT, jpose, d1, d2, 1e-6, gicp=mode == "gicp",
                   gicp_max_mahal=9.0, interpret=True,
                   src_covT=jnp.asarray(scovT) if aniso else None)
        rows = grid_rows(tp, tm, tpose, tr, GRID)
        a = fused_math.rows_objective(tp.t().contiguous(), tr.packed_aux if aniso else tr.packed,
                                      rows, tpose, d1, d2, 1e-6, gicp=mode == "gicp",
                                      gicp_max_mahal=9.0,
                                      src_covT=torch.as_tensor(scovT) if aniso else None)
        assert int(a.n_contrib) == int(b.n_contrib) > 0
        np.testing.assert_allclose(float(a.score), float(b.score), rtol=2e-6)
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b.grad), rtol=1e-4, atol=1e-2)
        np.testing.assert_allclose(a.hess.numpy(), np.asarray(b.hess), rtol=1e-4, atol=1e-1)


def test_row_index_matches_reference_on_edge_points(scene):
    """``grid_rows`` (the port's lean lookup) gives the reference's
    rows for points inside and outside the grid, masked, non-finite and far
    away (beyond float32's exact integers in voxels)."""
    jr, tr, pts, mask = scene
    pts, mask = pts.copy(), mask.copy()
    pts[1::31] = np.nan
    pts[2::37, 1] = np.inf
    pts[3::41] = 3e7
    pts[4::43] = -1e9
    pts[5::47, 2] = 1e38
    rot, trans = _poses(1, 5)
    want = np.asarray(jpoint_rows(jnp.asarray(pts), jnp.asarray(mask),
                                  jse3.Pose3(jnp.asarray(rot[0]), jnp.asarray(trans[0])), jr, GRID)[1])
    got = grid_rows(torch.as_tensor(pts), torch.as_tensor(mask),
                                     interop.pose_from_numpy(rot[0], trans[0]), tr, GRID)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want < tr.packed.shape[0] - 1).sum() > 1000  # most points find a cell


def test_out_of_range_rows_read_the_sentinel(scene, scovT):
    """An index outside the table reads the sentinel row, as the kernel's
    clamp does: the sums equal those with the sentinel's own index."""
    _, tr, pts, mask = scene
    rot, trans = _poses(2, 3)
    tp = torch.as_tensor(pts)
    ident = interop.pose_from_numpy(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    rows = grid_rows(tp, torch.as_tensor(mask), ident, tr, GRID)
    R = tr.packed.shape[0]
    bad = rows.clone()
    bad[::5] = R + 7
    bad[1::5] = -3
    sentinel = rows.clone()
    sentinel[::5] = R - 1
    sentinel[1::5] = R - 1
    ptsT = tp.t().contiguous()
    for mode in MODES:
        params, plain, table = _params(mode, rot, trans, scovT)
        table = getattr(tr, table)
        assert torch.equal(plain(params, ptsT, table, bad), plain(params, ptsT, table, sentinel)), mode


def test_all_sentinel_rows_count_nothing(scene, scovT):
    _, tr, pts, _ = scene
    rot, trans = _poses(2, 4)
    ptsT = torch.as_tensor(pts).t().contiguous()
    rows = torch.full((N,), tr.packed.shape[0] - 1, dtype=torch.int32)
    for mode in MODES:
        params, plain, table = _params(mode, rot, trans, scovT)
        out = plain(params, ptsT, getattr(tr, table), rows)
        assert torch.isfinite(out).all() and (out == 0).all(), mode


def test_aniso_wrapper_checks_source_covariances(scene, scovT):
    """The plane-to-plane wrapper takes scovT (9, N) float32, contiguous,
    on the points' device; on CPU tensors it runs the plain version and
    launches nothing."""
    _, tr, pts, mask = scene
    ptsT = torch.as_tensor(pts).t().contiguous()
    rot, trans = _poses(1, 6)
    params, _, _ = _params("aniso", rot, trans, scovT)
    rows = grid_rows(torch.as_tensor(pts), torch.as_tensor(mask),
                     interop.pose_from_numpy(rot[0], trans[0]), tr, GRID)
    s = torch.as_tensor(scovT)
    for bad in (s.double(), s[:8].contiguous(), s[:, 1:].contiguous(), s.t().contiguous().t(),
                s.reshape(N, 9)):
        with pytest.raises(ValueError):
            fused_math.aniso_pair(params, ptsT, tr.packed_aux, rows, bad)
    before = dict(fused_math.LAUNCHES)
    out = fused_math.aniso_pair(params, ptsT, tr.packed_aux, rows, s)
    assert fused_math.LAUNCHES == before
    assert torch.equal(out, fused_math._aniso_pair_plain(params, ptsT, tr.packed_aux, rows, s))
    assert int(out[0, 43]) > 0


def test_rows_wrapper_checks_inputs(scene, scovT):
    _, tr, pts, _ = scene
    ptsT = torch.as_tensor(pts).t().contiguous()
    params = torch.zeros((1, 16))
    rows = torch.zeros(N, dtype=torch.int32)
    s = torch.as_tensor(scovT)

    def aniso(p, ptsT, table, rows):
        return fused_math.aniso_pair(p, ptsT, table, rows, s)

    for fn in (fused_math.ndt_pair, fused_math.gicp_pair, aniso):
        with pytest.raises(ValueError):  # int64 indices
            fn(params, ptsT, tr.packed, rows.long())
        with pytest.raises(ValueError):  # one index too few
            fn(params, ptsT, tr.packed, rows[1:])
        with pytest.raises(ValueError):  # table not 96 wide
            fn(params, ptsT, tr.packed[:, :92].contiguous(), rows)
        with pytest.raises(ValueError):  # table not contiguous
            fn(params, ptsT, tr.packed.t().contiguous().t(), rows)
        with pytest.raises(ValueError):  # float64 table
            fn(params, ptsT, tr.packed.double(), rows)
