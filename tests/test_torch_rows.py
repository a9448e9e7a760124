"""The NDT and VGICP pair kernels' row-index inputs (B1, B2) on the CPU: the
plain version on the RegMap table and each point's row index
(``grid_rows``), against the same plain version on the pre-gathered
rows of ``gather_megaT`` and against the reference's Pallas kernel
(``slamtpu.ndt.pallas_math.fused_objective``, interpret mode) on the
reference's own ``gather_megaT``.

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
from slamtpu.ndt import gauss_constants
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
    jr = jbuild_regmap(gmap, grid_shape=GRID)
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


def _poses(k, seed):
    xi = np.random.default_rng(seed).normal(scale=[0.01, 0.01, 0.02, 0.05, 0.05, 0.05], size=(k, 6))
    p = jse3.expmap(jnp.asarray(xi, jnp.float32))
    return np.asarray(p.rot, np.float32), np.asarray(p.trans, np.float32)


def _params(mode, rot, trans):
    d1, d2, _ = gauss_constants(float(RES), 0.55)
    pose = interop.pose_from_numpy(rot, trans)
    if mode == "ndt":
        return fused_math.pose_params(pose, d1, d2), fused_math._ndt_pair_plain
    return fused_math.pose_params(pose, 0.0, 0.04, 9.0, gicp=True), fused_math._gicp_pair_plain


@pytest.mark.parametrize("mode", ["ndt", "gicp"])
def test_rows_plain_equals_pregathered_plain(scene, mode):
    """(table, rows) and gather_megaT's (96, N) give the same sums, bit for
    bit, for K = 4 poses in one call."""
    _, tr, pts, mask = scene
    rot, trans = _poses(4, 1)
    params, plain = _params(mode, rot, trans)
    tp, tm = torch.as_tensor(pts), torch.as_tensor(mask)
    ident = interop.pose_from_numpy(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    rows = grid_rows(tp, tm, ident, tr, GRID)
    assert rows.dtype == torch.int32 and rows.shape == (N,)
    assert int(rows.max()) == tr.packed.shape[0] - 1  # some points read the sentinel
    megaT = fused_math.gather_megaT(tp, tm, ident, tr, GRID)
    ptsT = tp.t().contiguous()
    a = plain(params, ptsT, tr.packed, rows)
    b = plain(params, ptsT, *fused_math.pregathered_table(megaT))
    assert torch.equal(a, b)
    assert (a[:, 43] > 0).all()


@pytest.mark.parametrize("mode", ["ndt", "gicp"])
def test_rows_objective_matches_pallas(scene, mode):
    """``rows_objective`` on the RegMap table and ``grid_rows`` against
    the reference's kernel on its ``gather_megaT``, at three poses."""
    jr, tr, pts, mask = scene
    d1, d2, _ = gauss_constants(float(RES), 0.55)
    if mode == "gicp":
        d1, d2 = 0.0, 0.04  # a distance gate that bites
    rot, trans = _poses(3, 2)
    tp, tm = torch.as_tensor(pts), torch.as_tensor(mask)
    for i in range(3):
        jpose = jse3.Pose3(jnp.asarray(rot[i]), jnp.asarray(trans[i]))
        tpose = interop.pose_from_numpy(rot[i], trans[i])
        megaT = jgather(jnp.asarray(pts), jnp.asarray(mask), jpose, jr, GRID)
        b = jfused(jnp.asarray(pts.T), megaT, jpose, d1, d2, 1e-6, gicp=mode == "gicp",
                   gicp_max_mahal=9.0, interpret=True)
        rows = grid_rows(tp, tm, tpose, tr, GRID)
        a = fused_math.rows_objective(tp.t().contiguous(), tr.packed, rows, tpose, d1, d2, 1e-6,
                                      gicp=mode == "gicp", gicp_max_mahal=9.0)
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


def test_out_of_range_rows_read_the_sentinel(scene):
    """An index outside the table reads the sentinel row, as the kernel's
    clamp does: the sums equal those with the sentinel's own index."""
    _, tr, pts, mask = scene
    rot, trans = _poses(2, 3)
    params, plain = _params("ndt", rot, trans)
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
    assert torch.equal(plain(params, ptsT, tr.packed, bad), plain(params, ptsT, tr.packed, sentinel))


def test_all_sentinel_rows_count_nothing(scene):
    _, tr, pts, _ = scene
    rot, trans = _poses(2, 4)
    ptsT = torch.as_tensor(pts).t().contiguous()
    rows = torch.full((N,), tr.packed.shape[0] - 1, dtype=torch.int32)
    for mode in ("ndt", "gicp"):
        params, plain = _params(mode, rot, trans)
        out = plain(params, ptsT, tr.packed, rows)
        assert torch.isfinite(out).all() and (out == 0).all()


def test_rows_wrapper_checks_inputs(scene):
    _, tr, pts, _ = scene
    ptsT = torch.as_tensor(pts).t().contiguous()
    params = torch.zeros((1, 16))
    rows = torch.zeros(N, dtype=torch.int32)
    for fn in (fused_math.ndt_pair, fused_math.gicp_pair):
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
