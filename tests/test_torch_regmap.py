"""Parity of slamtpu_torch.ndt.regmap (RegMap build with the aux payload)
with slamtpu.ndt.regmap: the port may lay the table out differently, so
what must agree is what a query sees, the gathered 96-float rows
(``gather_megaT``) for points inside, outside and masked, on both tables,
and the overflow count."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamtpu.core import se3 as jse3
from slamtpu.mapping import gaussian_map as jgm
from slamtpu.ndt import build_regmap as jbuild_regmap
from slamtpu.ndt import regularize_plane_covariance as jregularize
from slamtpu.ndt.pallas_math import gather_megaT as jgather
from slamtpu_torch import interop
from slamtpu_torch.ndt.fused_math import gather_megaT
from slamtpu_torch.ndt.gicp import regularize_plane_covariance
from slamtpu_torch.ndt.regmap import build_regmap, empty_regmap
from tests.oracles import two_plane_cloud

torch.set_num_threads(1)
RNG = np.random.default_rng(77)
RES = np.float32(1.0)
GRID = (64, 64, 32)


@pytest.fixture(scope="module")
def maps():
    base = two_plane_cloud(extent=8.0, pitch=0.15)
    target = (base + RNG.normal(scale=0.02, size=base.shape) + [0.5, 0.0, 0.3]).astype(np.float32)
    origin = (np.floor(target.min(0)) - 8.0).astype(np.float32)
    jmap = jgm.build_map(jnp.asarray(target), jnp.ones(len(target), bool), jnp.asarray(origin), RES,
                         capacity=2048)
    tmap = interop.gaussian_map_from_numpy({k: np.asarray(v) for k, v in jmap._asdict().items()})
    return jmap, tmap


def _aux_pair(jmap, tmap):
    jaux = jnp.concatenate([jmap.mean, jregularize(jmap.cov).reshape(-1, 9)], axis=1)
    taux = torch.cat([tmap.mean, regularize_plane_covariance(tmap.cov).reshape(-1, 9)], dim=1)
    return jaux, taux


def _queries():
    inside = two_plane_cloud(extent=8.0, pitch=0.37) + RNG.normal(scale=0.05, size=(1, 3))
    outside = RNG.uniform(-60.0, 60.0, size=(64, 3))
    pts = np.concatenate([inside, outside, np.full((8, 3), 1e7)]).astype(np.float32)
    mask = np.ones(len(pts), bool)
    mask[::9] = False  # masked points gather the sentinel row
    return pts, mask


def test_gathered_rows_match_on_both_tables(maps):
    jmap, tmap = maps
    jaux, taux = _aux_pair(jmap, tmap)
    # plane regularization: arccos/cos differ by an ulp between the libraries
    np.testing.assert_allclose(taux.numpy(), np.asarray(jaux), atol=1e-6)
    jr = jbuild_regmap(jmap, grid_shape=GRID, aux_payload=jaux)
    # the same payload numbers on both sides, so the layouts compare exactly
    tr = build_regmap(tmap, grid_shape=GRID, aux_payload=torch.as_tensor(np.asarray(jaux)))
    assert int(tr.overflow) == int(jr.overflow) == 0
    assert int(tr.num_valid) == int(jr.num_valid)
    pts, mask = _queries()
    rot = np.asarray(jse3.expmap(jnp.asarray([0.01, -0.02, 0.03, 0.2, -0.1, 0.05])).rot, np.float32)
    trans = np.float32([0.2, -0.1, 0.05])
    jpose = jse3.Pose3(jnp.asarray(rot), jnp.asarray(trans))
    tpose = interop.pose_from_numpy(rot, trans)
    for table in ("packed", "aux"):
        a = gather_megaT(torch.as_tensor(pts), torch.as_tensor(mask), tpose, tr, GRID, table=table).numpy()
        b = np.asarray(jgather(jnp.asarray(pts), jnp.asarray(mask), jpose, jr, GRID, table=table))
        assert a.shape == b.shape == (96, len(pts))
        # same rows: the slot flags and the sentinel pattern are exact, the
        # payload is the same float32 numbers
        np.testing.assert_array_equal(a[84:], b[84:])
        np.testing.assert_array_equal(a, b)
        assert (a[:, ~mask] == 0).all()
        assert a[84:91, : len(pts) - 72].sum() > 0  # inside points do find voxels


@pytest.mark.parametrize("kw", [dict(dilated_capacity=256), dict(grid_shape=(8, 8, 4))],
                         ids=["capacity", "out_of_grid"])
def test_forced_overflow_counted(maps, kw):
    jmap, tmap = maps
    kw = dict(dict(grid_shape=GRID), **kw)
    jr = jbuild_regmap(jmap, **kw)
    tr = build_regmap(tmap, **kw)
    assert int(tr.overflow) == int(jr.overflow) > 0
    # the truncated map stays safe to query: rows agree with the reference
    pts, mask = _queries()
    eye = interop.pose_from_numpy(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    a = gather_megaT(torch.as_tensor(pts), torch.as_tensor(mask), eye, tr, kw["grid_shape"]).numpy()
    b = np.asarray(jgather(jnp.asarray(pts), jnp.asarray(mask),
                           jse3.Pose3(jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32)),
                           jr, kw["grid_shape"]))
    np.testing.assert_array_equal(a, b)


def test_empty_regmap_shapes_and_interop(maps):
    jmap, tmap = maps
    jr = jbuild_regmap(jmap, grid_shape=GRID)
    e = empty_regmap(2048, GRID, "cpu", with_aux=True)
    assert e.packed.shape == tuple(jr.packed.shape) and e.grid.shape == tuple(jr.grid.shape)
    assert e.packed_aux.shape == e.packed.shape and int(e.num_valid) == 0
    back = interop.regmap_from_numpy({k: (None if v is None else np.asarray(v))
                                      for k, v in jr._asdict().items()})
    np.testing.assert_array_equal(interop.to_numpy(back)["packed"], np.asarray(jr.packed))
