"""Parity of slamtpu_torch.mapping (voxel keys, Gaussian map build) with
slamtpu.mapping, in float32 on both sides (the resolution goes in as a
numpy float32 so the JAX build does not widen to float64 under x64)."""
import jax.numpy as jnp
import numpy as np
import torch

from slamtpu.mapping import gaussian_map as jgm
from slamtpu.mapping import voxel as jvoxel
from slamtpu_torch.mapping import gaussian_map, voxel

torch.set_num_threads(1)
RNG = np.random.default_rng(4)
RES = np.float32(1.0)


def cloud(n=4000):
    """Points on a few planes plus scattered clutter, far from the origin
    (the corner-relative sums matter at these magnitudes)."""
    u = RNG.uniform(0.0, 12.0, size=(n, 2))
    which = RNG.integers(0, 3, size=n)
    z = RNG.normal(scale=0.01, size=n)
    pts = np.where(which[:, None] == 0, np.stack([u[:, 0], u[:, 1], z], -1),
                   np.where(which[:, None] == 1, np.stack([u[:, 0], z + 3.0, u[:, 1]], -1),
                            np.stack([z + 7.0, u[:, 0], u[:, 1]], -1)))
    pts = pts + np.array([310.0, -220.0, 15.0])
    pts[:50] = RNG.uniform(300.0, 330.0, size=(50, 3))
    pts[50:55] = np.nan  # non-finite points must not poison the sums
    return pts.astype(np.float32)


def test_voxel_keys_match():
    c = RNG.integers(-5, 1030, size=(1000, 3)).astype(np.int32)
    np.testing.assert_array_equal(voxel.pack(torch.as_tensor(c)).numpy(), np.asarray(jvoxel.pack(jnp.asarray(c))))
    k = np.asarray(jvoxel.pack(jnp.asarray(np.abs(c) % 1024)))
    np.testing.assert_array_equal(voxel.unpack(torch.as_tensor(k)).numpy(), np.asarray(jvoxel.unpack(jnp.asarray(k))))
    p = RNG.uniform(-3, 3, size=(500, 3)).astype(np.float32)
    o = np.float32([-1.5, 0.25, 0.0])
    np.testing.assert_array_equal(
        voxel.coords_of(torch.as_tensor(p), torch.as_tensor(o), RES).numpy(),
        np.asarray(jvoxel.coords_of(jnp.asarray(p), jnp.asarray(o), RES)),
    )
    assert voxel.INVALID_KEY == jvoxel.INVALID_KEY
    np.testing.assert_array_equal(voxel.DIRECT7_OFFSETS, jvoxel.DIRECT7_OFFSETS)


def test_build_map_matches_reference():
    pts = cloud()
    mask = np.ones(len(pts), bool)
    mask[100:120] = False
    origin = np.float32([290.0, -240.0, -5.0])
    cap = 1024
    j = jgm.build_map(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(origin), RES,
                      capacity=cap, min_points_per_voxel=4)
    t = gaussian_map.build_map(torch.as_tensor(pts), torch.as_tensor(mask), torch.as_tensor(origin),
                               RES, capacity=cap, min_points_per_voxel=4)
    # the voxel set and its counts are exact
    np.testing.assert_array_equal(t.keys.numpy(), np.asarray(j.keys))
    np.testing.assert_array_equal(t.count.numpy(), np.asarray(j.count))
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    v = np.asarray(j.valid)
    assert v.sum() > 100
    # float32 sums in the same (sorted) order; the absolute means carry the
    # float32 rounding of ~300 m coordinates
    np.testing.assert_allclose(t.mean.numpy()[v], np.asarray(j.mean)[v], rtol=0, atol=1e-4)
    np.testing.assert_allclose(t.cov.numpy()[v], np.asarray(j.cov)[v], rtol=0, atol=1e-6)
    # icov scales with 1 / (surface-normal variance ~1e-4): compare relative
    # to each voxel's largest entry
    jic = np.asarray(j.icov)[v]
    scale = np.abs(jic).reshape(-1, 9).max(1)[:, None, None]
    np.testing.assert_allclose(t.icov.numpy()[v] / scale, jic / scale, atol=1e-4)
    assert int(gaussian_map.GaussianMap.num_valid(t)) == int(j.num_valid())


def test_capacity_overflow_and_recenter():
    pts = cloud()
    origin = np.float32([290.0, -240.0, -5.0])
    mask = np.isfinite(pts).all(1)
    js = jgm.stats_from_points(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(origin), jnp.asarray(RES), 64)
    ts = gaussian_map.stats_from_points(torch.as_tensor(pts), torch.as_tensor(mask),
                                        torch.as_tensor(origin), RES, 64)
    assert int(ts.overflow) == int(js.overflow) > 0
    np.testing.assert_array_equal(ts.keys.numpy(), np.asarray(js.keys))
    for pos in ([0.0, 0.0, 0.0], [400.0, 0.0, 0.0]):
        o_t, s_t = gaussian_map.recenter_origin(np.float32([-512.0, -512.0, -512.0]), np.asarray(pos), 1.0)
        o_j, s_j = jgm.recenter_origin(jnp.asarray(np.float32([-512.0] * 3)), np.asarray(pos), 1.0)
        assert s_t == s_j
        np.testing.assert_array_equal(np.asarray(o_t), np.asarray(o_j))


def test_segment_sum_scan_matches_index_add():
    """The GPU's segment sums (float64 prefix sums over the sorted segment
    ids), run here on the CPU: empty segments, one point a segment and a
    long run (the overflow bucket) against ``index_add_`` in float64."""
    seg = torch.as_tensor(np.sort(np.concatenate([RNG.integers(0, 40, 3000), np.full(20000, 60)])))
    vals = torch.as_tensor(RNG.normal(size=(len(seg), 3, 3)).astype(np.float32))
    out = gaussian_map.segment_sum_scan(vals, seg, 61)
    ref = torch.zeros((61, 3, 3), dtype=torch.float64).index_add_(0, seg, vals.double())
    assert out.dtype == torch.float32 and out.shape == (61, 3, 3)
    assert not out[40:60].any()
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-6, atol=1e-5)


def test_build_map_with_scan_sums_matches_reference(monkeypatch):
    """The map build through the GPU's segment sums, on the CPU, against the
    reference at the tolerances of test_build_map_matches_reference. The
    validity gate's sign test on the smallest eigenvalue is decided by
    rounding where that eigenvalue is ~1e-8 (coplanar points): there alone
    the two builds may disagree."""
    monkeypatch.setattr(gaussian_map, "segment_sum", gaussian_map.segment_sum_scan)
    pts = cloud()
    mask = np.ones(len(pts), bool)
    mask[100:120] = False
    origin = np.float32([290.0, -240.0, -5.0])
    j = jgm.build_map(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(origin), RES,
                      capacity=1024, min_points_per_voxel=4)
    t = gaussian_map.build_map(torch.as_tensor(pts), torch.as_tensor(mask), torch.as_tensor(origin),
                               RES, capacity=1024, min_points_per_voxel=4)
    np.testing.assert_array_equal(t.keys.numpy(), np.asarray(j.keys))
    np.testing.assert_array_equal(t.count.numpy(), np.asarray(j.count))
    stats = gaussian_map.stats_from_points(torch.as_tensor(pts), torch.as_tensor(mask),
                                           torch.as_tensor(origin), RES, 1024)
    n = stats.n.clamp(min=2).double()
    mu = stats.sx.double() / n[:, None]
    raw = torch.linalg.eigvalsh(stats.sxx.double() / n[:, None, None] - mu[:, :, None] * mu[:, None, :])
    degenerate = (raw[:, 0].abs() <= 1e-6 * raw[:, 2].abs()).numpy()
    flips = t.valid.numpy() != np.asarray(j.valid)
    assert not (flips & ~degenerate).any() and flips.sum() <= 5
    v = t.valid.numpy() & np.asarray(j.valid)
    assert v.sum() > 100
    np.testing.assert_allclose(t.mean.numpy()[v], np.asarray(j.mean)[v], rtol=0, atol=1e-4)
    np.testing.assert_allclose(t.cov.numpy()[v], np.asarray(j.cov)[v], rtol=0, atol=1e-6)
    jic = np.asarray(j.icov)[v]
    scale = np.abs(jic).reshape(-1, 9).max(1)[:, None, None]
    np.testing.assert_allclose(t.icov.numpy()[v] / scale, jic / scale, atol=1e-4)
