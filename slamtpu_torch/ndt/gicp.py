"""GICP pieces (port of the target maps and source covariances of
slamtpu/ndt/gicp.py): the isotropic VGICP target map of odom_ndt's GICP
engine; the plane model, the plane-to-plane target map and the stencil and
voxel source covariances of odom_ndt's anisotropic GICP engine and the
lo_svn polish. The objectives are the pair kernels' (``fused_math``)."""
from __future__ import annotations

import math

import torch

from ..core import linalg
from ..mapping import voxel
from ..mapping.gaussian_map import GaussianMap, segment_sum


def gicp_map(gmap: GaussianMap, source_noise_sigma: float = 0.05) -> GaussianMap:
    """The Gaussian map with icov = (cov + sigma^2 I)^-1 (zero where the
    voxel is invalid): the isotropic source covariance baked into the
    target, so the VGICP cost runs on the NDT gather and kernel layout."""
    eye = torch.eye(3, dtype=gmap.cov.dtype, device=gmap.cov.device)
    icov = linalg.inv3x3(gmap.cov + (source_noise_sigma ** 2) * eye)
    return gmap._replace(icov=torch.where(gmap.valid[:, None, None], icov, 0.0))


def regularize_plane_covariance(cov: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """GICP surface model: eigenvalues replaced by (eps, 1, 1), i.e.
    ``I - (1 - eps) n n^T`` with n the smallest-eigenvalue direction.

    lambda_min comes from the closed-form symmetric-3x3 (Cardano) formula
    and n from the longest cross product of two rows of (C - lambda_min I);
    no eigendecomposition."""
    c00, c11, c22 = cov[..., 0, 0], cov[..., 1, 1], cov[..., 2, 2]
    c01 = 0.5 * (cov[..., 0, 1] + cov[..., 1, 0])
    c02 = 0.5 * (cov[..., 0, 2] + cov[..., 2, 0])
    c12 = 0.5 * (cov[..., 1, 2] + cov[..., 2, 1])
    q = (c00 + c11 + c22) / 3.0
    p1 = c01 * c01 + c02 * c02 + c12 * c12
    p2 = (c00 - q) ** 2 + (c11 - q) ** 2 + (c22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=0.0))
    p_safe = torch.where(p > 1e-30, p, 1.0)
    b00, b11, b22 = (c00 - q) / p_safe, (c11 - q) / p_safe, (c22 - q) / p_safe
    b01, b02, b12 = c01 / p_safe, c02 / p_safe, c12 / p_safe
    detB = (
        b00 * (b11 * b22 - b12 * b12)
        - b01 * (b01 * b22 - b12 * b02)
        + b02 * (b01 * b12 - b11 * b02)
    )
    r = torch.clamp(0.5 * detB, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lmin = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    a00, a11, a22 = c00 - lmin, c11 - lmin, c22 - lmin
    rows = ((a00, c01, c02), (c01, a11, c12), (c02, c12, a22))

    def cross(u, v):
        return (u[1] * v[2] - u[2] * v[1], u[2] * v[0] - u[0] * v[2], u[0] * v[1] - u[1] * v[0])

    cands = [cross(rows[0], rows[1]), cross(rows[0], rows[2]), cross(rows[1], rows[2])]
    norms = [u[0] * u[0] + u[1] * u[1] + u[2] * u[2] for u in cands]
    best01 = norms[0] >= norms[1]
    n = [torch.where(best01, cands[0][c], cands[1][c]) for c in range(3)]
    use2 = norms[2] > torch.maximum(norms[0], norms[1])
    n = [torch.where(use2, cands[2][c], n[c]) for c in range(3)]
    nn = torch.sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2])
    degenerate = nn < 1e-20  # isotropic / zero covariance: any normal will do
    inv_nn = torch.where(degenerate, 0.0, 1.0 / torch.where(degenerate, 1.0, nn))
    n0, n1, n2 = n[0] * inv_nn, n[1] * inv_nn, n[2] * inv_nn
    n2 = torch.where(degenerate, 1.0, n2)  # the z axis
    nv = torch.stack([n0, n1, n2], dim=-1)
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
    return eye - (1.0 - eps) * nv[..., :, None] * nv[..., None, :]


def gicp_map_aniso(gmap: GaussianMap, eps: float = 1e-3) -> GaussianMap:
    """Target map of plane-to-plane GICP: the icov slot carries the
    plane-regularized covariance (zero where the voxel is invalid), not an
    inverse; the pair kernel adds the rotated source covariance and inverts
    per pair."""
    cov_r = regularize_plane_covariance(gmap.cov, eps)
    return gmap._replace(icov=torch.where(gmap.valid[:, None, None], cov_r, 0.0))


def stencil_point_covariances(
    points: torch.Tensor,  # (cols*sub, 3) row-major over the range image
    mask: torch.Tensor,  # (cols*sub,)
    grid_shape: tuple,  # (cols, sub)
    col_window: int = 2,
    chan_window: int = 1,
    dist_gate_rel: float = 0.08,
    dist_gate_abs: float = 0.3,
    fallback_sigma: float = 0.05,
    min_neighbors: int = 5,
    eps: float = 1e-3,
) -> torch.Tensor:
    """(N, 3, 3) plane-regularized source covariances from each point's
    range-image neighborhood (+-2 columns, wrapping in azimuth; +-1 channel,
    clamped), gated by a range-proportional distance. Sums are taken
    CENTER-RELATIVE: at body-frame ranges of 150 m the float32 rounding of
    absolute outer products would swamp the surface-normal variance. Points
    with fewer than ``min_neighbors`` neighbors get sigma^2 I."""
    dtype = points.dtype
    cols, sub = grid_shape
    N = points.shape[0]
    assert N == cols * sub, (N, grid_shape)
    P = torch.where(mask[:, None], points, 0.0).reshape(cols, sub, 3)
    V = mask.reshape(cols, sub)
    r = torch.sqrt(torch.sum(P * P, dim=-1))
    gate2 = (dist_gate_rel * r + dist_gate_abs) ** 2

    n = torch.zeros((cols, sub), dtype=dtype, device=points.device)
    sx = torch.zeros((cols, sub, 3), dtype=dtype, device=points.device)
    sxx = torch.zeros((cols, sub, 3, 3), dtype=dtype, device=points.device)
    for dc in range(-col_window, col_window + 1):
        for ds in range(-chan_window, chan_window + 1):
            Q = torch.roll(P, shifts=(-dc, -ds), dims=(0, 1))
            VQ = torch.roll(V, shifts=(-dc, -ds), dims=(0, 1))
            if ds > 0:
                VQ[:, -ds:] = False  # the channel axis does not wrap
            elif ds < 0:
                VQ[:, :-ds] = False
            Qr = Q - P
            d2 = torch.sum(Qr * Qr, dim=-1)
            w = (V & VQ & (d2 <= gate2)).to(dtype)
            n = n + w
            sx = sx + w[..., None] * Qr
            sxx = sxx + w[..., None, None] * (Qr[..., :, None] * Qr[..., None, :])
    nf = torch.clamp(n, min=1.0)
    mu = sx / nf[..., None]
    cov = sxx / nf[..., None, None] - mu[..., :, None] * mu[..., None, :]
    cov = cov * (nf / torch.clamp(nf - 1.0, min=1.0))[..., None, None]
    cov = regularize_plane_covariance(cov, eps)
    good = (n >= min_neighbors) & V
    iso = (fallback_sigma ** 2) * torch.eye(3, dtype=dtype, device=points.device)
    return torch.where(good[..., None, None], cov, iso).reshape(N, 3, 3)


def source_point_covariances(
    points: torch.Tensor,
    mask: torch.Tensor,
    resolution,
    capacity: int = 8192,
    min_points_per_voxel: int = 4,
    fallback_sigma: float = 0.05,
    eps: float = 1e-3,
) -> torch.Tensor:
    """(N, 3, 3) source covariances: each point takes the plane-regularized
    covariance of its own voxel of the source scan, or sigma^2 I where the
    voxel holds fewer than ``min_points_per_voxel`` points (or lies past
    ``capacity`` distinct voxels). Points are sorted by voxel key, summed
    per segment and un-sorted. The sums are taken relative to each point's
    voxel corner: relative to the scan's corner, float32 outer products at
    a ~300 m scan diameter would swamp the surface covariance."""
    dtype, dev = points.dtype, points.device
    finite = torch.all(torch.isfinite(points), dim=-1)
    mask = mask & finite
    masked = torch.where(mask[:, None], points, 1e6)
    origin = (torch.floor(torch.amin(masked, dim=0) / resolution) - 1.0) * resolution
    rel = points - origin[None, :]
    coords = voxel.floor_to_int32(rel * (1.0 / resolution))
    keys = torch.where(mask, voxel.pack(coords), voxel.INVALID_KEY)
    pts_rel = torch.where(finite[:, None], rel - coords.to(dtype) * resolution, 0.0)

    order = torch.argsort(keys, stable=True)
    skeys, spts = keys[order], pts_rel[order]
    is_valid = skeys != voxel.INVALID_KEY
    first = torch.cat([torch.ones_like(is_valid[:1]), skeys[1:] != skeys[:-1]]) & is_valid
    seg = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    seg_ok = is_valid & (seg >= 0) & (seg < capacity)
    seg = torch.where(seg_ok, seg, capacity).long()
    n = segment_sum(seg_ok.to(dtype), seg, capacity + 1)
    sx = segment_sum(torch.where(seg_ok[:, None], spts, 0.0), seg, capacity + 1)
    outer = torch.where(seg_ok[:, None, None], spts[:, :, None] * spts[:, None, :], 0.0)
    sxx = segment_sum(outer.reshape(-1, 9), seg, capacity + 1).view(-1, 3, 3)
    nf = torch.clamp(n, min=1.0)
    mu = sx / nf[:, None]
    cov_v = sxx / nf[:, None, None] - mu[:, :, None] * mu[:, None, :]
    cov_v = cov_v * (nf / torch.clamp(nf - 1.0, min=1.0))[:, None, None]
    cov_v = regularize_plane_covariance(cov_v, eps)
    good_sorted = seg_ok & (n >= min_points_per_voxel)[seg]
    iso = (fallback_sigma ** 2) * torch.eye(3, dtype=dtype, device=dev)
    cov_sorted = torch.where(good_sorted[:, None, None], cov_v[seg], iso)
    cov = torch.empty_like(cov_sorted)
    cov[order] = cov_sorted  # un-sort
    return cov


def sweep_point_covariances(points, mask, scan_grid, resolution, capacity: int, min_points: int):
    """The source covariances of a sweep (RegisterConfig.svn_src_cov): the
    range-image stencil ones when ``scan_grid`` (cols, sub) gives the
    sweep's layout, else the voxel ones (at most 2^14 source voxels)."""
    if scan_grid is not None:
        return stencil_point_covariances(points, mask, scan_grid)
    return source_point_covariances(points, mask, resolution, capacity=min(capacity, 1 << 14),
                                    min_points_per_voxel=min_points)
