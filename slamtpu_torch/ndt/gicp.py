"""Plane-to-plane GICP pieces of the lo_svn polish (port of the
``regularize_plane_covariance`` and ``stencil_point_covariances`` parts of
slamtpu/ndt/gicp.py)."""
from __future__ import annotations

import math

import torch


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
