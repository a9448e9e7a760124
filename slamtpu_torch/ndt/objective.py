"""P2D-NDT score, gradient and Hessian against a Gaussian voxel map by
sorted-key search (port of slamtpu/ndt/objective.py), and the objective
container and guards that the RegMap path shares.

Derivatives are taken in the local SE(3) tangent ``[omega, v]`` at the
pose (right perturbation), as in the reference package.

The sorted-key objective finds each point's neighbor voxels by their
packed keys: DIRECT7 (the voxel and its 6 face neighbors) or DIRECT1 (the
voxel alone) integer offsets, then a binary search of the map's sorted
keys (``voxel.lookup``). It is the RegMap objective's semantics with no
layout built first; the apps run it with ``use_regmap=False``, and the
tests hold the RegMap pair kernels to it. It is plain PyTorch: in the
reference it runs outside any Pallas kernel. A pose may carry a leading
batch axis (K particles), evaluated in one pass.

Numeric guards: the Mahalanobis negativity clamp, the exponent cap at 50
and the near-zero pair-factor cutoff.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import se3, so3
from ..core.const import constant
from ..core.se3 import Pose3
from ..mapping import voxel
from ..mapping.gaussian_map import GaussianMap

MAX_EXPONENT_ARG = 50.0  # exponent cap of the reference's pair weight
MIN_FACTOR = 1e-15  # near-zero pair-factor cutoff


class NdtObjective(NamedTuple):
    score: torch.Tensor  # (...) total score (maximized)
    grad: torch.Tensor  # (..., 6) d(score)/d(tangent [omega, v])
    hess: torch.Tensor  # (..., 6, 6) Gauss-Newton Hessian
    n_contrib: torch.Tensor  # (...) int32 point-neighbor pairs that counted


def sanitize_points(points: torch.Tensor, mask: torch.Tensor):
    """Zero non-finite points and drop them from the mask (a NaN coordinate
    would poison the sums through 0 * NaN even at zero pair weight)."""
    finite = torch.all(torch.isfinite(points), dim=-1)
    return torch.where(finite[:, None], points, 0.0), mask & finite


def _pair_terms(points, mask, pose: Pose3, gmap: GaussianMap, d1, d2, offsets):
    """The neighbor search and the per-pair weights of sanitized points
    (N, 3) at a pose with batch dims B (none, or (K,)).

    Returns (xrel, icov, icx, factor, score_pairs, ok): xrel (B, N, S, 3)
    for S offsets, icov (B, N, S, 3, 3), icx = icov @ xrel, factor and
    score_pairs (B, N, S), ok (B, N, S) the pairs that count."""
    dtype, dev = points.dtype, points.device
    tp = se3.transform_points(pose, points)  # (B, N, 3)
    inv_res = (1.0 / gmap.resolution).to(dtype)
    coords = voxel.coords_of(tp, gmap.origin.to(dtype), inv_res)
    offs = constant(offsets.reshape(-1), torch.int32, dev).view(-1, 3)
    keys = voxel.pack(coords[..., None, :] + offs)  # (B, N, S)
    slot, found = voxel.lookup(gmap.keys, keys)
    found = found & gmap.valid[slot] & mask[:, None]

    mu = gmap.mean[slot].to(dtype)  # (B, N, S, 3)
    icov = gmap.icov[slot].to(dtype)  # (B, N, S, 3, 3)
    xrel = tp[..., None, :] - mu
    icx = (icov * xrel[..., None, :]).sum(-1)  # elementwise: millions of 3 x 3 products
    mahal = torch.clamp((xrel * icx).sum(-1), min=0.0)
    exponent = 0.5 * d2 * mahal
    ok = found & (exponent <= MAX_EXPONENT_ARG) & torch.isfinite(mahal)
    e = torch.exp(-torch.where(ok, exponent, 0.0))
    score_pairs = torch.where(ok, -d1 * e, 0.0)
    factor = d1 * d2 * e
    factor = torch.where(ok & (torch.abs(factor) >= MIN_FACTOR), factor, 0.0)
    return xrel, icov, icx, factor, score_pairs, ok


def point_jacobian(points: torch.Tensor, pose: Pose3) -> torch.Tensor:
    """d(transformed point)/d(tangent [omega, v]) at delta = 0:
    J = [-R hat(x) | R], (B, N, 3, 6) for points (N, 3)."""
    R = pose.rot[..., None, :, :]  # (B, 1, 3, 3)
    Jw = R @ -so3.hat(points)  # (B, N, 3, 3)
    return torch.cat([Jw, R.expand_as(Jw)], dim=-1)


def score_only(points, mask, pose: Pose3, gmap: GaussianMap, d1: float, d2: float,
               offsets=voxel.DIRECT7_OFFSETS) -> torch.Tensor:
    """Total NDT score at a pose (per-pair Magnusson Eq. 6.9, summed)."""
    points, mask = sanitize_points(points, mask)
    score_pairs = _pair_terms(points, mask, pose, gmap, d1, d2, offsets)[4]
    return score_pairs.sum((-2, -1))


def score_grad_hess(points, mask, pose: Pose3, gmap: GaussianMap, d1: float, d2: float,
                    offsets=voxel.DIRECT7_OFFSETS, hess_lambda: float = 1e-6,
                    reduce=None) -> NdtObjective:
    """Score, gradient and Gauss-Newton Hessian in one evaluation:

        grad = sum_{n,k} f_nk J_n^T C^-1_nk (x'_n - mu_nk)
        hess = sum_{n,k} f_nk J_n^T C^-1_nk J_n + lambda I

    with f = d1 d2 exp(-d2/2 mahal). The neighbor axis k is reduced before
    the 6-dof axis (b_n = sum_k f icx, M_n = sum_k f C^-1, then J^T b and
    J^T M J), in the reference's order. ``reduce`` maps the raw sums
    (..., 44) = [score, grad (6), Hessian (36), count] before lambda is
    added (the multi-device layer sums them over the ranks)."""
    points, mask = sanitize_points(points, mask)
    _xrel, icov, icx, factor, score_pairs, ok = _pair_terms(points, mask, pose, gmap, d1, d2, offsets)
    J = point_jacobian(points, pose)  # (B, N, 3, 6)
    b = (factor[..., None] * icx).sum(-2)  # (B, N, 3)
    M = (factor[..., None, None] * icov).sum(-3)  # (B, N, 3, 3)
    grad = torch.einsum("...nia,...ni->...a", J, b)
    hess = torch.einsum("...nia,...nij,...njb->...ab", J, M, J)
    batch = hess.shape[:-2]
    sums = torch.cat([score_pairs.sum((-2, -1))[..., None], grad, hess.reshape(batch + (36,)),
                      ok.sum((-2, -1)).to(grad.dtype)[..., None]], dim=-1)
    if reduce is not None:
        sums = reduce(sums)
    eye = torch.eye(6, dtype=sums.dtype, device=sums.device)
    return NdtObjective(sums[..., 0], sums[..., 1:7],
                        sums[..., 7:43].reshape(batch + (6, 6)) + hess_lambda * eye,
                        sums[..., 43].to(torch.int32))


def full_hessian(points, mask, pose: Pose3, gmap: GaussianMap, d1: float, d2: float,
                 offsets=voxel.DIRECT7_OFFSETS, hess_lambda: float = 1e-6):
    """Exact (not Gauss-Newton) gradient and Hessian of the score in the
    tangent at a single pose, by automatic differentiation of
    ``score_only``, with the neighbor set frozen at delta = 0 (the search
    has no derivative). An oracle for ``score_grad_hess``; no path runs it."""

    def f(xi):
        return score_only(points, mask, se3.retract(pose, xi), gmap, d1, d2, offsets)

    zero = torch.zeros(6, dtype=points.dtype, device=points.device)
    grad = torch.func.grad(f)(zero)
    hess = torch.func.hessian(f)(zero)
    return grad, hess + hess_lambda * torch.eye(6, dtype=hess.dtype, device=hess.device)
