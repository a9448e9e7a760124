"""NDT objective container and guards (port of the parts of
slamtpu/ndt/objective.py that the fused path needs).

Derivatives are taken in the local SE(3) tangent ``[omega, v]`` at the
pose (right perturbation), as in the reference package.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

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
