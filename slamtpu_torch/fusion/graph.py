"""Whitening of Gaussian factors (port of ``sqrt_info_from_cov`` in
slamtpu/fusion/graph.py; the 15-dof window graph is not ported)."""
from __future__ import annotations

import torch


def sqrt_info_from_cov(cov: torch.Tensor, jitter: float = 1e-12) -> torch.Tensor:
    """Whitening matrix S = L^-1 (lower triangular) of cov + jitter I =
    L L^T, so that S^T S = cov^-1 (batched). The factorization and the
    solve do not check for failure, so they never wait for the device; a
    matrix that is not positive definite gives non-finite entries, as in
    the reference."""
    d = cov.shape[-1]
    eye = torch.eye(d, dtype=cov.dtype, device=cov.device)
    L = torch.linalg.cholesky_ex(cov + jitter * eye)[0]
    return torch.linalg.solve_triangular(L, eye.expand(cov.shape), upper=False)
