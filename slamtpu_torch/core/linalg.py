"""Batched small-matrix linear algebra (port of slamtpu/core/linalg.py).

- ``sym_eig3x3``: a fixed 6-sweep cyclic Jacobi eigendecomposition of
  symmetric 3x3 matrices, the same rotation sequence as the reference, so
  per-voxel eigenvalues agree with it to float32 rounding.
- ``inv3x3``: closed-form adjugate inverse.
- ``eig_floor_psd``: eigenvalue floor of a small symmetric matrix.
"""
from __future__ import annotations

import torch


def _jacobi_rotation(A: torch.Tensor, V: torch.Tensor, p: int, q: int):
    """One Jacobi rotation zeroing A[p, q], batched over leading dims."""
    app, aqq, apq = A[..., p, p], A[..., q, q], A[..., p, q]
    zero = torch.abs(apq) < torch.finfo(A.dtype).tiny * 4
    safe_apq = torch.where(zero, torch.ones_like(apq), apq)
    tau = (aqq - app) / (2.0 * safe_apq)
    t = torch.sign(tau) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
    t = torch.where(tau == 0, torch.ones_like(t), t)  # sign(0) = 0 guard
    c = 1.0 / torch.sqrt(1.0 + t * t)
    s = t * c
    c = torch.where(zero, torch.ones_like(c), c)[..., None]
    s = torch.where(zero, torch.zeros_like(s), s)[..., None]

    # column update, then row update, then the eigenvector columns; each
    # reads the matrix as it stood before that update
    Ap, Aq = A[..., :, p], A[..., :, q]
    A = A.clone()
    A[..., :, p] = c * Ap - s * Aq
    A[..., :, q] = s * Ap + c * Aq
    Ap, Aq = A[..., p, :], A[..., q, :]
    A = A.clone()
    A[..., p, :] = c * Ap - s * Aq
    A[..., q, :] = s * Ap + c * Aq
    Vp, Vq = V[..., :, p], V[..., :, q]
    V = V.clone()
    V[..., :, p] = c * Vp - s * Vq
    V[..., :, q] = s * Vp + c * Vq
    return A, V


def sym_eig3x3(A: torch.Tensor, sweeps: int = 6):
    """Eigendecomposition of symmetric (..., 3, 3) matrices.

    Returns (evals (..., 3) ascending, evecs (..., 3, 3) as columns), the
    ``numpy.linalg.eigh`` layout."""
    A = 0.5 * (A + A.transpose(-1, -2))
    V = torch.eye(3, dtype=A.dtype, device=A.device).expand(A.shape).clone()
    scale = torch.clamp(
        torch.amax(torch.abs(A), dim=(-1, -2), keepdim=True), min=torch.finfo(A.dtype).tiny
    )
    A = A / scale
    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            A, V = _jacobi_rotation(A, V, p, q)
    evals = torch.stack([A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]], dim=-1) * scale[..., 0]
    order = torch.argsort(evals, dim=-1, stable=True)
    evals = torch.gather(evals, -1, order)
    evecs = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    return evals, evecs


def inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate inverse of (..., 3, 3) matrices."""
    c00 = A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1]
    c01 = A[..., 1, 2] * A[..., 2, 0] - A[..., 1, 0] * A[..., 2, 2]
    c02 = A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0]
    c10 = A[..., 0, 2] * A[..., 2, 1] - A[..., 0, 1] * A[..., 2, 2]
    c11 = A[..., 0, 0] * A[..., 2, 2] - A[..., 0, 2] * A[..., 2, 0]
    c12 = A[..., 0, 1] * A[..., 2, 0] - A[..., 0, 0] * A[..., 2, 1]
    c20 = A[..., 0, 1] * A[..., 1, 2] - A[..., 0, 2] * A[..., 1, 1]
    c21 = A[..., 0, 2] * A[..., 1, 0] - A[..., 0, 0] * A[..., 1, 2]
    c22 = A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
    det = A[..., 0, 0] * c00 + A[..., 0, 1] * c01 + A[..., 0, 2] * c02
    safe_det = torch.where(det == 0, torch.ones_like(det), det)
    adjT = torch.stack(
        [
            torch.stack([c00, c10, c20], dim=-1),
            torch.stack([c01, c11, c21], dim=-1),
            torch.stack([c02, c12, c22], dim=-1),
        ],
        dim=-2,
    )
    return adjT / safe_det[..., None, None]


def eig_floor_psd(A: torch.Tensor, min_eigenvalue: float) -> torch.Tensor:
    """Floor the eigenvalues of a symmetric matrix and recompose (the
    reference's final-covariance regularization). Small matrices only."""
    evals, evecs = torch.linalg.eigh(A)
    evals = torch.clamp(evals, min=min_eigenvalue)
    return (evecs * evals[..., None, :]) @ evecs.transpose(-1, -2)
