"""Pose-window Gauss-Newton smoother of odom_ndt (port of
``PoseWindowResult``, ``optimize_pose_window`` and
``pose_marginal_covariance`` in slamtpu/fusion/smoother.py; the 15-dof
window smoother is not ported).

It takes the place of the reference's iSAM2 updates (run/pipeline.cpp:
738-759) with a full re-linearized solve per keyframe. The residual
Jacobian is written out (GTSAM's Pose3 Logmap derivative and adjoint)
where the reference differentiates through a retract with ``jax.jacfwd``:
forward-mode differentiation in PyTorch (``torch.func.jacfwd``) costs
~15 residual evaluations of small-op dispatch per Jacobian, and the
smoother took ~200 ms of the ~245 ms keyframe that way on an H100. The
normal equations are solved by a Jacobi-equilibrated Cholesky
factorization. The factorization and the triangular solves do not check
for failure, so the smoother never waits for the device: a failed step is
non-finite, zeroed, and then rejected by the accept-if-better test.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import se3, so3
from ..core.se3 import Pose3


class PoseWindowResult(NamedTuple):
    rot: torch.Tensor  # (W, 3, 3)
    trans: torch.Tensor  # (W, 3)
    hessian: torch.Tensor  # (W*6, W*6) normal matrix at the solution (pins included)
    error: torch.Tensor  # () final 0.5*||r||^2


def _series(theta_sq, coeffs):
    return coeffs[0] + theta_sq * (coeffs[1] + theta_sq * coeffs[2])


def logmap_derivative(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6, 6) derivative of Log(A Exp(d)) at d = 0, where xi = Log(A)
    (GTSAM Pose3::LogmapDerivative, tangent [omega, v]): [[Jw, 0],
    [-Jw Q Jw, Jw]] with Jw the SO(3) right-Jacobian inverse and Q the
    translation block of the SE(3) right Jacobian."""
    w, v = xi[..., :3], xi[..., 3:]
    Jw = so3.left_jacobian_inv(-w)  # the right Jacobian inverse
    W, V = so3.hat(w), so3.hat(v)
    theta_sq = torch.sum(w * w, dim=-1)
    small = theta_sq < 1e-2  # Taylor series to theta^4: error < 1e-11
    t = torch.sqrt(torch.where(small, 1.0, theta_sq))
    t2 = t * t
    a = torch.where(small, _series(theta_sq, (1 / 6, -1 / 120, 1 / 5040)), (t - torch.sin(t)) / (t2 * t))
    b = torch.where(small, _series(theta_sq, (-1 / 24, 1 / 720, -1 / 40320)),
                    (1.0 - t2 / 2 - torch.cos(t)) / (t2 * t2))
    c = torch.where(small, _series(theta_sq, (-1 / 120, 1 / 5040, -1 / 362880)),
                    (t - torch.sin(t) - t2 * t / 6) / (t2 * t2 * t))
    WVW = W @ V @ W
    Q = (-0.5 * V + a[..., None, None] * (W @ V + V @ W - WVW)
         + b[..., None, None] * (W @ W @ V + V @ W @ W - 3.0 * WVW)
         - (0.5 * (b - 3.0 * c))[..., None, None] * (WVW @ W + W @ WVW))
    top = torch.cat([Jw, torch.zeros_like(Jw)], dim=-1)
    return torch.cat([top, torch.cat([-Jw @ Q @ Jw, Jw], dim=-1)], dim=-2)


def adjoint(p: Pose3) -> torch.Tensor:
    """(..., 6, 6) adjoint of a pose in the [omega, v] tangent:
    [[R, 0], [hat(t) R, R]]."""
    R = p.rot
    top = torch.cat([R, torch.zeros_like(R)], dim=-1)
    return torch.cat([top, torch.cat([so3.hat(p.trans) @ R, R], dim=-1)], dim=-2)


def _cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) x = b for lower-triangular L and a vector b."""
    y = torch.linalg.solve_triangular(L, b[:, None], upper=False)
    return torch.linalg.solve_triangular(L.transpose(0, 1), y, upper=True)[:, 0]


def optimize_pose_window(
    rot, trans, active,
    fp_rot, fp_trans, fp_sqrt_info,
    fb_rot, fb_trans, fb_sqrt_info, b_active,
    iterations: int = 5,
    damping: float = 1e-6,
) -> PoseWindowResult:
    """Pose-only window Gauss-Newton: one INS pose prior per state plus the
    registration between factors on the chain (pipeline.cpp:604-665).

    fb arrays describe edges k -> k+1 for k in [0, W-2]. Inactive states
    carry a unit pin on their tangent, as does every tangent direction that
    no factor observes (a zero Jacobian column); a step is accepted only if
    it does not raise the cost."""
    W = trans.shape[0]
    n = 6 * W
    dtype, dev = trans.dtype, trans.device
    eye = torch.eye(n, dtype=dtype, device=dev)
    pin = (~active).to(dtype).repeat_interleave(6)
    prior = Pose3(fp_rot, fp_trans)
    meas = Pose3(fb_rot, fb_trans)

    def errors(pose: Pose3):
        """Whitened, masked prior and between residuals and their tangents."""
        e_p = se3.local(prior, pose)
        xi = Pose3(pose.rot[:-1], pose.trans[:-1])
        xj = Pose3(pose.rot[1:], pose.trans[1:])
        e_b = se3.local(meas, se3.between(xi, xj))
        r_p = torch.where(active[:, None], torch.einsum("fij,fj->fi", fp_sqrt_info, e_p), 0.0)
        r_b = torch.where(b_active[:, None], torch.einsum("fij,fj->fi", fb_sqrt_info, e_b), 0.0)
        return torch.cat([r_p.reshape(-1), r_b.reshape(-1)]), e_p, e_b, xi, xj

    def resid(pose: Pose3):
        return errors(pose)[0]

    def gn_hessian(pose: Pose3):
        r, e_p, e_b, xi, xj = errors(pose)
        # state k's right perturbation moves its prior residual by
        # S_p D(e_p); edge k's by -S_b D(e_b) Ad(x_{k+1}^-1 x_k) (from k)
        # and S_b D(e_b) (from k+1), with D the Logmap derivative
        J_p = torch.where(active[:, None, None], fp_sqrt_info @ logmap_derivative(e_p), 0.0)
        J_j = torch.where(b_active[:, None, None], fb_sqrt_info @ logmap_derivative(e_b), 0.0)
        J_i = -J_j @ adjoint(se3.between(xj, xi))
        J_b = (torch.nn.functional.pad(torch.block_diag(*J_i.unbind(0)), (0, 6))
               + torch.nn.functional.pad(torch.block_diag(*J_j.unbind(0)), (6, 0)))
        J = torch.cat([torch.block_diag(*J_p.unbind(0)), J_b])
        unobserved = ~torch.any(torch.abs(J) > 0.0, dim=0)
        H = J.t() @ J + torch.diag(torch.maximum(pin, unobserved.to(dtype)))
        return r, J, H

    def solve(H, g):
        # Jacobi equilibration: solve (DHD) z = -Dg, delta = Dz, which keeps
        # the factorization stable across the spread between tight
        # registration betweens and trust-gain-scaled INS priors
        d = torch.rsqrt(torch.clamp(torch.diagonal(H), min=1e-30))
        Hs = H * d[:, None] * d[None, :]
        L = torch.linalg.cholesky_ex(Hs + damping * eye)[0]
        return d * _cho_solve(L, -(d * g))

    pose = Pose3(rot, trans)
    err = 0.5 * torch.sum(resid(pose) ** 2)
    for _ in range(iterations):
        r, J, H = gn_hessian(pose)
        delta = solve(H, J.t() @ r)
        delta = torch.where(torch.isfinite(delta), delta, 0.0)
        new_pose = se3.retract(pose, delta.reshape(W, 6))
        new_err = 0.5 * torch.sum(resid(new_pose) ** 2)
        accept = new_err <= err
        pose = se3.where(accept, new_pose, pose)
        err = torch.where(accept, new_err, err)
    r, _J, H = gn_hessian(pose)
    return PoseWindowResult(pose.rot, pose.trans, H, 0.5 * torch.sum(r ** 2))


def pose_marginal_covariance(hessian: torch.Tensor, idx: int, damping: float = 1e-12):
    """(6, 6) marginal covariance of pose ``idx`` from a pose-window normal
    matrix. The inverse does not check for singularity (no device wait)."""
    n = hessian.shape[0]
    eye = torch.eye(n, dtype=hessian.dtype, device=hessian.device)
    Hinv = torch.linalg.inv_ex(hessian + damping * eye)[0]
    s = 6 * int(idx)
    return Hinv[s:s + 6, s:s + 6]
