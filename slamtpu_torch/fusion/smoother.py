"""Window Gauss-Newton smoothers (port of slamtpu/fusion/smoother.py): the
15-dof window of ligo_tc (``optimize``, ``marginal_covariance``) and the
pose-only window of odom_ndt (``optimize_pose_window``,
``pose_marginal_covariance``).

They take the place of the reference's iSAM2 updates (run/pipeline.cpp:
738-759, run/pipeline_ligo_tc.cpp:578-587) with a full re-linearized solve
per keyframe. The residual Jacobian is written out (GTSAM's Pose3 Logmap
derivative and adjoint, and the IMU factor's blocks) where the reference
differentiates through a retract with ``jax.jacfwd``: forward-mode
differentiation in PyTorch (``torch.func.jacfwd``) costs ~15 residual
evaluations of small-op dispatch per Jacobian, and the pose-window
smoother took ~200 ms of the ~245 ms keyframe that way on an H100. The
written-out Jacobian has exact zeros wherever forward-mode
differentiation has them (inactive factors, unobserved states), because
the final Hessian pins every all-zero column. The factorizations and the
triangular solves do not check for failure, so the smoothers never wait
for the device: a failed step is non-finite, zeroed, and then rejected by
the accept-if-better test.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import se3, so3
from ..core.se3 import Pose3
from .graph import Factors, WindowState, factor_errors, imu_pim, residuals, whiten
from .preintegration import ImuBias, bias_corrected_deltas

STATE_DIM = 15  # pose(6) + vel(3) + bias(6)


class SmootherConfig(NamedTuple):
    iterations: int = 8
    damping: float = 1e-6
    step_tol: float = 1e-10
    # "qr": QR of the augmented Jacobian; "chol": Jacobi-equilibrated
    # Cholesky of the normal equations of the same system
    # (H = J^T J + diag(pin) + damping I)
    solver: str = "qr"


class SmootherResult(NamedTuple):
    state: WindowState
    hessian: torch.Tensor  # (W*15, W*15) Gauss-Newton normal matrix at the solution
    error: torch.Tensor  # () final 0.5*||r||^2
    iterations: torch.Tensor  # () int32


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


def _masked(block, active):
    return torch.where(active[:, None, None], block, 0.0)


def _place(block, idx, W: int, off: int) -> torch.Tensor:
    """Jacobian rows (F*d, W*15) of F factors whose (F, d, c) blocks sit at
    state idx[f], tangent columns off..off+c of that state; exact zeros
    elsewhere."""
    F, d, c = block.shape
    hit = torch.arange(W, device=block.device) == idx[:, None]  # (F, W)
    out = torch.where(hit[:, None, :, None], block[:, :, None, :], 0.0)  # (F, d, W, c)
    out = torch.nn.functional.pad(out, (off, STATE_DIM - off - c))
    return out.reshape(F * d, W * STATE_DIM)


def _imu_jacobian(state: WindowState, factors: Factors, r_R) -> torch.Tensor:
    """Unwhitened (F, 15, 30) Jacobian of the IMU residual [r_R, r_v, r_p,
    r_b] with respect to the tangents of states i (columns 0..15) and j
    (15..30). With dR_c = dR Exp(phi), phi = dR_dbg (bg_i - bg_hat), and
    E = dR_c^T Ri^T Rj = Exp(r_R): r_R moves by Jr^-1(r_R) under omega_j,
    by -Jr^-1 Rj^T Ri under omega_i and by -Jr^-1 E^T Jr(phi) dR_dbg under
    bg_i; r_v and r_p rotate with Ri (hat of their rotated vectors) and are
    linear in the velocities, the translations (which move by R v under a
    pose tangent) and the biases; r_b = b_j - b_i."""
    fi = factors.imu
    F, dt_, dev = fi.i.shape[0], fi.dR.dtype, fi.dR.device
    Ri, Rj = state.rot.index_select(0, fi.i), state.rot.index_select(0, fi.j)
    pi, pj = state.trans.index_select(0, fi.i), state.trans.index_select(0, fi.j)
    vi, vj = state.vel.index_select(0, fi.i), state.vel.index_select(0, fi.j)
    bias_i = state.bias.index_select(0, fi.i)
    pim = imu_pim(fi)
    dR_c, _, _ = bias_corrected_deltas(pim, ImuBias(bias_i[:, :3], bias_i[:, 3:]))
    phi = (fi.dR_dbg @ (bias_i[:, 3:] - fi.bias_hat[:, 3:])[..., None])[..., 0]
    Ri_T = Ri.transpose(1, 2)
    E = dR_c.transpose(1, 2) @ Ri_T @ Rj
    Jr_inv = so3.left_jacobian_inv(-r_R)  # right Jacobian inverse at r_R
    t = fi.dt[:, None]
    g = factors.gravity
    u_v = (Ri_T @ (vj - vi - g * t)[..., None])[..., 0]
    u_p = (Ri_T @ (pj - pi - vi * t - 0.5 * g * t * t)[..., None])[..., 0]
    Z = torch.zeros((F, 3, 3), dtype=dt_, device=dev)
    eye3 = torch.eye(3, dtype=dt_, device=dev).expand(F, 3, 3)
    Z9 = torch.zeros((F, 6, 9), dtype=dt_, device=dev)
    eye6 = torch.eye(6, dtype=dt_, device=dev).expand(F, 6, 6)
    d_bg = -Jr_inv @ E.transpose(1, 2) @ so3.left_jacobian(-phi) @ fi.dR_dbg
    return torch.cat([
        # columns: state i [omega, v, vel, ba, bg], state j [omega, v, vel, ba, bg]
        torch.cat([-Jr_inv @ Rj.transpose(1, 2) @ Ri, Z, Z, Z, d_bg, Jr_inv, Z, Z, Z, Z], dim=2),
        torch.cat([so3.hat(u_v), Z, -Ri_T, -fi.dv_dba, -fi.dv_dbg, Z, Z, Ri_T, Z, Z], dim=2),
        torch.cat([so3.hat(u_p), -eye3, -Ri_T * t[..., None], -fi.dp_dba, -fi.dp_dbg,
                   Z, Ri_T @ Rj, Z, Z, Z], dim=2),
        torch.cat([Z9, -eye6, Z9, eye6], dim=2),
    ], dim=1)


def _linearize(state: WindowState, factors: Factors):
    """Whitened residual vector and its Jacobian (written out) with respect
    to the stacked window tangent (W*15)."""
    W = state.window
    errors = factor_errors(state, factors)
    r = torch.cat([whiten(factors, k, e).reshape(-1) for k, e in errors.items()])
    fp, fb = factors.prior_pose, factors.between
    rows = [_place(_masked(fp.sqrt_info @ logmap_derivative(errors["prior_pose"]), fp.active),
                   fp.idx, W, 0)]
    # between: S D(e) at j, -S D(e) Ad(x_j^-1 x_i) at i
    J_j = _masked(fb.sqrt_info @ logmap_derivative(errors["between"]), fb.active)
    x_i = Pose3(state.rot.index_select(0, fb.i), state.trans.index_select(0, fb.i))
    x_j = Pose3(state.rot.index_select(0, fb.j), state.trans.index_select(0, fb.j))
    J_i = -J_j @ adjoint(se3.between(x_j, x_i))
    rows.append(_place(J_i, fb.i, W, 0) + _place(J_j, fb.j, W, 0))
    fv, fbias = factors.prior_vel, factors.prior_bias
    rows.append(_place(_masked(fv.sqrt_info, fv.active), fv.idx, W, 6))
    rows.append(_place(_masked(fbias.sqrt_info, fbias.active), fbias.idx, W, 9))
    if "imu" in errors:
        fi = factors.imu
        J = _masked(fi.sqrt_info @ _imu_jacobian(state, factors, errors["imu"][:, :3]), fi.active)
        rows.append(_place(J[..., :STATE_DIM], fi.i, W, 0) + _place(J[..., STATE_DIM:], fi.j, W, 0))
    fpos = factors.position
    R = state.rot.index_select(0, fpos.idx)  # the translation moves by R v
    rows.append(_place(_masked(fpos.sqrt_info @ torch.cat([torch.zeros_like(R), R], dim=2),
                               fpos.active), fpos.idx, W, 0))
    return r, torch.cat(rows)


def _error(state: WindowState, factors: Factors):
    return 0.5 * torch.sum(residuals(state, factors) ** 2)


def optimize(state: WindowState, factors: Factors,
             cfg: SmootherConfig = SmootherConfig()) -> SmootherResult:
    """Gauss-Newton over the window, ``cfg.iterations`` steps, each accepted
    only if it does not raise the cost. Inactive states carry a unit prior
    on their tangent, and the final Hessian pins every unobserved tangent
    direction (an all-zero Jacobian column) with one too."""
    W = state.window
    n = W * STATE_DIM
    dtype, dev = state.trans.dtype, state.trans.device
    eye = torch.eye(n, dtype=dtype, device=dev)
    pin = (~state.active).to(dtype).repeat_interleave(STATE_DIM)

    def gn_step(st):
        r, J = _linearize(st, factors)
        if cfg.solver == "chol":
            # the normal equations of the augmented system below: the
            # diag(pin) rows add pin, the damping rows damping * I
            H = J.t() @ J + torch.diag(pin) + cfg.damping * eye
            d = torch.rsqrt(torch.clamp(torch.diagonal(H), min=1e-30))
            L = torch.linalg.cholesky_ex(H * d[:, None] * d[None, :])[0]
            return d * _cho_solve(L, -(d * (J.t() @ r)))
        aug = torch.cat([J, torch.diag(pin), cfg.damping ** 0.5 * eye])
        Q, R = torch.linalg.qr(aug)
        qtr = Q[: r.shape[0]].t() @ r  # Q^T [r; 0]
        return -torch.linalg.solve_triangular(R, qtr[:, None], upper=True)[:, 0]

    err = _error(state, factors)
    for _ in range(cfg.iterations):
        delta = gn_step(state)
        delta = torch.where(torch.isfinite(delta), delta, 0.0)
        step_ok = torch.linalg.vector_norm(delta) > cfg.step_tol
        new_state = state.retract(torch.where(step_ok, delta, 0.0).reshape(W, STATE_DIM))
        new_err = _error(new_state, factors)
        accept = new_err <= err
        state = WindowState(*(torch.where(accept, a, b) for a, b in zip(new_state[:4], state[:4])),
                            state.active)
        err = torch.where(accept, new_err, err)
    r, J = _linearize(state, factors)
    unobserved = ~torch.any(torch.abs(J) > 0.0, dim=0)
    H = J.t() @ J + torch.diag(torch.maximum(pin, unobserved.to(dtype)))
    iters = torch.full((), cfg.iterations, dtype=torch.int32, device=dev)
    return SmootherResult(state, H, 0.5 * torch.sum(r ** 2), iters)


def marginal_covariance(hessian: torch.Tensor, idx: int, damping: float = 1e-12):
    """(15, 15) marginal covariance of state ``idx``: its block of H^-1
    (what iSAM2's marginalCovariance returns, run/pipeline.cpp:753; the pose
    part is [:6, :6]). The inverse does not check for singularity (no
    device wait)."""
    n = hessian.shape[0]
    eye = torch.eye(n, dtype=hessian.dtype, device=hessian.device)
    Hinv = torch.linalg.inv_ex(hessian + damping * eye)[0]
    s = STATE_DIM * int(idx)
    return Hinv[s:s + STATE_DIM, s:s + STATE_DIM]


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
