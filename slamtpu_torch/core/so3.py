"""SO(3) rotation algebra on tensors (port of slamtpu/core/so3.py).

GTSAM conventions, as in the reference package: ``exp``/``log`` are
Rodrigues' formulas, ``rpy_to_rot`` builds Rz(yaw) Ry(pitch) Rx(roll), and
quaternions are scalar-first ``[w, x, y, z]``. Every function broadcasts
over leading batch dimensions and keeps the input dtype and device.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew matrix, hat(w) @ v == cross(w, v): (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def _small_angle(theta_sq):
    small = theta_sq < _EPS
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    return small, safe_sq, torch.sqrt(safe_sq)


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def exp(w: torch.Tensor) -> torch.Tensor:
    """SO(3) exponential (Rodrigues): (..., 3) -> (..., 3, 3)."""
    theta_sq = torch.sum(w * w, dim=-1)
    small, safe_sq, safe_t = _small_angle(theta_sq)
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(safe_t) / safe_t)
    b = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(safe_t)) / safe_sq)
    W = hat(w)
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """J_l = I + (1 - cos t)/t^2 W + (t - sin t)/t^3 W^2."""
    theta_sq = torch.sum(w * w, dim=-1)
    small, safe_sq, safe_t = _small_angle(theta_sq)
    b = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(safe_t)) / safe_sq)
    c = torch.where(
        small,
        1.0 / 6.0 - theta_sq / 120.0,
        (safe_t - torch.sin(safe_t)) / (safe_sq * safe_t),
    )
    W = hat(w)
    return _eye_like(W) + b[..., None, None] * W + c[..., None, None] * (W @ W)


def left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    """Inverse left Jacobian of SO(3)."""
    theta_sq = torch.sum(w * w, dim=-1)
    small, safe_sq, safe_t = _small_angle(theta_sq)
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0,
        1.0 / safe_sq - (1.0 + torch.cos(safe_t)) / (2.0 * safe_t * torch.sin(safe_t)),
    )
    W = hat(w)
    return _eye_like(W) - 0.5 * W + cot_term[..., None, None] * (W @ W)


def rpy_to_rot(rpy: torch.Tensor) -> torch.Tensor:
    """R = Rz(yaw) @ Ry(pitch) @ Rx(roll): (..., 3) -> (..., 3, 3)."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    row0 = torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], dim=-1)
    row1 = torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], dim=-1)
    row2 = torch.stack([-sp, cp * sr, cp * cr], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def rot_to_rpy(R: torch.Tensor) -> torch.Tensor:
    """Inverse of rpy_to_rot: (..., 3, 3) -> (..., 3) [roll, pitch, yaw]."""
    pitch = torch.asin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([roll, pitch, yaw], dim=-1)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Quaternion [w, x, y, z] -> rotation matrix (normalizing)."""
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = qw * qw + qx * qx + qy * qy + qz * qz
    s = 2.0 / torch.where(n > 0, n, torch.ones_like(n))
    wx, wy, wz = s * qw * qx, s * qw * qy, s * qw * qz
    xx, xy, xz = s * qx * qx, s * qx * qy, s * qx * qz
    yy, yz, zz = s * qy * qy, s * qy * qz, s * qz * qz
    one = torch.ones_like(qw)
    row0 = torch.stack([one - (yy + zz), xy - wz, xz + wy], dim=-1)
    row1 = torch.stack([xy + wz, one - (xx + zz), yz - wx], dim=-1)
    row2 = torch.stack([xz - wy, yz + wx, one - (xx + yy)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion [w, x, y, z] with w >= 0
    (branch-free Shepperd: the candidate with the largest pivot wins)."""
    r00, r01, r02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    r10, r11, r12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = r00 + r11 + r22
    qw0 = 1.0 + tr
    c0 = torch.stack([qw0, r21 - r12, r02 - r20, r10 - r01], dim=-1)
    qx1 = 1.0 + r00 - r11 - r22
    c1 = torch.stack([r21 - r12, qx1, r01 + r10, r02 + r20], dim=-1)
    qy2 = 1.0 - r00 + r11 - r22
    c2 = torch.stack([r02 - r20, r01 + r10, qy2, r12 + r21], dim=-1)
    qz3 = 1.0 - r00 - r11 + r22
    c3 = torch.stack([r10 - r01, r02 + r20, r12 + r21, qz3], dim=-1)
    choice = torch.argmax(torch.stack([qw0, qx1, qy2, qz3], dim=-1), dim=-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)  # (..., 4 cand, 4 comp)
    idx = choice[..., None, None].expand(choice.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., 0:1] < 0, -1.0, 1.0)


def quat_log(q: torch.Tensor) -> torch.Tensor:
    """Rotation vector of a unit quaternion (shortest arc)."""
    sign = torch.where(q[..., 0] < 0, -1.0, 1.0).to(q.dtype)
    qw = q[..., 0] * sign
    qv = q[..., 1:] * sign[..., None]
    vn = torch.linalg.vector_norm(qv, dim=-1)
    angle = 2.0 * torch.atan2(vn, qw)
    small = vn < _EPS
    scale = torch.where(
        small,
        2.0 / torch.clamp(qw, min=0.5),
        angle / torch.where(small, torch.ones_like(vn), vn),
    )
    return qv * scale[..., None]


def log(R: torch.Tensor) -> torch.Tensor:
    """SO(3) logarithm via the quaternion (stable up to angle pi)."""
    return quat_log(rot_to_quat(R))
