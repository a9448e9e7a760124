"""SE(3) pose algebra on tensors (port of slamtpu/core/se3.py).

GTSAM ``Pose3`` semantics: tangent vectors are ``[omega(3), v(3)]``,
``retract`` is the full exponential at the pose (right perturbation),
``between(a, b) = a^-1 b``. A pose is ``Pose3(rot (..., 3, 3), trans (..., 3))``
and every op broadcasts over leading batch dimensions.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import so3


class Pose3(NamedTuple):
    rot: torch.Tensor  # (..., 3, 3)
    trans: torch.Tensor  # (..., 3)


def _mv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (A @ v[..., None])[..., 0]


def expmap(xi: torch.Tensor) -> Pose3:
    """SE(3) exponential of [omega, v] (..., 6)."""
    w, v = xi[..., :3], xi[..., 3:]
    return Pose3(so3.exp(w), _mv(so3.left_jacobian(w), v))


def logmap(pose: Pose3) -> torch.Tensor:
    """SE(3) logarithm -> [omega, v] (..., 6)."""
    w = so3.log(pose.rot)
    return torch.cat([w, _mv(so3.left_jacobian_inv(w), pose.trans)], dim=-1)


def compose(a: Pose3, b: Pose3) -> Pose3:
    return Pose3(a.rot @ b.rot, _mv(a.rot, b.trans) + a.trans)


def inverse(p: Pose3) -> Pose3:
    rt = p.rot.transpose(-1, -2)
    return Pose3(rt, -_mv(rt, p.trans))


def between(a: Pose3, b: Pose3) -> Pose3:
    """a^-1 * b (GTSAM Pose3::between)."""
    return compose(inverse(a), b)


def retract(p: Pose3, xi: torch.Tensor) -> Pose3:
    """Right retraction p * Exp(xi)."""
    return compose(p, expmap(xi))


def local(a: Pose3, b: Pose3) -> torch.Tensor:
    """Local coordinates of b at a: Log(a^-1 b)."""
    return logmap(between(a, b))


def transform_points(p: Pose3, pts: torch.Tensor) -> torch.Tensor:
    """Apply a pose to points (..., N, 3); pose batch dims broadcast."""
    return pts @ p.rot.transpose(-1, -2) + p.trans[..., None, :]


def cast(p: Pose3, dtype) -> Pose3:
    return Pose3(p.rot.to(dtype), p.trans.to(dtype))


def interpolate(a: Pose3, b: Pose3, t: torch.Tensor) -> Pose3:
    """Geodesic interpolation a * Exp(t * Log(a^-1 b))."""
    return retract(a, t[..., None] * local(a, b))


def where(cond, a: Pose3, b: Pose3) -> Pose3:
    """Select pose a where the (batch-shaped) condition holds, else b."""
    c = torch.as_tensor(cond, device=a.trans.device)
    return Pose3(
        torch.where(c[..., None, None], a.rot, b.rot),
        torch.where(c[..., None], a.trans, b.trans),
    )
