"""Newton / Gauss-Newton registration settings and the prior-pose penalty
(port of the ``NewtonConfig``, ``NewtonResult`` and ``regularize_step``
parts of slamtpu/ndt/newton.py).

The port's Newton loop runs only on the fused path
(``fused_math.newton_align_fused``), in every search mode.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import se3
from ..core.se3 import Pose3


class NewtonConfig(NamedTuple):
    resolution: float = 1.0
    outlier_ratio: float = 0.55
    max_iterations: int = 50
    trans_eps: float = 1e-4  # convergence threshold on |step| (register_config.json)
    step_size: float = 1.0
    max_step_norm: float = 1.0  # trust-region style clamp on the Newton step
    # read by the reference's sorted-key objective only: on the RegMap path
    # DIRECT1 runs DIRECT7, in both packages
    use_direct1: bool = False
    hess_lambda: float = 1e-6
    # prior-pose regularization: a tangent-space penalty
    # 0.5 * w * |Log(reg_pose^-1 pose)|^2 with w = reg_weight * n_contrib
    # (ndt_omp's setRegularizationPose); 0 disables the term
    reg_weight: float = 0.0
    # fused path: summed step length since the last mega-row gather at which
    # inner-step reuse freezes and the next outer iteration re-gathers, as a
    # fraction of the resolution
    gather_stale_frac: float = 1.0
    # GICP engine only: Euclidean correspondence-distance gate in meters
    # (the reference's gicp_corr_dist_threshold)
    gicp_max_corr_dist: float = 5.0
    # GICP engine only: plane-to-plane mode with per-point source covariances
    gicp_aniso: bool = False
    # KDTREE search mode: > 0 gates each candidate leaf on |point - centroid|
    # <= kd_radius at the lookup pose (pair with build_regmap_kdtree)
    kd_radius: float = 0.0


class NewtonResult(NamedTuple):
    pose: Pose3
    hessian: torch.Tensor  # (6, 6) GN Hessian of the score
    score: torch.Tensor  # ()
    iterations: torch.Tensor  # () int32
    converged: torch.Tensor  # () bool
    n_contrib: torch.Tensor  # () int32


def regularize_step(pose: Pose3, grad, hess, n_contrib, cfg: NewtonConfig, reg_pose):
    """Add the prior-pose quadratic penalty to (grad, hess). No-op when
    reg_weight == 0 or no reg_pose is given.

    The NDT score is maximized (H negative definite), so the augmented
    objective is score - 0.5*w*|xi|^2 and the penalty subtracts: grad - w*xi,
    hess - w*I. Toy check: data optimum 1.0, prior 0, h = 4, w = 1 gives
    0.8."""
    if reg_pose is None or cfg.reg_weight <= 0.0:
        return grad, hess
    dtype = grad.dtype
    w = cfg.reg_weight * torch.clamp(n_contrib, min=1).to(dtype)
    xi = se3.local(se3.cast(reg_pose, dtype), se3.cast(pose, dtype))
    return grad - w * xi, hess - w * torch.eye(6, dtype=dtype, device=grad.device)
