"""Newton / Gauss-Newton registration (port of slamtpu/ndt/newton.py): the
settings, the prior-pose penalty, the Newton loop and ``newton_align`` on
the sorted-key objective.

One loop serves every objective. ``_NewtonRun`` holds a registration's
state on the device and advances it one outer iteration at a time
(``outer_step``, a function of tensors: the pose and the step count in,
the loop state out): a ``lookup`` at the current pose (the RegMap rows, or
nothing for the sorted-key objective, which searches inside each
evaluation) and up to ``inner_iters`` Newton steps, each one ``evaluate``.
``drive`` runs the outer iterations; its exit test reads the iteration
count and the convergence flag on the host, packed in one small tensor,
one device sync per outer iteration, counted in ``HOST_READS``.
``fused_math.newton_align_fused`` runs it on the RegMap pair kernels, where
``fused_math.NewtonGraph`` may replay each outer iteration as one CUDA
graph.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import se3
from ..core.se3 import Pose3
from ..mapping import voxel
from . import objective
from .constants import gauss_constants
from .objective import NdtObjective

# host reads of the Newton loop state (each one waits for the device)
HOST_READS = {"newton": 0}


class NewtonConfig(NamedTuple):
    resolution: float = 1.0
    outlier_ratio: float = 0.55
    max_iterations: int = 50
    trans_eps: float = 1e-4  # convergence threshold on |step| (register_config.json)
    step_size: float = 1.0
    max_step_norm: float = 1.0  # trust-region style clamp on the Newton step
    # the sorted-key objective's neighbor set (newton_align): the voxel alone
    # instead of DIRECT7; on the RegMap path DIRECT1 runs DIRECT7, in both
    # packages
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
    # <= kd_radius at the lookup pose (pair with build_regmap_kdtree); the
    # sorted-key objective ignores it, as the reference's does
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


class OuterState(NamedTuple):
    """The loop state after an outer iteration, all on the device."""
    pose: Pose3
    it: torch.Tensor  # () int32 applied steps
    conv: torch.Tensor  # () bool: the last applied step was shorter than trans_eps
    obj: NdtObjective  # the last applied step's objective
    read: torch.Tensor  # (2,) int32 [it, conv]: what the exit test reads


def _newton_step(evaluate, pose: Pose3, looked_up, cfg: NewtonConfig, reg_pose: Pose3):
    """One Newton step from ``pose``: (the retracted pose, the step's length,
    the objective at ``pose``)."""
    obj = evaluate(pose, looked_up)
    grad, hess = regularize_step(pose, obj.grad, obj.hess, obj.n_contrib, cfg, reg_pose)
    step = torch.linalg.solve_ex(hess, -grad)[0]
    step = torch.where(torch.isfinite(step).all(), step, 0.0)
    norm = torch.linalg.vector_norm(step)
    scale = torch.where(norm > cfg.max_step_norm,
                        cfg.max_step_norm / torch.clamp(norm, min=1e-30), 1.0)
    step = (cfg.step_size * scale) * step
    return se3.retract(pose, step.to(pose.trans.dtype)), torch.linalg.vector_norm(step), obj


def outer_step(lookup, evaluate, pose: Pose3, it, cfg: NewtonConfig, inner_iters: int, reg_pose: Pose3,
               budget) -> OuterState:
    """One lookup at ``pose`` and up to ``inner_iters`` steps on it, after
    ``it`` applied steps. Once the summed step length since the lookup
    would pass ``budget`` (``cfg.gather_stale_frac * cfg.resolution``),
    further inner steps freeze (their evaluations are discarded and they do
    not count toward ``cfg.max_iterations``). No host sync."""
    looked_up = lookup(pose)
    pose, norm, obj = _newton_step(evaluate, pose, looked_up, cfg, reg_pose)
    moved, applied = norm, torch.ones((), dtype=torch.int32, device=norm.device)
    for _ in range(inner_iters - 1):
        new_pose, stepn, obj2 = _newton_step(evaluate, pose, looked_up, cfg, reg_pose)
        ok = moved + stepn <= budget
        pose = se3.where(ok, new_pose, pose)
        norm = torch.where(ok, stepn, norm)
        obj = NdtObjective(*(torch.where(ok, n, o) for n, o in zip(obj2, obj)))
        moved = torch.where(ok, moved + stepn, moved + budget)
        applied = applied + ok.to(torch.int32)
    it = it + applied
    conv = norm < cfg.trans_eps
    return OuterState(pose, it, conv, obj, torch.stack([it, conv.to(torch.int32)]))


class _NewtonRun:
    """One registration, an outer iteration at a time: its pose, applied-step
    count ``it``, convergence flag ``conv`` and the last applied step's
    objective, all on the device. ``lookup(pose)`` returns what the
    evaluations of one outer iteration share; ``evaluate(pose, looked_up)``
    returns an NdtObjective at ``pose``. ``advance(pose, it)`` is one outer
    iteration (``outer_step`` on them, unless a caller puts a graph replay
    of it in its place)."""

    def __init__(self, lookup, evaluate, init_pose: Pose3, cfg: NewtonConfig, inner_iters: int = 1,
                 reg_pose: Pose3 = None, dtype=torch.float32):
        dev = init_pose.trans.device
        self.lookup, self.evaluate = lookup, evaluate
        self.cfg = cfg
        self.budget = torch.full((), cfg.gather_stale_frac * cfg.resolution, dtype=dtype, device=dev)
        self.pose = se3.cast(init_pose, dtype)
        self.it = torch.zeros((), dtype=torch.int32, device=dev)
        self.conv = torch.zeros((), dtype=torch.bool, device=dev)
        self.obj = NdtObjective(torch.zeros((), dtype=dtype, device=dev),
                                torch.zeros(6, dtype=dtype, device=dev),
                                torch.zeros((6, 6), dtype=dtype, device=dev),
                                torch.zeros((), dtype=torch.int32, device=dev))
        self.read = None  # (2,) [it, conv] after the first outer iteration
        self.advance = lambda pose, it: outer_step(lookup, evaluate, pose, it, cfg, inner_iters, reg_pose,
                                                   self.budget)

    def outer_iteration(self):
        self.pose, self.it, self.conv, self.obj, self.read = self.advance(self.pose, self.it)

    def result(self, final_eval: bool) -> NewtonResult:
        obj = self.evaluate(self.pose, self.lookup(self.pose)) if final_eval else self.obj
        return NewtonResult(self.pose, obj.hess, obj.score, self.it, self.conv, obj.n_contrib)


def _read_state(run: _NewtonRun):
    """(iterations, converged) on the host: one device sync."""
    HOST_READS["newton"] += 1
    it_h, conv_h = run.read.tolist()
    return it_h, bool(conv_h)


def drive(run: _NewtonRun, final_eval: bool) -> NewtonResult:
    """Outer iterations until the last applied step is shorter than
    ``cfg.trans_eps`` or the applied steps reach ``cfg.max_iterations``.
    By default the returned (score, hessian, n_contrib) are those of the
    last applied step, evaluated at the pose before its retract;
    ``final_eval=True`` evaluates them at the returned pose."""
    it_h, conv_h = 0, False
    while it_h < run.cfg.max_iterations and not conv_h:
        run.outer_iteration()
        it_h, conv_h = _read_state(run)
    return run.result(final_eval)


def newton_align(points, mask, gmap, init_pose: Pose3, cfg: NewtonConfig = NewtonConfig(),
                 reg_pose: Pose3 = None, reduce=None) -> NewtonResult:
    """Align a source scan to the Gaussian map ``gmap`` from ``init_pose`` on
    the sorted-key objective (``objective.score_grad_hess``): DIRECT1 or
    DIRECT7 neighbors from ``cfg.use_direct1``; ``cfg.kd_radius`` is
    ignored, as in the reference. Each step is one evaluation at its own
    pose; score and Hessian come from one more at the returned pose.

    The NDT score is maximized; near the optimum its Gauss-Newton Hessian is
    negative definite, so the step solve(H, -g) moves uphill. ``reg_pose``
    (with ``cfg.reg_weight`` > 0) adds the prior-pose pull. ``reduce`` maps
    each evaluation's raw sums (the multi-device layer sums them over the
    ranks). Runs in the points' dtype."""
    d1, d2, _ = gauss_constants(cfg.resolution, cfg.outlier_ratio)
    offsets = voxel.DIRECT1_OFFSETS if cfg.use_direct1 else voxel.DIRECT7_OFFSETS

    def evaluate(pose, _looked_up):
        return objective.score_grad_hess(points, mask, pose, gmap, d1, d2, offsets, cfg.hess_lambda,
                                         reduce=reduce)

    run = _NewtonRun(lambda _pose: None, evaluate, init_pose, cfg, 1, reg_pose, points.dtype)
    return drive(run, final_eval=True)
