"""Stein-Variational-Newton NDT registration: a pose posterior (port of
slamtpu/ndt/svn.py, the RegMap path).

Per iteration: one row lookup at the particle mean; stage 1 evaluates the
NDT objective for all K particles in ONE launch of the pair kernel, which
gathers the rows from the RegMap table itself (and, in the KDTREE search
mode, gates their slots at the mean pose). With ``shared_gather=False``
each particle looks its rows up (and is gated) at its own pose instead,
one launch at K = 1 per particle;
stage 2 is the K x K SE(3) RBF kernel, the kernel-averaged force and the
regularized Hessians, batched 6x6 solves; stage 3 retracts the particles.
Then an optional MAP polish (Newton steps on the NDT score, or on the
plane-to-plane GICP cost against the RegMap's aux table, each step one row
lookup at its own pose and one launch of the plane-to-plane kernel, which
gathers the aux rows itself) and the particle-spread covariance at the
published pose.

The loop runs ``max_iterations`` trips on the device with no host sync:
once converged, the state freezes (the iteration counter and the
particles stop moving), which gives the reference's while-loop results.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import linalg, se3
from ..core.const import constant
from ..core.se3 import Pose3
from .constants import gauss_constants
from .fused_math import gate_params, rows_objective
from .objective import NdtObjective
from .regmap import grid_rows

# particle init sigmas around the prior, tangent order [omega, v]
INIT_SIGMAS = (0.01, 0.01, 0.02, 0.05, 0.05, 0.05)


class SvnConfig(NamedTuple):
    resolution: float = 1.0
    outlier_ratio: float = 0.55
    num_particles: int = 20
    max_iterations: int = 100
    kernel_h: float = 5.0
    step_size: float = 0.05
    stop_thresh: float = 1e-4
    # read by the reference's sorted-key objective only: on the RegMap path
    # DIRECT1 runs DIRECT7, in both packages
    use_direct1: bool = False
    hess_lambda: float = 1e-6  # per-particle NDT Hessian Tikhonov
    svn_hess_lambda: float = 1e-6  # H~ regularization
    cov_eig_floor: float = 1e-9  # final covariance eigenvalue floor
    # one row lookup at the particle mean for all K particles; False looks up
    # each particle's rows at its own pose (strict per-particle DIRECT7)
    shared_gather: bool = True
    # KDTREE search mode: > 0 gates each slot on its centroid's distance from
    # the point at the gather pose (pair with build_regmap_kdtree)
    kd_radius: float = 0.0
    polish_iters: int = 0  # Newton steps from the polish start point
    polish_from: str = "prior"  # "prior" | "mean"
    polish_pre_iters: int = 6  # "mean" start only: NDT steps before aniso
    polish_objective: str = "ndt"  # "ndt" | "gicp_aniso"


class SvnResult(NamedTuple):
    pose: Pose3  # published pose (posterior mean, or the polished mode)
    covariance: torch.Tensor  # (6, 6) posterior covariance in the tangent at pose
    iterations: torch.Tensor  # () int32
    converged: torch.Tensor  # () bool
    particles: Pose3  # (K,) final particle poses
    score: torch.Tensor  # () objective at the published pose


def _pairwise_kernel(particles: Pose3, kernel_h: float, columns: Optional[Pose3] = None):
    """RBF kernel k[l, k] = exp(-|Log(T_l^-1 T_k)|^2 / h) between the rows
    l of ``particles`` and the columns k of ``columns`` (default the same
    particles), and its gradient k * (-2/h) * Log(T_l^-1 T_k)."""
    columns = particles if columns is None else columns
    inv = se3.inverse(particles)
    rel = se3.compose(
        Pose3(inv.rot[:, None], inv.trans[:, None]),
        Pose3(columns.rot[None, :], columns.trans[None, :]),
    )
    diff = se3.logmap(rel)  # (L, K, 6)
    kval = torch.exp(-torch.sum(diff * diff, dim=-1) / kernel_h)
    return kval, kval[..., None] * (-2.0 / kernel_h) * diff


class _OneDevice:
    """The particle loop's view of the ranks on one device: every particle
    is local and each collective is the identity (``dist.sharded`` passes
    its process group's)."""

    rank, world = 0, 1

    @staticmethod
    def gather(particles: Pose3) -> Pose3:
        return particles

    @staticmethod
    def reduce_scatter(phi, Ht):
        return phi, Ht

    @staticmethod
    def all_reduce(t):
        return t


def _all_finite(x: torch.Tensor, dims) -> torch.Tensor:
    return torch.all(torch.isfinite(x).reshape(x.shape[: x.dim() - dims] + (-1,)), dim=-1)


def svn_align_reg(
    points: torch.Tensor,
    mask: torch.Tensor,
    regmap,
    prior: Pose3,
    cfg: SvnConfig = SvnConfig(),
    grid_shape: tuple = (256, 256, 64),
    src_cov: Optional[torch.Tensor] = None,  # (N, 3, 3) for "gicp_aniso"
    init_noise: Optional[torch.Tensor] = None,  # (K, 6) standard normal
    generator: Optional[torch.Generator] = None,
    _ranks=_OneDevice,
) -> SvnResult:
    """SVN-NDT on the RegMap layout. With ``cfg.shared_gather`` (default)
    each iteration looks up the points' rows once at the particle mean and
    every particle reuses them (exact while the particle spread stays inside
    the DIRECT7 window); without it every particle looks its rows up at its
    own pose, and stage 1 launches the pair kernel once per particle. With
    ``cfg.kd_radius`` > 0 the slots are gated at the pose of their lookup
    (stage 1) and at each NDT polish step's own pose.

    The initial particle draws are ``init_noise`` when given (tests pass in
    the reference's draws), else drawn from ``generator``."""
    d1, d2, _ = gauss_constants(cfg.resolution, cfg.outlier_ratio)
    ptsT = points.t().contiguous()

    def objective_at(lookup_pose):
        """The NDT objective on the rows looked up (and gated) at ``lookup_pose``."""
        rows = grid_rows(points, mask, lookup_pose, regmap, grid_shape)
        gate = gate_params(lookup_pose, cfg.kd_radius)
        return lambda pose: rows_objective(ptsT, regmap.packed, rows, pose, d1, d2,
                                           cfg.hess_lambda, gate=gate)

    def per_particle(pose):
        """Each of the (K,) poses on its own rows: K launches at K = 1."""
        if pose.rot.dim() == 2:
            return objective_at(pose)(pose)
        objs = [objective_at(Pose3(r, t))(Pose3(r, t)) for r, t in zip(pose.rot, pose.trans)]
        return NdtObjective(*(torch.stack(f) for f in zip(*objs)))

    make_obj = objective_at if cfg.shared_gather else (lambda _mean_pose: per_particle)

    polish_make_obj = None
    if cfg.polish_iters > 0 and cfg.polish_objective == "gicp_aniso":
        if regmap.packed_aux is None or src_cov is None:
            raise ValueError("polish_objective='gicp_aniso' needs a RegMap with "
                             "packed_aux and the source covariances src_cov")
        scovT = src_cov.reshape(points.shape[0], 9).t().contiguous().to(torch.float32)

        def polish_make_obj(mean_pose):
            rows = grid_rows(points, mask, mean_pose, regmap, grid_shape)
            return lambda pose: rows_objective(ptsT, regmap.packed_aux, rows, pose, 0.0, 25.0,
                                               cfg.hess_lambda, src_covT=scovT)

    if init_noise is None:
        init_noise = torch.randn(
            (cfg.num_particles, 6), generator=generator, dtype=points.dtype, device=points.device
        )
    return _svn_loop(make_obj, points.dtype, prior, init_noise, cfg, polish_make_obj, _ranks)


def _svn_loop(make_obj, dtype, prior: Pose3, init_noise, cfg: SvnConfig,
              polish_make_obj=None, ranks=_OneDevice) -> SvnResult:
    """The particle flow, the polish and the posterior. ``ranks`` splits
    the K particles: this rank holds rows ``rank * L .. (rank + 1) * L`` of
    the draws (L = K / world), gathers every rank's particles for the
    kernel's columns, and sums the moments and tangents over the ranks."""
    K = cfg.num_particles
    L = K // ranks.world
    dev = prior.trans.device
    I6 = torch.eye(6, dtype=dtype, device=dev)
    sigmas = constant(INIT_SIGMAS, dtype, dev)
    prior_b = Pose3(prior.rot.expand(L, 3, 3), prior.trans.expand(L, 3))
    particles = se3.retract(prior_b, sigmas * init_noise[ranks.rank * L:(ranks.rank + 1) * L].to(dtype))

    def mean_pose_of(parts):
        return se3.retract(prior, ranks.all_reduce(torch.sum(se3.local(prior_b, parts), dim=0)) / K)

    mean_pose = prior
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    converged = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(cfg.max_iterations):
        obj = make_obj(mean_pose)(particles)  # stage 1: the L particles, one launch (or L)
        grads = torch.where(_all_finite(obj.grad, 1)[:, None], obj.grad, 0.0)
        hessians = torch.where(_all_finite(obj.hess, 2)[:, None, None], obj.hess, I6)
        # stage 2: Stein-variational Newton update; the sums run over the
        # rows l (these L particles), for every column k (all K)
        kval, kgrad = _pairwise_kernel(particles, cfg.kernel_h, ranks.gather(particles))
        phi, Ht = ranks.reduce_scatter(
            torch.einsum("lk,la->ka", kval, grads) + kgrad.sum(0),
            torch.einsum("lk,lab->kab", kval * kval, hessians) + torch.einsum("lka,lkb->kab", kgrad, kgrad),
        )
        phi = phi / K
        Ht = Ht / K + cfg.svn_hess_lambda * I6
        updates = torch.linalg.solve_ex(Ht, -phi[..., None])[0][..., 0]
        updates = torch.where(_all_finite(updates, 1)[:, None], updates, 0.0)
        # stage 3: retract, and freeze everything once converged
        new_particles = se3.retract(particles, cfg.step_size * updates)
        mean_now = mean_pose_of(new_particles)
        delta = torch.linalg.vector_norm(se3.local(mean_pose, mean_now))
        active = ~converged
        particles = se3.where(active.expand(L), new_particles, particles)
        mean_pose = se3.where(active, mean_now, mean_pose)
        iters = iters + active.to(torch.int32)
        converged = converged | (active & (delta < cfg.stop_thresh))

    score = torch.zeros((), dtype=torch.float32, device=dev)
    if cfg.polish_iters > 0:

        def polish(mk_fn, pose, n_steps, score):
            for _ in range(n_steps):
                obj = mk_fn(pose)(pose)  # each step gathers at its own pose
                step = torch.linalg.solve_ex(obj.hess, -obj.grad[:, None])[0][:, 0]
                step = torch.where(_all_finite(step, 1), step, 0.0)
                nrm = torch.linalg.vector_norm(step)
                # near the optimum a large step means a degenerate Hessian
                step = step * torch.clamp(0.25 / torch.clamp(nrm, min=1e-30), max=1.0)
                pose = se3.retract(pose, step.to(dtype))
                score = obj.score.to(torch.float32)
            return pose, score

        start = prior if cfg.polish_from == "prior" else mean_pose
        if polish_make_obj is not None and cfg.polish_pre_iters > 0 and cfg.polish_from == "mean":
            start, _ = polish(make_obj, start, cfg.polish_pre_iters, score)
        mean_pose, score = polish(polish_make_obj or make_obj, start, cfg.polish_iters, score)
    else:
        score = make_obj(mean_pose)(mean_pose).score.to(torch.float32)

    # posterior: sample covariance of the particles' tangents at the pose
    mean_b = Pose3(mean_pose.rot.expand(L, 3, 3), mean_pose.trans.expand(L, 3))
    tangents = se3.local(mean_b, particles)
    if K > 1:
        centered = tangents - ranks.all_reduce(torch.sum(tangents, dim=0, keepdim=True)) / K
        cov = ranks.all_reduce(centered.t() @ centered) / (K - 1)
    else:
        cov = torch.diag(1e-6 * sigmas ** 2)
    cov = linalg.eig_floor_psd(cov, cfg.cov_eig_floor)
    return SvnResult(mean_pose, cov, iters, converged, ranks.gather(particles), score)
