"""Multi-device execution on ``torch.distributed`` (port of
slamtpu/dist/sharded.py).

The NDT math is a sum over point-voxel pairs, so it shards along the point
axis: each rank builds voxel statistics, or evaluates the registration
objective, on its own points, and the ranks combine fixed-size buffers.

The reference takes global arrays and a ``Mesh`` and runs ``shard_map``;
the port is SPMD. Every rank of the process group calls a function with
its local shard (and ``group``, default the default process group) and
gets the result replicated on every rank; ``batch_align_sharded`` alone
returns each rank's own scans, as the reference's sharded output does.
The process group takes the mesh's place, so ``make_mesh`` has no
counterpart: the caller runs ``torch.distributed.init_process_group``
(gloo on the CPU, NCCL on cards, one rank a card).

Every rank takes the same host-side decisions (Newton's continue test) from
the same bits: a collective gives every rank equal results, and each rank
then runs the same arithmetic on them. ``COLLECTIVES`` counts the
collectives issued, by kind. Importing this module starts neither CUDA
nor a process group.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..core import se3
from ..core.se3 import Pose3
from ..mapping import gaussian_map
from ..mapping.gaussian_map import GaussianMap, VoxelStats
from ..ndt import fused_math
from ..ndt.newton import NewtonConfig, NewtonResult, newton_align
from ..ndt.regmap import RegMap, build_regmap
from ..ndt.svn import SvnConfig, SvnResult, svn_align_reg

COLLECTIVES = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0}


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum over the ranks, in place."""
    COLLECTIVES["all_reduce"] += 1
    dist.all_reduce(t, group=group)
    return t


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Each rank's ``t`` stacked in rank order: (D,) + t.shape."""
    COLLECTIVES["all_gather"] += 1
    world = dist.get_world_size(group)
    t = t.reshape((1,) + tuple(t.shape[1:]) if t.dim() == 0 else t.shape).contiguous()
    out = t.new_empty((world * t.shape[0],) + tuple(t.shape[1:]))
    # the newer name where this torch has it (the older one warns there)
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, t, group=group)
    return out.view((world,) + tuple(t.shape))


def _reduce_scatter(t: torch.Tensor, group) -> torch.Tensor:
    """Sum over the ranks of ``t`` (D * m, ...), rank r keeping rows
    r * m .. (r + 1) * m."""
    COLLECTIVES["reduce_scatter"] += 1
    world = dist.get_world_size(group)
    out = t.new_empty((t.shape[0] // world,) + tuple(t.shape[1:]))
    scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    scatter(out, t.contiguous(), group=group)
    return out


def _merge_gathered(local: VoxelStats, acc: Optional[VoxelStats], capacity: int, group) -> VoxelStats:
    """Every rank's ``local`` statistics (one all_gather per buffer: keys, n,
    sx, sxx, overflow) merged in rank order into ``acc``, or, with no
    ``acc``, into rank 0's."""
    keys, n, sx, sxx, ovf = (_all_gather(x, group) for x in
                             (local.keys, local.n, local.sx, local.sxx, local.overflow))
    first = 0
    if acc is None:
        acc, first = VoxelStats(keys[0], n[0], sx[0], sxx[0], local.origin, local.resolution, ovf[0, 0]), 1
    for i in range(first, keys.shape[0]):
        acc = gaussian_map.merge_stats(
            acc, VoxelStats(keys[i], n[i], sx[i], sxx[i], acc.origin, acc.resolution, ovf[i, 0]), capacity)
    return acc


def build_map_sharded(points, mask, origin, resolution: float, capacity: int,
                      min_points_per_voxel: int = 6, group=None) -> GaussianMap:
    """The Gaussian voxel map of the points of every rank: each rank's
    ``stats_from_points`` on its shard, merged in rank order from rank 0's,
    then ``finalize``. Five collectives."""
    local = gaussian_map.stats_from_points(points, mask, origin, resolution, capacity)
    return gaussian_map.finalize(_merge_gathered(local, None, capacity, group), min_points_per_voxel)


def _sum_ranks(group):
    return lambda sums: _all_reduce(sums, group)


def newton_align_sharded(points, mask, gmap: GaussianMap, init_pose: Pose3, resolution: float = 1.0,
                         outlier_ratio: float = 0.55, max_iterations: int = 30, trans_eps: float = 1e-4,
                         hess_lambda: float = 1e-6, group=None):
    """Newton NDT on the sorted-key objective (DIRECT7, as the reference
    hard-codes) with the objective summed over the ranks: each evaluation
    is this rank's points against the replicated Gaussian map
    (``newton.newton_align``), then one all_reduce of the packed (score,
    grad, Hessian, count), with ``hess_lambda`` added once after the sum;
    the 6x6 solve and retract run on every rank. Steps are clamped to norm
    1; score and Hessian are evaluated again at the returned pose. Returns
    (pose, hessian, score, iterations)."""
    cfg = NewtonConfig(resolution=resolution, outlier_ratio=outlier_ratio, max_iterations=max_iterations,
                       trans_eps=trans_eps, hess_lambda=hess_lambda)
    res = newton_align(points, mask, gmap, init_pose, cfg, reduce=_sum_ranks(group))
    return res.pose, res.hessian, res.score, res.iterations


def newton_align_sharded_reg(points, mask, regmap: RegMap, init_pose: Pose3, grid_shape: tuple,
                             resolution: float = 1.0, outlier_ratio: float = 0.55,
                             max_iterations: int = 30, trans_eps: float = 1e-4,
                             hess_lambda: float = 1e-6, group=None):
    """Newton NDT with the objective summed over the ranks: each
    evaluation is the row lookup and the NDT pair kernel on this rank's
    points at the evaluation pose (``fused_math.score_grad_hess_fused``),
    then one all_reduce of the packed (score, grad, Hessian, count); the
    6x6 solve and retract run on every rank. Steps are clamped to norm 1;
    score and Hessian are evaluated again at the returned pose. Returns
    (pose, hessian, score, iterations)."""
    cfg = NewtonConfig(resolution=resolution, outlier_ratio=outlier_ratio, max_iterations=max_iterations,
                       trans_eps=trans_eps, hess_lambda=hess_lambda)
    res = fused_math.newton_align_fused(points, mask, regmap, init_pose, cfg, grid_shape, inner_iters=1,
                                        final_eval=True, reduce=_sum_ranks(group))
    return res.pose, res.hessian, res.score, res.iterations


def newton_align_sharded_fused(points, mask, regmap: RegMap, init_pose: Pose3, grid_shape: tuple,
                               resolution: float = 1.0, outlier_ratio: float = 0.55,
                               max_iterations: int = 30, inner_iters: int = 6, trans_eps: float = 1e-4,
                               hess_lambda: float = 1e-6, max_step_norm: float = 1.0,
                               gather_stale_frac: float = 0.25, group=None):
    """The single-device fused Newton recipe with its sums over the ranks:
    each outer iteration looks up this rank's rows once and takes up to
    ``inner_iters`` steps on them under the staleness budget
    (``fused_math.newton_align_fused``), each step one launch of the NDT
    pair kernel at K = 1 and one all_reduce; score and Hessian are
    evaluated again at the returned pose. Returns (pose, hessian, score,
    iterations)."""
    cfg = NewtonConfig(resolution=resolution, outlier_ratio=outlier_ratio, max_iterations=max_iterations,
                       trans_eps=trans_eps, max_step_norm=max_step_norm, hess_lambda=hess_lambda,
                       gather_stale_frac=gather_stale_frac)
    res = fused_math.newton_align_fused(points, mask, regmap, init_pose, cfg, grid_shape,
                                        inner_iters=inner_iters, final_eval=True, reduce=_sum_ranks(group))
    return res.pose, res.hessian, res.score, res.iterations


def lo_train_step(points, mask, map_stats: VoxelStats, pose_guess: Pose3, resolution: float,
                  capacity: int, grid_shape: tuple = (64, 64, 32), max_iterations: int = 20,
                  inner_iters: int = 4, min_points_per_voxel: int = 6, group=None):
    """One LiDAR-odometry step over the ranks: register the scan (each rank
    its shard) against the map of ``map_stats`` (replicated) with
    ``newton_align_sharded_fused``, then fold every rank's registered points
    into the statistics (five all_gathers, merged in rank order). Returns
    (pose, hessian, score, iterations, new_map_stats)."""
    rmap = build_regmap(gaussian_map.finalize(map_stats, min_points_per_voxel), grid_shape=grid_shape)
    pose, hess, score, iters = newton_align_sharded_fused(
        points, mask, rmap, pose_guess, grid_shape, resolution=resolution, max_iterations=max_iterations,
        inner_iters=inner_iters, group=group)
    local = gaussian_map.stats_from_points(se3.transform_points(pose, points), mask, map_stats.origin,
                                           map_stats.resolution, capacity)
    return pose, hess, score, iters, _merge_gathered(local, map_stats, capacity, group)


class _Ranks:
    """``svn_align_reg``'s view of the ranks of a process group: K/D
    particles a rank."""

    def __init__(self, group):
        self.group = group
        self.rank, self.world = dist.get_rank(group), dist.get_world_size(group)

    def gather(self, particles: Pose3) -> Pose3:
        """Every rank's particles in rank order: one all_gather of the
        packed rotations and translations."""
        L = particles.rot.shape[0]
        packed = _all_gather(torch.cat([particles.rot.reshape(L, 9), particles.trans], dim=1), self.group)
        packed = packed.reshape(-1, 12)
        return Pose3(packed[:, :9].reshape(-1, 3, 3), packed[:, 9:])

    def reduce_scatter(self, phi, Ht):
        """(phi, Ht) of all K columns summed over the ranks, this rank's K/D
        rows kept: one reduce_scatter of the two packed."""
        K = phi.shape[0]
        m = _reduce_scatter(torch.cat([phi, Ht.reshape(K, 36)], dim=1), self.group)
        return m[:, :6], m[:, 6:].reshape(-1, 6, 6)

    def all_reduce(self, t):
        return _all_reduce(t, self.group)


def svn_align_sharded(points, mask, regmap: RegMap, prior: Pose3, init_noise: torch.Tensor,
                      cfg: SvnConfig, grid_shape: tuple, group=None) -> SvnResult:
    """SVN-NDT (``svn_align_reg``) with the K particles split over the D
    ranks, K/D a rank, on replicated points, RegMap and prior.
    ``init_noise`` (K, 6) is the replicated standard-normal draw (the
    reference draws it from its key); rank r takes rows r K/D .. (r + 1)
    K/D.

    Stage 1 evaluates this rank's particles in one launch of the NDT pair
    kernel at K = K/D. Stage 2's moments are sums over the source particle l,
        phi[k] = (1/K) sum_l k[l,k] grad[l] + dk[l,k],
        Ht[k]  = (1/K) sum_l k[l,k]^2 H[l] + dk[l,k] dk[l,k]^T,
    so each rank forms the partial moments of all K columns from its rows
    and one reduce_scatter both sums them and hands each rank its K/D rows.
    An iteration issues one all_gather of the particles, that
    reduce_scatter and one all_reduce of the 6-float tangent sum for the
    mean; the posterior adds two all_reduces and the returned particles one
    all_gather. The loop runs ``max_iterations`` trips and freezes once
    converged, as on one device, so every rank issues the same collectives
    and no host read decides. The polish (NDT objective only) runs on every
    rank."""
    if cfg.polish_iters > 0 and cfg.polish_objective != "ndt":
        raise ValueError("svn_align_sharded polishes on the NDT objective only")
    ranks = _Ranks(group)
    if cfg.num_particles % ranks.world or cfg.num_particles < 2:
        raise ValueError(f"{cfg.num_particles} particles do not split over {ranks.world} ranks "
                         "(a multiple of the world size, at least 2)")
    return svn_align_reg(points, mask, regmap, prior, cfg, grid_shape, init_noise=init_noise,
                         _ranks=ranks)


def batch_align_sharded(points, mask, regmap: RegMap, init_poses: Pose3, cfg: NewtonConfig,
                        grid_shape: tuple, inner_iters: int = 1) -> NewtonResult:
    """Data-parallel registration: this rank's B/D scans (points (B/D, N,
    3), init_poses (B/D,)-batched) against one replicated RegMap with
    ``fused_math.newton_align_fused_batch``; no collective. The results
    stay on their rank, as the reference's batch-sharded output does."""
    return fused_math.newton_align_fused_batch(points, mask, regmap, init_poses, cfg, grid_shape,
                                               inner_iters)
