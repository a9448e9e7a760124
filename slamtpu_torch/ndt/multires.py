"""Coarse-to-fine multi-resolution NDT (port of slamtpu/ndt/multires.py).

The scan is registered against Gaussian maps of decreasing voxel size,
each level seeding the next: coarse levels widen the basin of
convergence, the finest gives the accuracy (the reference's
multigrid_ndt_omp variant). Each level is the Newton driver over the NDT
pair kernel with one step per row lookup and the score and Hessian taken
at the returned pose: the contract of the reference's Newton loop
(``newton_align_reg``).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

from ..core.se3 import Pose3
from ..mapping import gaussian_map
from .fused_math import newton_align_fused
from .newton import NewtonConfig, NewtonResult
from .regmap import RegMap, build_regmap


class MultiResLevel(NamedTuple):
    regmap: RegMap
    grid_shape: Tuple[int, int, int]
    cfg: NewtonConfig


def build_pyramid(points, mask, origin, resolutions: Sequence[float], capacity: int,
                  grid_shape: Tuple[int, int, int] = (256, 256, 64),
                  min_points_per_voxel: int = 6,
                  max_iterations: Sequence[int] = None) -> list:
    """The map pyramid of one target cloud, coarse first; each level's
    NewtonConfig has its resolution, its iteration budget, trans_eps 1e-3
    and the defaults otherwise."""
    resolutions = sorted(resolutions, reverse=True)
    iters = max_iterations or [10] * (len(resolutions) - 1) + [20]
    if len(iters) != len(resolutions):
        raise ValueError(f"max_iterations has {len(iters)} entries for {len(resolutions)} "
                         "resolutions: zip would silently drop pyramid levels")
    levels = []
    for res, it in zip(resolutions, iters):
        gmap = gaussian_map.build_map(points, mask, origin, res, capacity=capacity,
                                      min_points_per_voxel=min_points_per_voxel)
        levels.append(MultiResLevel(build_regmap(gmap, grid_shape=grid_shape), grid_shape,
                                    NewtonConfig(resolution=res, max_iterations=it, trans_eps=1e-3)))
    return levels


def multires_align(points, mask, levels: Sequence[MultiResLevel], init_pose: Pose3) -> NewtonResult:
    """Align through the pyramid; the finest level's result."""
    pose, result = init_pose, None
    for lvl in levels:
        result = newton_align_fused(points, mask, lvl.regmap, pose, lvl.cfg, lvl.grid_shape,
                                    inner_iters=1, final_eval=True)
        pose = result.pose
    return result
