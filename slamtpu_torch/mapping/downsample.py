"""Point-cloud downsampling and cropping with fixed shapes (port of
slamtpu/mapping/downsample.py).

- ``voxel_downsample``: one point per occupied voxel, the centroid, like
  ``pcl::VoxelGrid`` (the reference applies it at map-distribution time);
  the same sort and segment sums as the Gaussian map, padded to a fixed
  capacity.
- ``axis_crop``: a band-pass mask on one coordinate axis, like
  ``pcl::PassThrough``.
"""
from __future__ import annotations

import torch

from . import voxel
from .gaussian_map import _sorted_segments, segment_sum


def voxel_downsample(points: torch.Tensor, mask: torch.Tensor, origin: torch.Tensor, resolution,
                     capacity: int):
    """Centroid per voxel over a padded point buffer: (centroids (capacity,
    3), out_mask (capacity,), overflow ()) where ``overflow`` counts the
    distinct occupied voxels dropped for capacity. Slots past the occupied
    voxels are masked out and hold zeros. Voxels outside the [0,
    GRID_DIM)^3 key range around ``origin`` are dropped."""
    finite = torch.all(torch.isfinite(points), dim=-1)
    inv_res = 1.0 / torch.as_tensor(resolution, dtype=points.dtype)
    keys = voxel.pack(voxel.coords_of(points, origin.to(points.dtype), inv_res))
    keys = torch.where(mask & finite, keys, voxel.INVALID_KEY)
    order, _, first, seg = _sorted_segments(keys, capacity)
    n = torch.zeros(capacity + 1, dtype=torch.int32, device=points.device)
    n.index_add_(0, seg, torch.ones_like(seg, dtype=torch.int32))
    sx = segment_sum(torch.where(finite[:, None], points, 0.0)[order], seg, capacity + 1)
    n, sx = n[:capacity], sx[:capacity]
    out_mask = n > 0
    centroids = torch.where(out_mask[:, None], sx / torch.clamp(n, min=1).to(points.dtype)[:, None], 0.0)
    overflow = torch.clamp(torch.sum(first.to(torch.int32)) - capacity, min=0).to(torch.int32)
    return centroids, out_mask, overflow


def axis_crop(points: torch.Tensor, mask: torch.Tensor, axis: int, lo, hi) -> torch.Tensor:
    """PassThrough band filter: keep masked points with lo <= p[axis] <= hi."""
    v = points[:, axis]
    return mask & (v >= lo) & (v <= hi)
