"""Fixed-capacity Gaussian voxel map, the NDT target (port of
slamtpu/mapping/gaussian_map.py).

pass 1: pack voxel keys -> stable sort by key -> segment sums of n, sum(x)
        and sum(x x^T) over voxel-CORNER-RELATIVE coordinates;
pass 2: mean, Bessel-corrected covariance, eigenvalue inflation at
        ``min_covar_eigvalue_mult * lambda_max``, inverse and validity gates.

Float segment sums go through ``segment_sum``, which adds each segment in
a fixed order on either device, so a build repeats bit for bit and a
resumed run can equal a continuous one: float64 prefix sums on the GPU
(``segment_sum_scan``), float32 ``index_add_`` on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import linalg
from . import voxel

MIN_EIGENVALUE_THRESHOLD = 1e-12
MAX_INVERSE_COEFF = 1e12


class VoxelStats(NamedTuple):
    keys: torch.Tensor  # (V,) int32 sorted, INVALID_KEY padding
    n: torch.Tensor  # (V,) int32
    sx: torch.Tensor  # (V, 3) sum of voxel-corner-relative points
    sxx: torch.Tensor  # (V, 3, 3) sum of their outer products
    origin: torch.Tensor  # (3,)
    resolution: torch.Tensor  # () on the CPU (a scalar for device ops)
    overflow: torch.Tensor  # () int32: distinct voxels dropped for capacity


class GaussianMap(NamedTuple):
    keys: torch.Tensor  # (V,) int32 sorted
    count: torch.Tensor  # (V,) int32
    mean: torch.Tensor  # (V, 3)
    cov: torch.Tensor  # (V, 3, 3) regularized covariance
    icov: torch.Tensor  # (V, 3, 3)
    evals: torch.Tensor  # (V, 3) ascending (inflated)
    evecs: torch.Tensor  # (V, 3, 3) columns
    valid: torch.Tensor  # (V,) bool
    origin: torch.Tensor  # (3,)
    resolution: torch.Tensor  # () on the CPU

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    def num_valid(self) -> torch.Tensor:
        return torch.sum(self.valid.to(torch.int32)).to(torch.int32)


def segment_sum(values: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Row sums of ``values`` (M, ...) by segment id ``seg`` (M,) int64,
    sorted ascending, into ``num_segments`` rows, in an order that does not
    change from run to run.

    On the GPU ``index_add_``'s atomics add in no fixed order, so the card
    takes ``segment_sum_scan``. The CPU keeps float32 ``index_add_``, which
    adds in index order and so rounds as the reference's float32 segment
    sums over the same sorted points do, bit for bit.
    ``test_build_map_matches_reference`` needs that: it holds the map's
    validity gate to the reference's exactly, and with the scan's float64
    sums 3 coplanar voxels of its cloud flip the smallest-eigenvalue sign
    test. ``test_build_map_with_scan_sums_matches_reference`` and
    ``test_run_replay_with_scan_sums_matches_reference`` hold the card's
    sums, run on the CPU, to the reference."""
    if values.device.type == "cpu":
        out = torch.zeros((num_segments,) + tuple(values.shape[1:]), dtype=values.dtype)
        return out.index_add_(0, seg, values)
    return segment_sum_scan(values, seg, num_segments)


def segment_sum_scan(values: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``segment_sum`` by float64 prefix sums over the sorted ``seg`` (the
    GPU's path; on any device): each segment is the difference of the
    prefix sum at its two ends. A scan adds in a fixed order, and in
    float64 the difference is off by ~1e-9 at most for the map's
    corner-relative sums, below their float32 rounding."""
    # one 1-D scan over the columns laid end to end, each led by a zero: the
    # GPU scans a 1-D tensor with the whole device, where a scan along a
    # dimension of a 2-D one runs a thread (or block) per column. Within a
    # column the difference cancels the sums of the columns before it.
    M = values.shape[0]
    cols = torch.nn.functional.pad(values.reshape(M, -1).t().to(torch.float64), (1, 0))
    prefix = torch.cumsum(cols.reshape(-1), 0).view(cols.shape)
    ids = torch.arange(num_segments, dtype=seg.dtype, device=seg.device)
    lo, hi = torch.searchsorted(seg, ids), torch.searchsorted(seg, ids, right=True)
    sums = (prefix[:, hi] - prefix[:, lo]).t()
    return sums.to(values.dtype).reshape((num_segments,) + tuple(values.shape[1:]))


def _sorted_segments(keys: torch.Tensor, capacity: int):
    """Stable sort by key; returns (order, sorted keys, segment-start flags,
    segment ids). Invalid keys and voxels beyond ``capacity`` go to the
    overflow segment ``capacity``."""
    order = torch.argsort(keys, stable=True)
    skeys = keys[order]
    is_valid = skeys != voxel.INVALID_KEY
    first = torch.cat([torch.ones_like(is_valid[:1]), skeys[1:] != skeys[:-1]]) & is_valid
    seg = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    seg = torch.where(is_valid & (seg >= 0) & (seg < capacity), seg, capacity).long()
    return order, skeys, first, seg


def _segment_reduce(keys: torch.Tensor, points: torch.Tensor, capacity: int):
    """Stable sort by key and segment-sum the sufficient statistics of
    ``points`` (already voxel-corner-relative; a global cumsum difference
    would bring back the f32 cancellation the corner shift removes).
    Returns (slot_keys, n, sx, sxx, overflow) over ``capacity`` slots."""
    order, skeys, first, seg = _sorted_segments(keys, capacity)
    spts = points[order]
    dev = points.device
    n = torch.zeros(capacity + 1, dtype=torch.int32, device=dev)
    n.index_add_(0, seg, torch.ones_like(seg, dtype=torch.int32))
    sx = segment_sum(spts, seg, capacity + 1)
    sxx = segment_sum((spts[:, :, None] * spts[:, None, :]).reshape(-1, 9), seg, capacity + 1)
    # every key of a kept segment is the same, so any write is its key
    slot_keys = torch.full(
        (capacity + 1,), int(np.iinfo(np.int32).min), dtype=torch.int32, device=dev
    ).scatter_reduce_(0, seg, skeys, reduce="amax")
    n, sx, sxx, slot_keys = n[:capacity], sx[:capacity], sxx[:capacity], slot_keys[:capacity]
    slot_keys = torch.where(n > 0, slot_keys, voxel.INVALID_KEY)
    n_distinct = torch.sum(first.to(torch.int32))
    overflow = torch.clamp(n_distinct - capacity, min=0).to(torch.int32)
    return slot_keys, n, sx, sxx.view(capacity, 3, 3), overflow


def _corner_keys(points, mask, origin, resolution):
    """Each point's packed voxel key (``INVALID_KEY`` where masked or
    non-finite) and its voxel-corner-relative coordinates (0 where
    non-finite)."""
    finite = torch.all(torch.isfinite(points), dim=-1)
    rel = points - origin.to(points.dtype)[None, :]
    coords = voxel.floor_to_int32(rel * (1.0 / resolution))
    keys = voxel.pack(coords)
    keys = torch.where(mask & finite, keys, voxel.INVALID_KEY)
    rel_v = rel - coords.to(points.dtype) * resolution
    rel_v = torch.where(finite[:, None], rel_v, 0.0)  # NaN/Inf must not poison sums
    return keys, rel_v


def stats_from_points(points, mask, origin, resolution, capacity: int) -> VoxelStats:
    """Per-voxel sufficient statistics of the masked, finite points (N, 3),
    accumulated relative to each point's voxel corner (magnitudes below the
    resolution): at origin-relative magnitudes of hundreds of meters the
    float32 rounding of E[xx] would swamp the surface-normal variance."""
    # a 0-dim CPU tensor: it enters device ops as a scalar, with no copy
    resolution = torch.as_tensor(resolution, dtype=points.dtype)
    keys, rel_v = _corner_keys(points, mask, origin, resolution)
    slot_keys, n, sx, sxx, overflow = _segment_reduce(keys, rel_v, capacity)
    return VoxelStats(slot_keys, n, sx, sxx, origin, resolution, overflow)


def finalize(
    stats: VoxelStats, min_points_per_voxel: int = 6, min_covar_eigvalue_mult: float = 0.01
) -> GaussianMap:
    """Sufficient statistics -> NDT Gaussians (Bessel-corrected covariance,
    eigenvalue inflation, inverse-covariance gates, >= 3 points floor)."""
    min_points_per_voxel = max(min_points_per_voxel, 3)
    n = stats.n
    dt = stats.sx.dtype
    nf = torch.clamp(n, min=1).to(dt)
    res = stats.resolution.to(dt)
    corner = (
        voxel.unpack(torch.where(stats.keys == voxel.INVALID_KEY, 0, stats.keys)).to(dt) * res
        + stats.origin.to(dt)[None, :]
    )
    rel_mean = stats.sx / nf[:, None]
    mean = rel_mean + corner
    cov = stats.sxx / nf[:, None, None] - rel_mean[:, :, None] * rel_mean[:, None, :]
    bessel = nf / torch.clamp(nf - 1.0, min=1.0)
    cov = cov * bessel[:, None, None]

    evals, evecs = linalg.sym_eig3x3(cov)
    psd_ok = (evals[:, 0] >= 0.0) & (evals[:, 1] >= 0.0) & (evals[:, 2] >= MIN_EIGENVALUE_THRESHOLD)
    min_acceptable = torch.clamp(evals[:, 2] * min_covar_eigvalue_mult, min=MIN_EIGENVALUE_THRESHOLD)
    evals = torch.maximum(evals, min_acceptable[:, None])
    cov = (evecs * evals[:, None, :]) @ evecs.transpose(-1, -2)
    icov = linalg.inv3x3(cov)
    icov_ok = torch.all(torch.isfinite(icov).reshape(-1, 9), dim=1) & (
        torch.amax(torch.abs(icov), dim=(1, 2)) <= MAX_INVERSE_COEFF
    )
    valid = (n >= min_points_per_voxel) & psd_ok & icov_ok
    icov = torch.where(valid[:, None, None], icov, 0.0)
    return GaussianMap(
        keys=stats.keys, count=n, mean=mean, cov=cov, icov=icov, evals=evals,
        evecs=evecs, valid=valid, origin=stats.origin, resolution=stats.resolution,
    )


def recenter_origin(origin, position, resolution: float, grid_dim: int = None,
                    threshold_frac: float = 0.5):
    """Shift the map origin (host numpy) when ``position`` strays from the
    key-range center. Returns (new_origin, shifted); the origin keeps its
    dtype."""
    grid_dim = grid_dim or voxel.GRID_DIM
    half = 0.5 * grid_dim * float(resolution)
    origin = np.asarray(origin)
    off = np.asarray(position, np.float64) - (origin.astype(np.float64) + half)
    if np.max(np.abs(off)) <= threshold_frac * half:
        return origin, False
    new_origin = np.floor((np.asarray(position) - half) / resolution) * resolution
    return new_origin.astype(origin.dtype), True


def build_map(points, mask, origin, resolution, capacity: int,
              min_points_per_voxel: int = 6, min_covar_eigvalue_mult: float = 0.01) -> GaussianMap:
    """One-shot map build: stats + finalize."""
    stats = stats_from_points(points, mask, origin, resolution, capacity)
    return finalize(stats, min_points_per_voxel, min_covar_eigvalue_mult)
