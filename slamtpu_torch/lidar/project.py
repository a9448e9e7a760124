"""Range image -> point cloud projection and filtering on the device (port
of slamtpu/lidar/project.py).

    point = range * direction_lut[col, ch] + offset_lut[col]
    keep  = range in [rmin, rmax] & range > 0 & column valid
            & not inside the vehicle box
            & (z in [zmin, zmax] OR reflectivity >= threshold)

plus each point's normalized intra-sweep time ``alpha`` for the deskew.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class ProjectionFilters(NamedTuple):
    range_min: float = 0.0
    range_max: float = 1e9
    z_min: float = -1e9
    z_max: float = 1e9
    reflectivity_threshold: float = 255.0
    box_min: tuple = (0.0, 0.0, 0.0)
    box_max: tuple = (0.0, 0.0, 0.0)


class ScanBuffer(NamedTuple):
    """Padded fixed-shape scan: flattened (cols*sub) points + validity."""

    points: torch.Tensor  # (N, 3) float32, body frame
    mask: torch.Tensor  # (N,) bool
    alpha: torch.Tensor  # (N,) float32 intra-sweep time fraction in [0, 1]
    reflectivity: torch.Tensor  # (N,) uint8
    num_points: torch.Tensor  # () int32
    signal: Optional[torch.Tensor] = None  # (N,) int32 signal photons
    nir: Optional[torch.Tensor] = None  # (N,) int32 ambient NIR


def project_frame(ranges_m, reflectivity, col_timestamp_s, col_valid, direction, offset,
                  filters: ProjectionFilters, signal=None, nir=None) -> ScanBuffer:
    pts = ranges_m[..., None] * direction + offset[:, None, :]  # (cols, sub, 3)
    in_range = (
        (ranges_m >= filters.range_min)
        & (ranges_m <= filters.range_max)
        & (ranges_m > 0.0)
        & col_valid[:, None]
    )
    in_box = torch.ones_like(in_range)
    for a in range(3):
        in_box = in_box & (pts[..., a] >= filters.box_min[a]) & (pts[..., a] <= filters.box_max[a])
    z = pts[..., 2]
    z_or_refl = ((z >= filters.z_min) & (z <= filters.z_max)) | (
        reflectivity.to(torch.float32) >= filters.reflectivity_threshold
    )
    keep = in_range & ~in_box & z_or_refl

    # normalized intra-sweep time per column (0 where invalid), in float64
    ts = col_timestamp_s.to(torch.float64)
    t0 = torch.amin(torch.where(col_valid, ts, float("inf")))
    t1 = torch.amax(torch.where(col_valid, ts, float("-inf")))
    span = torch.clamp(t1 - t0, min=1e-12)
    alpha_col = torch.clamp((ts - t0) / span, 0.0, 1.0).to(torch.float32)
    alpha = alpha_col[:, None].expand(ranges_m.shape)

    n = ranges_m.shape[0] * ranges_m.shape[1]
    return ScanBuffer(
        points=pts.reshape(n, 3),
        mask=keep.reshape(n),
        alpha=alpha.reshape(n),
        reflectivity=reflectivity.reshape(n),
        num_points=torch.sum(keep.to(torch.int32)).to(torch.int32),
        signal=None if signal is None else signal.reshape(n),
        nir=None if nir is None else nir.reshape(n),
    )


def pack_frame(ranges_m, reflectivity, col_timestamp_s, col_valid, signal=None, nir=None):
    """Host side: one (cols, 2*sub + 2) float32 array carrying the decoded
    frame (``(cols, 4*sub + 2)`` with signal and NIR), so a keyframe makes one
    host-to-device copy. Column timestamps are re-based to the first valid
    column in float64 before the float32 cast."""
    cols, sub = ranges_m.shape
    extras = 2 * sub if signal is not None else 0
    out = np.empty((cols, 2 * sub + extras + 2), np.float32)
    out[:, :sub] = ranges_m
    out[:, sub : 2 * sub] = reflectivity
    if signal is not None:
        out[:, 2 * sub : 3 * sub] = signal
        out[:, 3 * sub : 4 * sub] = nir
    ts = np.asarray(col_timestamp_s, np.float64)
    valid = np.asarray(col_valid, bool)
    base = ts[valid][0] if valid.any() else 0.0
    out[:, 2 * sub + extras] = ts - base
    out[:, 2 * sub + extras + 1] = valid
    return out


def project_frame_packed(packed, direction, offset, filters: ProjectionFilters) -> ScanBuffer:
    """project_frame on a pack_frame buffer (the same numbers)."""
    sub = direction.shape[1]
    ranges_m = packed[:, :sub]
    reflectivity = packed[:, sub : 2 * sub].to(torch.uint8)
    with_radiometry = packed.shape[1] == 4 * sub + 2
    extras = 2 * sub if with_radiometry else 0
    signal = nir = None
    if with_radiometry:  # uint16 values, held as int32 (exact)
        signal = packed[:, 2 * sub : 3 * sub].to(torch.int32)
        nir = packed[:, 3 * sub : 4 * sub].to(torch.int32)
    col_timestamp_s = packed[:, 2 * sub + extras]
    col_valid = packed[:, 2 * sub + extras + 1] > 0.5
    return project_frame(ranges_m, reflectivity, col_timestamp_s, col_valid,
                         direction, offset, filters, signal=signal, nir=nir)


def filters_from_params(params) -> ProjectionFilters:
    """ProjectionFilters from a lidar.ouster.LidarParams."""
    half = np.asarray(params.vehicle_box_dimensions, np.float32) / 2.0
    center = np.asarray(params.vehicle_box_center, np.float32)
    return ProjectionFilters(
        range_min=float(params.range_filter[0]),
        range_max=float(params.range_filter[1]),
        z_min=float(params.z_filter[0]),
        z_max=float(params.z_filter[1]),
        reflectivity_threshold=float(params.reflectivity_threshold),
        box_min=tuple((center - half).tolist()),
        box_max=tuple((center + half).tolist()),
    )
