"""Registration map layout: dense-grid DIRECT7 without per-point search
(port of slamtpu/ndt/regmap.py, DIRECT7 builder only).

Per dilated cell (every voxel within one face step of an occupied one) a
96-float mega row holds the 7 DIRECT7 neighbors' payloads: 12 floats each
at 12*k (mean(3) + icov(9), or mean + plane-regularized covariance in the
aux table), validity flags at 84..90, zero pad; row D is the all-zero
sentinel. A dense int32 grid over the dilated bounding box maps a cell to
its row (D outside). A point's lookup is one grid read and one row read.

The build writes each (voxel, slot) payload straight into its row. Each
pair lands in a distinct (row, column block), so the writes need no
accumulation; writes with no target cell go to a scratch row past the
table, which is cut off. Every sentinel row stays inside its tensor, so no
index ever leaves its range.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import se3
from ..core.se3 import Pose3
from ..mapping import voxel
from ..mapping.gaussian_map import GaussianMap
from .objective import sanitize_points


class RegMap(NamedTuple):
    packed: torch.Tensor  # (D+1, 96) mega rows; row D = 0
    grid: torch.Tensor  # (Gx*Gy*Gz + 1,) int32 cell -> row (last = D)
    bbox_min: torch.Tensor  # (3,) int32 voxel coords of grid cell (0,0,0)
    origin: torch.Tensor  # (3,)
    resolution: torch.Tensor  # () on the CPU
    num_valid: torch.Tensor  # () int32
    overflow: torch.Tensor  # () int32 dilated cells dropped (capacity + bounds)
    packed_aux: Optional[torch.Tensor] = None  # (D+1, 96) alternative payload


def _unique_sorted(keys: torch.Tensor, capacity: int):
    """Sorted unique keys, INVALID-padded to ``capacity`` (static shapes, no
    host sync), and the number of distinct valid keys."""
    sk = torch.sort(keys, stable=True).values
    first = torch.cat([torch.ones_like(sk[:1], dtype=torch.bool), sk[1:] != sk[:-1]])
    first = first & (sk != voxel.INVALID_KEY)
    uk = torch.sort(torch.where(first, sk, voxel.INVALID_KEY)).values
    return uk[:capacity], torch.sum(first.to(torch.int32))


def _cell_of(c3, valid, bbox_min, grid_shape):
    gx, gy, gz = grid_shape
    n_cells = gx * gy * gz
    rel = c3 - bbox_min[None, :]
    ing = (
        valid
        & (rel[:, 0] >= 0) & (rel[:, 0] < gx)
        & (rel[:, 1] >= 0) & (rel[:, 1] < gy)
        & (rel[:, 2] >= 0) & (rel[:, 2] < gz)
    )
    return torch.where(ing, (rel[:, 0] * gy + rel[:, 1]) * gz + rel[:, 2], n_cells)


def build_regmap(
    gmap: GaussianMap,
    grid_shape: tuple = (256, 256, 64),
    dilated_capacity: Optional[int] = None,
    aux_payload: Optional[torch.Tensor] = None,
) -> RegMap:
    """Registration layout from a finalized GaussianMap; ``aux_payload``
    (V, 12) fills ``packed_aux`` over the same rows."""
    V = gmap.capacity
    D = dilated_capacity or 4 * V
    gx, gy, gz = grid_shape
    n_cells = gx * gy * gz
    dev, dt = gmap.mean.device, gmap.mean.dtype

    keys = torch.where(gmap.valid, gmap.keys, voxel.INVALID_KEY)
    coords = voxel.unpack(keys)
    # dilated set = occupied voxels + their 6 face neighbors
    dil = torch.cat([voxel.pack(voxel.shift(coords, off)) for off in voxel.DIRECT7_OFFSETS])
    dil = torch.where((keys != voxel.INVALID_KEY).repeat(7), dil, voxel.INVALID_KEY)
    dkeys, n_distinct = _unique_sorted(dil, D)
    dvalid = dkeys != voxel.INVALID_KEY
    dcoords = voxel.unpack(dkeys)

    big = torch.iinfo(torch.int32).max
    bbox_min = torch.amin(torch.where(dvalid[:, None], dcoords, big), dim=0)
    dflat = _cell_of(dcoords, dvalid, bbox_min, grid_shape)
    out_of_grid = torch.sum(((dflat == n_cells) & dvalid).to(torch.int32))
    overflow = (torch.clamp(n_distinct - D, min=0) + out_of_grid).to(torch.int32)
    rows = torch.where(dvalid, torch.arange(D, dtype=torch.int32, device=dev), D)
    grid = torch.full((n_cells + 1,), D, dtype=torch.int32, device=dev)
    grid[dflat.long()] = rows  # distinct cells; index n_cells is reset below
    grid[n_cells] = D

    # occupied voxel v is neighbor slot j of the dilated cell coords[v] - off_j
    trows = []
    for off in voxel.DIRECT7_OFFSETS:
        tr = grid[_cell_of(voxel.shift(coords, -off), gmap.valid, bbox_min, grid_shape).long()]
        trows.append(torch.where(gmap.valid & (tr < D), tr, D + 1).long())

    def scatter_rows(payload):
        # rows D+1.. are the drop target for pairs without a cell
        out = torch.zeros((D + 2, 96), dtype=dt, device=dev)
        payload = torch.where(gmap.valid[:, None], payload, 0.0)
        for j, tr in enumerate(trows):
            out[tr, 12 * j : 12 * j + 12] = payload
            out[tr, 84 + j] = 1.0
        out[D:] = 0.0  # the sentinel row, and the scratch row
        return out[: D + 1]

    packed = scatter_rows(torch.cat([gmap.mean, gmap.icov.reshape(V, 9)], dim=1))
    packed_aux = None
    if aux_payload is not None:
        packed_aux = scatter_rows(aux_payload.reshape(V, 12).to(dt))
    return RegMap(
        packed=packed, grid=grid, bbox_min=bbox_min, origin=gmap.origin,
        resolution=gmap.resolution, num_valid=gmap.num_valid(), overflow=overflow,
        packed_aux=packed_aux,
    )


def empty_regmap(capacity: int, grid_shape: tuple, device, dtype=torch.float32,
                 dilated_capacity: Optional[int] = None, with_aux: bool = False) -> RegMap:
    """An all-empty RegMap with build_regmap's shapes (the initial cache of
    apps that rebuild at reduced cadence)."""
    D = dilated_capacity or 4 * capacity
    gx, gy, gz = grid_shape
    zeros = lambda: torch.zeros((D + 1, 96), dtype=dtype, device=device)  # noqa: E731
    return RegMap(
        packed=zeros(),
        grid=torch.full((gx * gy * gz + 1,), D, dtype=torch.int32, device=device),
        bbox_min=torch.zeros(3, dtype=torch.int32, device=device),
        origin=torch.zeros(3, dtype=dtype, device=device),
        resolution=torch.tensor(1.0, dtype=dtype),
        num_valid=torch.zeros((), dtype=torch.int32, device=device),
        overflow=torch.zeros((), dtype=torch.int32, device=device),
        packed_aux=zeros() if with_aux else None,
    )


def point_rows(points, mask, pose: Pose3, regmap: RegMap, grid_shape):
    """Dense-grid lookup: (tp (N, 3), row (N,) int64), row D for masked or
    out-of-grid points. The one implementation of the indexing contract."""
    gx, gy, gz = grid_shape
    n_cells = gx * gy * gz
    if n_cells + 1 != regmap.grid.shape[0]:
        raise ValueError(f"grid_shape {grid_shape} does not match the RegMap's grid "
                         f"({regmap.grid.shape[0] - 1} cells)")
    points, mask = sanitize_points(points, mask)
    tp = se3.transform_points(pose, points)
    inv_res = (1.0 / regmap.resolution).to(points.dtype)
    coords = voxel.coords_of(tp, regmap.origin.to(points.dtype), inv_res)
    flat = _cell_of(coords, mask, regmap.bbox_min, grid_shape)
    return tp, regmap.grid[flat.long()].long()
