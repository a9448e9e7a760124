"""Registration map layout: dense-grid DIRECT7 without per-point search
(port of slamtpu/ndt/regmap.py: ``build_regmap``, ``build_regmap_kdtree``,
``radius_gate`` and the row lookup).

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

The KDTREE search mode (``build_regmap_kdtree``) fills the same layout
with each cell's 7 leaves nearest its centre among the 27 cells around
it; the pair kernels then keep a slot only if its centroid lies within
the radius of the point (``radius_gate``), as the reference's radius
search over leaf centroids does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.const import constant
from ..core.se3 import Pose3
from ..mapping import voxel
from ..mapping.gaussian_map import GaussianMap


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


def _dilated_grid(keys, offsets, D: int, grid_shape: tuple):
    """The dilated cell set of the valid ``keys`` (every cell at one of
    ``offsets`` from an occupied one), capped at D rows, and the dense grid
    over its bounding box: (dcoords, dvalid, bbox_min, grid, overflow)."""
    gx, gy, gz = grid_shape
    n_cells = gx * gy * gz
    dev = keys.device
    coords = voxel.unpack(keys)
    dil = torch.cat([voxel.pack(voxel.shift(coords, off)) for off in offsets])
    dil = torch.where((keys != voxel.INVALID_KEY).repeat(len(offsets)), dil, voxel.INVALID_KEY)
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
    return dcoords, dvalid, bbox_min, grid, overflow


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
    dev, dt = gmap.mean.device, gmap.mean.dtype

    keys = torch.where(gmap.valid, gmap.keys, voxel.INVALID_KEY)
    coords = voxel.unpack(keys)
    # dilated set = occupied voxels + their 6 face neighbors
    _, _, bbox_min, grid, overflow = _dilated_grid(keys, voxel.DIRECT7_OFFSETS, D, grid_shape)

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


# the 3 x 3 x 3 cell neighbourhood, in the reference's (meshgrid "ij") order
KD_OFFSETS = np.stack(
    np.meshgrid(*([np.arange(-1, 2, dtype=np.int32)] * 3), indexing="ij"), -1
).reshape(27, 3)


def build_regmap_kdtree(
    gmap: GaussianMap,
    grid_shape: tuple = (256, 256, 64),
    dilated_capacity: Optional[int] = None,
) -> RegMap:
    """The RegMap of the KDTREE search mode (default D = 6V rows).

    A leaf's centroid lies inside its own voxel, so every leaf within one
    resolution of a point in cell c sits in c's 3 x 3 x 3 neighbourhood.
    Each cell of the 27-dilated set holds, in its 7 slots, the occupied
    leaves of that neighbourhood nearest the cell's centre (a stable sort
    of the 27 distances: ties keep the neighbourhood order). The gate
    |tp - mu| <= radius is the pair kernels' (``radius_gate``). Exact while
    at most 7 leaves fall within the radius."""
    V = gmap.capacity
    D = dilated_capacity or 6 * V
    dev, dt = gmap.mean.device, gmap.mean.dtype
    n_cells = grid_shape[0] * grid_shape[1] * grid_shape[2]

    keys = torch.where(gmap.valid, gmap.keys, voxel.INVALID_KEY)
    payload = torch.where(gmap.valid[:, None],
                          torch.cat([gmap.mean, gmap.icov.reshape(V, 9)], dim=1), 0.0)
    dcoords, dvalid, bbox_min, grid, overflow = _dilated_grid(keys, KD_OFFSETS, D, grid_shape)

    # occupied-cell grid: cell -> payload row (sentinel V)
    oflat = _cell_of(voxel.unpack(keys), gmap.valid, bbox_min, grid_shape)
    occgrid = torch.full((n_cells + 1,), V, dtype=torch.int32, device=dev)
    occgrid[oflat.long()] = torch.where(gmap.valid, torch.arange(V, dtype=torch.int32, device=dev), V)
    occgrid[n_cells:].fill_(V)  # a fill: writing a number through an index waits for the device

    # candidate leaves per dilated cell: its 27-neighbourhood's occupants
    cand = torch.stack([
        occgrid[_cell_of(voxel.shift(dcoords, o), dvalid, bbox_min, grid_shape).long()]
        for o in KD_OFFSETS
    ], dim=1).long()  # (D, 27) payload rows, sentinel V
    mu_table = torch.cat([gmap.mean, gmap.mean.new_zeros((1, 3))])
    center = (dcoords.to(dt) + 0.5) * gmap.resolution.to(dt) + gmap.origin.to(dt)[None, :]
    dist2 = torch.sum((mu_table[cand] - center[:, None, :]) ** 2, dim=-1)
    dist2 = torch.where(cand < V, dist2, torch.inf)
    order = torch.argsort(dist2, dim=1, stable=True)[:, :7]  # (D, 7) nearest candidates
    sel = torch.gather(cand, 1, order)
    sel_ok = sel < V

    pay_table = torch.cat([payload, payload.new_zeros((1, 12))])
    fields = pay_table[sel]  # (D, 7, 12); the sentinel row V is zero
    packed = torch.cat([fields.reshape(D, 84), sel_ok.to(dt), fields.new_zeros((D, 5))], dim=1)
    packed = torch.where(dvalid[:, None], packed, 0.0)
    packed = torch.cat([packed, packed.new_zeros((1, 96))])
    return RegMap(
        packed=packed, grid=grid, bbox_min=bbox_min, origin=gmap.origin,
        resolution=gmap.resolution, num_valid=gmap.num_valid(), overflow=overflow,
    )


def radius_gate(tp, mu, active_slot, kd_radius):
    """The KDTREE gate on gathered slots: slot k of point i counts only if
    |tp_i - mu_ik|^2 <= kd_radius^2 (tp (N, 3), mu (N, 7, 3), active_slot
    (N, 7)). None or 0 disables it (DIRECT7)."""
    if kd_radius is None or kd_radius <= 0.0:
        return active_slot
    d2 = torch.sum((tp[:, None, :] - mu) ** 2, dim=-1)
    return active_slot & (d2 <= kd_radius * kd_radius)


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


def grid_rows(points, mask, pose: Pose3, regmap: RegMap, grid_shape) -> torch.Tensor:
    """Dense-grid lookup: each point's row (N,) int32, row D for masked,
    non-finite or out-of-grid points. The one implementation of the
    indexing contract.

    It runs once per SVN iteration and Newton outer iteration, so it is
    written with few elementwise launches (on the H100 each costs a few
    microseconds, and a (N, 3) x (3, 3) matmul goes to a GEMM kernel that
    costs more than all of them): the pose is applied as a broadcast
    product and a sum, a non-finite point fails the in-grid test by itself
    (NaN compares false), and the cell test and index work on the floored
    float coordinates, which are exact integers wherever a point can be
    inside the grid (|coordinate| < 2^24 voxels)."""
    gx, gy, gz = grid_shape
    n_cells = gx * gy * gz
    if n_cells + 1 != regmap.grid.shape[0]:
        raise ValueError(f"grid_shape {grid_shape} does not match the RegMap's grid "
                         f"({regmap.grid.shape[0] - 1} cells)")
    dt, dev = points.dtype, points.device
    tp = (points[:, None, :] * pose.rot).sum(-1) + pose.trans
    inv_res = (1.0 / regmap.resolution).to(dt)
    rel = torch.floor((tp - regmap.origin.to(dt)) * inv_res) - regmap.bbox_min
    inside = ((rel >= 0) & (rel < constant((gx, gy, gz), dt, dev))).all(-1) & mask
    cell = (rel.to(torch.int64) * constant((gy * gz, gz, 1), torch.int64, dev)).sum(-1)
    return regmap.grid[torch.where(inside, cell, n_cells)]
