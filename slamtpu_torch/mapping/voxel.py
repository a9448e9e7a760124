"""Voxel key math (port of slamtpu/mapping/voxel.py).

Packed int32 keys ``(x * 1024 + y) * 1024 + z`` over voxel coordinates
relative to a map origin, each in ``[0, GRID_DIM)``; out-of-range
coordinates pack to ``INVALID_KEY``, which sorts last. Coordinates follow
the floor convention everywhere.
"""
from __future__ import annotations

import numpy as np
import torch

GRID_DIM = 1024  # voxels per axis; 1024^3 = 2^30 fits int32
INVALID_KEY = int(np.iinfo(np.int32).max)

# float32 values nearest the int32 range: float -> int32 casts saturate
# there, as XLA's conversion does (a plain cast of an out-of-range float is
# undefined in C++ and differs between the CPU and the GPU)
_I32_LO = -2147483648.0
_I32_HI = 2147483520.0

# DIRECT7 neighbor offsets: center + 6 face neighbors, and DIRECT1's center
# alone (numpy, so importing this module touches no device)
DIRECT7_OFFSETS = np.array(
    [[0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
    dtype=np.int32,
)
DIRECT1_OFFSETS = np.zeros((1, 3), dtype=np.int32)


def floor_to_int32(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.floor(x), _I32_LO, _I32_HI).to(torch.int32)


def coords_of(points: torch.Tensor, origin: torch.Tensor, inv_resolution) -> torch.Tensor:
    """Floored int32 voxel coordinates of points (..., 3) relative to origin."""
    return floor_to_int32((points - origin) * inv_resolution)


def pack(coords: torch.Tensor) -> torch.Tensor:
    """Pack int voxel coords (..., 3) into int32 keys (INVALID_KEY outside)."""
    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
    in_range = (
        (x >= 0) & (x < GRID_DIM) & (y >= 0) & (y < GRID_DIM) & (z >= 0) & (z < GRID_DIM)
    )
    key = (x * GRID_DIM + y) * GRID_DIM + z
    return torch.where(in_range, key, torch.full_like(key, INVALID_KEY))


def unpack(key: torch.Tensor) -> torch.Tensor:
    """Inverse of pack for valid keys: (...,) int32 -> (..., 3) int32."""
    z = torch.remainder(key, GRID_DIM)
    rem = torch.div(key, GRID_DIM, rounding_mode="floor")
    y = torch.remainder(rem, GRID_DIM)
    x = torch.div(rem, GRID_DIM, rounding_mode="floor")
    return torch.stack([x, y, z], dim=-1)


def key_of_points(points: torch.Tensor, origin: torch.Tensor, inv_resolution,
                  valid: torch.Tensor = None) -> torch.Tensor:
    """Packed keys of points, INVALID_KEY where ``valid`` is False."""
    key = pack(coords_of(points, origin, inv_resolution))
    if valid is not None:
        key = torch.where(valid, key, INVALID_KEY)
    return key


def lookup(sorted_keys: torch.Tensor, query_keys: torch.Tensor):
    """Slots of ``query_keys`` (...,) int32 in the sorted key array (V,)
    int32: (slot (...,) int64 clamped to V - 1, found (...,) bool). The
    INVALID_KEY padding sorts last, and an INVALID query is never found."""
    cap = sorted_keys.shape[0]
    idx = torch.searchsorted(sorted_keys, query_keys.contiguous(), side="left")
    idx = torch.clamp(idx, max=cap - 1)
    found = (sorted_keys[idx] == query_keys) & (query_keys != INVALID_KEY)
    return idx, found


def shift(coords: torch.Tensor, off) -> torch.Tensor:
    """coords (..., 3) + a constant integer offset, without a host-to-device
    copy of the offset."""
    return torch.stack([coords[..., a] + int(off[a]) for a in range(3)], dim=-1)
