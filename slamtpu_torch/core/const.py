"""Small constant tensors, made once per (values, dtype, device).

A tensor built from host values reaches a CUDA device through a blocking
copy, which waits for the stream to drain. The keyframe path builds its
constants through this cache, so that only the first keyframe pays it.
"""
from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _cached(values: tuple, dtype, device: str) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def constant(values, dtype, device) -> torch.Tensor:
    """A cached tensor of ``values`` (a flat sequence of numbers)."""
    return _cached(tuple(float(v) for v in values), dtype, str(torch.device(device)))
