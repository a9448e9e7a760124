"""State carried between the JAX reference package and the port.

Plain functions from numpy arrays (the reference's NamedTuple fields,
each passed through ``np.asarray`` by the caller) to the port's tensors,
and back. This module imports no JAX.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .core.se3 import Pose3
from .mapping.gaussian_map import GaussianMap
from .ndt.regmap import RegMap
from .ndt.svn import SvnConfig


def _t(a, device, dtype=None):
    """Tensor of ``a``; integer arrays become int32, as the port keeps them."""
    a = np.array(a)
    if dtype is None and np.issubdtype(a.dtype, np.integer):
        dtype = torch.int32
    return torch.as_tensor(a, dtype=dtype, device=device)


def pose_from_numpy(rot, trans, device="cpu", dtype=torch.float32) -> Pose3:
    return Pose3(_t(rot, device, dtype), _t(trans, device, dtype))


def gaussian_map_from_numpy(fields: Mapping[str, np.ndarray], device="cpu") -> GaussianMap:
    """A GaussianMap from the reference map's fields (resolution stays a
    CPU scalar tensor, as the port keeps it)."""
    out = {k: _t(fields[k], device) for k in GaussianMap._fields if k != "resolution"}
    out["resolution"] = _t(fields["resolution"], "cpu", out["mean"].dtype)
    return GaussianMap(**out)


def regmap_from_numpy(fields: Mapping[str, np.ndarray], device="cpu") -> RegMap:
    """A RegMap from the reference RegMap's fields (``packed_aux`` may be
    missing or None)."""
    out = {
        k: _t(fields[k], device)
        for k in RegMap._fields
        if k not in ("resolution", "packed_aux")
    }
    aux = fields.get("packed_aux")
    out["packed_aux"] = None if aux is None else _t(aux, device)
    out["resolution"] = _t(fields["resolution"], "cpu", out["packed"].dtype)
    return RegMap(**out)


def to_numpy(named_tuple) -> dict:
    """Fields of a port NamedTuple (Pose3, GaussianMap, RegMap, ...) as numpy."""
    return {
        k: (None if v is None else v.detach().cpu().numpy())
        for k, v in named_tuple._asdict().items()
    }


# reference SvnConfig fields the port carries only at these values
_FIXED_SVN_FIELDS = {"use_direct1": False, "shared_gather": True, "kd_radius": 0.0}


def svn_config_from_fields(fields: Mapping) -> SvnConfig:
    """The port's SvnConfig from the reference SvnConfig's fields
    (``cfg._asdict()``). Raises on the modes this port does not carry
    (DIRECT1, per-particle gathers, the KDTREE radius gate)."""
    for k, v in _FIXED_SVN_FIELDS.items():
        if k in fields and fields[k] != v:
            raise NotImplementedError(f"SvnConfig.{k}={fields[k]!r} is not ported")
    return SvnConfig(**{k: fields[k] for k in SvnConfig._fields if k in fields})
