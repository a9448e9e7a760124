"""State carried between the JAX reference package and the port.

Plain functions from numpy arrays (the reference's NamedTuple fields,
each passed through ``np.asarray`` by the caller) to the port's tensors,
and back. This module imports no JAX.
"""
from __future__ import annotations

from typing import List, Mapping

import numpy as np
import torch

from .core.se3 import Pose3
from .fusion import graph
from .fusion.loop_closure import LoopClosure
from .fusion.pose_graph import PoseGraph
from .fusion.preintegration import ImuNoise
from .fusion.smoother import SmootherConfig
from .mapping.gaussian_map import GaussianMap
from .ndt.newton import NewtonConfig
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


def svn_config_from_fields(fields: Mapping) -> SvnConfig:
    """The port's SvnConfig from the reference SvnConfig's fields
    (``cfg._asdict()``)."""
    return SvnConfig(**{k: fields[k] for k in SvnConfig._fields if k in fields})


def newton_config_from_reference(cfg) -> NewtonConfig:
    """The port's NewtonConfig from the reference NewtonConfig (a NamedTuple
    of floats, or its ``_asdict()``), field for field."""
    fields = cfg if isinstance(cfg, Mapping) else cfg._asdict()
    return NewtonConfig(**{k: fields[k] for k in NewtonConfig._fields})


# the odom_ndt window carry: float64 window state, float32 clouds, bool masks
_CARRY_WINDOW = ("win_rot", "win_trans", "fp_rot", "fp_trans", "fp_sig", "fb_rot", "fb_trans",
                 "fb_si")


def odom_carry_from_numpy(fields: Mapping[str, np.ndarray], device="cpu") -> dict:
    """The port's odom_ndt carry from the reference app's carry dict (each
    field passed through ``np.asarray``): the window fields as float64, the
    target clouds as float32, their masks as bool, and the fill count ``n``
    as a host integer."""
    carry = {k: _t(fields[k], device, torch.float64) for k in _CARRY_WINDOW}
    carry["prev_points"] = _t(fields["prev_points"], device, torch.float32)
    carry["prev_mask"] = _t(fields["prev_mask"], device, torch.bool)
    carry["n"] = int(fields["n"])
    return carry


def _fields(nt) -> Mapping:
    return nt if isinstance(nt, Mapping) else nt._asdict()


def _f64_or_index(a, device):
    """float64, except the integer (index) fields, which stay int32, and
    the bool (mask) fields."""
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return _t(a, device, torch.bool)
    return _t(a, device, None if np.issubdtype(a.dtype, np.integer) else torch.float64)


def imu_noise_from_reference(noise, device="cpu") -> ImuNoise:
    """The port's ImuNoise (float64 tensors) from the reference ImuNoise
    (a NamedTuple or its ``_asdict()``)."""
    f = _fields(noise)
    return ImuNoise(*(_t(f[k], device, torch.float64) for k in ImuNoise._fields[:4]),
                    integration_sigma=float(f["integration_sigma"]))


def window_state_from_numpy(fields, device="cpu") -> graph.WindowState:
    """The port's WindowState from the reference WindowState's fields."""
    f = _fields(fields)
    return graph.WindowState(*(_f64_or_index(f[k], device) for k in graph.WindowState._fields))


def factors_from_numpy(fields, device="cpu") -> graph.Factors:
    """The port's Factors from the reference Factors (a NamedTuple of
    factor NamedTuples and the gravity vector, or the same as nested
    mappings), field for field: indices int32, masks bool, the rest
    float64."""
    f = _fields(fields)
    kinds = dict(prior_pose=graph.PriorPoseFactors, between=graph.BetweenFactors,
                 prior_vel=graph.VecPriorFactors, prior_bias=graph.VecPriorFactors,
                 imu=graph.ImuFactors, position=graph.PositionFactors)
    out = {name: cls(*(_f64_or_index(_fields(f[name])[k], device) for k in cls._fields))
           for name, cls in kinds.items()}
    return graph.Factors(**out, gravity=_t(f["gravity"], device, torch.float64))


def pose_graph_from_numpy(fields, device="cpu") -> PoseGraph:
    """The port's PoseGraph from the reference PoseGraph (a NamedTuple, or
    the same as mappings, its arrays numpy or anything ``np.array`` takes):
    floats keep their dtype, indices become int32, masks stay bool."""
    f = _fields(fields)
    poses = _fields(f["poses"])
    return PoseGraph(Pose3(_t(poses["rot"], device), _t(poses["trans"], device)),
                     *(_t(f[k], device) for k in PoseGraph._fields[1:]))


def loop_closures_from_reference(closures, device="cpu") -> List[LoopClosure]:
    """The port's LoopClosures from the reference's: the relative pose as
    tensors of its own dtype on ``device``, the covariance float64 numpy."""
    return [LoopClosure(int(c.i), int(c.j), Pose3(_t(c.relative.rot, device), _t(c.relative.trans, device)),
                        np.asarray(c.covariance, np.float64), float(c.score)) for c in closures]


def smoother_config_from_reference(cfg) -> SmootherConfig:
    """The port's SmootherConfig from the reference SmootherConfig (a
    NamedTuple or its ``_asdict()``), field for field."""
    f = _fields(cfg)
    return SmootherConfig(**{k: f[k] for k in SmootherConfig._fields})
