"""Build the port's ``OdomNdtApp`` from a configuration file of the
benchmark."""
from __future__ import annotations

import inspect

import numpy as np
import torch

from .lo_svn import pipeline_config

# the port's device-timer span of the map + RegMap build and of the
# registration, as this app names them
MAP_SPAN = "map_build"
REGISTER_SPAN = "newton"
# the trust gain's settings in the configuration's ``fusion`` block, which
# the app takes from robust.trust_gain_update_np's defaults
TRUST_GAIN = ("denial_threshold", "recovery_rate", "denied_scale")
# the precision the configuration states for the target map's voxel
# statistics: double, as the source's covariances
MAP_DTYPE = torch.float64


def make(cfg: dict, device):
    from slamtpu_torch.apps import odom_ndt
    from slamtpu_torch.fusion import robust

    port_dtype = getattr(odom_ndt, "MAP_DTYPE", torch.float32)
    if port_dtype != MAP_DTYPE:
        raise ValueError(f"the port builds the target map's statistics in {port_dtype}, "
                         f"the configuration in {MAP_DTYPE}")
    fu = cfg["fusion"]
    defaults = inspect.signature(robust.trust_gain_update_np).parameters
    for k in TRUST_GAIN:
        if float(fu[k]) != float(defaults[k].default):
            raise ValueError(f"fusion.{k} {fu[k]} is not the port's {defaults[k].default}")
    return odom_ndt.OdomNdtApp(pipeline_config(cfg), device, window=int(fu["window"]),
                               smoother_iters=int(fu["smoother_iters"]),
                               max_trans_deviation=float(fu["max_trans_deviation"]),
                               max_rot_deviation=float(fu["max_rot_deviation"]))


def state(app):
    """What the reference judges besides the trajectory: each keyframe's
    count of kept points (keyframe 0 has no record) and blend weight, and
    the target cloud(s) the app holds at the end of the run, {keyframe:
    (world points (N, 3) float64, mask (N,))}, each keyframe's cloud placed
    at its published pose (slot M-1 of the ring is the newest keyframe)."""
    recs = app._stats.records
    kept = {j + 1: (int(r.num_points), float(r.trust_weight)) for j, r in enumerate(recs)}
    n = len(app._trajectory)
    pts, mask = app._carry["prev_points"], app._carry["prev_mask"]
    M = pts.shape[0]
    clouds = {}
    for slot in range(M):
        j = n - M + slot
        if j < 0:
            continue
        pose = app._trajectory[j].pose
        R, t = np.asarray(pose.rot, np.float64), np.asarray(pose.trans, np.float64)
        clouds[j] = (pts[slot].double().cpu().numpy() @ R.T + t, mask[slot].cpu().numpy())
    return kept, clouds


def published(app) -> int:
    """How many keyframes the app has published, each with its pose on the
    host: the length of its trajectory list. Not ``app.trajectory``, whose
    property calls ``flush()``; nothing here reads the device, so a look
    after every ``process()`` adds no wait and changes no schedule."""
    return len(app._trajectory)
