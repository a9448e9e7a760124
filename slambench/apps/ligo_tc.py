"""Build the port's ``LigoTcApp`` from a configuration file of the
benchmark."""
from __future__ import annotations

import dataclasses
import inspect

import numpy as np

from .lo_svn import pipeline_config

# the port's device-timer span of the map + RegMap build and of the
# registration, as this app names them
MAP_SPAN = "map_build"
REGISTER_SPAN = "newton"
# the trust gain's settings in the configuration's ``fusion`` block, which
# the app takes from robust.trust_gain_update_np's defaults
TRUST_GAIN = ("denial_threshold", "recovery_rate", "denied_scale")
# the noise densities of the configuration's ``imu`` block, the port's ImuConfig fields of the same names
IMU_NOISE = ("velocity_random_walk", "angular_random_walk", "bias_random_walk_accel", "bias_random_walk_gyro")


def make(cfg: dict, device):
    from slamtpu_torch.apps import ligo_tc
    from slamtpu_torch.fusion import preintegration, robust
    from slamtpu_torch.ins.imu_config import ImuConfig

    fu, imu = cfg["fusion"], cfg["imu"]
    defaults = inspect.signature(robust.trust_gain_update_np).parameters
    for k in TRUST_GAIN:
        if float(fu[k]) != float(defaults[k].default):
            raise ValueError(f"fusion.{k} {fu[k]} is not the port's {defaults[k].default}")
    if int(fu["smoother_iters"]) != ligo_tc.SMOOTHER_ITERATIONS:
        raise ValueError(f"fusion.smoother_iters {fu['smoother_iters']} is not the port's "
                         f"{ligo_tc.SMOOTHER_ITERATIONS}")
    if float(imu["integration_sigma"]) != preintegration.ImuNoise._field_defaults["integration_sigma"]:
        raise ValueError(f"imu.integration_sigma {imu['integration_sigma']} is not the port's")
    imu_cfg = ImuConfig(update_rate_hz=float(imu["update_rate_hz"]),
                        **{k: np.full(3, float(imu[k])) for k in IMU_NOISE})
    # the host record the reference redoes each keyframe from (``state``)
    app = ligo_tc.LigoTcApp(dataclasses.replace(pipeline_config(cfg), imu=imu_cfg), device,
                            window=int(fu["window"]), keep_record=True)
    tpl = app._factor_template
    for name, sigma in (("prior_vel", fu["prior_vel_sigma"]), ("prior_bias", fu["bias_prior_sigma"])):
        got = float(getattr(tpl, name).sqrt_info[0, 0, 0])
        if abs(got * float(sigma) - 1.0) > 1e-12:
            raise ValueError(f"fusion.{name} sigma {sigma} is not the port's {1.0 / got}")
    return app


def state(app):
    """What the reference judges besides the trajectory: each keyframe's
    count of kept points (keyframe 0 has no record), and ``held``: the
    app's host record (``record``, {keyframe: (solved window states, the
    poses its target was fused at, the registration's pose)}, all host
    numpy) and the registration ring's clouds at the end of the run,
    {keyframe: (world points (N, 3) float64, mask (N,))}, each placed at
    its published pose (slot k mod K holds keyframe k)."""
    recs = app.stats.records
    kept = {j + 1: int(r.num_points) for j, r in enumerate(recs)}
    n = len(app.trajectory)
    K = app._kf_clouds.shape[0]
    ring = {}
    for j in range(max(0, n - K), n):
        pose = app.trajectory[j].pose
        R, t = np.asarray(pose.rot, np.float64), np.asarray(pose.trans, np.float64)
        ring[j] = (app._kf_clouds[j % K].double().cpu().numpy() @ R.T + t, app._kf_masks[j % K].cpu().numpy())
    return kept, {"record": dict(app.record), "ring": ring}


def published(app) -> int:
    """How many keyframes the app has published, each with its pose on the
    host: the length of its trajectory list. Nothing here reads the
    device, so a look after every ``process()`` adds no wait and changes
    no schedule."""
    return len(app.trajectory)
