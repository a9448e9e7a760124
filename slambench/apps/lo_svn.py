"""Build the port's ``LoSvnApp`` from a configuration file of the
benchmark."""
from __future__ import annotations

import numpy as np

# the port's device-timer span of the map + RegMap build and of the
# registration, as this app names them
MAP_SPAN = "map_rebuild"
REGISTER_SPAN = "svn"


def pipeline_config(cfg: dict):
    """The port's PipelineConfig for a configuration file's ``sensor``,
    ``register`` and ``deskew``."""
    from slamtpu_torch.ins.imu_config import ImuConfig
    from slamtpu_torch.lidar.ouster import LidarParams, synthetic_os2_metadata
    from slamtpu_torch.runtime.config import PipelineConfig, RegisterConfig

    s = cfg["sensor"]
    meta = synthetic_os2_metadata(columns_per_frame=s["columns_per_frame"],
                                  pixels_per_column=s["pixels_per_column"],
                                  columns_per_packet=s["columns_per_packet"], fov_deg=s["fov_deg"])
    reg = dict(cfg["register"])
    reg["reg_grid_shape"] = tuple(reg["reg_grid_shape"])
    return PipelineConfig(
        meta=meta,
        lidar=LidarParams(channel_stride=s["channel_stride"], range_filter=tuple(s["range_filter"]),
                          body_to_lidar_rotation=np.eye(3), body_to_lidar_translation=np.zeros(3)),
        imu=ImuConfig(),
        register=RegisterConfig(**reg),
        deskew=bool(cfg["deskew"]),
    )


def make(cfg: dict, device):
    from slamtpu_torch.apps.lo_svn import LoSvnApp

    return LoSvnApp(pipeline_config(cfg), device, **cfg.get("app_args", {}))


def state(app):
    """What the reference judges besides the trajectory: each keyframe's
    count of kept points, and the ring's clouds at the end of the run,
    {keyframe: (world points (N, 3) float64, mask (N,))} (keyframe j sits in
    slot j mod W: the ring's head starts at 0 and moves one a keyframe)."""
    kept = [int(r.num_points) for r in app.stats.records]
    W = app._kf_points.shape[0]
    n = len(kept)
    ring = {j: (app._kf_points[j % W].double().cpu().numpy(), app._kf_mask[j % W].cpu().numpy())
            for j in range(max(0, n - W), n)}
    return kept, ring


def published(app) -> int:
    """How many keyframes the app has published, each with its pose on the
    host: the length of its trajectory list. Not ``app.trajectory``, whose
    property calls ``flush()``; nothing here reads the device, so a look
    after every ``process()`` adds no wait and changes no schedule."""
    return len(app._trajectory)
