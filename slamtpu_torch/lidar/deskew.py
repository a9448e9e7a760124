"""Motion deskew of a sweep from per-point intra-sweep times (port of
slamtpu/lidar/deskew.py).

Each point is re-expressed in the end-of-sweep body frame by the relative
motion still to come after its time alpha, on the SE(3) geodesic between
the sweep's start and end poses: p' = Exp(-(1 - alpha) xi) p with
xi = Log(T_start^-1 T_end).
"""
from __future__ import annotations

import torch

from ..core import se3
from ..core.se3 import Pose3


def deskew_points(points: torch.Tensor, alpha: torch.Tensor, pose_start: Pose3,
                  pose_end: Pose3) -> torch.Tensor:
    """Return points (N, 3) re-expressed in the end-of-sweep body frame."""
    xi = se3.local(pose_start, pose_end)  # (6,)
    T = se3.expmap(-(1.0 - alpha)[:, None] * xi[None, :])  # (N,) poses
    return (T.rot @ points[..., None])[..., 0] + T.trans


def deskew_scan(scan, pose_start: Pose3, pose_end: Pose3):
    """Deskew a ScanBuffer (returns a new one)."""
    return scan._replace(points=deskew_points(scan.points, scan.alpha, pose_start, pose_end))
