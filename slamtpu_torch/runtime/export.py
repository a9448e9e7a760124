"""End-of-run exports, on the host with numpy (port of
slamtpu/runtime/export.py): the NDT map as text files (ellipsoids, voxel
counts, summary), the compass CSV archive for IMU calibration, ASCII PLY
point clouds and TUM-format trajectories. The files are byte for byte the
reference's on the same inputs.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..ins.anpp import NavFrame
from ..mapping.gaussian_map import GaussianMap


@dataclasses.dataclass
class NdtExportData:
    """Per-valid-voxel Gaussian summaries (the reference's NdtEllipsoid and
    NdtVoxel)."""

    means: np.ndarray  # (V, 3)
    evals: np.ndarray  # (V, 3) ascending
    evecs: np.ndarray  # (V, 3, 3) columns
    counts: np.ndarray  # (V,)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def extract_ndt_data(gmap: GaussianMap) -> NdtExportData:
    """Mean, eigenvectors, eigenvalues and count of each valid voxel."""
    valid = _host(gmap.valid)
    return NdtExportData(means=_host(gmap.mean)[valid], evals=_host(gmap.evals)[valid],
                         evecs=_host(gmap.evecs)[valid], counts=_host(gmap.count)[valid])


def write_ndt_data(data: NdtExportData, prefix: str):
    """<prefix>_ellipsoids.txt, <prefix>_voxels.txt and <prefix>_summary.txt."""
    with open(f"{prefix}_ellipsoids.txt", "w") as f:
        f.write("# mean_x mean_y mean_z eval1 eval2 eval3 evec_colmajor(9)\n")
        for m, ev, evec in zip(data.means, data.evals, data.evecs):
            cols = " ".join(f"{v:.9g}" for v in evec.T.ravel())
            f.write(f"{m[0]:.9g} {m[1]:.9g} {m[2]:.9g} {ev[0]:.9g} {ev[1]:.9g} {ev[2]:.9g} {cols}\n")
    with open(f"{prefix}_voxels.txt", "w") as f:
        f.write("# mean_x mean_y mean_z count\n")
        for m, c in zip(data.means, data.counts):
            f.write(f"{m[0]:.9g} {m[1]:.9g} {m[2]:.9g} {int(c)}\n")
    with open(f"{prefix}_summary.txt", "w") as f:
        f.write(f"valid_voxels {len(data.counts)}\n")
        f.write(f"total_points {int(data.counts.sum())}\n")


COMPASS_COLUMNS = (
    ["t"] + [f"lla_{c}" for c in "012"] + [f"vel_ned_{c}" for c in "012"]
    + [f"quat_{c}" for c in "0123"] + [f"rpy_{c}" for c in "012"]
    + [f"accel_nav_{c}" for c in "012"] + [f"gyro_nav_{c}" for c in "012"] + ["g_force"]
    + [f"sigma_pos_{c}" for c in "012"] + [f"sigma_vel_{c}" for c in "012"]
    + [f"sigma_rpy_{c}" for c in "012"] + [f"imu_accel_{c}" for c in "012"]
    + [f"imu_gyro_{c}" for c in "012"] + [f"mag_{c}" for c in "012"] + [f"env_{c}" for c in "012"]
    + ["t29"] + [f"lla29_{c}" for c in "012"] + [f"vel29_{c}" for c in "012"]
    + [f"sigma_pos29_{c}" for c in "012"] + [f"tilt_heading29_{c}" for c in "0123"]
    + ["fail_bits", "init_bits", "fix_status", "fix_status29"]
)
_COMPASS_FIELDS = ("t", "lla", "vel_ned", "quat", "rpy", "accel_nav", "gyro_nav", "g_force",
                   "sigma_pos", "sigma_vel", "sigma_rpy", "imu_accel", "imu_gyro", "mag", "env", "t29",
                   "lla29", "vel29", "sigma_pos29", "tilt_heading29", "fail_bits", "init_bits",
                   "fix_status", "fix_status29")
_COMPASS_SCALARS = {"t", "g_force", "t29", "fail_bits", "init_bits", "fix_status", "fix_status29"}


def write_compass_csv(frames: List[NavFrame], path: str):
    """The full NavFrame archive as CSV, sorted by timestamp."""
    with open(path, "w") as f:
        f.write(",".join(COMPASS_COLUMNS) + "\n")
        for fr in sorted(frames, key=lambda fr: fr.t):
            vals = []
            for name in _COMPASS_FIELDS:
                v = getattr(fr, name)
                vals.extend([v] if name in _COMPASS_SCALARS else list(v))
            f.write(",".join(f"{v:.12g}" if isinstance(v, float) else str(v) for v in vals) + "\n")


def write_ply(points: np.ndarray, path: str, mask=None):
    """ASCII PLY of the (masked) points (N, 3)."""
    pts = points if mask is None else points[np.asarray(mask)]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {len(pts)}\n"
                "property float x\nproperty float y\nproperty float z\nend_header\n")
        for p in pts:
            f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f}\n")


def write_trajectory_tum(path: str, stamps, poses):
    """TUM-format trajectory (timestamp tx ty tz qx qy qz qw) for ATE tools."""
    from ..core import so3

    with open(path, "w") as f:
        for t, pose in zip(stamps, poses):
            q = so3.rot_to_quat(torch.tensor(_host(pose.rot))).numpy()
            tr = _host(pose.trans)
            f.write(f"{t:.9f} {tr[0]:.6f} {tr[1]:.6f} {tr[2]:.6f} "
                    f"{q[1]:.9f} {q[2]:.9f} {q[3]:.9f} {q[0]:.9f}\n")
