"""Shared app plumbing: replay ingest, INS pose seeding, the RegMap
rebuild cadence, the search-mode switch and the live viewer's hook (port
of slamtpu/apps/common.py, the parts the ported apps use).

Packets decode on the host (numpy + the native decoders), sync with the
INS stream, and each sweep reaches the device as one packed buffer.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Iterator, List, Optional

import numpy as np
import torch

from ..core.se3 import Pose3
from ..ins import geodesy
from ..ins.anpp import AnppDecoder, NavFrame
from ..lidar.ouster import FrameAssembler, build_luts
from ..lidar.project import ScanBuffer, filters_from_params, pack_frame, project_frame_packed
from ..ndt.regmap import empty_regmap
from ..runtime.config import PipelineConfig
from ..runtime.replay import STREAM_COMPASS, STREAM_LIDAR, read_replay
from ..runtime.sync import SyncedFrame, Synchronizer


def to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device``. To a CUDA device it goes through
    pinned memory with a non-blocking copy, so the host does not wait for
    the stream to drain."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def np_quat_to_rot(q) -> np.ndarray:
    """Host float64 rotation from a quaternion [w, x, y, z]."""
    qw, qx, qy, qz = np.asarray(q, np.float64)
    n = qw * qw + qx * qx + qy * qy + qz * qz
    s = 2.0 / n if n > 0 else 2.0
    wx, wy, wz = s * qw * qx, s * qw * qy, s * qw * qz
    xx, xy, xz = s * qx * qx, s * qx * qy, s * qx * qz
    yy, yz, zz = s * qy * qy, s * qy * qz, s * qz * qz
    return np.array(
        [
            [1.0 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1.0 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1.0 - (xx + yy)],
        ]
    )


def np_pose7(rot, trans) -> np.ndarray:
    """(7,) [qw qx qy qz tx ty tz] from a rotation matrix and translation."""
    R = np.asarray(rot, np.float64)
    t = np.asarray(trans, np.float64)
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                      (R[1, 0] - R[0, 1]) / s])
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 0.0)) * 2
        q = np.empty(4)
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
    if q[0] < 0:
        q = -q
    return np.concatenate([q, t])


def ins_pose_ned(nav: NavFrame, ref_lla: np.ndarray) -> Pose3:
    """Host float64 NED pose of the body from a NavFrame (position via
    lla2ned around the reference origin, attitude from the fused
    quaternion). The fields stay numpy arrays."""
    ned = geodesy.lla2ned(np.asarray(nav.lla, np.float64), np.asarray(ref_lla, np.float64))
    return Pose3(np_quat_to_rot(nav.quat), ned)


def pose_to_device(pose: Pose3, device, dtype=torch.float32) -> Pose3:
    """A host pose on ``device`` (through ``to_device``: no wait for the
    stream on a CUDA device)."""
    return Pose3(*(to_device(np.asarray(a), torch.device(device)).to(dtype) for a in pose))


@dataclasses.dataclass
class IngestPipeline:
    """Replay packets -> SyncedFrames -> scans on ``device``."""

    cfg: PipelineConfig
    device: torch.device

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.luts = build_luts(self.cfg.meta, self.cfg.lidar)
        self.assembler = FrameAssembler(self.cfg.meta, self.luts)
        self.anpp = AnppDecoder()
        self.sync = Synchronizer(self.cfg.nav_window)
        self.filters = filters_from_params(self.cfg.lidar)
        self.dir_lut = torch.as_tensor(self.luts.direction, dtype=torch.float32, device=self.device)
        self.off_lut = torch.as_tensor(self.luts.offset, dtype=torch.float32, device=self.device)

    def synced_frames(self, replay_path: str) -> Iterator[SyncedFrame]:
        # consecutive LiDAR payloads batch into one native decode call; the
        # Synchronizer holds scans until nav coverage arrives
        batch: list = []

        def drain_lidar():
            for frame in self.assembler.push_packets(batch):
                yield from self.sync.push_scan(frame)
            batch.clear()

        for stream, _ts, payload in read_replay(replay_path):
            if stream == STREAM_LIDAR:
                batch.append(payload)
                if len(batch) >= 256:
                    yield from drain_lidar()
            elif stream == STREAM_COMPASS:
                yield from drain_lidar()
                nav = self.anpp.push_packet(payload)
                if nav is not None:
                    yield from self.sync.push_nav(nav)
        yield from drain_lidar()
        tail = self.assembler.flush()
        if tail is not None:
            yield from self.sync.push_scan(tail)

    def pack(self, synced: SyncedFrame) -> torch.Tensor:
        fr = synced.scan
        packed = pack_frame(fr.ranges_m, fr.reflectivity, fr.col_timestamp_s, fr.col_valid,
                            signal=fr.signal, nir=fr.nir)
        return to_device(packed, self.device)

    def project(self, synced: SyncedFrame) -> ScanBuffer:
        return project_frame_packed(self.pack(synced), self.dir_lut, self.off_lut, self.filters)


def deskew_interval_poses(synced: SyncedFrame, ref_lla):
    """Host INS poses at the sweep's own start and end timestamps: alpha is
    normalized over the scan's column span, not over the sync interval
    (which starts at the previous sweep's end)."""
    from ..runtime.sync import interpolate_at

    nav_s = interpolate_at(synced.ins, synced.scan.timestamp)
    nav_e = interpolate_at(synced.ins, synced.scan.timestamp_end)
    return ins_pose_ned(nav_s, ref_lla), ins_pose_ned(nav_e, ref_lla)


def maybe_deskew(scan: ScanBuffer, synced: SyncedFrame, ref_lla, enabled: bool) -> ScanBuffer:
    """INS-based motion compensation of a projected scan."""
    if not enabled:
        return scan
    from ..lidar.deskew import deskew_scan

    pose_s, pose_e = deskew_interval_poses(synced, ref_lla)
    dev, dt = scan.points.device, scan.points.dtype
    return deskew_scan(scan, pose_to_device(pose_s, dev, dt), pose_to_device(pose_e, dev, dt))


_log = logging.getLogger("slamtpu_torch.apps")
_warned: set = set()
SEARCH_METHODS = ("DIRECT7", "DIRECT1", "KDTREE")


def _warn_once(key, message):
    if key not in _warned:
        _warned.add(key)
        _log.warning(message)


def search_radius(method: str, resolution: float, use_regmap: bool = True) -> float:
    """The KDTREE gate's radius of a search method (one resolution, the
    reference's radius search over leaf centroids), 0 for DIRECT7 and
    DIRECT1. As in the reference, each layout honours two of the three
    modes: on the RegMap path DIRECT1 runs DIRECT7 (``use_direct1`` is read
    by the sorted-key objective only); on the sorted-key path
    (``use_regmap=False``) DIRECT1 searches one voxel and KDTREE runs
    DIRECT7 (the sorted-key objective reads no radius). The first such
    substitution logs a warning."""
    if method not in SEARCH_METHODS:
        raise ValueError(f"unknown search method {method!r}; known: {SEARCH_METHODS}")
    if use_regmap and method == "DIRECT1":
        _warn_once("DIRECT1", "search method DIRECT1 runs DIRECT7 on the RegMap path, as in the "
                   "reference (its use_direct1 is read by the sorted-key objective only)")
    if not use_regmap and method == "KDTREE":
        _warn_once("KDTREE", "search method KDTREE runs DIRECT7 on the sorted-key path "
                   "(use_regmap=False), as in the reference (its sorted-key objective reads no radius)")
    return float(resolution) if method == "KDTREE" else 0.0


class MapRebuildCadence:
    """Rebuild cadence of the cached RegMap (RegisterConfig.map_rebuild_every):
    periodic, forced when the map origin moves, and forced once after a
    resume (``force_next``: checkpoints do not carry the RegMap). The empty
    cache has the builder's shapes: 6V rows and no aux table when either
    search method is KDTREE (its builder dilates 27 ways), else 4V. With no
    ``grid_shape`` (the sorted-key path, ``use_regmap=False``) there is no
    cache: ``regmap`` is None and the apps build their map every keyframe."""

    def __init__(self, register_cfg, grid_shape, device, with_aux: bool = False):
        self._every = max(int(register_cfg.map_rebuild_every), 1)
        self._idx = 0
        self.force_next = False
        self.regmap = None
        if grid_shape is not None:
            kdtree = "KDTREE" in (register_cfg.search_method, register_cfg.svn_search_method)
            cap = register_cfg.map_capacity
            self.regmap = empty_regmap(cap, grid_shape, device,
                                       dilated_capacity=6 * cap if kdtree else None,
                                       with_aux=with_aux and not kdtree)

    def tick(self, force: bool = False) -> bool:
        """Advance one keyframe; True when this keyframe must rebuild."""
        rebuild = force or self.force_next or (self._idx % self._every == 0)
        self.force_next = False
        self._idx += 1
        return rebuild


class VizHook:
    """Optional live-viewer attachment (``--viz``): each keyframe's scan,
    stride-subsampled and read to the host in one copy, posed into the world
    with the published pose and pushed to a ``runtime.viewer.LiveViewer``
    (which owns the sliding window), with the trajectory and, when given,
    the raw INS pose beside it. The apps call it only when their ``viz`` is
    set, so the default keyframe path reads nothing for it."""

    def __init__(self, viewer, stride: int = 8):
        self.viewer = viewer
        self.stride = max(int(stride), 1)

    def subsample(self, scan) -> np.ndarray:
        """Host body-frame points of a ScanBuffer's kept rows at the stride:
        (M, 4) with the reflectivity as the intensity column (the viewer
        colors by it, as pipeline.cpp:919 does), or (M, 3) for a buffer
        without reflectivity."""
        s = self.stride
        cols = [scan.points[::s].to(torch.float32), scan.mask[::s, None].to(torch.float32)]
        if getattr(scan, "reflectivity", None) is not None:
            cols.append(scan.reflectivity[::s, None].to(torch.float32))
        host = torch.cat(cols, dim=1).cpu().numpy()
        return np.delete(host, 3, axis=1)[host[:, 3] > 0.5]

    def push(self, body_pts: Optional[np.ndarray], pose, frame_id: int, ins_pose=None) -> None:
        """Pose a subsampled cloud into the world and feed the viewer; with
        ``ins_pose`` the INS trajectory renders beside the optimized one
        (red vs green, pipeline.cpp:862-864)."""
        if body_pts is None:
            return
        body_pts = np.asarray(body_pts)
        inten = None
        if body_pts.ndim == 2 and body_pts.shape[1] == 4:
            body_pts, inten = body_pts[:, :3], body_pts[:, 3]
        R = np.asarray(pose.rot, np.float64)
        t = np.asarray(pose.trans, np.float64)
        self.viewer.push_cloud(body_pts @ R.T + t, frame_id, intensity=inten)
        self.viewer.push_pose(t, ins_xyz=None if ins_pose is None else np.asarray(ins_pose.trans, np.float64))


@dataclasses.dataclass
class TrajectoryEntry:
    timestamp: float
    frame_id: int
    pose: Pose3  # published pose (NED), host numpy
    ins_pose: Pose3
    covariance: Optional[np.ndarray] = None


def ate_rmse(traj_a: List[Pose3], traj_b: List[Pose3]) -> float:
    """Absolute trajectory error (translation RMSE), no alignment."""
    assert len(traj_a) == len(traj_b) and traj_a
    d = [np.linalg.norm(np.asarray(a.trans) - np.asarray(b.trans)) for a, b in zip(traj_a, traj_b)]
    return float(np.sqrt(np.mean(np.square(d))))


def np_between(a: Pose3, b: Pose3) -> Pose3:
    """Relative pose a^-1 b of host poses (GTSAM between)."""
    Ra, ta = np.asarray(a.rot, np.float64), np.asarray(a.trans, np.float64)
    Rb, tb = np.asarray(b.rot, np.float64), np.asarray(b.trans, np.float64)
    return Pose3(Ra.T @ Rb, Ra.T @ (tb - ta))


def np_sqrt_info_from_sigmas(sigmas) -> np.ndarray:
    """Host (numpy) diagonal whitening from per-dof standard deviations."""
    return np.diag(1.0 / np.asarray(sigmas, np.float64))


def np_sqrt_info_from_cov(cov, jitter: float = 1e-12) -> np.ndarray:
    """Host (numpy) whitening S with S^T S = cov^-1 (lower-inverse)."""
    cov = np.asarray(cov, np.float64)
    d = cov.shape[-1]
    L = np.linalg.cholesky(cov + jitter * np.eye(d))
    return np.linalg.solve(L, np.eye(d))

