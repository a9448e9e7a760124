"""INS-only georeferenced mapping and the NDT map export, the reference's
``pipeline_ins_map_distribution`` (port of slamtpu/apps/ins_map.py).

Per keyframe: project the sweep, pose it at the INS pose, and merge its
voxel statistics into the map's (``gaussian_map.merge_stats``: the
statistics are associative, so the map grows a sweep at a time in bounded
memory). At the end the statistics are finalized into Gaussians and
exported as the reference's text files and a PLY of the voxel means.

The keyframe path queues on one device without host syncs: the count of
points beyond the map's key range (+-512 voxels around the first pose) is
read every ``OOR_READ_EVERY`` keyframes. ``device_timer`` times the
``project``, ``accumulate`` and ``finalize`` stages on the device.
``save_checkpoint``/``resume_from`` carry the statistics and the geodetic
reference (``runtime.checkpoint``), in files of either package.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional

import numpy as np
import torch

from ..core import se3
from ..core.se3 import Pose3
from ..mapping import gaussian_map, voxel
from ..runtime import checkpoint
from ..runtime.config import PipelineConfig
from ..runtime.device_timer import DeviceStageTimer
from ..runtime.export import extract_ndt_data, write_ndt_data, write_ply
from .common import IngestPipeline, TrajectoryEntry, ins_pose_ned, pose_to_device, to_device

log = logging.getLogger("slamtpu_torch.ins_map")

OOR_READ_EVERY = 16  # keyframes between host reads of the out-of-range count


def _accumulate(stats: gaussian_map.VoxelStats, points, mask, pose: Pose3, capacity: int):
    """(stats merged with the sweep's at ``pose``, the count () int32 of its
    finite masked points beyond the packed-key range, which the statistics
    drop)."""
    world = se3.transform_points(pose, points)
    new = gaussian_map.stats_from_points(world, mask, stats.origin, stats.resolution, capacity)
    finite = torch.all(torch.isfinite(world), dim=-1)
    keys, _ = gaussian_map._corner_keys(world, mask & finite, stats.origin, stats.resolution)
    out_of_range = torch.sum(((keys == voxel.INVALID_KEY) & mask & finite).to(torch.int32))
    return gaussian_map.merge_stats(stats, new, capacity), out_of_range


@dataclasses.dataclass
class InsMapApp:
    cfg: PipelineConfig
    device: torch.device  # where the keyframe path runs ("cuda" or "cpu")
    resolution: Optional[float] = None  # default: register.map_voxel_size

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.ingest = IngestPipeline(self.cfg, self.device)
        self.res = self.resolution or self.cfg.register.map_voxel_size
        self.trajectory: List[TrajectoryEntry] = []
        self._ref_lla: Optional[np.ndarray] = None
        self._stats: Optional[gaussian_map.VoxelStats] = None
        self.out_of_range_points = 0  # points beyond the packed-key extent
        self._oor_pending: list = []  # device counts not read yet
        self.device_timer = DeviceStageTimer(self.device)  # per-stage device spans
        self.viz = None  # Optional[common.VizHook], set by the command line's --viz

    @property
    def stats(self) -> Optional[gaussian_map.VoxelStats]:
        return self._stats

    def run_replay(self, replay_path: str, max_keyframes: int = 10**9):
        for synced in self.ingest.synced_frames(replay_path):
            self.process(synced)
            if len(self.trajectory) >= max_keyframes:
                break
        return self.trajectory

    def process(self, synced):
        k = len(self.trajectory)
        self.device_timer.keyframe_begin(k)
        with self.device_timer.span("project"):
            scan = self.ingest.project(synced)
        nav = synced.ins[-1]
        if self._ref_lla is None:
            self._ref_lla = np.asarray(nav.lla)
        pose = ins_pose_ned(nav, self._ref_lla)
        capacity = self.cfg.register.map_capacity
        if self._stats is None:
            origin = to_device(np.asarray(np.asarray(pose.trans) - 512.0 * self.res, np.float32),
                               self.device)
            self._stats = gaussian_map.stats_from_points(
                torch.zeros((1, 3), device=self.device), torch.zeros(1, dtype=torch.bool, device=self.device),
                origin, np.float32(self.res), capacity)
        with self.device_timer.span("accumulate"):
            self._stats, oor = _accumulate(self._stats, scan.points, scan.mask,
                                           pose_to_device(pose, self.device), capacity)
        self._oor_pending.append(oor)
        self.device_timer.keyframe_queued(k)
        if len(self._oor_pending) >= OOR_READ_EVERY:
            self._drain_oor(synced.scan.frame_id)
        if self.viz is not None:
            self.viz.push(self.viz.subsample(scan), pose, synced.scan.frame_id)
        self.trajectory.append(TrajectoryEntry(synced.t_end, synced.scan.frame_id, pose, pose))

    def flush(self):
        """Read the pending counts and wait for the map statistics."""
        self._drain_oor()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.device_timer.collect()

    def _drain_oor(self, frame_id=None):
        if not self._oor_pending:
            return
        total = int(torch.stack(self._oor_pending).sum())  # one host read
        self._oor_pending.clear()
        if total:
            if self.out_of_range_points == 0:
                log.warning("frame %s: %d points beyond the map key range (+-512 voxels from the "
                            "first-pose origin) were dropped: the trajectory has outgrown the grid; "
                            "start a new map segment (checkpoint + fresh origin) to keep this "
                            "content", frame_id, total)
            self.out_of_range_points += total

    def save_checkpoint(self, path: str):
        """Write the map statistics and the geodetic reference
        (``checkpoint.save_ins_map``)."""
        if self._stats is None:
            raise RuntimeError("nothing to checkpoint yet")
        checkpoint.save_ins_map(path, self._stats, self._ref_lla)

    def resume_from(self, path: str):
        """Continue from a checkpoint of either package: later sweeps merge
        into the loaded statistics."""
        self._stats, self._ref_lla = checkpoint.load_ins_map(path, self.device)
        return self

    def finalize_and_export(self, prefix: str, min_points_per_voxel: int = 6):
        """Finalize the map and write <prefix>_ellipsoids.txt, _voxels.txt,
        _summary.txt and _means.ply; returns the GaussianMap."""
        self._drain_oor()
        with self.device_timer.span("finalize"):
            gmap = gaussian_map.finalize(self._stats, min_points_per_voxel)
        data = extract_ndt_data(gmap)
        write_ndt_data(data, prefix)
        write_ply(data.means, f"{prefix}_means.ply")
        log.info("exported %d valid voxels (%d points, overflow=%d, out_of_range=%d)",
                 len(data.counts), int(self._stats.n.sum()), int(self._stats.overflow),
                 self.out_of_range_points)
        return gmap
