"""SVN-NDT LiDAR odometry, the reference's primary pipeline (port of
slamtpu/apps/lo_svn.py).

Per keyframe: seed with the INS pose, project and deskew the sweep, on
rebuild keyframes build the NDT map and the RegMap (with the
plane-regularized aux payload) from a ring of keyframe clouds, compute the
stencil source covariances, run SVN-NDT with the plane-to-plane polish,
and insert the new cloud into the ring. All of it is queued on one device
without host syncs in between; results are read back in batches (``flush``)
so the next sweep's decode overlaps the device work.

On a CUDA device the registration goes through the app's ``SvnGraph``
(``ndt/svn.py``): the first RegMap keyframe runs eagerly, the second
captures the SVN flow and the polish as one CUDA graph, and every keyframe
after replays it with its points, mask, prior, particle draws and source
covariances copied into the graph's static buffers, and the RegMap's
tables copied in on rebuild keyframes only (nothing is captured again).
The DIRECT7 map and RegMap rebuild replays the same way (``regmap.MapGraph``,
under ``map_graph_replay``: the first rebuild eager, the second captured).
Projection, deskew, source covariances, ring insert and the posterior
(``eigh``) stay eager; each keyframe's result is a copy of
the graph's outputs, so the 64 kept in flight until ``flush`` stay
distinct. On the CPU the registration is ``svn_align_reg`` itself.

In the KDTREE search mode (``svn_search_method``) the RegMap comes from
``build_regmap_kdtree``, the NDT pair kernel gates its slots at the gather
pose, and the polish stays on the NDT score (the layout has no aux table),
as in the reference. DIRECT1 runs DIRECT7, as the reference's RegMap path
does (``common.search_radius``).

With ``use_regmap=False`` (the sorted-key path, as the reference's
``grid_shape=None``) every keyframe builds the NDT map and runs
``svn_align``: the K particles in one batched pass of the sorted-key
objective, DIRECT1 searching one voxel, and the polish on that objective;
no RegMap, no source covariances, and the rebuild cadence does not apply.

``save_checkpoint``/``resume_from`` carry the ring, the origin and the
particle generator (``runtime.checkpoint``).
"""
from __future__ import annotations

import dataclasses
import logging
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..core import se3
from ..core.se3 import Pose3
from ..lidar.deskew import deskew_points
from ..lidar.project import project_frame_packed
from ..mapping import gaussian_map
from ..ndt.gicp import sweep_point_covariances
from ..ndt.regmap import MapGraph, build_regmap_kdtree, build_target
from ..ndt.svn import SvnConfig, SvnGraph, svn_align, svn_align_reg
from ..runtime import checkpoint
from ..runtime.config import PipelineConfig
from ..runtime.device_timer import DeviceStageTimer
from ..runtime.device_timer import span as _span
from ..runtime.stats import KeyFrameStats, StageTimer, StatsArchive
from .common import (IngestPipeline, MapRebuildCadence, TrajectoryEntry, deskew_interval_poses,
                     ins_pose_ned, maybe_deskew, np_pose7, pose_to_device, search_radius,
                     to_device)

log = logging.getLogger("slamtpu_torch.lo_svn")


class KeyframeResult(NamedTuple):
    """One keyframe's outputs, device tensors until ``flush`` reads them."""

    pose: Pose3  # published pose
    covariance: torch.Tensor  # (6, 6)
    iterations: torch.Tensor  # () int32
    converged: torch.Tensor  # () bool
    n_voxels: torch.Tensor  # () int32 valid voxels of the registration map
    score: torch.Tensor  # ()
    num_points: Optional[torch.Tensor] = None  # () int32 kept points of the sweep


def _lo_svn_core(
    kf_points,  # (W, N, 3) world-frame keyframe clouds, the ring (updated in place)
    kf_mask,  # (W, N) (updated in place)
    new_points,  # (N, 3) body frame
    new_mask,  # (N,)
    prior: Pose3,  # INS pose, float32 on the device
    origin,  # (3,) map origin on the device
    rebuild: bool,
    ins_anchor: bool,  # ring clouds enter at the INS prior (else the published pose)
    head: int,  # ring slot to overwrite
    init_noise,  # (K, 6) standard-normal particle draws
    regmap_in,  # RegMap of the last rebuild (None on the sorted-key path)
    svn_cfg: SvnConfig,
    capacity: int,
    min_points: int,
    grid_shape: tuple,  # None: the sorted-key path (use_regmap=False)
    publish_svn: bool = True,
    scan_grid: tuple = None,  # (cols, sub) of the sweep: stencil covariances (else voxel ones)
    exclude_recent: Optional[int] = None,  # rebuilds skip the newest ring clouds
    timer=None,
    svn_graph: Optional[SvnGraph] = None,  # the RegMap registration (else svn_align_reg)
    map_graph: Optional[MapGraph] = None,  # the DIRECT7 map and RegMap (else build_target)
):
    """One keyframe on a projected sweep: (new regmap, KeyframeResult).

    The map and RegMap rebuild only on rebuild keyframes; in between the
    registration targets the cached RegMap. With no ``grid_shape`` the map
    is built on every keyframe and ``svn_align`` registers against it; the
    RegMap cache passes through untouched."""
    W, N, _ = kf_points.shape
    bmask = kf_mask
    if exclude_recent is not None:
        # ring age of slot s: 0 = newest (slot head - 1), W - 1 = oldest
        ages = torch.remainder(head - 1 - torch.arange(W, device=kf_mask.device), W)
        bmask = kf_mask & (ages >= exclude_recent)[:, None]
    sorted_key = grid_shape is None
    aniso = not sorted_key and svn_cfg.polish_iters > 0 and svn_cfg.polish_objective == "gicp_aniso"
    regmap = regmap_in
    n_voxels = None
    if rebuild or sorted_key:
        with _span(timer, "map_rebuild"):
            points, mask = kf_points.reshape(W * N, 3), bmask.reshape(W * N)
            if sorted_key or svn_cfg.kd_radius > 0.0:
                gmap = gaussian_map.build_map(points, mask, origin, svn_cfg.resolution,
                                              capacity=capacity, min_points_per_voxel=min_points)
                if sorted_key:
                    n_voxels = gmap.num_valid()
                else:
                    regmap = build_regmap_kdtree(gmap, grid_shape=grid_shape)
            else:  # DIRECT7; the polish payload: plane-regularized target covariances
                regmap = (map_graph or build_target)(points, mask, origin, svn_cfg.resolution, capacity,
                                                     min_points, grid_shape, aux=aniso)
    src_cov = None
    if aniso:
        with _span(timer, "src_covariances"):
            src_cov = sweep_point_covariances(new_points, new_mask, scan_grid, svn_cfg.resolution,
                                              capacity, min_points)
    with _span(timer, "svn"):
        if sorted_key:
            res = svn_align(new_points, new_mask, gmap, prior, svn_cfg, init_noise=init_noise)
        else:
            res = (svn_graph or svn_align_reg)(new_points, new_mask, regmap, prior, svn_cfg, grid_shape,
                                               src_cov=src_cov, init_noise=init_noise)
            n_voxels = regmap.num_valid
    published = res.pose if publish_svn else prior
    with _span(timer, "ring_insert"):
        anchor = prior if ins_anchor else published
        # in place: the reference step donates the ring buffers instead
        kf_points[head] = se3.transform_points(anchor, new_points)
        kf_mask[head] = new_mask
    return regmap, KeyframeResult(published, res.covariance, res.iterations, res.converged,
                                  n_voxels, res.score)


def _lo_svn_step_packed(
    kf_points, kf_mask,
    packed,  # (cols, W) pack_frame buffer on the device
    dir_lut, off_lut,  # projection LUTs on the device
    prior: Pose3, origin, rebuild: bool, ins_anchor: bool,
    pose_start: Pose3, pose_end: Pose3,  # deskew endpoints
    head: int, init_noise, regmap_in, svn_cfg: SvnConfig, capacity: int, min_points: int,
    grid_shape: tuple, publish_svn: bool = True, scan_grid: tuple = None, filters=None,
    deskew: bool = True, exclude_recent: Optional[int] = None, timer=None,
    svn_graph: Optional[SvnGraph] = None, map_graph: Optional[MapGraph] = None,
):
    """The whole per-keyframe device path: projection + filtering, INS
    deskew, then ``_lo_svn_core``. The result carries num_points."""
    with _span(timer, "project"):
        scan = project_frame_packed(packed, dir_lut, off_lut, filters)
    new_points = scan.points
    if deskew:
        with _span(timer, "deskew"):
            new_points = deskew_points(new_points, scan.alpha, pose_start, pose_end)
    regmap, res = _lo_svn_core(
        kf_points, kf_mask, new_points, scan.mask, prior, origin, rebuild, ins_anchor, head,
        init_noise, regmap_in, svn_cfg, capacity, min_points, grid_shape, publish_svn,
        scan_grid, exclude_recent, timer, svn_graph, map_graph,
    )
    return regmap, res._replace(num_points=scan.num_points)


def _host(t):
    return t.detach().cpu().numpy()


@dataclasses.dataclass
class LoSvnApp:
    cfg: PipelineConfig
    device: torch.device  # where the keyframe path runs ("cuda" or "cpu")
    publish: str = "svn"  # "svn" | "ins"
    anchor: str = "ins"  # "ins" | "odom": pose at which clouds enter the ring
    seed: int = 1337  # seeds the particle draws

    def __post_init__(self):
        self.device = torch.device(self.device)
        reg = self.cfg.register
        kd_radius = search_radius(reg.svn_search_method, reg.svn_resolution, reg.use_regmap)
        self.ingest = IngestPipeline(self.cfg, self.device)
        self.svn_cfg = SvnConfig(
            resolution=reg.svn_resolution,
            outlier_ratio=reg.svn_outlier_ratio,
            num_particles=reg.svn_particles,
            max_iterations=reg.svn_max_iterations,
            kernel_h=reg.svn_kernel_h,
            step_size=reg.svn_step_size,
            stop_thresh=reg.svn_stop_thresh,
            use_direct1=reg.svn_search_method == "DIRECT1",
            kd_radius=kd_radius,
            polish_iters=reg.svn_polish_iters,
            # the KDTREE layout has no aux table: the polish stays on the NDT score
            polish_objective=reg.svn_polish_objective if kd_radius <= 0.0 else "ndt",
            polish_from=reg.svn_polish_from,
        )
        # None: the sorted-key path (map built every keyframe, no RegMap)
        self.grid_shape = tuple(reg.reg_grid_shape) if reg.use_regmap else None
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)
        self._svn_graph = SvnGraph()  # the registration, replayed as a CUDA graph on a card
        self._map_graph = MapGraph()  # the DIRECT7 map and RegMap, replayed as a CUDA graph on a card
        self._trajectory: List[TrajectoryEntry] = []
        self._stats_archive = StatsArchive()
        self._pending: List[tuple] = []  # keyframes whose results are on the device
        self.viz = None  # Optional[common.VizHook], set by the command line's --viz
        self._ovf_warned = False
        self._n_keyframes = 0
        self.timer = StageTimer()  # host spans
        self.device_timer = DeviceStageTimer(self.device)  # per-stage device spans
        self._ref_lla: Optional[np.ndarray] = None
        self._kf_points = None  # (W, N, 3) ring
        self._kf_mask = None
        self._kf_head = 0
        self._origin = None  # (3,) float32 host numpy
        # range-image layout of the sweep, for the stencil source covariances
        self._scan_grid = ((self.cfg.meta.columns_per_frame, self.ingest.luts.subset_channels)
                           if reg.svn_src_cov == "stencil" else None)
        self._cadence = MapRebuildCadence(
            reg, self.grid_shape, self.device,
            with_aux=self.svn_cfg.polish_iters > 0 and self.svn_cfg.polish_objective == "gicp_aniso",
        )

    @property
    def trajectory(self) -> List[TrajectoryEntry]:
        self.flush()
        return self._trajectory

    @property
    def stats(self) -> StatsArchive:
        self.flush()
        return self._stats_archive

    def save_checkpoint(self, path: str):
        """Write the state a later run continues from (``checkpoint.save_lo_svn``)."""
        checkpoint.save_lo_svn(path, self)

    def resume_from(self, path: str):
        """Continue from a checkpoint of either package."""
        return checkpoint.load_lo_svn(path, self)

    def run_replay(self, replay_path: str, max_keyframes: int = 10**9):
        for synced in self.ingest.synced_frames(replay_path):
            self.process(synced)
            if self._n_keyframes >= max_keyframes:
                break
        return self.trajectory

    def flush(self):
        """Read back the in-flight keyframe results and record them."""
        pending, self._pending = self._pending, []
        if pending and self._cadence.regmap is not None:
            ovf = int(self._cadence.regmap.overflow)
            if ovf and not self._ovf_warned:
                self._ovf_warned = True
                log.warning("RegMap truncated %d dilated cells (capacity/grid too small) — "
                            "raise map_capacity or reg_grid_shape", ovf)
        for k, synced, ins_pose, dt_ms, res, viz_pts in pending:
            published = Pose3(_host(res.pose.rot).astype(np.float64),
                              _host(res.pose.trans).astype(np.float64))
            self.device_timer.keyframe_published(k)
            if self.viz is not None:
                self.viz.push(viz_pts, published, synced.scan.frame_id, ins_pose=ins_pose)
            self._record(synced, int(res.num_points), published, ins_pose,
                         _host(res.covariance).astype(np.float64), int(res.iterations),
                         bool(res.converged), float(res.score), dt_ms)
        self.device_timer.collect()

    def _exclude_recent(self) -> Optional[int]:
        """Exclusion count for map rebuilds, clamped so a build keeps at least
        one ring cloud while the ring fills (None disables)."""
        e = int(self.cfg.register.map_exclude_recent)
        if e <= 0:
            return None
        filled = min(self._n_keyframes, int(self.cfg.register.keyframe_window))
        return min(e, max(filled - 1, 0))

    def process(self, synced):
        k = self._n_keyframes
        self.device_timer.keyframe_begin(k)
        nav_end = synced.ins[-1]
        if self._ref_lla is None:  # first keyframe fixes the geodetic reference
            self._ref_lla = np.asarray(nav_end.lla)
        ins_pose = ins_pose_ned(nav_end, self._ref_lla)
        if self._kf_points is None:
            self._first_keyframe(synced, ins_pose)
            self.device_timer.keyframe_queued(k)
            self.device_timer.keyframe_published(k)
            return
        self._origin, shifted = gaussian_map.recenter_origin(
            self._origin, np.asarray(ins_pose.trans), self.svn_cfg.resolution
        )
        if shifted:
            log.info("map origin recentered at keyframe %d", synced.scan.frame_id)
        rebuild = self._cadence.tick(force=shifted)
        if self.cfg.deskew:
            pose_s, pose_e = deskew_interval_poses(synced, self._ref_lla)
        else:
            pose_s = pose_e = ins_pose
        # the keyframe's host scalars reach the device in one copy
        flat = to_device(np.concatenate([
            np.asarray(ins_pose.rot, np.float64).ravel(), np.asarray(ins_pose.trans, np.float64),
            np.asarray(self._origin, np.float64),
            np.asarray(pose_s.rot, np.float64).ravel(), np.asarray(pose_s.trans, np.float64),
            np.asarray(pose_e.rot, np.float64).ravel(), np.asarray(pose_e.trans, np.float64),
        ]).astype(np.float32), self.device)
        prior = Pose3(flat[0:9].view(3, 3), flat[9:12])
        origin = flat[12:15]
        pose_start = Pose3(flat[15:24].view(3, 3), flat[24:27])
        pose_end = Pose3(flat[27:36].view(3, 3), flat[36:39])
        init_noise = torch.randn((self.svn_cfg.num_particles, 6), generator=self.generator,
                                 device=self.device)
        reg = self.cfg.register
        viz_pts = None
        if self.viz is not None:
            # the step projects inside; the viewer's scan is projected beside it
            scan_v = maybe_deskew(self.ingest.project(synced), synced, self._ref_lla, self.cfg.deskew)
            viz_pts = self.viz.subsample(scan_v)
        with self.timer.span("svn_step"):
            packed = self.ingest.pack(synced)
            self._cadence.regmap, res = _lo_svn_step_packed(
                self._kf_points, self._kf_mask, packed, self.ingest.dir_lut, self.ingest.off_lut,
                prior, origin, rebuild, self.anchor == "ins", pose_start, pose_end,
                self._kf_head, init_noise, self._cadence.regmap, self.svn_cfg,
                reg.map_capacity, reg.min_points_per_voxel, self.grid_shape,
                self.publish == "svn", self._scan_grid, self.ingest.filters, self.cfg.deskew,
                self._exclude_recent(), self.device_timer, svn_graph=self._svn_graph,
                map_graph=self._map_graph,
            )
        self._kf_head = (self._kf_head + 1) % int(reg.keyframe_window)
        self._n_keyframes += 1
        self._pending.append((k, synced, ins_pose, self.timer.last_ms("svn_step"), res, viz_pts))
        self.device_timer.keyframe_queued(k)
        if len(self._pending) >= 64:  # bound the in-flight queue
            self.flush()

    def _first_keyframe(self, synced, ins_pose):
        """The first sweep only seeds the ring (and the map origin)."""
        with self.timer.span("project"):
            scan = self.ingest.project(synced)
        scan = maybe_deskew(scan, synced, self._ref_lla, self.cfg.deskew)
        W = self.cfg.register.keyframe_window
        N = scan.points.shape[0]
        self._kf_points = torch.zeros((W, N, 3), dtype=torch.float32, device=self.device)
        self._kf_mask = torch.zeros((W, N), dtype=torch.bool, device=self.device)
        grid_half = 512.0 * self.svn_cfg.resolution
        self._origin = np.asarray(np.asarray(ins_pose.trans) - grid_half, np.float32)
        world = se3.transform_points(pose_to_device(ins_pose, self.device), scan.points)
        self._kf_points[self._kf_head] = world
        self._kf_mask[self._kf_head] = scan.mask
        self._kf_head = (self._kf_head + 1) % W
        self._n_keyframes += 1
        if self.viz is not None:
            self.viz.push(self.viz.subsample(scan), ins_pose, synced.scan.frame_id, ins_pose=ins_pose)
        self._record(synced, int(scan.num_points), ins_pose, ins_pose, None, 0, True, 0.0, 0.0)

    def _record(self, synced, num_points, pose, ins_pose, cov, iters, converged, score,
                dispatch_ms):
        self._trajectory.append(TrajectoryEntry(
            timestamp=synced.t_end, frame_id=synced.scan.frame_id, pose=pose,
            ins_pose=ins_pose, covariance=cov,
        ))
        ins7 = np_pose7(np.asarray(ins_pose.rot), np.asarray(ins_pose.trans))
        opt7 = np_pose7(np.asarray(pose.rot), np.asarray(pose.trans))
        self._stats_archive.add(KeyFrameStats(
            frame_id=synced.scan.frame_id,
            timestamp=synced.t_end,
            num_points=num_points,
            align_time_ms=max(dispatch_ms, 1e-3),  # host time to queue the step
            ndt_iterations=iters,
            converged=converged,
            score=score,
            ins_sigma=np.concatenate([np.asarray(synced.ins[-1].sigma_rpy),
                                      np.asarray(synced.ins[-1].sigma_pos)]),
            lidar_sigma=np.sqrt(np.maximum(np.diag(cov), 0.0)) if cov is not None else np.zeros(6),
            ins_pose=ins7,
            optimized_pose=opt7,
            pose_rmse=float(np.linalg.norm(ins7[4:] - opt7[4:])),
        ))
