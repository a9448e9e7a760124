"""Tightly coupled LiDAR-IMU odometry, the reference's ``pipeline_ligo_tc``
(port of slamtpu/apps/ligo_tc.py).

Per keyframe (run/pipeline_ligo_tc.cpp:339-622):
1. preintegrate the sweep's raw IMU samples (packet 28) from the previous
   keyframe's bias (:429-449) and predict the new state (:453);
2. register the sweep with Newton NDT against the keyframe window fused at
   its optimized poses (:519-527), from the IMU prediction and with the
   prior-pose pull toward it (setRegularizationPose, :531); the map and
   RegMap are rebuilt every ``map_rebuild_every`` keyframes (with
   ``use_regmap=False``: the map every keyframe and ``newton_align`` on the
   sorted-key objective, no RegMap);
3. re-solve the 15-dof window (replaces iSAM2, :578-587): INS pose priors
   with trust-gain scaling (:465-506), the LiDAR between factors, the IMU
   factor chain (:459-463), velocity priors and the initial bias prior.
The first keyframe places the priors, with WGS-84 gravity (:365-404).

Dtypes: registration in float32 (clouds, map, the prediction cast to
float32; the map's voxel statistics computed in float64, as odom_ndt's
``_register_step`` builds it); preintegration, the factors and the smoother in float64 on the
device. The host keeps the window as numpy, as the reference does: it reads
the step's result vector and the window solution once per keyframe each,
and ships the factor arrays through pinned memory as one buffer. Other host
reads: one per Newton outer iteration (``fused_math.HOST_READS``) and the
RegMap overflow count every 32 keyframes.

``save_checkpoint``/``resume_from`` carry the window, the keyframe ring
and the host state (``runtime.checkpoint``).

Search modes, as the reference: its NewtonConfig sets neither
``use_direct1`` nor a radius, so DIRECT1 runs DIRECT7 on both paths
(``common.search_radius`` warns on the RegMap path). On the RegMap path
KDTREE (either search method) cannot run in the reference: its builder
makes the DIRECT7 layout (4V rows), while its rebuild cadence caches an
empty KDTREE layout (6V rows), and the two branches of its rebuild
``lax.cond`` differ in shape, a TypeError at the first registration. The
port raises at construction with that reason. On the sorted-key path
there is no cache, and KDTREE runs DIRECT7 in both packages.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional

import numpy as np
import torch

from ..core import se3
from ..core.se3 import Pose3
from ..fusion import robust
from ..fusion.graph import WindowState, empty_factors
from ..fusion.preintegration import ImuBias, ImuNoise, NavState, integrate, predict
from ..fusion.smoother import SmootherConfig, marginal_covariance, optimize
from ..ins.gravity import gravity_wgs84
from ..mapping import gaussian_map
from ..ndt.newton import NewtonConfig
from ..runtime import checkpoint
from ..runtime.config import PipelineConfig
from ..runtime.device_timer import DeviceStageTimer
from ..runtime.device_timer import span as _span
from ..runtime.stats import KeyFrameStats, StageTimer, StatsArchive
from .common import (IngestPipeline, MapRebuildCadence, TrajectoryEntry, ins_pose_ned, maybe_deskew,
                     np_between, np_pose7, np_sqrt_info_from_cov, np_sqrt_info_from_sigmas,
                     search_radius, to_device)
from .odom_ndt import _register_step

log = logging.getLogger("slamtpu_torch.ligo_tc")

IMU_WINDOW_CAPACITY = 64  # samples per sweep interval at most (50 Hz x ~0.2 s)
FLAT = 27  # the step's host scalars: prev pose (12), vel (3), bias (6), gravity (3), origin (3)
SMOOTHER_ITERATIONS = 6


def _ligo_step(
    kf_points,  # (K, N, 3) keyframe-window clouds, body frame
    kf_mask,  # (K, N) all False on empty slots
    kf_poses,  # (K, 12) optimized world poses of the window keyframes
    new_points,  # (N, 3) body frame
    new_mask,
    imu,  # (M, 6) [accel(3), gyro(3)] float64 on the device
    dts,  # (M,) host per-sample dt (<= 0: padding)
    flat,  # (27,) float64 on the device, see FLAT
    rebuild: bool,  # host flag: rebuild the map this keyframe
    regmap_in,  # the RegMap of the last rebuild (None on the sorted-key path)
    noise: ImuNoise,
    cfg: NewtonConfig,
    capacity: int,
    min_points: int,
    grid_shape: tuple,  # None: the sorted-key path (map every keyframe)
    inner_iters: int = 2,
    final_eval: bool = False,  # see odom_ndt._register_step
    timer=None,
):
    """One tightly coupled keyframe (pipeline_ligo_tc.cpp:429-542):
    preintegrate, predict, fuse the keyframe window at its optimized poses
    into the target (on rebuild keyframes), register from the prediction
    with the pull toward it. Returns (regmap, result (346,) float64 =
    [pim(292), predicted vel(3), pose(12), hessian(36), score, iterations,
    converged]), the reference's layout."""
    f32 = torch.float32
    with _span(timer, "preintegrate"):
        prev_pose = Pose3(flat[0:9].reshape(3, 3), flat[9:12])
        bias = ImuBias(flat[15:18], flat[18:21])
        pim = integrate(imu[:, 0:3], imu[:, 3:6], dts, bias, noise)
        predicted = predict(NavState(prev_pose, flat[12:15]), bias, pim, flat[21:24])
        pred32 = se3.cast(predicted.pose, f32)
    K, N, _ = kf_points.shape
    sorted_key = grid_shape is None
    world = None
    if rebuild or sorted_key:  # only a build reads the target
        wposes = Pose3(kf_poses[:, 0:9].reshape(K, 3, 3).to(f32), kf_poses[:, 9:12].to(f32))
        world = se3.transform_points(wposes, kf_points).reshape(K * N, 3)
    out = _register_step(
        world, kf_mask.reshape(K * N), new_points, new_mask, pred32, flat[24:27].to(f32), cfg,
        capacity, min_points, grid_shape, inner_iters=inner_iters, final_eval=final_eval,
        timer=timer, reg_pose=pred32, regmap_cache=None if sorted_key else regmap_in, rebuild=rebuild,
    )
    res, regmap = (out, regmap_in) if sorted_key else out
    dt = flat.dtype
    return regmap, torch.cat([
        pim.dR.reshape(-1), pim.dv, pim.dp, pim.dt.reshape(1), pim.dR_dbg.reshape(-1),
        pim.dv_dba.reshape(-1), pim.dv_dbg.reshape(-1), pim.dp_dba.reshape(-1),
        pim.dp_dbg.reshape(-1), pim.bias_hat.vec(), pim.cov.reshape(-1),
        predicted.vel,
        res.pose.rot.reshape(-1).to(dt), res.pose.trans.to(dt), res.hessian.reshape(-1).to(dt),
        torch.stack([res.score.to(dt), res.iterations.to(dt), res.converged.to(dt)]),
    ])


@dataclasses.dataclass
class LigoTcApp:
    cfg: PipelineConfig
    device: torch.device  # where the keyframe path runs ("cuda" or "cpu")
    window: int = 6  # smoother window size (states kept live)

    def __post_init__(self):
        self.device = torch.device(self.device)
        reg = self.cfg.register
        if reg.use_regmap and "KDTREE" in (reg.search_method, reg.svn_search_method):
            cap = reg.map_capacity
            raise ValueError(
                "ligo_tc cannot run the KDTREE search mode, as in the reference: its Newton "
                f"builds the DIRECT7 RegMap ({4 * cap + 1} rows) while the rebuild cache holds the "
                f"KDTREE shape ({6 * cap + 1} rows), and the reference's rebuild lax.cond fails "
                "on that shape mismatch")
        # the Newton config takes no search method: DIRECT1 (and, on the
        # sorted-key path, KDTREE) runs DIRECT7, with a warning
        search_radius(reg.search_method, reg.ndt_resolution, reg.use_regmap)
        if not reg.use_regmap and reg.search_method == "DIRECT1":
            log.warning("ligo_tc's Newton takes no search method: DIRECT1 runs DIRECT7 on the "
                        "sorted-key path too, as in the reference")
        self.ingest = IngestPipeline(self.cfg, self.device)
        self.newton_cfg = NewtonConfig(
            resolution=reg.ndt_resolution,
            outlier_ratio=reg.svn_outlier_ratio,
            max_iterations=reg.ndt_max_iterations,
            trans_eps=reg.ndt_transform_epsilon,
            # prior-pose pull toward the IMU prediction
            # (setRegularizationScaleFactor, pipeline_ligo_tc.cpp:293)
            reg_weight=reg.regularization_scale_factor,
        )
        self.noise = ImuNoise.from_imu_config(self.cfg.imu, self.device)
        self.smoother_cfg = SmootherConfig(iterations=SMOOTHER_ITERATIONS, solver=reg.smoother_solver)
        # None: the sorted-key path (map built every keyframe, no RegMap)
        self.grid_shape = tuple(reg.reg_grid_shape) if reg.use_regmap else None
        self.trajectory: List[TrajectoryEntry] = []
        self.stats = StatsArchive()
        self.viz = None  # Optional[common.VizHook], set by the command line's --viz
        self.timer = StageTimer()  # host spans
        self.device_timer = DeviceStageTimer(self.device)  # per-stage device spans
        self._ref_lla: Optional[np.ndarray] = None
        self._origin = None  # numpy (3,) float64
        self._gravity = None
        # registration target = the keyframe window fused at its optimized
        # poses: a ring of body-frame clouds and, per slot, the live window
        # entry whose "pose" the re-solve updates
        self._kf_clouds = None  # (K, N, 3) body frame
        self._kf_masks = None  # (K, N)
        self._kf_slots: List[Optional[dict]] = []
        self._kf_head = 0
        self._cadence = MapRebuildCadence(reg, self.grid_shape, self.device)
        self._ovf_warned = False
        self._trust = robust.trust_gain_init_np()
        self._win: List[dict] = []  # per-state dicts (numpy): pose, vel, bias, ins, pim, ...
        self._factor_template = self._template()

    def _template(self):
        """The static factor skeleton (indices and fixed whitenings) on the
        device; gravity is set at the first keyframe from the WGS-84 model."""
        W, dev = self.window, self.device
        tpl = empty_factors(W, W - 1, W, 1, W - 1, 0, device=dev)
        ks = torch.arange(W, dtype=torch.int32, device=dev)
        return tpl._replace(
            prior_pose=tpl.prior_pose._replace(idx=ks),
            between=tpl.between._replace(i=ks[:-1], j=ks[1:]),
            prior_vel=tpl.prior_vel._replace(idx=ks, sqrt_info=tpl.prior_vel.sqrt_info / 0.5),
            prior_bias=tpl.prior_bias._replace(idx=ks[:1], sqrt_info=tpl.prior_bias.sqrt_info / 0.05,
                                               active=torch.ones(1, dtype=torch.bool, device=dev)),
            imu=tpl.imu._replace(i=ks[:-1], j=ks[1:]),
        )

    def save_checkpoint(self, path: str):
        """Write the state a later run continues from (``checkpoint.save_ligo_tc``)."""
        checkpoint.save_ligo_tc(path, self)

    def resume_from(self, path: str):
        """Continue from a checkpoint of either package."""
        return checkpoint.load_ligo_tc(path, self)

    def run_replay(self, replay_path: str, max_keyframes: int = 10**9):
        for synced in self.ingest.synced_frames(replay_path):
            self.process(synced)
            if len(self.trajectory) >= max_keyframes:
                break
        self.device_timer.collect()
        return self.trajectory

    def _imu_window(self, synced) -> np.ndarray:
        """Padded (64, 7) [accel(3), gyro(3), dt] window from the sweep's INS
        samples, static biases removed (imu config, compcallback.cpp:28-157)."""
        samples = synced.ins
        imu = np.zeros((IMU_WINDOW_CAPACITY, 7))
        k = 0
        for a, b in zip(samples, samples[1:]):
            if k >= IMU_WINDOW_CAPACITY:
                log.warning("IMU window overflow (%d samples)", len(samples))
                break
            imu[k, 0:3] = np.asarray(a.imu_accel) - self.cfg.imu.static_bias_accel
            imu[k, 3:6] = np.asarray(a.imu_gyro) - self.cfg.imu.static_bias_gyro
            imu[k, 6] = max(b.t - a.t, 0.0)
            k += 1
        return imu

    def _insert_keyframe(self, points, mask, win_entry: dict):
        """Insert a body-frame sweep into the registration ring; the slot keeps
        the live window entry, so later re-solves move its world pose."""
        self._kf_clouds[self._kf_head] = points
        self._kf_masks[self._kf_head] = mask
        self._kf_slots[self._kf_head] = win_entry
        self._kf_head = (self._kf_head + 1) % self._kf_clouds.shape[0]

    def _window_poses(self) -> np.ndarray:
        """(K, 12) float32 optimized world poses of the ring slots (identity
        rows for empty slots, whose masks are all False)."""
        out = np.zeros((len(self._kf_slots), 12), np.float32)
        for k, entry in enumerate(self._kf_slots):
            if entry is None:
                out[k, 0:9] = np.eye(3).ravel()
            else:
                out[k, 0:9] = np.asarray(entry["pose"].rot, np.float64).ravel()
                out[k, 9:12] = np.asarray(entry["pose"].trans, np.float64)
        return out

    def process(self, synced):
        k = len(self.trajectory)
        self.device_timer.keyframe_begin(k)
        with self.timer.span("project"), self.device_timer.span("project"):
            scan = self.ingest.project(synced)
        nav = synced.ins[-1]
        if self._ref_lla is None:
            self._ref_lla = np.asarray(nav.lla)
            self._gravity = np.array([0.0, 0.0, float(gravity_wgs84(*self._ref_lla))])  # NED: +down
            self._factor_template = self._factor_template._replace(
                gravity=to_device(self._gravity, self.device))
        with self.device_timer.span("deskew"):
            scan = maybe_deskew(scan, synced, self._ref_lla, self.cfg.deskew)
        ins_pose = ins_pose_ned(nav, self._ref_lla)
        ins_np = Pose3(np.asarray(ins_pose.rot, np.float64), np.asarray(ins_pose.trans, np.float64))
        ins_sigma = np.concatenate([np.asarray(nav.sigma_rpy), np.asarray(nav.sigma_pos)])
        vel_ned = np.asarray(nav.vel_ned, np.float64)

        if self._kf_clouds is None:
            self._first_keyframe(synced, scan, ins_np, ins_sigma, vel_ned)
            self.device_timer.keyframe_queued(k)
            self.device_timer.keyframe_published(k)
            return

        prev = self._win[-1]
        self._origin, shifted = gaussian_map.recenter_origin(
            self._origin, ins_np.trans, self.newton_cfg.resolution)
        imu = self._imu_window(synced)
        reg = self.cfg.register
        rebuild = self._cadence.tick(force=shifted)
        # the step's host inputs reach the device in one copy
        K = len(self._kf_slots)
        host = np.concatenate([
            self._window_poses().ravel(),
            np.asarray(prev["pose"].rot, np.float64).ravel(), np.asarray(prev["pose"].trans, np.float64),
            np.asarray(prev["vel"], np.float64), np.asarray(prev["bias"], np.float64),
            self._gravity, np.asarray(self._origin, np.float64),
            imu[:, 0:6].ravel(),
        ]).astype(np.float64)
        buf = to_device(host, self.device)
        with self.timer.span("ndt"):
            self._cadence.regmap, out = _ligo_step(
                self._kf_clouds, self._kf_masks, buf[:12 * K].view(K, 12), scan.points, scan.mask,
                buf[12 * K + FLAT:].view(IMU_WINDOW_CAPACITY, 6), imu[:, 6],
                buf[12 * K:12 * K + FLAT], rebuild, self._cadence.regmap, self.noise,
                self.newton_cfg, reg.map_capacity, reg.min_points_per_voxel, self.grid_shape,
                reg.fused_inner_iters, timer=self.device_timer,
            )
            out = torch.cat([out, scan.num_points.reshape(1).to(out.dtype)]).cpu().numpy()
        if self._cadence.regmap is not None and (self._cadence._idx & 31) == 1:
            ovf = int(self._cadence.regmap.overflow)
            if ovf and not self._ovf_warned:
                self._ovf_warned = True
                log.warning("RegMap truncated %d dilated cells (capacity/grid too small) — "
                            "raise map_capacity or reg_grid_shape", ovf)
        pim_np = dict(
            dR=out[0:9].reshape(3, 3), dv=out[9:12], dp=out[12:15], dt=float(out[15]),
            dR_dbg=out[16:25].reshape(3, 3), dv_dba=out[25:34].reshape(3, 3),
            dv_dbg=out[34:43].reshape(3, 3), dp_dba=out[43:52].reshape(3, 3),
            dp_dbg=out[52:61].reshape(3, 3), bias_hat=out[61:67], cov=out[67:292].reshape(15, 15),
        )
        predicted_vel = out[292:295]
        res_pose = Pose3(out[295:304].reshape(3, 3), out[304:307])
        H = out[307:343].reshape(6, 6)
        ndt_score, ndt_iters, ndt_converged, num_points = out[343:347]
        lidar_cov = -np.linalg.inv(H + 1e-6 * np.eye(6))
        lidar_cov = 0.5 * (lidar_cov + lidar_cov.T)
        ev, evec = np.linalg.eigh(lidar_cov)
        lidar_cov = evec @ np.diag(np.maximum(ev, 1e-12)) @ evec.T
        # registration-bias variance floor (RegisterConfig.lidar_*_sigma_floor):
        # the point-count-scaled Hessian prices the between factor far below
        # the estimator's real mm-class bias
        floor = np.concatenate([np.full(3, reg.lidar_rot_sigma_floor),
                                np.full(3, reg.lidar_trans_sigma_floor)])
        lidar_cov = lidar_cov + np.diag(floor * floor)
        rel = np_between(prev["pose"], res_pose)

        self._trust, scale = robust.trust_gain_update_np(
            self._trust, float(np.linalg.norm(np.asarray(nav.sigma_pos))))
        scaled_sigma = np.maximum(ins_sigma * float(scale), 1e-6)

        entry = dict(pose=res_pose, vel=predicted_vel, bias=np.asarray(prev["bias"]),
                     ins=(ins_np, scaled_sigma), ins_vel=vel_ned, pim=pim_np, rel=rel,
                     rel_cov=lidar_cov)
        self._win.append(entry)
        if len(self._win) > self.window:
            self._win.pop(0)

        with self.timer.span("smoother"):
            # _fuse writes the optimized states back into self._win
            pose_opt, cov_opt = self._fuse()
        self._insert_keyframe(scan.points, scan.mask, entry)  # body frame; _ligo_step poses it
        self.device_timer.keyframe_queued(k)
        if self.viz is not None:
            self.viz.push(self.viz.subsample(scan), pose_opt, synced.scan.frame_id, ins_pose=ins_pose)
        self.trajectory.append(TrajectoryEntry(synced.t_end, synced.scan.frame_id, pose_opt,
                                               ins_pose, cov_opt))
        self.device_timer.keyframe_published(k)
        self.stats.add(KeyFrameStats(
            frame_id=synced.scan.frame_id,
            timestamp=synced.t_end,
            num_points=int(num_points),
            align_time_ms=self.timer.last_ms("ndt"),
            ndt_iterations=int(ndt_iters),
            converged=bool(ndt_converged > 0.5),
            score=float(ndt_score),
            ins_sigma=ins_sigma,
            scaled_sigma=scaled_sigma,
            lidar_sigma=np.sqrt(np.maximum(np.diag(lidar_cov), 0.0)),
            optimized_sigma=np.sqrt(np.maximum(np.diag(cov_opt)[:6], 0.0)),
            ins_pose=np_pose7(ins_np.rot, ins_np.trans),
            optimized_pose=np_pose7(pose_opt.rot, pose_opt.trans),
            # INS-vs-optimized translation gap (pipeline.cpp:745-752)
            pose_rmse=float(np.linalg.norm(ins_np.trans - pose_opt.trans)),
        ))

    def _first_keyframe(self, synced, scan, ins_np, ins_sigma, vel_ned):
        """Priors only (pipeline_ligo_tc.cpp:365-404): the first window state
        at the INS pose and velocity, and the ring's first cloud."""
        self._origin = ins_np.trans - 512.0 * self.newton_cfg.resolution
        K = max(int(self.cfg.register.keyframe_window), 1)
        N = scan.points.shape[0]
        self._kf_clouds = torch.zeros((K, N, 3), dtype=torch.float32, device=self.device)
        self._kf_masks = torch.zeros((K, N), dtype=torch.bool, device=self.device)
        self._kf_slots = [None] * K
        first = dict(pose=ins_np, vel=vel_ned, bias=np.zeros(6), ins=(ins_np, np.maximum(ins_sigma, 1e-6)),
                     ins_vel=vel_ned, pim=None, rel=None, rel_cov=None)
        self._insert_keyframe(scan.points, scan.mask, first)
        self._win = [first]
        if self.viz is not None:
            self.viz.push(self.viz.subsample(scan), ins_np, synced.scan.frame_id, ins_pose=ins_np)
        self.trajectory.append(TrajectoryEntry(synced.t_end, synced.scan.frame_id, ins_np, ins_np))

    def _fuse(self):
        """Window re-solve: the factor arrays are assembled in numpy, reach
        the device as one buffer, and the solution comes back in one read;
        it is written into the window entries. Returns the newest state's
        pose and its (15, 15) marginal covariance."""
        W, n = self.window, len(self._win)
        pad, pad_b = W - n, W - n
        eye3, eye6, eye15 = np.eye(3), np.eye(6), np.eye(15)
        pims = [w["pim"] for w in self._win[1:]]

        def stack(items, pad_item, count=pad):
            return np.stack([np.asarray(x, np.float64) for x in items] + [pad_item] * count)

        def stack_pim(key, pad_val):
            return stack((p[key] for p in pims), pad_val, pad_b)

        args = dict(
            rot=stack((w["pose"].rot for w in self._win), eye3),
            trans=stack((w["pose"].trans for w in self._win), np.zeros(3)),
            vel=stack((w["vel"] for w in self._win), np.zeros(3)),
            bias=stack((w["bias"] for w in self._win), np.zeros(6)),
            active=np.asarray([1.0] * n + [0.0] * pad),
            fp_rot=stack((w["ins"][0].rot for w in self._win), eye3),
            fp_trans=stack((w["ins"][0].trans for w in self._win), np.zeros(3)),
            fp_si=stack((np_sqrt_info_from_sigmas(w["ins"][1]) for w in self._win), eye6),
            fv_val=stack((w["ins_vel"] for w in self._win), np.zeros(3)),
            fbias_val=np.asarray(self._win[0]["bias"], np.float64)[None],
            fb_rot=stack((w["rel"].rot for w in self._win[1:]), eye3, pad_b),
            fb_trans=stack((w["rel"].trans for w in self._win[1:]), np.zeros(3), pad_b),
            fb_si=stack((np_sqrt_info_from_cov(w["rel_cov"]) for w in self._win[1:]), eye6, pad_b),
            b_active=np.asarray([1.0] * (n - 1) + [0.0] * pad_b),
            dR=stack_pim("dR", eye3),
            dv=stack_pim("dv", np.zeros(3)),
            dp=stack_pim("dp", np.zeros(3)),
            dt=np.asarray([p["dt"] for p in pims] + [0.0] * pad_b),
            dR_dbg=stack_pim("dR_dbg", np.zeros((3, 3))),
            dv_dba=stack_pim("dv_dba", np.zeros((3, 3))),
            dv_dbg=stack_pim("dv_dbg", np.zeros((3, 3))),
            dp_dba=stack_pim("dp_dba", np.zeros((3, 3))),
            dp_dbg=stack_pim("dp_dbg", np.zeros((3, 3))),
            bias_hat=stack_pim("bias_hat", np.zeros(6)),
            fi_si=stack((np_sqrt_info_from_cov(p["cov"]) for p in pims), eye15, pad_b),
        )
        buf = to_device(np.concatenate([a.ravel() for a in args.values()]), self.device)
        parts = torch.split(buf, [a.size for a in args.values()])
        a = {k: t.view(v.shape) for (k, v), t in zip(args.items(), parts)}
        out = self._fuse_device(a, n - 1).cpu().numpy()
        rot, trans, vel, bias, cov = np.split(out, np.cumsum([9 * W, 3 * W, 3 * W, 6 * W]))
        rot, trans = rot.reshape(W, 3, 3), trans.reshape(W, 3)
        vel, bias = vel.reshape(W, 3), bias.reshape(W, 6)
        for k in range(n):
            self._win[k]["pose"] = Pose3(rot[k], trans[k])
            self._win[k]["vel"] = vel[k]
            self._win[k]["bias"] = bias[k]
        return Pose3(rot[n - 1], trans[n - 1]), cov.reshape(15, 15)

    def _fuse_device(self, a: dict, cur: int) -> torch.Tensor:
        """Device half of the window re-solve: the smoother over the factor
        template filled from ``a``, then state ``cur``'s marginal covariance.
        Returns [rot, trans, vel, bias, cov] flat."""
        tpl = self._factor_template
        active, b_active = a["active"] > 0.5, a["b_active"] > 0.5
        state = WindowState(a["rot"], a["trans"], a["vel"], a["bias"], active)
        factors = tpl._replace(
            prior_pose=tpl.prior_pose._replace(rot=a["fp_rot"], trans=a["fp_trans"],
                                               sqrt_info=a["fp_si"], active=active),
            prior_vel=tpl.prior_vel._replace(value=a["fv_val"], active=active),
            prior_bias=tpl.prior_bias._replace(value=a["fbias_val"]),
            between=tpl.between._replace(rot=a["fb_rot"], trans=a["fb_trans"], sqrt_info=a["fb_si"],
                                         active=b_active),
            imu=tpl.imu._replace(
                dR=a["dR"], dv=a["dv"], dp=a["dp"], dt=a["dt"], dR_dbg=a["dR_dbg"],
                dv_dba=a["dv_dba"], dv_dbg=a["dv_dbg"], dp_dba=a["dp_dba"], dp_dbg=a["dp_dbg"],
                bias_hat=a["bias_hat"], sqrt_info=a["fi_si"], active=b_active),
        )
        with self.device_timer.span("smoother"):
            result = optimize(state, factors, self.smoother_cfg)
        with self.device_timer.span("covariance"):
            cov = marginal_covariance(result.hessian, cur)
        st = result.state
        return torch.cat([st.rot.reshape(-1), st.trans.reshape(-1), st.vel.reshape(-1),
                          st.bias.reshape(-1), cov.reshape(-1)])
