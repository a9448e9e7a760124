"""Newton-NDT odometry with the pose-window smoother, the reference's plain
``pipeline`` executable (port of slamtpu/apps/odom_ndt.py).

Per keyframe (run/pipeline.cpp:432-824): the target map is the previous
keyframe cloud at its optimized pose; Newton registration (NDT, or
isotropic VGICP) from the INS-relative seed; the deviation gate against
the seed and the SE(3) blend; the LiDAR covariance from the Hessian with
its eigenvalue and sigma floors; the INS prior with GPS-denial trust-gain
sigma scaling; the window smoother and the newest state's marginal
covariance. The host ships one (36,) vector in and reads one (100,) vector
out per keyframe, two keyframes late, so the fetch overlaps the next
dispatch.

Engines, all on the RegMap layout: ``NDT_OMP`` (``newton_align_fused``
over the NDT pair kernel); ``GICP``, isotropic (over the VGICP pair
kernel) or with ``gicp_source_cov="anisotropic"`` (``gicp_align_aniso``
over the plane-to-plane pair kernel, with stencil or voxel source
covariances); ``SVNNDT`` (``svn_align_reg``, the particle draws from the
app's seeded generator, one draw a keyframe); and ``NDT_OMP_MULTIRES``
(``multires_align`` over a two-level pyramid).

Search modes, as the reference: with ``search_method="KDTREE"`` NDT_OMP
registers on a ``build_regmap_kdtree`` map with the radius gate in the NDT
pair kernel, and isotropic GICP gates the VGICP pair kernel over its
DIRECT7 ``gicp_map`` table (the reference's fused contract; its XLA path
skips the gate); SVNNDT takes ``svn_search_method`` the same way.
Anisotropic GICP and NDT_OMP_MULTIRES ignore the mode. DIRECT1 runs
DIRECT7 (``common.search_radius``). ``save_checkpoint``/``resume_from``
carry the window and the host state (``runtime.checkpoint``).

With ``use_regmap=False`` (the sorted-key path, the reference's
``grid_shape=None``) the engines run as the reference's do there: NDT_OMP
is ``newton_align`` and SVNNDT ``svn_align`` on the sorted-key objective
against the keyframe's Gaussian map (DIRECT1 searching one voxel, KDTREE
running DIRECT7); isotropic GICP is ``gicp_align`` (one Newton step a
lookup, no KDTREE gate) and anisotropic GICP and NDT_OMP_MULTIRES run as
before, all three on a RegMap over the fixed grid ``SORTED_KEY_GRID``
instead of ``reg_grid_shape``.

With ``loop_closure=True`` a ``LoopDetector`` takes each keyframe's cloud
(its own copy, on the device) at its optimized pose as the host reads it,
two keyframes late (the first at its INS pose), and verifies revisits by
NDT registration; ``refine_loop_closures()`` then solves the pose graph of
the odometry chain, the verified closures and the INS priors and rewrites
the trajectory. Checkpoints do not carry the detector, as in the
reference: after a resume it starts empty.

Dtypes: registration runs in float32. The target map's voxel statistics
are computed in float64 (``MAP_DTYPE``) from the float32 target cloud, as
the source's double-precision voxel covariances: in float32 the voxels
whose points lie nearly on a line (one scan ring on the ground) fail the
eigenvalue gate at random, and the map loses a few percent of its voxels
a keyframe. (The reference builds it in float32.) The window carry (poses, priors, between factors,
sqrt-information) is float64 on every device: the smoother is a 48x48
problem and Hopper has float64 units. (The reference keeps it in float64
under x64, as its tests run, and in float32 on the TPU.) The window fill
count ``n`` is a host integer: it advances by one per keyframe up to the
window size, so no device value decides it.

On a CUDA device the full window's solve (the ring's slide, the Gauss-Newton
iterations and the newest state's marginal covariance: the ``smoother``
span) is a CUDA graph replay (``PoseWindowGraph``, a client of
``core.cuda_graph``): the first full-window keyframe runs eagerly, the
second captures, the rest copy their inputs into the graph's buffers and
replay it under a ``smoother_graph_replay`` span. The window's fill-up and
the CPU stay eager.

Host syncs per keyframe in this module: one per Newton outer iteration
(the loop's exit test; one per step for ``newton_align``; none for
SVNNDT), one in ``torch.linalg.eigh`` (the
LiDAR covariance floor), and the lagged read of the result vector and the
point count. The map and RegMap build adds its own (``ndt/regmap.py``).
"""
from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional

import numpy as np
import torch

from ..core import cuda_graph, se3
from ..core.se3 import Pose3
from ..fusion import robust
from ..fusion.graph import sqrt_info_from_cov
from ..fusion.loop_closure import LoopClosureConfig, LoopDetector, refine_trajectory
from ..fusion.smoother import optimize_pose_window, pose_marginal_covariance
from ..mapping import gaussian_map
from ..ndt.fused_math import gicp_align, gicp_align_aniso, newton_align_fused
from ..ndt.gicp import gicp_map, gicp_map_aniso, sweep_point_covariances
from ..ndt.multires import build_pyramid, multires_align
from ..ndt.newton import NewtonConfig, NewtonResult, newton_align
from ..ndt.regmap import RegMap, build_regmap, build_regmap_kdtree
from ..ndt.svn import SvnConfig, SvnResult, svn_align, svn_align_reg
from ..runtime import checkpoint
from ..runtime.config import PipelineConfig
from ..runtime.device_timer import DeviceStageTimer
from ..runtime.device_timer import span as _span
from ..runtime.stats import KeyFrameStats, StageTimer, StatsArchive
from .common import (IngestPipeline, TrajectoryEntry, ins_pose_ned, maybe_deskew, np_pose7,
                     search_radius, to_device)

log = logging.getLogger("slamtpu_torch.odom_ndt")

KNOWN_METHODS = ("NDT_OMP", "SVNNDT", "GICP", "NDT_OMP_MULTIRES")
# seeds the SVNNDT particle draws; the reference seeds its key with the same
# number (PRNGKey(1234), slamtpu/apps/odom_ndt.py:501)
PARTICLE_SEED = 1234
# the RegMap grid of the GICP engines and the pyramid on the sorted-key path
# (the reference's ``grid_shape or (256, 256, 64)``)
SORTED_KEY_GRID = (256, 256, 64)
# the dtype the target map's voxel statistics are computed in (see Dtypes)
MAP_DTYPE = torch.float64


def _register_step(
    target_points,  # (M*N, 3) previous keyframe cloud(s), world frame; the
    #   Gaussian map is built in float64 and registered against in float32
    target_mask,
    new_points,  # (N, 3) body frame
    new_mask,
    init_guess: Pose3,  # float32
    origin,  # (3,) float32 map origin
    cfg: NewtonConfig,
    capacity: int,
    min_points: int,
    grid_shape: tuple,  # None: the sorted-key path (use_regmap=False)
    method: str = "NDT_OMP",
    inner_iters: int = 2,
    final_eval: bool = False,
    timer=None,
    reg_pose: Pose3 = None,
    regmap_cache: RegMap = None,
    rebuild: bool = True,
    svn_cfg: SvnConfig = None,  # SVNNDT
    init_noise=None,  # (K, 6) standard-normal particle draws (SVNNDT)
    scan_grid: tuple = None,  # (cols, sub) of new_points: stencil source
    #   covariances for the anisotropic GICP engine (else voxel ones)
):
    """Build the target map and register by the configured engine (the
    reference's registration_method switch, run/pipeline.cpp:464-481):
    NDT_OMP -> Newton NDT, GICP -> VGICP (plane-to-plane with
    ``cfg.gicp_aniso``), SVNNDT -> the SVN posterior, NDT_OMP_MULTIRES ->
    the coarse-to-fine pyramid. In the KDTREE search mode (``cfg.kd_radius``,
    or ``svn_cfg.kd_radius`` for SVNNDT) NDT_OMP and SVNNDT build the KDTREE
    layout; the gate itself is the Newton driver's and the SVN's.
    ``final_eval`` is newton_align_fused's
    contract switch for NDT_OMP and isotropic GICP: the app keeps the
    reference's default (score and Hessian of the last applied step); the
    plane-to-plane and pyramid engines take the contract of the reference's
    XLA loop, which they run on every backend. ``reg_pose`` adds the
    prior-pose pull toward it (with ``cfg.reg_weight``).

    With ``regmap_cache`` (NDT_OMP) the map and RegMap are built only when
    the host flag ``rebuild`` is set, in the cache's dtypes, and the call
    returns ``(result, regmap)`` so the caller carries the cache forward
    (RegisterConfig.map_rebuild_every).

    With no ``grid_shape`` (the sorted-key path) NDT_OMP and SVNNDT
    register on the Gaussian map itself (``newton_align``, ``svn_align``),
    isotropic GICP takes ``gicp_align``'s contract, and the GICP engines and
    the pyramid build their RegMaps over ``SORTED_KEY_GRID``."""
    sorted_key = grid_shape is None
    if method == "NDT_OMP_MULTIRES":
        with _span(timer, "map_build"):
            levels = build_pyramid(
                target_points.to(MAP_DTYPE), target_mask, origin, [2.0 * cfg.resolution, cfg.resolution],
                capacity, grid_shape or SORTED_KEY_GRID, min_points,
                [max(cfg.max_iterations // 3, 3), cfg.max_iterations],
            )
        with _span(timer, "newton"):
            return multires_align(new_points, new_mask, levels, init_guess)
    aniso = method == "GICP" and cfg.gicp_aniso
    reg_grid = grid_shape or SORTED_KEY_GRID
    regmap = regmap_cache
    if regmap_cache is None or rebuild:
        with _span(timer, "map_build"):
            gmap = gaussian_map.to_float32(gaussian_map.build_map(
                target_points.to(MAP_DTYPE), target_mask, origin, cfg.resolution, capacity=capacity,
                min_points_per_voxel=min_points))
            kd_radius = svn_cfg.kd_radius if method == "SVNNDT" else cfg.kd_radius
            build = build_regmap
            if aniso:
                gmap = gicp_map_aniso(gmap)
            elif method == "GICP":
                gmap = gicp_map(gmap)
            elif kd_radius > 0.0:
                build = build_regmap_kdtree
            if method == "GICP" or not sorted_key:  # the sorted-key NDT engines search gmap itself
                regmap = build(gmap, grid_shape=reg_grid)
            if regmap_cache is not None:
                regmap = RegMap(*(None if a is None else a.to(c.dtype)
                                  for a, c in zip(regmap, regmap_cache)))
    if method == "SVNNDT":
        with _span(timer, "svn"):
            if sorted_key:
                sv = svn_align(new_points, new_mask, gmap, init_guess, svn_cfg, init_noise=init_noise)
            else:
                sv = svn_align_reg(new_points, new_mask, regmap, init_guess, svn_cfg, grid_shape,
                                   init_noise=init_noise)
            res = _svn_as_newton(sv, new_points.dtype)
    elif aniso:
        with _span(timer, "src_covariances"):
            src_cov = sweep_point_covariances(new_points, new_mask, scan_grid, cfg.resolution,
                                              capacity, min_points)
        with _span(timer, "newton"):
            res = gicp_align_aniso(new_points, new_mask, src_cov, regmap, init_guess, cfg, reg_grid)
    elif sorted_key:
        with _span(timer, "newton"):
            if method == "GICP":
                res = gicp_align(new_points, new_mask, regmap, init_guess, cfg, reg_grid)
            else:
                res = newton_align(new_points, new_mask, gmap, init_guess, cfg, reg_pose=reg_pose)
    else:
        with _span(timer, "newton"):
            res = newton_align_fused(new_points, new_mask, regmap, init_guess, cfg, grid_shape,
                                     inner_iters=inner_iters, reg_pose=reg_pose,
                                     final_eval=final_eval, _gicp=method == "GICP")
    return res if regmap_cache is None else (res, regmap)


def _svn_as_newton(res: SvnResult, dtype) -> NewtonResult:
    """The SVN posterior in the Newton interface: H = -(cov + 1e-9 I)^-1, so
    that the LiDAR covariance -(H)^-1 is the posterior covariance."""
    cov = res.covariance
    eye = torch.eye(6, dtype=cov.dtype, device=cov.device)
    return NewtonResult(res.pose, -torch.linalg.inv_ex(cov + 1e-9 * eye)[0], res.score.to(dtype),
                        res.iterations, res.converged,
                        torch.zeros((), dtype=torch.int32, device=cov.device))


# the window ring in the carry: poses, INS priors (rotation, translation,
# sigmas) and between factors (rotation, translation, sqrt-information)
RING = ("win_rot", "win_trans", "fp_rot", "fp_trans", "fp_sig", "fb_rot", "fb_trans", "fb_si")


def _window_solve(ring, new, idx: int, full: bool, iterations: int):
    """Slide the window ring (roll left when ``full``, write ``new`` at
    ``idx``) and solve it: (the slid ring with the solved poses in place of
    the window's, the newest state's (6, 6) marginal covariance)."""

    def roll_in(a, new_val):
        rolled = torch.roll(a, -1, dims=0) if full else a.clone()
        rolled[idx] = new_val.to(a.dtype)
        return rolled

    win_rot, win_trans, fp_rot, fp_trans, fp_sig, fb_rot, fb_trans, fb_si = map(roll_in, ring, new)
    ks = torch.arange(win_trans.shape[0], device=win_trans.device)
    active = ks <= idx
    b_active = (ks >= 1) & (ks <= idx)
    sm = optimize_pose_window(
        win_rot, win_trans, active, fp_rot, fp_trans, torch.diag_embed(1.0 / fp_sig),
        fb_rot[1:], fb_trans[1:], fb_si[1:], b_active[1:], iterations=iterations,
    )
    cov_opt = pose_marginal_covariance(sm.hessian, idx)
    return (sm.rot, sm.trans, fp_rot, fp_trans, fp_sig, fb_rot, fb_trans, fb_si), cov_opt


class PoseWindowGraph(cuda_graph.GraphRunner):
    """``_window_solve`` with the full window's solve replayed as one CUDA
    graph on a CUDA device (``core.cuda_graph``); a window still filling
    changes its indices, so it stays eager. Keyed by (W, iterations, dtype,
    device); the buffers are the carry's ring and the keyframe's new
    entries. The graph calls ``optimize_pose_window`` as this module names
    it when it is captured."""

    def __init__(self):
        super().__init__(_window_solve, "smoother_graph_replay")

    def __call__(self, ring, new, idx: int, full: bool, iterations: int):
        win_trans = ring[1]
        if not (full and cuda_graph.replays(win_trans.device)):
            return _window_solve(ring, new, idx, full, iterations)
        key = (win_trans.shape[0], iterations, win_trans.dtype, win_trans.device)
        return self.run(key, win_trans.device, (ring, new, idx, full, iterations))


def _odom_fused_step(
    carry: dict,  # window ring + previous cloud(s); see OdomNdtApp._start
    new_points,  # (N, 3) body frame
    new_mask,
    flat,  # (36,) float64 on the device: [ins_rot(9), ins_trans(3),
    #   scaled_sigma(6), origin(3), lidar sigma floor (rot, trans),
    #   use_ins_rel flag(1), ins_rel rot(9) + trans(3)]
    cfg: NewtonConfig,
    capacity: int,
    min_points: int,
    grid_shape: tuple,
    max_td: float,
    max_rd: float,
    method: str = "NDT_OMP",
    inner_iters: int = 2,
    window: int = 6,
    smoother_iters: int = 4,
    tgt_window: int = 1,  # RegisterConfig.odom_target_window
    tgt_exclude: int = 0,  # RegisterConfig.odom_target_exclude
    final_eval: bool = False,  # see _register_step
    timer=None,
    svn_cfg: SvnConfig = None,  # SVNNDT
    init_noise=None,  # (K, 6) particle draws (SVNNDT)
    scan_grid: tuple = None,  # see _register_step
    window_graph=None,  # a PoseWindowGraph (else the window solve runs eagerly)
):
    """One complete odometry keyframe: (new carry, (100,) result vector
    [pose rot(9), trans(3), marginal cov(36), lidar cov(36), rel rot(9),
    trans(3), score, iterations, converged, blend weight])."""
    W, M = window, tgt_window
    cd = carry["win_trans"].dtype
    f32 = torch.float32
    ins_pose = Pose3(flat[0:9].reshape(3, 3).to(cd), flat[9:12].to(cd))
    scaled_sigma = torch.clamp(flat[12:18].to(cd), min=1e-6)
    origin = flat[18:21].to(f32)

    n = carry["n"]  # states currently in the window (>= 1)
    idx_prev = n - 1
    win_rot, win_trans = carry["win_rot"], carry["win_trans"]
    prev = Pose3(win_rot[idx_prev], win_trans[idx_prev])
    pp = Pose3(win_rot[max(idx_prev - 1, 0)], win_trans[max(idx_prev - 1, 0)])
    prev32, pp32 = se3.cast(prev, f32), se3.cast(pp, f32)
    with _span(timer, "target"):
        if M == 1:
            # target = previous keyframe cloud at its optimized pose (:552-557)
            target = se3.transform_points(prev32, carry["prev_points"][0])
            target_mask = carry["prev_mask"][0]
        else:
            # the last M clouds at their optimized window poses; ring slot
            # M-1 is the newest (state idx_prev), slot j holds state
            # idx_prev - (M-1-j), invalid during fill-up
            state_of_slot = [idx_prev - (M - 1) + j for j in range(M)]
            sidx = [min(max(s, 0), W - 1) for s in state_of_slot]
            Rm = torch.stack([win_rot[i] for i in sidx]).to(f32)
            tm = torch.stack([win_trans[i] for i in sidx]).to(f32)
            world = torch.einsum("mij,mnj->mni", Rm, carry["prev_points"]) + tm[:, None, :]
            valid = [s >= 0 for s in state_of_slot]
            if tgt_exclude > 0:  # drop the newest E clouds, keeping at least one
                e_eff = min(tgt_exclude, max(sum(valid) - 1, 0))
                valid = [v and (M - 1 - j) >= e_eff for j, v in enumerate(valid)]
            target = world.reshape(-1, 3)
            target_mask = carry["prev_mask"].clone()
            for j, v in enumerate(valid):
                if not v:
                    target_mask[j] = False
            target_mask = target_mask.reshape(-1)
        # seed: constant velocity once two states exist, replaced by the
        # INS relative motion since the previous keyframe when flagged
        guess = robust.constant_velocity_predict(pp32, prev32) if n >= 2 else prev32
        rel_ins = Pose3(flat[24:33].reshape(3, 3).to(f32), flat[33:36].to(f32))
        guess = se3.where(flat[23] > 0.5, se3.compose(prev32, rel_ins), guess)
    res = _register_step(target, target_mask, new_points, new_mask, guess, origin, cfg, capacity,
                         min_points, grid_shape, method=method, inner_iters=inner_iters,
                         final_eval=final_eval, timer=timer, svn_cfg=svn_cfg,
                         init_noise=init_noise, scan_grid=scan_grid)
    with _span(timer, "blend"):
        blended32, w = robust.deviation_gated_blend(guess, res.pose, max_td, max_rd)
        blended = se3.cast(blended32, cd)
    with _span(timer, "covariance"):
        # LiDAR covariance from the Hessian (pipeline.cpp:594-603)
        eye6 = torch.eye(6, dtype=cd, device=flat.device)
        lidar_cov = -torch.linalg.inv_ex(res.hessian.to(cd) + 1e-6 * eye6)[0]
        lidar_cov = 0.5 * (lidar_cov + lidar_cov.t())
        ev, evec = torch.linalg.eigh(lidar_cov)  # waits for the device (error check)
        lidar_cov = (evec * torch.clamp(ev, min=1e-12)[None, :]) @ evec.t()
        # registration-bias variance floor (RegisterConfig.lidar_*_sigma_floor)
        floor = torch.cat([flat[21:22].expand(3), flat[22:23].expand(3)]).to(cd)
        lidar_cov = lidar_cov + torch.diag(floor * floor)
        fb_si_new = sqrt_info_from_cov(lidar_cov)
        rel = se3.between(prev, blended)

    with _span(timer, "smoother"):
        full = n >= W
        idx = min(n, W - 1)
        # the ring's new entries, in RING's order; edge slot e holds the
        # between factor (e-1) -> e, and idx >= 1 here
        new = (blended.rot, blended.trans, ins_pose.rot, ins_pose.trans, scaled_sigma, rel.rot, rel.trans,
               fb_si_new)
        ring = tuple(carry[k] for k in RING)
        ring, cov_opt = (window_graph or _window_solve)(ring, new, idx, full, smoother_iters)
        sm_rot, sm_trans = ring[0], ring[1]

    if M == 1:
        prev_points, prev_mask = new_points[None], new_mask[None]
    else:  # roll the target-cloud ring: newest at slot M-1
        prev_points = torch.roll(carry["prev_points"], -1, dims=0)
        prev_points[M - 1] = new_points
        prev_mask = torch.roll(carry["prev_mask"], -1, dims=0)
        prev_mask[M - 1] = new_mask
    new_carry = dict(zip(RING, ring), n=min(n + 1, W), prev_points=prev_points, prev_mask=prev_mask)
    out = torch.cat([
        sm_rot[idx].reshape(-1), sm_trans[idx], cov_opt.reshape(-1), lidar_cov.reshape(-1),
        rel.rot.reshape(-1), rel.trans,
        torch.stack([res.score.to(cd), res.iterations.to(cd), res.converged.to(cd), w.to(cd)]),
    ])
    return new_carry, out


@dataclasses.dataclass
class OdomNdtApp:
    cfg: PipelineConfig
    device: torch.device  # where the keyframe path runs ("cuda" or "cpu")
    window: int = 8  # smoother window size (states kept live)
    max_trans_deviation: float = 1.0  # pipeline.cpp:454
    max_rot_deviation: float = 0.1  # pipeline.cpp:455
    loop_closure: bool = False
    loop_cfg: object = None
    method: Optional[str] = None  # None -> cfg.register.method
    smoother_iters: int = 4  # pose-window Gauss-Newton iterations

    def __post_init__(self):
        self.device = torch.device(self.device)
        reg = self.cfg.register
        if self.method is None:
            self.method = reg.method
        if self.method not in KNOWN_METHODS:
            raise ValueError(f"unknown registration method {self.method!r}; known: {KNOWN_METHODS}")
        self.ingest = IngestPipeline(self.cfg, self.device)
        self.newton_cfg = NewtonConfig(
            resolution=reg.ndt_resolution,
            outlier_ratio=reg.svn_outlier_ratio,
            max_iterations=reg.ndt_max_iterations,
            trans_eps=reg.gicp_transform_epsilon if self.method == "GICP"
            else reg.ndt_transform_epsilon,
            use_direct1=reg.search_method == "DIRECT1",
            # KDTREE: radius search over leaf centroids at one resolution
            kd_radius=search_radius(reg.search_method, reg.ndt_resolution, reg.use_regmap),
            gicp_max_corr_dist=reg.gicp_corr_dist_threshold,
            gicp_aniso=reg.gicp_source_cov == "anisotropic",
        )
        # the anisotropic GICP engine's source covariances come from the
        # sweep's range-image stencil (RegisterConfig.svn_src_cov)
        self._scan_grid = (
            (self.cfg.meta.columns_per_frame, self.ingest.luts.subset_channels)
            if self.newton_cfg.gicp_aniso and reg.svn_src_cov == "stencil" else None
        )
        self.svn_cfg = None
        self.generator = None
        if self.method == "SVNNDT":
            self.svn_cfg = SvnConfig(
                resolution=reg.svn_resolution,
                outlier_ratio=reg.svn_outlier_ratio,
                num_particles=reg.svn_particles,
                max_iterations=reg.svn_max_iterations,
                kernel_h=reg.svn_kernel_h,
                step_size=reg.svn_step_size,
                stop_thresh=reg.svn_stop_thresh,
                use_direct1=reg.svn_search_method == "DIRECT1",
                kd_radius=search_radius(reg.svn_search_method, reg.svn_resolution, reg.use_regmap),
                polish_iters=reg.svn_polish_iters,
                # the RegMap carries no aux payload: the target is rebuilt
                # every keyframe, so the polish stays on the NDT score
                polish_objective="ndt",
            )
            self.generator = torch.Generator(device=self.device)
            self.generator.manual_seed(PARTICLE_SEED)
        # None: the sorted-key path (no RegMap for the NDT engines)
        self.grid_shape = tuple(reg.reg_grid_shape) if reg.use_regmap else None
        # multi-viewpoint registration target, clamped to the smoother window
        self.tgt_window = max(1, min(int(reg.odom_target_window), self.window))
        self.tgt_exclude = max(0, min(int(reg.odom_target_exclude), self.tgt_window - 1))
        self._trajectory: List[TrajectoryEntry] = []
        self._stats = StatsArchive()
        self.viz = None  # Optional[common.VizHook], set by the command line's --viz
        self.timer = StageTimer()  # host spans
        self.device_timer = DeviceStageTimer(self.device)  # per-stage device spans
        self._ref_lla: Optional[np.ndarray] = None
        self._origin = None  # numpy (3,) float64
        self._trust = robust.trust_gain_init_np()
        self._carry = None  # device window state; None until the first keyframe
        self._window_graph = PoseWindowGraph()  # the full window's solve, replayed as a CUDA graph on a card
        # (rot, trans) numpy float64 INS pose of the previous keyframe: the
        # source of the INS-relative registration seed
        self._prev_ins = None
        self._n_keyframes = 0
        # keyframes whose device results are still in flight; the host reads
        # them two keyframes late, so the read overlaps the next dispatch
        self._pending: List[tuple] = []
        # loop closure: the detector, its verified closures, and the
        # odometry chain (relative pose, LiDAR covariance) for the
        # pose-graph refinement
        self._detector = LoopDetector(self.loop_cfg or LoopClosureConfig()) if self.loop_closure else None
        self._closures = []
        self._odo_rels: List[tuple] = []

    @property
    def trajectory(self) -> List[TrajectoryEntry]:
        self.flush()
        return self._trajectory

    @property
    def stats(self) -> StatsArchive:
        self.flush()
        return self._stats

    def save_checkpoint(self, path: str):
        """Write the state a later run continues from (``checkpoint.save_odom_ndt``)."""
        checkpoint.save_odom_ndt(path, self)

    def resume_from(self, path: str):
        """Continue from a checkpoint of either package."""
        return checkpoint.load_odom_ndt(path, self)

    def run_replay(self, replay_path: str, max_keyframes: int = 10**9):
        for synced in self.ingest.synced_frames(replay_path):
            self.process(synced)
            if self._n_keyframes >= max_keyframes:
                break
        return self.trajectory

    def process(self, synced):
        k = self._n_keyframes
        self.device_timer.keyframe_begin(k)
        with self.timer.span("project"), self.device_timer.span("project"):
            scan = self.ingest.project(synced)
        nav = synced.ins[-1]
        if self._ref_lla is None:
            self._ref_lla = np.asarray(nav.lla)
        with self.device_timer.span("deskew"):
            scan = maybe_deskew(scan, synced, self._ref_lla, self.cfg.deskew)
        ins_pose = ins_pose_ned(nav, self._ref_lla)
        ins_sigma = np.concatenate([np.asarray(nav.sigma_rpy), np.asarray(nav.sigma_pos)])

        if self._carry is None:
            # first keyframe: INS prior only (pipeline.cpp:532-543)
            self._origin = np.asarray(ins_pose.trans, np.float64) - 512.0 * self.newton_cfg.resolution
            self._start(ins_pose, ins_sigma, synced, scan)
            self.device_timer.keyframe_queued(k)
            self.device_timer.keyframe_published(k)
            return

        self._origin, _shifted = gaussian_map.recenter_origin(
            self._origin, np.asarray(ins_pose.trans), self.newton_cfg.resolution
        )
        # trust-gain INS prior (pipeline.cpp:637-665): host data only
        self._trust, scale = robust.trust_gain_update_np(
            self._trust, float(np.linalg.norm(np.asarray(nav.sigma_pos)))
        )
        scaled_sigma = np.maximum(ins_sigma * float(scale), 1e-6)
        reg = self.cfg.register
        # INS relative motion since the previous keyframe: the registration
        # seed. Like the reference (odom_ndt.py:603) it is not gated on the
        # GPS-denial trust or checked against the constant-velocity guess.
        # Unknown after resuming a file without it: flag 0, the
        # constant-velocity seed.
        cr = np.asarray(ins_pose.rot, np.float64)
        ct = np.asarray(ins_pose.trans, np.float64)
        if self._prev_ins is None:
            ins_rel = np.zeros(13)
        else:
            pr, pt = self._prev_ins
            ins_rel = np.concatenate([[1.0], (pr.T @ cr).ravel(), pr.T @ (ct - pt)])
        self._prev_ins = (cr.copy(), ct.copy())
        flat = np.concatenate([
            cr.ravel(), ct, scaled_sigma, np.asarray(self._origin, np.float64),
            [reg.lidar_rot_sigma_floor, reg.lidar_trans_sigma_floor], ins_rel,
        ]).astype(np.float64)
        with self.timer.span("step"):
            self._carry, out = _odom_fused_step(
                self._carry, scan.points, scan.mask, to_device(flat, self.device), self.newton_cfg,
                reg.map_capacity, reg.min_points_per_voxel, self.grid_shape,
                self.max_trans_deviation, self.max_rot_deviation, method=self.method,
                inner_iters=reg.fused_inner_iters, window=self.window,
                smoother_iters=self.smoother_iters, tgt_window=self.tgt_window,
                tgt_exclude=self.tgt_exclude, timer=self.device_timer, svn_cfg=self.svn_cfg,
                init_noise=self._particle_noise(), scan_grid=self._scan_grid,
                window_graph=self._window_graph,
            )
        self._n_keyframes += 1
        # the detector keeps its own copy of the cloud
        det_cloud = (scan.points.clone(), scan.mask.clone()) if self._detector is not None else None
        viz_pts = self.viz.subsample(scan) if self.viz is not None else None
        self._pending.append((k, synced, scan.num_points, ins_pose, ins_sigma, scaled_sigma,
                              self.timer.last_ms("step"), out, det_cloud, viz_pts))
        self.device_timer.keyframe_queued(k)
        if len(self._pending) > 2:
            self._drain_one()

    def _particle_noise(self):
        """The keyframe's (K, 6) standard-normal particle draws (SVNNDT), or None."""
        if self.generator is None:
            return None
        return torch.randn((self.svn_cfg.num_particles, 6), generator=self.generator,
                           device=self.device)

    def flush(self):
        """Read back all in-flight keyframe results."""
        while self._pending:
            self._drain_one()
        self.device_timer.collect()

    def _drain_one(self):
        (k, synced, num_points, ins_pose, ins_sigma, scaled_sigma, dt_ms, out_dev, det_cloud,
         viz_pts) = self._pending.pop(0)
        out = out_dev.cpu().numpy().astype(np.float64)
        self.device_timer.keyframe_published(k)
        pose_opt = (out[0:9].reshape(3, 3), out[9:12])
        cov_opt = out[12:48].reshape(6, 6)
        lidar_cov = out[48:84].reshape(6, 6)
        ndt_score, ndt_iters, ndt_converged, w = out[96:100]
        if self.viz is not None:
            self.viz.push(viz_pts, Pose3(*pose_opt), synced.scan.frame_id, ins_pose=ins_pose)
        if self._detector is not None:
            self._odo_rels.append((Pose3(out[84:93].reshape(3, 3), out[93:96]), lidar_cov))
            self._closures += self._detector.add_keyframe(Pose3(*pose_opt), *det_cloud)
        self._trajectory.append(TrajectoryEntry(
            timestamp=synced.t_end, frame_id=synced.scan.frame_id,
            pose=Pose3(pose_opt[0], pose_opt[1]), ins_pose=ins_pose, covariance=cov_opt,
        ))
        self._stats.add(KeyFrameStats(
            frame_id=synced.scan.frame_id,
            timestamp=synced.t_end,
            num_points=int(num_points),
            ndt_iterations=int(ndt_iters),
            converged=bool(ndt_converged > 0.5),
            score=float(ndt_score),
            ins_sigma=ins_sigma,
            scaled_sigma=scaled_sigma,
            lidar_sigma=np.sqrt(np.maximum(np.diag(lidar_cov), 0.0)),
            optimized_sigma=np.sqrt(np.maximum(np.diag(cov_opt), 0.0)),
            align_time_ms=dt_ms,
            ins_pose=np_pose7(np.asarray(ins_pose.rot), np.asarray(ins_pose.trans)),
            optimized_pose=np_pose7(pose_opt[0], pose_opt[1]),
            # INS-vs-optimized translation gap (pipeline.cpp:745-752)
            pose_rmse=float(np.linalg.norm(np.asarray(ins_pose.trans) - pose_opt[1])),
            trust_weight=float(w),
        ))

    def _start(self, ins_pose, ins_sigma, synced, scan):
        W, M = self.window, self.tgt_window
        f64, dev = torch.float64, self.device
        rot = np.asarray(ins_pose.rot, np.float64)
        trans = np.asarray(ins_pose.trans, np.float64)
        self._prev_ins = (rot.copy(), trans.copy())
        eye3 = np.tile(np.eye(3), (W, 1, 1))
        win_rot = eye3.copy()
        win_rot[0] = rot
        win_trans = np.zeros((W, 3))
        win_trans[0] = trans
        fp_sig = np.ones((W, 6))
        fp_sig[0] = np.maximum(ins_sigma, 1e-6)
        host = dict(win_rot=win_rot, win_trans=win_trans, fp_rot=win_rot, fp_trans=win_trans,
                    fp_sig=fp_sig, fb_rot=eye3, fb_trans=np.zeros((W, 3)),
                    fb_si=np.tile(np.eye(6), (W, 1, 1)))
        self._carry = {k: to_device(v, dev).to(f64) for k, v in host.items()}
        self._carry["n"] = 1
        # target-cloud ring, newest at slot M-1 (odom_target_window)
        prev_points = torch.zeros((M,) + tuple(scan.points.shape), dtype=scan.points.dtype, device=dev)
        prev_points[M - 1] = scan.points
        prev_mask = torch.zeros((M,) + tuple(scan.mask.shape), dtype=torch.bool, device=dev)
        prev_mask[M - 1] = scan.mask
        self._carry.update(prev_points=prev_points, prev_mask=prev_mask)
        self._n_keyframes += 1
        if self.viz is not None:
            self.viz.push(self.viz.subsample(scan), ins_pose, synced.scan.frame_id, ins_pose=ins_pose)
        if self._detector is not None:
            self._closures += self._detector.add_keyframe(Pose3(rot, trans), scan.points.clone(),
                                                          scan.mask.clone())
        self._trajectory.append(TrajectoryEntry(
            timestamp=synced.t_end, frame_id=synced.scan.frame_id, pose=ins_pose, ins_pose=ins_pose,
        ))

    def refine_loop_closures(self):
        """Offline pose-graph pass over the whole trajectory: the odometry
        chain's between factors (each keyframe's registration relative and
        LiDAR covariance), every verified loop closure, and the
        trust-gain-scaled INS priors (pipeline.cpp:676-736 completed with
        ``fusion.pose_graph``), on the app's device in float64. Rewrites the
        trajectory's poses in place (host float64) and returns (refined
        poses, closures).

        As in the reference, node k's prior sigma is the scaled sigma of
        the k-th keyframe record (records start at the second keyframe),
        falling back to the INS sigma and then, for the last node, to
        1e-2."""
        if self._detector is None:
            raise RuntimeError("construct the app with loop_closure=True")
        traj = self.trajectory
        poses = [e.pose for e in traj]
        if not self._closures:
            log.info("no loop closures found; trajectory unchanged")
            return poses, []
        prior_sigmas = []
        for rec in self.stats.records[: len(traj)]:
            sig = np.asarray(rec.scaled_sigma)
            if not (sig > 0).all():
                sig = np.maximum(np.asarray(rec.ins_sigma), 1e-6)
            prior_sigmas.append(np.maximum(sig, 1e-6))
        while len(prior_sigmas) < len(traj):
            prior_sigmas.append(np.full(6, 1e-2))
        _, result = refine_trajectory(
            poses, [r for r, _ in self._odo_rels], [c for _, c in self._odo_rels], self._closures,
            prior_poses=[e.ins_pose for e in traj], prior_sigmas=prior_sigmas, device=self.device,
        )
        rot = result.poses.rot.cpu().numpy().astype(np.float64)  # one read each
        trans = result.poses.trans.cpu().numpy().astype(np.float64)
        for e, R, t in zip(traj, rot, trans):
            e.pose = Pose3(R, t)
        return [e.pose for e in traj], self._closures
