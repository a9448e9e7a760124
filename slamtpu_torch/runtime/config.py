"""Host copy of ``slamtpu/runtime/config.py`` (numpy only, code unchanged).

The port cannot import it from ``slamtpu``: ``slamtpu/__init__.py``
imports JAX, so any ``import slamtpu.<module>`` pulls JAX in, and the
GPU port runs where JAX is absent. The docstring below is the
original's.

Typed configuration tree for the apps.

The reference parses four JSON files (lidar meta/config, imu config, register
config — SURVEY.md section 2.6) with paths hardcoded per main(). Here one
``PipelineConfig`` aggregates them with CLI-overridable fields, plus a
``berlin()`` preset mirroring the reference's shipped operating point
(reference config/*.json)."""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np

from ..ins.imu_config import ImuConfig
from ..lidar.ouster import LidarParams, SensorMeta, synthetic_os2_metadata


# The reference's flat snake_case key schema, exactly as parsed by
# RegisterCallback::ParseParamdata (reference src/registercallback.cpp:
# 24-91) and shipped in config/register_config.json. "num_threads" is parsed
# and ignored (OpenMP sizing has no TPU equivalent — vmap/XLA decide).
# "ndt_regularization_scale_factor" is the key the shipped JSON actually uses
# (the reference parser looks for "regularization_scale_factor" and therefore
# silently keeps its default; we accept both spellings).
_REFERENCE_KEYS = {
    "num_threads",
    "mapvoxelsize",
    "registration_method",
    "ndt_resolution",
    "ndt_transform_epsilon",
    "ndt_neighborhood_search_method",
    "regularization_scale_factor",
    "ndt_regularization_scale_factor",
    "gicp_corr_dist_threshold",
    "gicp_transform_epsilon",
    "svn_ndt_resolution",
    "svn_ndt_neighborhood_search_method",
    "svn_ndt_number_particle",
    "svn_ndt_max_iterations",
    "svn_ndt_kernel_bandwith",
    "svn_ndt_step_size",
    "svn_ndt_stop_threshold",
    "svn_ndt_set_outlier_ratio",
}
# slamtpu extensions (absent from the reference JSON): fixed device-buffer
# sizing and engine switches.
_EXTENSION_KEYS = {
    "ndt_max_iterations",
    "min_points_per_voxel",
    "map_capacity",
    "keyframe_window",
    "use_regmap",
    "reg_grid_shape",
    "map_rebuild_every",
    "map_exclude_recent",
    "odom_target_window",
    "odom_target_exclude",
    "fused_inner_iters",
    "gicp_source_cov",
    "svn_polish_iters",
    "svn_polish_objective",
    "svn_polish_from",
    "lidar_rot_sigma_floor",
    "lidar_trans_sigma_floor",
    "smoother_solver",
}


@dataclasses.dataclass(frozen=True)
class RegisterConfig:
    """cf. RegisterCallback::ParseParamdata
    (reference src/registercallback.cpp:24-91) and
    config/register_config.json. Dataclass defaults mirror the shipped Berlin
    JSON (not the C++ in-class defaults)."""

    # the C++ in-class default (registercallback.hpp:39); the shipped Berlin
    # JSON selects SVNNDT — load it via from_json to match that operating point
    method: str = "NDT_OMP"  # NDT_OMP (-> Newton NDT) | SVNNDT | GICP | NDT_OMP_MULTIRES
    ndt_resolution: float = 2.0
    ndt_transform_epsilon: float = 1e-4
    ndt_max_iterations: int = 30
    search_method: str = "DIRECT7"  # DIRECT7 | DIRECT1 (Newton NDT)
    svn_search_method: str = "DIRECT7"  # DIRECT7 | DIRECT1 (SVN-NDT)
    regularization_scale_factor: float = 10.0  # NDT prior-pose penalty weight
    gicp_corr_dist_threshold: float = 5.0
    gicp_transform_epsilon: float = 1e-4
    # "isotropic": sigma^2 I source covariance baked into the map (fast mode);
    # "anisotropic": plane-to-plane with per-point source covariances from
    # the source scan's own voxel stats (gicp_omp fidelity mode)
    gicp_source_cov: str = "isotropic"
    svn_resolution: float = 1.0
    svn_particles: int = 20
    svn_max_iterations: int = 100
    svn_kernel_h: float = 5.0
    svn_step_size: float = 0.05
    svn_stop_thresh: float = 1e-4
    svn_outlier_ratio: float = 0.55
    # extension: Newton MAP-polish steps on the SVN particle mean before it
    # is published (ndt.svn.SvnConfig.polish_iters). The Stein repulsion
    # spreads particles over the posterior, so the raw mean carries
    # ~sigma/sqrt(K) (cm-class) error; two polish steps publish the mode at
    # the cost of one extra gather. 0 = the reference's publish semantics.
    svn_polish_iters: int = 4
    # extension: objective for the polish steps. "gicp_aniso" descends the
    # plane-to-plane GICP cost (source-scan per-point covariances against
    # plane-regularized target covariances) — NDT's view-dependent surface
    # bias dominates its residual at exact inits (measured 13.8 -> 5.1 mm on
    # the sim world), so the posterior comes from the NDT particle flow and
    # the published mode from the GICP geometry. "ndt" polishes on the NDT
    # score itself.
    svn_polish_objective: str = "gicp_aniso"
    # extension: polish start — "prior" (the INS-seeded pose; strictly better
    # whenever the prior is sane, and what the reference effectively
    # publishes) or "mean" (the Stein particle mean; for degraded-prior
    # operation). See ndt.svn.SvnConfig.polish_from.
    svn_polish_from: str = "prior"
    # extension: source-covariance construction for the plane-to-plane
    # polish (lo_svn) AND the GICP-aniso engine (odom_ndt).
    # "stencil" computes each point's plane-regularized
    # covariance from its RANGE-IMAGE neighborhood (pure shifts + FMA;
    # ndt.gicp.stencil_point_covariances); "voxel" is the sort-based
    # voxelized analog of gicp_omp's kNN covariances. Apps fall back to "voxel" when the scan has no grid layout.
    svn_src_cov: str = "stencil"
    # extension: variance floor added to the registration covariance
    # -(H + eps I)^-1 before it enters a factor graph (odom_ndt / ligo_tc).
    # The GN Hessian's information scales with the number of contributing
    # point-voxel pairs (~1e5), pricing the between factor at sub-0.1 mm
    # sigma, while the estimator's real per-pair error is mm-class (voxel
    # discretization bias + sensor noise — bench: 2-4 mm). Without a floor
    # the window smoother rationally ignores the honest cm-class INS priors
    # and the trajectory random-walks at the registration bias rate. The
    # floor is that bias budget, added as independent variance. 0 = the
    # reference's raw -(H)^-1 pricing (run/pipeline.cpp:594-603).
    lidar_rot_sigma_floor: float = 3e-4  # rad
    lidar_trans_sigma_floor: float = 3e-3  # m
    map_voxel_size: float = 0.5
    min_points_per_voxel: int = 6
    map_capacity: int = 1 << 17
    keyframe_window: int = 5  # target window of keyframes (lo_svn :328)
    use_regmap: bool = True  # search-free registration layout (ndt.regmap)
    reg_grid_shape: tuple = (256, 256, 64)  # dense-grid extent in voxels
    # rebuild the registration map every N keyframes (1 = the reference's
    # per-keyframe setInputTarget; higher trades <=N-1 keyframes of target
    # staleness for amortizing the Berlin-scale map+RegMap build)
    map_rebuild_every: int = 1
    # extension (lo_svn): map rebuilds skip the newest N keyframe clouds in
    # the ring. Registering against content rendered from viewpoints close
    # to the current one carries a measured viewpoint-proximity bias
    # (~10 mm published-pose error at 0.3 m separation, decaying below 1 mm
    # past ~1.5 m at Berlin scale — BENCH_NOTES round-4 error budget); the
    # nearest clouds add no coverage the current scan lacks, so excluding
    # them removes the bias at zero cost. 0 = reference full-window
    # semantics.
    map_exclude_recent: int = 0
    # extension (odom_ndt): register against the last N keyframe clouds at
    # their OPTIMIZED window poses instead of only the previous one
    # (run/pipeline.cpp:552-557 semantics at 1). A single-scan NDT target
    # carries the scan's concentric ground-ring sampling pattern into the
    # voxel Gaussians; density-biased means alias against the next scan's
    # shifted rings (the same viewpoint-proximity bias lo_svn removes with
    # map_exclude_recent, which scan-to-previous odometry cannot use — the
    # target IS the nearest viewpoint). Blending >=2 viewpoints decorrelates
    # the ring pattern. Must be <= the smoother window.
    odom_target_window: int = 1
    # extension (odom_ndt, with odom_target_window > 1): drop the newest N
    # clouds from the registration target. The ring-pattern lock that stalls
    # scan-to-previous NDT is a nearest-viewpoint effect (phase correlation
    # decays below mm past ~1.5 m of viewpoint separation, BENCH_NOTES "ATE
    # error budget"); excluding the adjacent cloud(s) registers against
    # viewpoints whose ring phases have diverged while the smoother chain is
    # unchanged. Capped at odom_target_window - 1.
    odom_target_exclude: int = 0
    # Newton steps per mega-row gather in the fused kernel (a staleness
    # budget also re-gathers after an eighth-voxel of motion). 1 = exact
    # DIRECT7 per step; 2 halves the gather cost at negligible accuracy
    # loss; larger values trade convergence rate on hard scenes
    fused_inner_iters: int = 2
    # window-smoother linear solver (fusion.smoother.SmootherConfig.solver):
    # "chol" = Jacobi-equilibrated normal-equation Cholesky (fast; TPU
    # small-matrix QR is sequential-per-column), "qr" = augmented-Jacobian
    # QR (most conservative f32 conditioning)
    smoother_solver: str = "chol"

    @classmethod
    def from_json(cls, obj: dict) -> "RegisterConfig":
        """Parse the reference's flat snake_case register_parameter schema.

        Unrecognized keys raise (a typo'd knob silently falling back to its
        default is worse than a hard failure)."""
        p = obj.get("register_parameter", obj)
        unknown = set(p) - _REFERENCE_KEYS - _EXTENSION_KEYS
        if unknown:
            raise ValueError(
                f"unrecognized register_parameter keys: {sorted(unknown)} "
                f"(known: {sorted(_REFERENCE_KEYS | _EXTENSION_KEYS)})"
            )
        defaults = cls()
        reg_scale = p.get(
            "regularization_scale_factor",
            p.get(
                "ndt_regularization_scale_factor",
                defaults.regularization_scale_factor,
            ),
        )
        return cls(
            method=str(p.get("registration_method", defaults.method)),
            ndt_resolution=float(p.get("ndt_resolution", defaults.ndt_resolution)),
            ndt_transform_epsilon=float(
                p.get("ndt_transform_epsilon", defaults.ndt_transform_epsilon)
            ),
            ndt_max_iterations=int(
                p.get("ndt_max_iterations", defaults.ndt_max_iterations)
            ),
            search_method=str(
                p.get("ndt_neighborhood_search_method", defaults.search_method)
            ),
            svn_search_method=str(
                p.get("svn_ndt_neighborhood_search_method", defaults.svn_search_method)
            ),
            regularization_scale_factor=float(reg_scale),
            gicp_corr_dist_threshold=float(
                p.get("gicp_corr_dist_threshold", defaults.gicp_corr_dist_threshold)
            ),
            gicp_transform_epsilon=float(
                p.get("gicp_transform_epsilon", defaults.gicp_transform_epsilon)
            ),
            gicp_source_cov=str(
                p.get("gicp_source_cov", defaults.gicp_source_cov)
            ),
            svn_resolution=float(p.get("svn_ndt_resolution", defaults.svn_resolution)),
            svn_particles=int(p.get("svn_ndt_number_particle", defaults.svn_particles)),
            svn_max_iterations=int(
                p.get("svn_ndt_max_iterations", defaults.svn_max_iterations)
            ),
            svn_kernel_h=float(p.get("svn_ndt_kernel_bandwith", defaults.svn_kernel_h)),
            svn_step_size=float(p.get("svn_ndt_step_size", defaults.svn_step_size)),
            svn_stop_thresh=float(
                p.get("svn_ndt_stop_threshold", defaults.svn_stop_thresh)
            ),
            svn_outlier_ratio=float(
                p.get("svn_ndt_set_outlier_ratio", defaults.svn_outlier_ratio)
            ),
            svn_polish_iters=int(
                p.get("svn_polish_iters", defaults.svn_polish_iters)
            ),
            svn_polish_objective=str(
                p.get("svn_polish_objective", defaults.svn_polish_objective)
            ),
            svn_polish_from=str(
                p.get("svn_polish_from", defaults.svn_polish_from)
            ),
            svn_src_cov=str(p.get("svn_src_cov", defaults.svn_src_cov)),
            lidar_rot_sigma_floor=float(
                p.get("lidar_rot_sigma_floor", defaults.lidar_rot_sigma_floor)
            ),
            lidar_trans_sigma_floor=float(
                p.get("lidar_trans_sigma_floor", defaults.lidar_trans_sigma_floor)
            ),
            map_voxel_size=float(p.get("mapvoxelsize", defaults.map_voxel_size)),
            min_points_per_voxel=int(
                p.get("min_points_per_voxel", defaults.min_points_per_voxel)
            ),
            map_capacity=int(p.get("map_capacity", defaults.map_capacity)),
            keyframe_window=int(p.get("keyframe_window", defaults.keyframe_window)),
            use_regmap=bool(p.get("use_regmap", defaults.use_regmap)),
            reg_grid_shape=tuple(p.get("reg_grid_shape", defaults.reg_grid_shape)),
            map_rebuild_every=int(
                p.get("map_rebuild_every", defaults.map_rebuild_every)
            ),
            map_exclude_recent=int(
                p.get("map_exclude_recent", defaults.map_exclude_recent)
            ),
            odom_target_window=int(
                p.get("odom_target_window", defaults.odom_target_window)
            ),
            odom_target_exclude=int(
                p.get("odom_target_exclude", defaults.odom_target_exclude)
            ),
            fused_inner_iters=int(
                p.get("fused_inner_iters", defaults.fused_inner_iters)
            ),
            smoother_solver=str(
                p.get("smoother_solver", defaults.smoother_solver)
            ),
        )


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    meta: SensorMeta
    lidar: LidarParams
    imu: ImuConfig
    register: RegisterConfig
    scan_points_capacity: int = 1 << 17  # padded device buffer per scan
    nav_window: int = 256
    deskew: bool = False  # INS-based motion compensation (lidar.deskew);
    #   off by default for parity (the reference computes alpha but never
    #   applies it, dataframe.hpp:406-433)

    @classmethod
    def berlin(cls, meta: Optional[SensorMeta] = None) -> "PipelineConfig":
        """The reference's Berlin operating point (config/*_berlin.json):
        OS-2-128 2048x10, stride 4 -> 32 beams, z in [-250, 0] OR refl >= 60,
        range [0, 250] m, 10.5 x 3 x 2.1 m vehicle box; SVN-NDT res 1.0,
        K=20, h=5.0, step 0.05; ndt res 2.0; map voxel 0.5."""
        return cls(
            meta=meta or synthetic_os2_metadata(),
            lidar=LidarParams(
                body_to_lidar_rotation=np.diag([-1.0, -1.0, 1.0]),  # Cb2s
                body_to_lidar_translation=np.asarray([0.135, 0.0, 0.1243]),  # tb2s
                channel_stride=4,
                z_filter=(-250.0, 0.0),
                reflectivity_threshold=60.0,
                range_filter=(0.0, 250.0),
                vehicle_box_center=np.asarray([-3.0, 0.0, 1.0], np.float32),
                vehicle_box_dimensions=np.asarray([10.5, 3.0, 2.1], np.float32),
            ),
            imu=ImuConfig(update_rate_hz=50.0),
            register=RegisterConfig(),
        )

    @classmethod
    def from_files(
        cls,
        meta_path: str,
        lidar_path: str,
        imu_path: str,
        register_path: str,
    ) -> "PipelineConfig":
        with open(register_path) as f:
            reg = RegisterConfig.from_json(json.load(f))
        return cls(
            meta=SensorMeta.from_file(meta_path),
            lidar=LidarParams.from_file(lidar_path),
            imu=ImuConfig.from_file(imu_path),
            register=reg,
        )
