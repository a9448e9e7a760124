#!/usr/bin/env python3
"""Smoke run of the PyTorch port (slamtpu_torch) on one CUDA card.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit, torch's device name).
2. Builds the CUDA pair kernels from slamtpu_torch/csrc (nvcc, into
   build/slamtpu_torch/) and prints the build time and the ptxas report.
3. Kernel phase: a Gaussian map from one simulated Berlin-shape sweep
   (2048 x 128 beams, stride 4: N = 65,536 points) at its true pose, the
   next sweep's rows looked up in it; each kernel against its plain
   PyTorch version on the card: the NDT pair kernel for K = 20 particle
   poses and for K = 1 (both also on a map at the odom capacity, 2^15:
   the SVNNDT and NDT_OMP engines' shapes), the VGICP pair kernel against
   the map's ``gicp_map`` rows (K = 1) and the plane-to-plane kernel with
   the points' stencil source covariances (K = 1) against the map's aux
   table (the lo_svn polish) and against the table of a ``gicp_map_aniso``
   map at the odom capacity (the anisotropic GICP engine), each gathering
   its rows in the kernel from (table, rows). It checks that the in-kernel
   gather equals the same kernel on pre-gathered rows bit for bit, and
   prints max errors, device
   times per call (CUDA events around 20 back-to-back calls queued behind
   a device-side spin, see ``time_ms``; median of 10 such rounds, kernel
   and plain version in turns), each call's bound (bytes and operations at
   the card's published peaks), its share of the bound, the unique rows
   touched, the time of ``gather_megaT`` on each table (the torch gather
   that the in-kernel one replaces), of the row lookup with the
   plane-to-plane kernel (one polish evaluation), and of the map build's
   largest fixed-order segment sum on a 5-sweep ring against
   ``index_add_``'s atomic one on the same sorted values, and checks that
   20 repeats of that sum are equal bit for bit (beside the count of
   equal repeats of a 1-D float64 ``cumsum`` of the same values).
4. lo_svn phase: ``LoSvnApp(cfg, "cuda").run_replay`` over a 12-sweep skewed
   replay at the Berlin operating point; checks that the NDT and
   plane-to-plane kernels launched, that every pose is finite and that the
   ATE against ground truth is below 5 mm.
5. odom phases: ``OdomNdtApp(cfg, "cuda", window=6).run_replay`` over the
   same replay with each engine: NDT_OMP (Newton over the NDT pair
   kernel), isotropic GICP (Newton over the VGICP pair kernel),
   anisotropic GICP (Newton over the plane-to-plane pair kernel with the
   stencil source covariances), SVNNDT (the SVN particle flow over the NDT
   pair kernel at K = 20, polished on the NDT score) and NDT_OMP_MULTIRES
   (Newton over the NDT pair kernel on a two-level map pyramid); checks
   that the engine's kernel launched, that every pose and covariance is
   finite and that the ATE is below the engine's bound.
6. ligo phases: ``LigoTcApp(cfg, "cuda", window=6).run_replay`` over the
   same replay (IMU preintegration, Newton over the NDT pair kernel from
   the IMU prediction with the prior-pose pull, the 15-dof window
   smoother) at the operating point (RegMap rebuilt every 4 keyframes,
   Cholesky smoother) and at parity semantics (rebuilt every keyframe, QR
   smoother); checks that the NDT pair kernel launched, that every pose
   and covariance is finite and that the ATE is below 10 mm.
7. resume phase: lo_svn, odom NDT_OMP and ligo at parity semantics each
   run the first keyframes, ``save_checkpoint`` to a temporary file,
   ``resume_from`` it in a new app on the card and run the rest; the
   combined trajectory must equal the phase's continuous run above within
   1e-4 m and 1e-4 rad.
8. KDTREE search mode: the kernel phase also holds the gated NDT pair
   kernel (K = 20 and K = 1) and the gated VGICP pair kernel (K = 1)
   against their plain versions on ``build_regmap_kdtree`` maps of the same
   sweep, gate at the points' true pose with radius = resolution, and
   prints the slots the gate cut and the gate decisions near the radius
   (where kernel and plain may round apart); replay phases run lo_svn with
   ``svn_search_method="KDTREE"`` and odom NDT_OMP and isotropic GICP with
   ``search_method="KDTREE"`` (ATE < 10 mm, GICP < 50 mm).
9. ins_map phase: ``InsMapApp(cfg, "cuda")`` at the Berlin config's
   ``map_voxel_size`` (0.5) and ``map_capacity`` (2^17) over the replay;
   prints keyframes/s, per-stage device ms, valid voxels, overflow and
   out-of-range points; checks that a split run (``save_checkpoint`` ->
   ``resume_from`` in a new app) equals the continuous one bit for bit,
   that the merged statistics of a prefix of sweeps equal one
   ``stats_from_points`` over the same INS-posed sweeps (keys and counts
   exact, sums rtol 1e-5), and that ``finalize_and_export`` writes its
   files.
10. pose-graph phase: bench.py:43-96's graph in numpy (seed 7, 10,000
   poses on a 500 m circle, 150 mid-range and 50 circle-closing closures,
   sqrt-information 100 I, float32) solved by ``fusion.pose_graph.optimize``
   on the card (8 Gauss-Newton x 60 CG), once to warm up and then 3 chained
   solves, as bench.py times them; prints the end drift before and after,
   device ms per solve (CUDA events), host syncs during a solve and peak
   memory; checks drift before ~6.27 m, after <= 0.10 m, and that two
   solves of the same graph are equal bit for bit.
11. loop-closure phase: ``OdomNdtApp(..., loop_closure=True)`` (NDT_OMP at
   the odom operating point) over a 46-sweep Berlin-shape replay around a
   1.9 m-radius circle (3 m/s, 4 s a turn; tests/test_e2e.py's loop
   settings), then ``refine_loop_closures``; checks a verified closure with
   j - i >= 30, finite poses and ATE after <= max(2 x before, 0.05 m);
   prints the closures, the verifications and their ms, and the NDT pair
   kernel's launches inside them. The kernel phase holds that kernel on
   the verification map (2^14 voxels, grid (128, 128, 32), resolution 2).
12. command-line phase: ``python -m slamtpu_torch odom_ndt --loop-closure``
   (``__main__.main``, Berlin preset, ``--device`` default cuda) over the
   12-sweep replay; checks its files and that its poses are finite.
13. live phase: a sender process plays the circle replay of 11. over
   loopback at its recorded timestamps (10 sweeps/s: ~1280 LiDAR and 250
   ANPP datagrams/s) into ``LivePipeline(cfg, app, io_backend="native")``,
   once with odom NDT_OMP and once with lo_svn; prints datagrams sent,
   received and dropped, frames synced, processed and dropped, errors,
   keyframes/s, the latency from a sweep's last datagram to the return of
   ``process`` (p50, p95, max), the drain time after the last datagram,
   the ATE of the processed keyframes, host syncs a keyframe and the
   kernels' launches; then 12 sweeps into the asyncio backend (its
   drops), and the reactor's per-datagram decode time on this host.
   Checks that the app raised nothing, that frames were processed through
   the expected kernels with finite poses, and, when nothing was dropped,
   odom NDT_OMP's ATE within 2x of 11.'s before its refinement.
14. per-particle SVN: ``svn_align_reg`` on the kernel phase's sweep with
   the shared gather and with ``shared_gather=False`` (K = 20): B1
   launches an iteration (1 against 20), ms a call, the pose difference.
15. dist phase: ``slamtpu_torch.dist`` over NCCL at world size 1 (one
   card), at the Berlin width: ``build_map_sharded``,
   ``newton_align_sharded_reg`` and ``_fused``, ``lo_train_step``,
   ``svn_align_sharded`` (K = 20) and ``batch_align_sharded`` (B = 8
   offsets of one sweep), each against its one-device counterpart (bit
   for bit), with ms a call, collectives and B1 launches.
16. sorted-key path (``use_regmap=False``): the kernel phase holds the
   sorted-key objective (``ndt.objective.score_grad_hess``, plain PyTorch,
   as the JAX package runs it outside any Pallas kernel) against the NDT
   pair kernel at K = 1 on the rows of a RegMap of the same map and pose
   (over a grid that holds the whole map), at the kernel checks'
   tolerances, and prints its device ms an evaluation at K = 1 and K = 20
   and the K = 20 pass's peak memory; replay phases run lo_svn
   (``svn_align`` every keyframe on a map built every keyframe; its ATE
   beside the RegMap run's), odom NDT_OMP (``newton_align``) in DIRECT7
   and DIRECT1 and odom isotropic GICP (``gicp_align``: the VGICP pair
   kernel at one step a lookup on the fixed (256, 256, 64) grid); the NDT
   phases must launch no pair kernel. The dist phase holds
   ``newton_align_sharded`` (the sorted-key objective summed over one NCCL
   rank) to ``newton_align`` bit for bit.
Each replay phase prints the ATE, steady-state keyframes/s, iteration
counts, host syncs per keyframe, per-stage device times and peak memory.
The kernel phase also holds the NDT pair kernel at K = 1 against a
5-cloud map at the ligo operating point's capacity (2^16) and grid.
Importing slamtpu_torch, slamtpu_torch.fusion, slamtpu_torch.__main__,
slamtpu_torch.runtime.live and slamtpu_torch.dist must leave CUDA
uninitialized.

It imports neither JAX nor the JAX package. It exits non-zero, printing no
result line, when CUDA is unavailable or any check fails. The last line of
standard output is ``{"ok": true, "device": {...}}``.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_SWEEPS = 12
GRID = (256, 256, 32)
ODOM_GRID = (160, 160, 32)
LIGO_GRID = (192, 192, 32)
LIGO_CLOUDS = 5  # keyframe_window of the ligo operating point
# ATE bounds of the odom phase. The reference's ATE on this replay is not
# measured (running the JAX app at this width is for an accelerator). NDT_OMP:
# 5 mm (the reference read 0.0022 m over 30 sweeps of this replay family).
# Isotropic GICP: 50 mm. The engine is coarse on this replay family in the
# reference itself: at 1024 x 64 beams, stride 2, 8 sweeps, the reference
# read 0.104 m on the CPU and the port 0.099 m; at this width the port
# read 0.034 m on the card.
# The bounds of the engines added later were set before their first card
# run: anisotropic GICP 5 mm (the TPU-era record read it as the reference's
# most accurate odom engine), SVNNDT and NDT_OMP_MULTIRES 10 mm.
ODOM_PHASES = {  # label: (method, register changes, kernel, ATE bound)
    "NDT_OMP": ("NDT_OMP", {}, "ndt_pair", 0.005),
    "GICP": ("GICP", {}, "gicp_pair", 0.050),
    "GICP aniso": ("GICP", dict(gicp_source_cov="anisotropic"), "aniso_pair", 0.005),
    # lo_svn's Berlin point: 20 particles, 8 iterations, h 5, step 1.0, and
    # the app's 4 polish steps on the NDT score
    "SVNNDT": ("SVNNDT", dict(svn_resolution=1.0, svn_particles=20, svn_max_iterations=8,
                              svn_kernel_h=5.0, svn_step_size=1.0, svn_polish_iters=4),
               "ndt_pair", 0.010),
    "NDT_OMP_MULTIRES": ("NDT_OMP_MULTIRES", {}, "ndt_pair", 0.010),
    # the KDTREE search mode (set before its first card run): NDT_OMP 10 mm,
    # isotropic GICP as its DIRECT7 engine
    "NDT_OMP KDTREE": ("NDT_OMP", dict(search_method="KDTREE"), "ndt_pair_gated", 0.010),
    "GICP KDTREE": ("GICP", dict(search_method="KDTREE"), "gicp_pair_gated", 0.050),
    # the sorted-key path (use_regmap=False), bounds set before its first
    # card run: NDT_OMP (newton_align, no pair kernel) in DIRECT7 10 mm, twice
    # its RegMap phase's, since neither package has measured this path at
    # this width; in DIRECT1 20 mm, as one voxel's basin is coarser (on the
    # CPU tests' lo_svn replay DIRECT1 reads 10.9 mm in both packages where
    # DIRECT7 stays within 10 mm); isotropic GICP (gicp_align: B2 at one
    # step a lookup on the fixed (256, 256, 64) grid) 50 mm, as its RegMap phase
    "NDT_OMP sorted-key": ("NDT_OMP", dict(use_regmap=False), None, 0.010),
    "NDT_OMP sorted-key DIRECT1": ("NDT_OMP", dict(use_regmap=False, search_method="DIRECT1"), None, 0.020),
    "GICP sorted-key": ("GICP", dict(use_regmap=False), "gicp_pair", 0.050),
}
# ATE bound of the ligo phases. The reference's ATE on this 12-sweep replay
# is not measured (its 30-sweep figures are of another accelerator). On an
# NVIDIA H100 80GB HBM3 at 700 W the port read 0.0030 m at the operating
# point and 0.0013 m at parity semantics.
LIGO_ATE_BOUND = 0.010
# The resume phase: keyframes run before the checkpoint, per continuous
# phase. The file carries no RegMap, so a resumed app rebuilds it on its
# first keyframe: lo_svn (rebuild every 4) splits where the continuous run
# rebuilds too (keyframe 6); odom builds every keyframe and ligo runs at
# parity semantics (rebuild every keyframe).
RESUME_AFTER = {"lo_svn": 5, "odom NDT_OMP": 6, "ligo parity": 6}
RESUME_TOL_M, RESUME_TOL_RAD = 1e-4, 1e-4
# lo_svn in the KDTREE search mode (set before its first card run)
LO_SVN_KDTREE_ATE_BOUND = 0.010
# lo_svn on the sorted-key path (svn_align every keyframe, the polish on the
# NDT score instead of the plane-to-plane cost), set before its first card
# run: 10 mm, as the other NDT-polished lo_svn phase (KDTREE)
LO_SVN_SORTED_KEY_ATE_BOUND = 0.010
# the grid of the RegMap on which the kernel phase holds the NDT pair kernel
# to the sorted-key objective: it must hold the whole lo_svn map (ranges to
# 150 m at 1 m voxels), so that both see the same neighbors
SORTED_KEY_CHECK_GRID = (384, 384, 64)
# ins_map: keyframes merged before the checkpoint, and the prefix of sweeps
# whose merged statistics are held to one stats_from_points
INS_MAP_SPLIT, INS_MAP_PREFIX = 6, 3
# the pose-graph phase (bench.py's posegraph mode): drift before as the JAX
# package's construction reads it (6.268-6.269 m), the bound after set from
# the JAX package's float32 CPU solve (0.064 m)
PG_POSES, PG_DRIFT_BEFORE, PG_DRIFT_BEFORE_TOL, PG_DRIFT_AFTER_BOUND = 10_000, 6.27, 0.05, 0.10
# the loop-closure phase: tests/test_e2e.py:546-577's circle and settings
LOOP_SWEEPS, LOOP_SPEED, LOOP_PERIOD_S = 46, 3.0, 4.0
LOOP_CFG = dict(search_radius=2.0, min_keyframe_gap=30, max_candidates_per_keyframe=1,
                resolution=2.0, min_contrib_ratio=0.05)
LOOP_GRID, LOOP_CAPACITY = (128, 128, 32), 1 << 14  # the verification map's
# the live phase: the circle replay at 10 sweeps/s; the asyncio backend's
# short run sends this many sweeps. The dist phase's batch: B offsets of one sweep
LIVE_ASYNCIO_SWEEPS, LIVE_BATCH = 12, 8
# the dist phase's registrations start 0.33 m off the true pose (set before
# the first card run)
DIST_POSE_BOUND = 0.05
TIMED_ROUNDS, TIMED_LAUNCHES = 10, 20
SPIN_CYCLES_PER_S = 2.0e9  # at least the H100's top SM clock (1.98 GHz)
# kernel vs plain on the same inputs. The pair count may differ by a few in
# ~2e5: a pair whose exponent (NDT) or Mahalanobis distance (plane-to-plane)
# sits on its cut flips with the rounding of that distance (fused
# multiply-adds in the kernel, cuBLAS in the plain version); such a pair
# adds ~exp(-50) to the NDT sums. Score, gradient and Hessian are float32
# sums of ~4.6e5 pair terms taken in different orders (per-thread + block
# tree + double across blocks, vs torch's reductions). Score rtol 1e-5
# (not the 2e-6 of the 4096-point CPU test: 16x longer sums). Gradient and
# Hessian entries: rtol 1e-4 plus a floor of 1e-4 (gradient) / 1e-5
# (Hessian) of the largest entry of that pose's vector or matrix, because at
# ranges to 150 m the entries span many orders of magnitude and cancelling
# entries carry the rounding of the large ones.
COUNT_RTOL = 2e-5
SCORE_RTOL = 1e-5
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-4
HESS_RTOL, HESS_FLOOR = 1e-4, 1e-5


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def berlin_cfg(tconfig, ouster, imu):
    meta = ouster.synthetic_os2_metadata(columns_per_frame=2048, pixels_per_column=128,
                                         columns_per_packet=16)
    return tconfig.PipelineConfig(
        meta=meta,
        lidar=ouster.LidarParams(channel_stride=4, range_filter=(0.5, 150.0)),
        imu=imu.ImuConfig(),
        register=tconfig.RegisterConfig(
            svn_resolution=1.0, svn_particles=20, svn_max_iterations=8, svn_kernel_h=5.0,
            svn_step_size=1.0, map_capacity=1 << 17, min_points_per_voxel=4, keyframe_window=5,
            reg_grid_shape=GRID, map_rebuild_every=4, map_exclude_recent=3,
        ),
        deskew=True,
    )


def odom_cfg(tconfig, cfg, method, **change):
    """The odom_ndt operating point of bench.py's odom_berlin mode on the
    same sensor (resolution 1.0, 20 iterations, capacity 2^15, at least 4
    points per voxel, grid (160, 160, 32), deskew on, 2 Newton steps per
    gather); ``change`` gives the engine's own settings."""
    import dataclasses

    reg = dict(method=method, ndt_resolution=1.0, ndt_max_iterations=20, map_capacity=1 << 15,
               min_points_per_voxel=4, reg_grid_shape=ODOM_GRID)
    return dataclasses.replace(cfg, register=tconfig.RegisterConfig(**{**reg, **change}))


def ligo_cfg(tconfig, cfg, **change):
    """The ligo_tc operating point of bench.py's ligo_berlin mode on the same
    sensor (resolution 1.0, 20 iterations, capacity 2^16, at least 4 points
    per voxel, grid (192, 192, 32), rebuild every 4, a 5-cloud keyframe
    window, deskew on, Cholesky smoother); ``change`` gives the parity
    variant (rebuild every keyframe, QR smoother)."""
    import dataclasses

    reg = dict(ndt_resolution=1.0, ndt_max_iterations=20, map_capacity=1 << 16, min_points_per_voxel=4,
               reg_grid_shape=LIGO_GRID, map_rebuild_every=4, keyframe_window=LIGO_CLOUDS)
    return dataclasses.replace(cfg, register=tconfig.RegisterConfig(**{**reg, **change}))


def time_ms(fn, torch):
    """Device ms per call, from CUDA events around TIMED_LAUNCHES calls that
    wait in the stream behind a device-side spin (``torch.cuda._sleep``)
    lasting twice the host's time to enqueue them: the events then time the
    device's work back to back, not the host's launch rate."""
    t0 = time.perf_counter()
    for _ in range(TIMED_LAUNCHES):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2.0 * host_s * SPIN_CYCLES_PER_S))
    start.record()
    for _ in range(TIMED_LAUNCHES):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / TIMED_LAUNCHES


def compare(out, ref):
    """Kernel output (K, 44) against the plain version's: prints each check's
    worst error as a fraction of its tolerance, raises if one exceeds 1, and
    returns the max absolute error over all 44 outputs."""
    out, ref = out.double().cpu(), ref.double().cpu()
    err = (out - ref).abs()
    worst = {
        "count": float((err[:, 43] / (COUNT_RTOL * ref[:, 43].abs()).clamp(min=1.0)).max()),
        "score": float((err[:, 0] / (SCORE_RTOL * ref[:, 0].abs()).clamp(min=1e-300)).max()),
    }
    for sl, rtol, floor, name in ((slice(1, 7), GRAD_RTOL, GRAD_FLOOR, "grad"),
                                  (slice(7, 43), HESS_RTOL, HESS_FLOOR, "hess")):
        r = ref[:, sl]
        tol = rtol * r.abs() + floor * r.abs().amax(dim=1, keepdim=True)
        worst[name] = float((err[:, sl] / tol.clamp(min=1e-300)).max())
    log("  worst error / tolerance: " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
        + f"; count differences {[int(d) for d in (out[:, 43] - ref[:, 43]).tolist() if d]}")
    assert all(v <= 1.0 for v in worst.values()), worst
    return float(err.max())


def kernel_inputs(torch, replay_path, gt, cfg, dev):
    """Map from one sweep at its true pose; the next sweep's points, their
    rows in the lo_svn RegMap (and its ``gicp_map`` twin) and in an odom-size
    RegMap (and its ``gicp_map_aniso`` twin), the same rows pre-gathered (``gather_megaT``, for the in-kernel
    gather's check), source covariances and the K = 20 particle poses
    around the true pose. Also a ligo-size RegMap from 5 sweeps at their
    true poses, with the sixth sweep's points and rows in it."""
    import numpy as np

    from slamtpu_torch.apps.common import IngestPipeline, maybe_deskew
    from slamtpu_torch.core import se3
    from slamtpu_torch.core.se3 import Pose3
    from slamtpu_torch.mapping.gaussian_map import build_map, origin_for
    from slamtpu_torch.ndt import fused_math
    from slamtpu_torch.ndt.constants import gauss_constants
    from slamtpu_torch.ndt.newton import NewtonConfig
    from slamtpu_torch.ndt.gicp import (gicp_map, gicp_map_aniso, regularize_plane_covariance,
                                        stencil_point_covariances)
    from slamtpu_torch.ndt.regmap import build_regmap, build_regmap_kdtree, grid_rows
    from slamtpu_torch.ndt.svn import INIT_SIGMAS

    ing = IngestPipeline(cfg, dev)
    frames = [f for f, _ in zip(ing.synced_frames(replay_path), range(LIGO_CLOUDS + 1))]
    ref_lla = np.asarray(frames[0].ins[-1].lla)

    def world_scan(synced, k):
        scan = maybe_deskew(ing.project(synced), synced, ref_lla, True)
        R, p = gt[k]
        pose = Pose3(torch.as_tensor(R, dtype=torch.float32, device=dev),
                     torch.as_tensor(p, dtype=torch.float32, device=dev))
        return scan, pose

    # synced frame k ends at sweep k + 1
    clouds = [world_scan(f, k + 1) for k, f in enumerate(frames)]
    (scan_a, pose_a), (scan_b, pose_b) = clouds[:2]
    res = cfg.register.svn_resolution
    origin = torch.floor(pose_a.trans / res) * res - 512.0 * res
    world_a = se3.transform_points(pose_a, scan_a.points)
    gmap = build_map(world_a, scan_a.mask, origin, res, capacity=cfg.register.map_capacity,
                     min_points_per_voxel=4)
    aux = torch.cat([gmap.mean, regularize_plane_covariance(gmap.cov).reshape(-1, 9)], dim=1)
    regmap = build_regmap(gmap, grid_shape=GRID, aux_payload=aux)
    regmap_g = build_regmap(gicp_map(gmap, 0.05), grid_shape=GRID)
    # the KDTREE search mode's maps of the same sweep (6V rows), for the
    # gated NDT and VGICP kernels
    regmap_k = build_regmap_kdtree(gmap, grid_shape=GRID)
    regmap_kg = build_regmap_kdtree(gicp_map(gmap, 0.05), grid_shape=GRID)
    # the odom_ndt operating point's map: capacity 2^15 on its grid, and its
    # plane-to-plane twin (the anisotropic GICP engine's target)
    gmap_o = build_map(world_a, scan_a.mask, origin, res, capacity=1 << 15, min_points_per_voxel=4)
    regmap_o = build_regmap(gmap_o, grid_shape=ODOM_GRID)
    regmap_oa = build_regmap(gicp_map_aniso(gmap_o), grid_shape=ODOM_GRID)
    # the ligo operating point's map: 5 clouds, capacity 2^16, on its grid
    ring = (torch.cat([se3.transform_points(p, s.points) for s, p in clouds[:LIGO_CLOUDS]]),
            torch.cat([s.mask for s, _ in clouds[:LIGO_CLOUDS]]), origin, res, 1 << 16)
    regmap_l = build_regmap(build_map(*ring[:4], capacity=ring[4], min_points_per_voxel=4),
                            grid_shape=LIGO_GRID)
    scan_l, pose_l = clouds[LIGO_CLOUDS]
    pts, mask = scan_b.points, scan_b.mask
    # the loop verification's map (fusion.loop_closure.verify_pair): the
    # sweep at resolution 2 on an origin below its points, 2^14 voxels
    lres = LOOP_CFG["resolution"]
    gmap_v = build_map(world_a, scan_a.mask, origin_for(world_a, scan_a.mask, lres), lres,
                       capacity=LOOP_CAPACITY, min_points_per_voxel=4)
    regmap_v = build_regmap(gmap_v, grid_shape=LOOP_GRID)
    d1_v, d2_v, _ = gauss_constants(lres, NewtonConfig().outlier_ratio)
    N = pts.shape[0]
    K = cfg.register.svn_particles
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    sig = torch.tensor(INIT_SIGMAS, device=dev)
    xi = sig * torch.randn((K, 6), generator=g, device=dev)
    particles = se3.retract(Pose3(pose_b.rot.expand(K, 3, 3), pose_b.trans.expand(K, 3)), xi)
    one = Pose3(pose_b.rot[None], pose_b.trans[None])
    d1, d2, _ = gauss_constants(res, cfg.register.svn_outlier_ratio)
    inp = dict(
        N=N, K=K, pts=pts, mask=mask, pose=pose_b, ptsT=pts.t().contiguous(), regmap=regmap,
        gmap=gmap, d1=d1, d2=d2, particles=particles,
        world_a=world_a, mask_a=scan_a.mask, origin=origin,
        regmap_g=regmap_g, regmap_o=regmap_o, regmap_oa=regmap_oa, regmap_l=regmap_l, ring=ring,
        ptsT_l=scan_l.points.t().contiguous(),
        rows_l=grid_rows(scan_l.points, scan_l.mask, pose_l, regmap_l, LIGO_GRID),
        p_ndt1_l=fused_math.pose_params(Pose3(pose_l.rot[None], pose_l.trans[None]), d1, d2),
        regmap_v=regmap_v, rows_v=grid_rows(pts, mask, pose_b, regmap_v, LOOP_GRID),
        p_ndt1_v=fused_math.pose_params(Pose3(pose_b.rot[None], pose_b.trans[None]), d1_v, d2_v),
        rows=grid_rows(pts, mask, pose_b, regmap, GRID),
        rows_g=grid_rows(pts, mask, pose_b, regmap_g, GRID),
        rows_o=grid_rows(pts, mask, pose_b, regmap_o, ODOM_GRID),
        rows_oa=grid_rows(pts, mask, pose_b, regmap_oa, ODOM_GRID),
        regmap_k=regmap_k, regmap_kg=regmap_kg,
        rows_k=grid_rows(pts, mask, pose_b, regmap_k, GRID),
        rows_kg=grid_rows(pts, mask, pose_b, regmap_kg, GRID),
        # rows looked up, and gated, at the points' true pose, radius = resolution
        gate=fused_math.gate_params(pose_b, res),
        megaT=fused_math.gather_megaT(pts, mask, pose_b, regmap, GRID),
        megaT_g=fused_math.gather_megaT(pts, mask, pose_b, regmap_g, GRID),
        megaT_aux=fused_math.gather_megaT(pts, mask, pose_b, regmap, GRID, table="aux"),
        megaT_oa=fused_math.gather_megaT(pts, mask, pose_b, regmap_oa, ODOM_GRID),
        scovT=stencil_point_covariances(
            pts, mask, (cfg.meta.columns_per_frame, ing.luts.subset_channels)
        ).reshape(N, 9).t().contiguous(),
        p_ndt=fused_math.pose_params(particles, d1, d2),
        p_ndt1=fused_math.pose_params(one, d1, d2),
        p_aniso=fused_math.pose_params(one, 0.0, 25.0),
        # the VGICP pair at the 5 m default gate and the 3-sigma trim
        p_gicp=fused_math.pose_params(one, 0.0, 25.0, 9.0, gicp=True),
    )
    log(f"kernel phase: N={N} points, {int(scan_b.num_points)} kept, "
        f"{int(gmap.num_valid())} map voxels, overflow {int(regmap.overflow)}; ligo map "
        f"{int(regmap_l.num_valid)} voxels from {LIGO_CLOUDS} sweeps, overflow {int(regmap_l.overflow)}; "
        f"loop-verification map {int(regmap_v.num_valid)} voxels, overflow {int(regmap_v.overflow)}")
    return inp


# Operations the pair math needs (an FMA counts 2, exp and a division 1),
# counted from the arithmetic of csrc/ndt_pair.cu with the Hessian tail in
# the rotated frame (y = R x; R applied once per pose): per point with a
# valid slot, the pose transform (18), y x b, hat(y) M and hat(y) M hat(y)^T
# (54) and the 29 sums (29); per valid slot (pair), the NDT weight and
# moments (56) or the trimmed quadratic (55). The plane-to-plane cost adds
# R C_src R^T per point (R C_src 54, its upper triangle times R^T 36) and
# per pair S = C_t + rc (6) and its adjugate inverse (cofactors 18,
# determinant 5, reciprocal 1, scaling 6). Points and slots that do not
# count need no work, so the count follows this run's data.
FLOPS_POINT = {"ndt_pair": 101, "gicp_pair": 101, "aniso_pair": 191}
FLOPS_PAIR = {"ndt_pair": 56, "gicp_pair": 55, "aniso_pair": 91}
# the KDTREE gate, once per point and tile whatever K: the gather-pose
# transform (18) per point with a valid slot, the distance test (9) per
# valid slot before the gate; the pair math then runs on the kept slots
FLOPS_GATE_POINT, FLOPS_GATE_PAIR = 18, 9
COSTS = {"ndt_pair": 0, "gicp_pair": 1, "aniso_pair": 2, "ndt_pair_gated": 3,
         "gicp_pair_gated": 4}  # ndt_pair_blocks_per_sm's cost codes
# a gate decision within this fraction of r^2 of the radius may round apart
# in the kernel (fused multiply-adds) and the plain version (matrix product):
# at 150 m a coordinate carries ~1e-5 m of float32 rounding
GATE_NEAR = 1e-4
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_S = 67e12  # H100 SXM fp32 outside the tensor cores


def pair_flops(name, K, mega, kept=None):
    """(operations, valid pairs, points with a valid slot) of one call of a
    pair kernel for K poses over the points' mega rows (N, 96); for a gated
    kernel, ``kept`` (N, 7) are the slots its gate keeps."""
    valid = mega[:, 84:91] > 0.5
    if kept is None:
        pairs, active = int(valid.sum()), int(valid.any(1).sum())
        return K * (active * FLOPS_POINT[name] + pairs * FLOPS_PAIR[name]), pairs, active
    base = name.removesuffix("_gated")
    pairs, active = int(kept.sum()), int(kept.any(1).sum())
    flops = (K * (active * FLOPS_POINT[base] + pairs * FLOPS_PAIR[base])
             + int(valid.any(1).sum()) * FLOPS_GATE_POINT + int(valid.sum()) * FLOPS_GATE_PAIR)
    return flops, pairs, active


def gate_check(torch, fused_math, ptsT, table, rows, gate, limit=4000):
    """The gate's decisions: (slots it keeps (N, 7) in the plain version,
    slots it cut, decisions within GATE_NEAR of the radius, how many of
    those the kernel decides otherwise). Each near decision is taken by the
    gated VGICP kernel alone on its point and that one slot, with no
    distance or Mahalanobis trim: its count is the kernel's decision (at
    most ``limit`` of them)."""
    from slamtpu_torch.core.se3 import Pose3

    mega = fused_math._table_rows(table, rows)
    mu, _, valid = fused_math._unpack_rows(mega)
    x = ptsT.t()
    kept = fused_math._gate_valid(valid, gate, x, mu)
    q = x @ gate[:9].view(3, 3).t() + gate[9:12]
    d2 = torch.sum((q[:, None, :] - mu) ** 2, dim=-1)
    near = (valid & ((d2 - gate[12]).abs() <= GATE_NEAR * gate[12])).nonzero().tolist()
    dev = ptsT.device
    eye = Pose3(torch.eye(3, device=dev)[None], torch.zeros((1, 3), device=dev))
    params = fused_math.pose_params(eye, 0.0, float("inf"), float("inf"), gicp=True)
    zero_row = torch.zeros(1, dtype=torch.int32, device=dev)
    disagree = 0
    for i, s in near[:limit]:
        row = mega[i].clone()
        row[84:91] = 0.0
        row[84 + s] = 1.0
        tab = torch.stack([row, torch.zeros_like(row)])
        out = fused_math.gicp_pair(params, ptsT[:, i:i + 1].contiguous(), tab, zero_row, gate)
        disagree += int(out[0, 43].item()) != int(kept[i, s].item())
    return kept, int(valid.sum() - kept.sum()), len(near), disagree


def kernel_phase(torch, replay_path, gt, cfg, dev, card):
    """Each kernel against its plain version at the main paths' shapes, with
    times, bounds and the in-kernel gather's checks. Returns the kernels'
    JSON entries."""
    from slamtpu_torch.mapping import gaussian_map
    from slamtpu_torch.ndt import fused_math
    from slamtpu_torch.ndt.regmap import grid_rows

    inp = kernel_inputs(torch, replay_path, gt, cfg, dev)
    N, K, ptsT, scovT = inp["N"], inp["K"], inp["ptsT"], inp["scovT"]
    packed, packed_g, packed_o = inp["regmap"].packed, inp["regmap_g"].packed, inp["regmap_o"].packed
    packed_aux, packed_l = inp["regmap"].packed_aux, inp["regmap_l"].packed
    packed_oa, rows_oa = inp["regmap_oa"].packed, inp["rows_oa"]
    rows, rows_g, rows_o, rows_l = inp["rows"], inp["rows_g"], inp["rows_o"], inp["rows_l"]
    ptsT_l, p_ndt1_l = inp["ptsT_l"], inp["p_ndt1_l"]
    packed_v, rows_v, p_ndt1_v = inp["regmap_v"].packed, inp["rows_v"], inp["p_ndt1_v"]
    packed_k, rows_k, gate = inp["regmap_k"].packed, inp["rows_k"], inp["gate"]
    packed_kg, rows_kg = inp["regmap_kg"].packed, inp["rows_kg"]

    def aniso(p, ptsT_, tab, r):
        return fused_math.aniso_pair(p, ptsT_, tab, r, scovT)

    # the in-kernel gather equals the same kernel on the pre-gathered rows
    for fn, p, tab, r, megaT in ((fused_math.ndt_pair, inp["p_ndt"], packed, rows, inp["megaT"]),
                                 (fused_math.gicp_pair, inp["p_gicp"], packed_g, rows_g, inp["megaT_g"]),
                                 (aniso, inp["p_aniso"], packed_aux, rows, inp["megaT_aux"]),
                                 (aniso, inp["p_aniso"], packed_oa, rows_oa, inp["megaT_oa"])):
        assert torch.equal(fn(p, ptsT, tab, r), fn(p, ptsT, *fused_math.pregathered_table(megaT))), fn
    log("in-kernel gather == pre-gathered rows, bit for bit (ndt_pair K=20, gicp_pair K=1, "
        "aniso_pair K=1 on the aux table and on the odom plane-to-plane table)")
    lib = fused_math._load()
    log(f"pair kernel: grid {lib.ndt_pair_grid(N, torch.cuda.current_device())} persistent "
        f"blocks for N={N}; blocks per SM " + ", ".join(
            f"{name} {lib.ndt_pair_blocks_per_sm(k, cost)} at K={k}"
            for name, cost in COSTS.items() for k in (K, 1)))

    b1 = "slamtpu/ndt/pallas_math.py:37 (_kernel, gicp=False; pallas_call :371)"
    kd = " with the KDTREE gate of gather_megaT (:294-317)"
    b3 = "slamtpu/ndt/pallas_math.py:185 (_kernel_aniso; pallas_call :355)"
    cases = [  # name, label, K, kernel, plain, (table, rows) it gathers from, TPU source
        ("ndt_pair", "K=20", K, lambda: fused_math.ndt_pair(inp["p_ndt"], ptsT, packed, rows),
         lambda: fused_math._ndt_pair_plain(inp["p_ndt"], ptsT, packed, rows), (packed, rows), b1),
        ("ndt_pair", "K=1", 1, lambda: fused_math.ndt_pair(inp["p_ndt1"], ptsT, packed, rows),
         lambda: fused_math._ndt_pair_plain(inp["p_ndt1"], ptsT, packed, rows), (packed, rows), b1),
        ("ndt_pair", "K=20, odom map", K,
         lambda: fused_math.ndt_pair(inp["p_ndt"], ptsT, packed_o, rows_o),
         lambda: fused_math._ndt_pair_plain(inp["p_ndt"], ptsT, packed_o, rows_o),
         (packed_o, rows_o), b1),
        ("ndt_pair", "K=1, odom map", 1,
         lambda: fused_math.ndt_pair(inp["p_ndt1"], ptsT, packed_o, rows_o),
         lambda: fused_math._ndt_pair_plain(inp["p_ndt1"], ptsT, packed_o, rows_o),
         (packed_o, rows_o), b1),
        ("ndt_pair", "K=1, ligo map", 1,
         lambda: fused_math.ndt_pair(p_ndt1_l, ptsT_l, packed_l, rows_l),
         lambda: fused_math._ndt_pair_plain(p_ndt1_l, ptsT_l, packed_l, rows_l),
         (packed_l, rows_l), b1),
        ("ndt_pair", "K=1, loop-verification map", 1,
         lambda: fused_math.ndt_pair(p_ndt1_v, ptsT, packed_v, rows_v),
         lambda: fused_math._ndt_pair_plain(p_ndt1_v, ptsT, packed_v, rows_v),
         (packed_v, rows_v), b1),
        ("gicp_pair", "K=1", 1, lambda: fused_math.gicp_pair(inp["p_gicp"], ptsT, packed_g, rows_g),
         lambda: fused_math._gicp_pair_plain(inp["p_gicp"], ptsT, packed_g, rows_g),
         (packed_g, rows_g),
         "slamtpu/ndt/pallas_math.py:37 (_kernel, gicp=True, :96-103; pallas_call :371)"),
        ("aniso_pair", "K=1", 1, lambda: aniso(inp["p_aniso"], ptsT, packed_aux, rows),
         lambda: fused_math._aniso_pair_plain(inp["p_aniso"], ptsT, packed_aux, rows, scovT),
         (packed_aux, rows), b3),
        ("aniso_pair", "K=1, odom aniso map", 1, lambda: aniso(inp["p_aniso"], ptsT, packed_oa, rows_oa),
         lambda: fused_math._aniso_pair_plain(inp["p_aniso"], ptsT, packed_oa, rows_oa, scovT),
         (packed_oa, rows_oa), b3),
        # the KDTREE search mode: gather (and gate) at the true pose, K = 20
        # particles around it (SVN stage 1) or K = 1 (Newton, the polish)
        ("ndt_pair_gated", "K=20", K,
         lambda: fused_math.ndt_pair(inp["p_ndt"], ptsT, packed_k, rows_k, gate),
         lambda: fused_math._ndt_pair_plain(inp["p_ndt"], ptsT, packed_k, rows_k, gate),
         (packed_k, rows_k), b1 + kd),
        ("ndt_pair_gated", "K=1", 1,
         lambda: fused_math.ndt_pair(inp["p_ndt1"], ptsT, packed_k, rows_k, gate),
         lambda: fused_math._ndt_pair_plain(inp["p_ndt1"], ptsT, packed_k, rows_k, gate),
         (packed_k, rows_k), b1 + kd),
        ("gicp_pair_gated", "K=1", 1,
         lambda: fused_math.gicp_pair(inp["p_gicp"], ptsT, packed_kg, rows_kg, gate),
         lambda: fused_math._gicp_pair_plain(inp["p_gicp"], ptsT, packed_kg, rows_kg, gate),
         (packed_kg, rows_kg),
         "slamtpu/ndt/pallas_math.py:37 (_kernel, gicp=True, :96-103; pallas_call :371)" + kd),
    ]
    # the gated kernels with an infinite radius are the ungated ones, bit for bit
    wide = gate.clone()
    wide[12] = float("inf")
    for fn, p, tab, r in ((fused_math.ndt_pair, inp["p_ndt"], packed_k, rows_k),
                          (fused_math.gicp_pair, inp["p_gicp"], packed_kg, rows_kg)):
        assert torch.equal(fn(p, ptsT, tab, r, wide), fn(p, ptsT, tab, r)), fn
    log("gated kernels with an infinite radius == ungated kernels, bit for bit (ndt_pair K=20, "
        "gicp_pair K=1, KDTREE maps)")
    measured = []
    for name, label, k, kern, plain, gathered, replaces in cases:
        out = kern()
        torch.cuda.synchronize()
        ref = plain()
        torch.cuda.synchronize()
        max_err = compare(out, ref)
        assert torch.isfinite(out).all() and float(out[:, 43].min()) > 0, (name, out[:, 43])
        # runs repeat bit for bit: no atomics in the reduction
        assert torch.equal(kern(), out), f"{name} is not deterministic"
        ms, plain_ms, spread = timed_pair(torch, kern, plain)
        # each input byte read once (the 91 floats of a mega row the math
        # reads, once per distinct row the kernel gathers, and points,
        # indices, source covariances, params), each output written once
        mega = fused_math._table_rows(*gathered)
        uniq = int(torch.unique(gathered[1]).numel())
        nbytes = uniq * 91 * 4 + N * (12 + 4 + (36 if name == "aniso_pair" else 0)) + k * (64 + 176)
        kept, gate_note = None, ""
        if name.endswith("_gated"):
            nbytes += 64  # the gate block
            kept, cut, near, disagree = gate_check(torch, fused_math, ptsT, *gathered, gate)
            gate_note = (f"; gate: {cut} slots cut of {int((mega[:, 84:91] > 0.5).sum())}, {near} "
                         f"decisions within {GATE_NEAR:g} r^2 of the radius, {disagree} of them "
                         "decided otherwise by the kernel")
        flops, pairs, active = pair_flops(name, k, mega, kept)
        t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_F32_S * 1e3
        bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        log(f"[{card}] {name} {label}: N={N} max_abs_err={max_err:.6g} (score {float(ref[0, 0]):.7g}, "
            f"count {int(ref[0, 43])}) kernel {ms:.4f} ms ({spread[0]}), plain {plain_ms:.4f} ms "
            f"({spread[1]}); bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.2f} MB, "
            f"{flops / 1e9:.4f} GFLOP: {active} points with a valid slot, {pairs} pairs; unique rows "
            f"{uniq}); {100 * bound_ms / ms:.1f}% of bound{gate_note}")
        measured.append(dict(
            name=name, label=label, K=k, N=N, max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, share_of_bound=bound_ms / ms, unique_rows=uniq,
            replaces=replaces, **({"gate_cut": cut, "gate_near": near, "gate_disagree": disagree}
                                  if kept is not None else {}),
        ))
    # the torch gathers the in-kernel one replaces, the row lookup that
    # stays, and one polish evaluation (lookup + plane-to-plane kernel)
    pts, mask, pose, regmap = inp["pts"], inp["mask"], inp["pose"], inp["regmap"]
    gather_ms, index_ms, spread = timed_pair(
        torch, lambda: fused_math.gather_megaT(pts, mask, pose, regmap, GRID),
        lambda: grid_rows(pts, mask, pose, regmap, GRID))
    log(f"[{card}] gather_megaT {gather_ms:.4f} ms ({spread[0]}); grid_rows {index_ms:.4f} ms "
        f"({spread[1]}) (N={N}, lo_svn map)")
    gather_aux_ms, polish_ms, spread = timed_pair(
        torch, lambda: fused_math.gather_megaT(pts, mask, pose, regmap, GRID, table="aux"),
        lambda: aniso(inp["p_aniso"], ptsT, packed_aux, grid_rows(pts, mask, pose, regmap, GRID)))
    log(f"[{card}] gather_megaT(table=\"aux\") {gather_aux_ms:.4f} ms ({spread[0]}); grid_rows + "
        f"aniso_pair {polish_ms:.4f} ms ({spread[1]}) (N={N}, lo_svn map)")
    # the map build's largest segment sum (sum x x^T, 9 columns) on the
    # 5-cloud ring, on the (values, seg) its statistics pass sorts: the
    # fixed-order sum against index_add_'s atomic one
    ring_pts, ring_mask, ring_origin, ring_res, ring_cap = inp["ring"]
    keys, rel = gaussian_map._corner_keys(ring_pts, ring_mask, ring_origin, ring_res)
    order, _, _, seg = gaussian_map._sorted_segments(keys, ring_cap)
    srel = rel[order]
    sxx = (srel[:, :, None] * srel[:, None, :]).reshape(-1, 9)
    scan_ms, atomic_ms, spread = timed_pair(
        torch, lambda: gaussian_map.segment_sum(sxx, seg, ring_cap + 1),
        lambda: torch.zeros((ring_cap + 1, 9), device=dev).index_add_(0, seg, sxx))
    log(f"[{card}] segment_sum {scan_ms:.4f} ms ({spread[0]}); index_add_ {atomic_ms:.4f} ms "
        f"({spread[1]}) (sum x x^T of {sxx.shape[0]} points into {ring_cap + 1} segments)")
    # the fixed-order sums repeat bit for bit; a 1-D float cumsum on the card
    # (a decoupled look-back scan) need not, which is why segment_sum_scan
    # scans along a dimension of a multi-row tensor
    first = gaussian_map.segment_sum(sxx, seg, ring_cap + 1)
    repeats = sum(torch.equal(gaussian_map.segment_sum(sxx, seg, ring_cap + 1), first) for _ in range(20))
    flat = sxx.t().double().reshape(-1)
    first_1d = torch.cumsum(flat, 0)
    repeats_1d = sum(torch.equal(torch.cumsum(flat, 0), first_1d) for _ in range(20))
    log(f"[{card}] segment_sum repeated 20 times: {repeats} equal to the first bit for bit; a 1-D float64 "
        f"cumsum of the same values: {repeats_1d} of 20")
    assert repeats == 20, repeats
    # one entry per kernel, from its first case; its other cases under "cases"
    entries = []
    for m in measured:
        if any(e["name"] == m["name"] for e in entries):
            continue
        e = {k: m[k] for k in ("name", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                               "share_of_bound", "unique_rows", "K", "N", "replaces", "gate_cut",
                               "gate_near", "gate_disagree") if k in m}
        e.update(route="cuda", source="slamtpu_torch/csrc/ndt_pair.cu", launches=0, library_ms=None)
        e["cases"] = [{k: x[k] for k in ("label", "K", "ms", "plain_ms", "bound_ms", "bound_by",
                                         "share_of_bound", "unique_rows", "max_abs_err", "gate_cut",
                                         "gate_near", "gate_disagree") if k in x}
                      for x in measured if x["name"] == m["name"] and x is not m]
        if m["name"] == "ndt_pair":
            e["gather_megaT_ms"], e["grid_rows_ms"] = gather_ms, index_ms
        if m["name"] == "aniso_pair":
            e["gather_megaT_ms"], e["grid_rows_ms"] = gather_aux_ms, index_ms
            e["grid_rows_plus_kernel_ms"] = polish_ms
        entries.append(e)
    return entries, inp


def timed_pair(torch, a, b):
    """Median device ms per call of ``a`` and ``b`` over TIMED_ROUNDS rounds
    in turns (b, a, a, b, ...), and each one's range over the rounds."""
    for _ in range(3):
        a(), b()
    t_a, t_b = [], []
    for i in range(TIMED_ROUNDS):
        order = ((b, t_b), (a, t_a)) if i % 2 == 0 else ((a, t_a), (b, t_b))
        for fn, acc in order:
            acc.append(time_ms(fn, torch))
    return (statistics.median(t_a), statistics.median(t_b),
            tuple(f"rounds {min(t):.4f}..{max(t):.4f}" for t in (t_a, t_b)))


def replay_phase(torch, label, app, replay_path, gt, card, kernels, ate_bound):
    """``app.run_replay`` with every launch count at 0 and a warning on
    every host sync; checks that ``kernels`` launched (with none named:
    that no pair kernel launched), that every pose and covariance is finite
    and that the ATE is below ``ate_bound``. Returns the launch counts of
    the run, its trajectory and its ATE."""
    import numpy as np

    from slamtpu_torch.apps.common import ate_rmse, np_between
    from slamtpu_torch.core.se3 import Pose3
    from slamtpu_torch.ndt import fused_math
    from slamtpu_torch.runtime.device_timer import keyframe_summary

    torch.cuda.reset_peak_memory_stats()
    for k in fused_math.LAUNCHES:
        fused_math.LAUNCHES[k] = 0
    newton_reads = fused_math.HOST_READS["newton"]
    app.device_timer.trace_keyframes()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            traj = app.run_replay(replay_path)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fused_math.LAUNCHES)
    # where the host waited for the device, by source line; the device
    # timer's own reads (at the final flush) are instrumentation
    sites = Counter(f"{Path(w.filename).name}:{w.lineno}" for w in caught
                    if "synchroniz" in str(w.message))
    syncs = sum(n for site, n in sites.items() if not site.startswith("device_timer.py"))
    newton_reads = fused_math.HOST_READS["newton"] - newton_reads
    assert all(launches[k] > 0 for k in kernels), (label, launches)
    assert kernels or not any(launches.values()), (label, launches)
    assert len(traj) == N_SWEEPS - 1, len(traj)
    for e in traj:
        assert np.isfinite(np.asarray(e.pose.rot)).all() and np.isfinite(np.asarray(e.pose.trans)).all()
        assert e.covariance is None or np.isfinite(e.covariance).all()
    gtp = [Pose3(np.asarray(R), np.asarray(p)) for R, p in gt[1:]]
    ate = ate_rmse([np_between(traj[0].pose, e.pose) for e in traj],
                   [np_between(gtp[0], g) for g in gtp[: len(traj)]])
    ins_ate = ate_rmse([np_between(traj[0].ins_pose, e.ins_pose) for e in traj],
                       [np_between(gtp[0], g) for g in gtp[: len(traj)]])
    stamps = app.device_timer.keyframes()
    ends = [1e-9 * s.queued for s in stamps.values()]  # host clock as each keyframe's work is queued
    warm = 3  # the first keyframes carry one-time set-up
    kf_s = (len(ends) - 1 - warm) / (ends[-1] - ends[warm])
    stages = app.device_timer.summary(skip_first=1)
    recs = app.stats.records
    log(f"[{card}] {label}: {len(traj)} keyframes in {wall:.3f} s; ATE {ate:.6f} m (INS prior "
        f"{ins_ate:.6f} m, bound {ate_bound} m); steady-state {kf_s:.3f} keyframes/s (host clock, "
        f"keyframes {warm + 1}..{len(ends) - 1}); iterations {[r.ndt_iterations for r in recs]}; "
        f"host syncs {syncs} ({syncs / len(traj):.2f} per keyframe; Newton loop reads "
        f"{newton_reads}); peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    log(f"[{card}]   {label} host syncs by source line: {dict(sites.most_common())}")
    log(f"[{card}]   {label} keyframe record: {keyframe_summary(stamps)}; least done - queued "
        f"{min(s.done - s.queued for s in stamps.values()) * 1e-6:.4f} ms")
    for name, st in stages.items():
        log(f"[{card}]   {label} stage {name}: median {st['median_ms']:.3f} ms, "
            f"mean {st['mean_ms']:.3f} ms over {st['n']}")
    log(f"launches in the {label} run: {launches}")
    assert ate < ate_bound, f"{label}: ATE {ate} m"
    return launches, traj, ate


def resume_phase(torch, label, make_app, replay_path, split, continuous, card):
    """The first ``split`` keyframes in one app, ``save_checkpoint``,
    ``resume_from`` in a new app, the rest there; the combined trajectory
    against the continuous run's. Returns the launch counts."""
    import numpy as np

    from slamtpu_torch.ndt import fused_math

    for k in fused_math.LAUNCHES:
        fused_math.LAUNCHES[k] = 0
    first = make_app()
    frames = list(first.ingest.synced_frames(replay_path))
    for synced in frames[:split]:
        first.process(synced)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "checkpoint.npz")
        first.save_checkpoint(path)
        size = os.path.getsize(path)
        resumed = make_app().resume_from(path)
    for synced in frames[split:]:
        resumed.process(synced)
    torch.cuda.synchronize()
    launches = dict(fused_math.LAUNCHES)
    combined = list(first.trajectory) + list(resumed.trajectory)
    assert len(combined) == len(continuous), (label, len(combined), len(continuous))
    err_m, err_rad = 0.0, 0.0
    for a, b in zip(combined, continuous):
        assert a.frame_id == b.frame_id
        err_m = max(err_m, float(np.linalg.norm(np.asarray(a.pose.trans, np.float64)
                                                - np.asarray(b.pose.trans, np.float64))))
        dR = np.asarray(b.pose.rot, np.float64).T @ np.asarray(a.pose.rot, np.float64)
        W = 0.5 * (dR - dR.T)  # small angle from the skew part
        err_rad = max(err_rad, float(np.linalg.norm([W[2, 1], W[0, 2], W[1, 0]])))
    log(f"[{card}] resume {label}: {split} keyframes, checkpoint ({size / 2**20:.2f} MiB), "
        f"{len(frames) - split} resumed; against the continuous run: max {err_m:.3g} m, "
        f"{err_rad:.3g} rad (bounds {RESUME_TOL_M} m, {RESUME_TOL_RAD} rad); launches {launches}")
    assert err_m <= RESUME_TOL_M and err_rad <= RESUME_TOL_RAD, (label, err_m, err_rad)
    return launches


def ins_map_phase(torch, replay_path, cfg, dev, card):
    """``InsMapApp(cfg, "cuda").run_replay`` with its rate, stages and map;
    a split run against the continuous one (bit for bit); the merged
    statistics of a prefix against one ``stats_from_points``; the export
    files."""
    from slamtpu_torch.apps.common import pose_to_device
    from slamtpu_torch.apps.ins_map import InsMapApp
    from slamtpu_torch.core import se3
    from slamtpu_torch.mapping import gaussian_map

    reg = cfg.register
    torch.cuda.reset_peak_memory_stats()
    app = InsMapApp(cfg, dev)
    app.device_timer.trace_keyframes()
    frames = list(app.ingest.synced_frames(replay_path))
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for synced in frames:
                app.process(synced)
            app.flush()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    wall = time.perf_counter() - t0
    syncs = sum(1 for w in caught if "synchroniz" in str(w.message)
                and not Path(w.filename).name.startswith("device_timer"))
    ends, warm = [1e-9 * s.queued for s in app.device_timer.keyframes().values()], 3
    kf_s = (len(ends) - 1 - warm) / (ends[-1] - ends[warm])
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "map")
        gmap = app.finalize_and_export(prefix, min_points_per_voxel=reg.min_points_per_voxel)
        n_valid = int(gmap.num_valid())
        lines = {sfx: len(Path(prefix + sfx).read_text().splitlines())
                 for sfx in ("_ellipsoids.txt", "_voxels.txt", "_summary.txt", "_means.ply")}
    assert lines["_ellipsoids.txt"] == lines["_voxels.txt"] == n_valid + 1 > 1, lines
    assert lines["_means.ply"] == n_valid + 7 and lines["_summary.txt"] == 2, lines
    st = app.stats
    log(f"[{card}] ins_map: {len(frames)} keyframes in {wall:.3f} s; steady-state {kf_s:.3f} keyframes/s "
        f"(host clock, keyframes {warm + 1}..{len(ends) - 1}); voxel {app.res} m, capacity "
        f"{reg.map_capacity}: {int((st.n > 0).sum())} voxels, {n_valid} valid after finalize, overflow "
        f"{int(st.overflow)}, out of range {app.out_of_range_points}, {int(st.n.sum())} points; host "
        f"syncs {syncs} ({syncs / len(frames):.2f} per keyframe); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; export files {lines}")
    for name, sp in app.device_timer.summary(skip_first=1).items():
        log(f"[{card}]   ins_map stage {name}: median {sp['median_ms']:.3f} ms, mean {sp['mean_ms']:.3f} ms "
            f"over {sp['n']}")
    # a split run: checkpoint, resume in a new app, the rest there
    first = InsMapApp(cfg, dev)
    for synced in frames[:INS_MAP_SPLIT]:
        first.process(synced)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ins_map.npz")
        first.save_checkpoint(path)
        resumed = InsMapApp(cfg, dev).resume_from(path)
    for synced in frames[INS_MAP_SPLIT:]:
        resumed.process(synced)
    for k in gaussian_map.VoxelStats._fields:
        assert torch.equal(getattr(resumed.stats, k), getattr(st, k)), f"ins_map split != continuous: {k}"
    log(f"[{card}] ins_map resume: {INS_MAP_SPLIT} keyframes, checkpoint, {len(frames) - INS_MAP_SPLIT} "
        "resumed: statistics equal to the continuous run's, bit for bit")
    # the merged statistics of the longest prefix without overflow against
    # one pass over the same INS-posed sweeps
    pre, states = InsMapApp(cfg, dev), []
    for synced in frames[:INS_MAP_PREFIX]:
        pre.process(synced)
        states.append(pre.stats)
    m = max(i + 1 for i, s_ in enumerate(states) if int(s_.overflow) == 0)
    merged = states[m - 1]
    scans = [pre.ingest.project(f) for f in frames[:m]]
    world = torch.cat([se3.transform_points(pose_to_device(e.pose, dev), sc.points)
                       for e, sc in zip(pre.trajectory, scans)])
    one = gaussian_map.stats_from_points(world, torch.cat([sc.mask for sc in scans]), merged.origin,
                                         merged.resolution, reg.map_capacity)
    assert torch.equal(merged.keys, one.keys) and torch.equal(merged.n, one.n)
    errs = {}
    for k in ("sx", "sxx"):
        a, b = getattr(merged, k).double(), getattr(one, k).double()
        errs[k] = float(((a - b).abs() / (1e-5 * b.abs() + 1e-6 * b.abs().max())).max())
    assert all(v <= 1.0 for v in errs.values()), errs
    log(f"[{card}] ins_map merge: {m} sweeps merged one at a time == one stats_from_points: keys and "
        f"counts exact ({int(merged.n.sum())} points, {int((merged.n > 0).sum())} voxels), sums' worst "
        f"error / (rtol 1e-5 + 1e-6 of the largest) {errs}")


def sync_sites(caught) -> Counter:
    """Host waits for the device among caught warnings, by source line."""
    return Counter(f"{Path(w.filename).name}:{w.lineno}" for w in caught if "synchroniz" in str(w.message))


def posegraph_inputs(n_poses: int, seed: int = 7):
    """bench.py:43-96's pose graph in numpy: a 500 m circle (float64 closed
    forms), the odometry relatives perturbed by a float32 retract (bench.py's
    runs in JAX's default float32) and chained in float64 for the initial
    poses, 150 mid-range and 50
    circle-closing closures at their true relatives, sqrt-information 100 I.
    Returns (init (R, t), gt (R, t), i, j, rel (R, t), sqrt_info)."""
    import numpy as np
    import torch

    from slamtpu_torch.core import se3
    from slamtpu_torch.core.se3 import Pose3

    rng = np.random.default_rng(seed)
    yaw = 2 * np.pi * np.arange(n_poses) / n_poses
    gt_t = np.stack([500.0 * np.sin(yaw), 500.0 * (1 - np.cos(yaw)), np.zeros(n_poses)], -1)
    cy, sy, z, o = np.cos(yaw), np.sin(yaw), np.zeros(n_poses), np.ones(n_poses)
    gt_R = np.stack([np.stack([cy, -sy, z], -1), np.stack([sy, cy, z], -1), np.stack([z, z, o], -1)], 1)
    rel_R = np.einsum("nji,njk->nik", gt_R[:-1], gt_R[1:])
    rel_t = np.einsum("nji,nj->ni", gt_R[:-1], gt_t[1:] - gt_t[:-1])
    noise = rng.normal(size=(n_poses - 1, 6)) * np.array([1e-4] * 3 + [3e-3] * 3)
    f32 = torch.float32
    rel = se3.retract(Pose3(torch.as_tensor(rel_R, dtype=f32), torch.as_tensor(rel_t, dtype=f32)),
                      torch.as_tensor(noise, dtype=f32))
    rr, rt = rel.rot.double().numpy(), rel.trans.double().numpy()
    init_R, init_t = np.empty_like(gt_R), np.empty_like(gt_t)
    init_R[0], init_t[0] = gt_R[0], gt_t[0]
    for k in range(n_poses - 1):
        init_t[k + 1] = init_t[k] + init_R[k] @ rt[k]
        init_R[k + 1] = init_R[k] @ rr[k]
    li_mid = rng.integers(0, n_poses - 1000, 150)
    lj_mid = li_mid + rng.integers(500, 999, 150)
    li_end = rng.integers(0, 50, 50)
    lj_end = n_poses - 50 + rng.integers(0, 50, 50)
    li, lj = np.concatenate([li_mid, li_end]), np.concatenate([lj_mid, lj_end])
    lr_R = np.einsum("nji,njk->nik", gt_R[li], gt_R[lj])
    lr_t = np.einsum("nji,nj->ni", gt_R[li], gt_t[lj] - gt_t[li])
    i = np.concatenate([np.arange(n_poses - 1), li])
    j = np.concatenate([np.arange(1, n_poses), lj])
    rel_all = (np.concatenate([rr, lr_R]), np.concatenate([rt, lr_t]))
    return (init_R, init_t), (gt_R, gt_t), i, j, rel_all, np.tile(100.0 * np.eye(6), (len(i), 1, 1))


def posegraph_phase(torch, dev, card):
    """The 10k-pose graph on the card, as bench.py runs it: warm-up, then 3
    chained solves timed by CUDA events; a repeat solve bit for bit; host
    syncs during one solve. Returns the phase's numbers."""
    import numpy as np

    from slamtpu_torch.core.se3 import Pose3
    from slamtpu_torch.fusion import pose_graph as pg

    init, gt, i, j, rel, si = posegraph_inputs(PG_POSES)
    f32 = torch.float32

    def t(a, dtype=f32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    graph = pg.make_graph(Pose3(t(init[0]), t(init[1])), t(i, torch.int32), t(j, torch.int32),
                          Pose3(t(rel[0]), t(rel[1])), t(si))
    cfg = pg.PoseGraphConfig(gn_iterations=8, cg_iterations=60)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = pg.optimize(graph, cfg)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            again = pg.optimize(graph, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sync_sites(caught)
    torch.cuda.synchronize()
    assert torch.equal(again.poses.rot, first.poses.rot) and torch.equal(again.poses.trans, first.poses.trans), \
        "two pose-graph solves of the same graph differ"
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    g = graph
    t0 = time.perf_counter()
    start.record()
    for _ in range(3):  # chained: each solve re-linearized at the previous solution
        res = pg.optimize(g, cfg)
        g = g._replace(poses=res.poses)
    end.record()
    host_s = time.perf_counter() - t0
    end.synchronize()
    ms = start.elapsed_time(end) / 3
    gt_end = np.asarray(gt[1][-1], np.float32)
    before = float(np.linalg.norm(np.asarray(init[1][-1], np.float32) - gt_end))
    after = float(np.linalg.norm(res.poses.trans[-1].cpu().numpy() - gt_end))
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"[{card}] pose graph: {PG_POSES} poses, {len(i)} factors, 8 GN x 60 CG, float32: end drift "
        f"{before:.6f} m before, {after:.6f} m after 3 chained solves; {ms:.3f} ms a solve (CUDA events; "
        f"host {1e3 * host_s / 3:.3f} ms to queue each); first solve {warm_s:.3f} s; host syncs in a solve "
        f"{sum(syncs.values())} {dict(syncs)}; repeat solve equal bit for bit; peak device memory {peak:.1f} MiB")
    assert abs(before - PG_DRIFT_BEFORE) <= PG_DRIFT_BEFORE_TOL, before
    assert np.isfinite(after) and after <= PG_DRIFT_AFTER_BOUND, after
    return dict(poses=PG_POSES, factors=len(i), drift_before_m=before, drift_after_m=after, ms_per_solve=ms,
                host_syncs=sum(syncs.values()), peak_mib=peak)


def loop_phase(torch, cfg, tconfig, dev, card, path, gt):
    """odom NDT_OMP with loop closure over the 46-sweep Berlin-shape circle
    replay, then the pose-graph refinement. Returns the launch counts and
    the ATE before the refinement."""
    import numpy as np

    from slamtpu_torch.apps.common import ate_rmse, np_between
    from slamtpu_torch.apps.odom_ndt import OdomNdtApp
    from slamtpu_torch.core.se3 import Pose3
    from slamtpu_torch.fusion.loop_closure import LoopClosureConfig
    from slamtpu_torch.ndt import fused_math

    app = OdomNdtApp(odom_cfg(tconfig, cfg, "NDT_OMP"), dev, window=6, loop_closure=True,
                     loop_cfg=LoopClosureConfig(**LOOP_CFG))
    det = app._detector
    verify, in_verify = det.verify_pair, Counter()

    def counted(*a, **kw):  # the NDT pair kernel's launches inside the verifications
        before = dict(fused_math.LAUNCHES)
        try:
            return verify(*a, **kw)
        finally:
            in_verify.update({k: fused_math.LAUNCHES[k] - before[k] for k in before})

    det.verify_pair = counted
    torch.cuda.reset_peak_memory_stats()
    for k in fused_math.LAUNCHES:
        fused_math.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    traj = app.run_replay(path)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fused_math.LAUNCHES)
    gtp = [Pose3(np.asarray(R), np.asarray(p)) for R, p in gt[1:]]

    def ate():
        return ate_rmse([np_between(traj[0].pose, e.pose) for e in traj],
                        [np_between(gtp[0], g) for g in gtp[: len(traj)]])

    ate_before = ate()
    t0 = time.perf_counter()
    _, closures = app.refine_loop_closures()
    refine_s = time.perf_counter() - t0
    ate_after = ate()
    pairs = [(c.i, c.j) for c in closures]
    n_ver = len(det.verify_ms)
    log(f"[{card}] odom loop closure: {len(traj)} keyframes in {wall:.3f} s; closures {pairs}; "
        f"{n_ver} verifications, median {statistics.median(det.verify_ms) if n_ver else float('nan'):.3f} ms "
        f"(host clock, each ends in its one read; range {min(det.verify_ms, default=0):.3f}.."
        f"{max(det.verify_ms, default=0):.3f}); NDT pair kernel launches in them {in_verify['ndt_pair']} "
        f"({in_verify['ndt_pair'] / max(n_ver, 1):.1f} a verification), in the run {launches}; "
        f"ATE {ate_before:.6f} m before, {ate_after:.6f} m after refine_loop_closures ({refine_s:.3f} s); "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    assert len(traj) == LOOP_SWEEPS - 1, len(traj)
    assert any(j - i >= LOOP_CFG["min_keyframe_gap"] for i, j in pairs), pairs
    assert in_verify["ndt_pair"] > 0, in_verify
    for e in traj:
        assert np.isfinite(e.pose.rot).all() and np.isfinite(e.pose.trans).all()
    assert ate_after <= max(2.0 * ate_before, 0.05), (ate_before, ate_after)
    return launches, ate_before


def cli_phase(torch, replay_path, card, tmp):
    """``python -m slamtpu_torch odom_ndt --loop-closure`` on the card."""
    import contextlib
    import io

    import numpy as np

    from slamtpu_torch.__main__ import main as cli_main
    from slamtpu_torch.ndt import fused_math
    from slamtpu_torch.runtime.checkpoint import load_trajectory

    out = os.path.join(tmp, "cli_out")
    for k in fused_math.LAUNCHES:
        fused_math.LAUNCHES[k] = 0
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        rc = cli_main(["odom_ndt", "--replay", replay_path, "--loop-closure", "--out", out])
    wall = time.perf_counter() - t0
    files = sorted(os.listdir(out))
    _, poses, _ = load_trajectory(os.path.join(out, "trajectory.npz"))
    said = printed.getvalue().strip().splitlines()
    log(f"[{card}] command line odom_ndt --loop-closure: rc {rc} in {wall:.3f} s; files {files}; "
        f"{len(poses)} poses; launches {dict(fused_math.LAUNCHES)}; it printed {said}")
    assert rc == 0 and {"trajectory.tum", "trajectory.npz", "keyframe_stats.csv"} <= set(files), files
    assert poses and all(np.isfinite(p.rot).all() and np.isfinite(p.trans).all() for p in poses)
    assert any(line.startswith("loop closures: ") for line in said), said
    assert fused_math.LAUNCHES["ndt_pair"] > 0
    return dict(fused_math.LAUNCHES)


def send_replay(path, lidar_port, compass_port, out_path, max_sweeps=None):
    """The sensors: send a replay's datagrams to loopback at their recorded
    timestamps, from a process of its own (the sensors are other machines
    and must not take the receiver's interpreter lock). Writes to
    ``out_path`` (JSON) the datagrams sent per stream and, per LiDAR frame
    id, the monotonic time its last datagram left. ``max_sweeps`` stops
    after that many LiDAR frames."""
    import socket

    sys.path.insert(0, str(ROOT))
    from slamtpu_torch.runtime.replay import STREAM_LIDAR, read_replay

    packets = list(read_replay(path))
    out = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sent, last, late = {"lidar": 0, "compass": 0}, {}, 0.0
    t0, ts0 = time.monotonic() + 0.1, packets[0][1]
    try:
        for stream, ts, payload in packets:
            if stream == STREAM_LIDAR:
                fid = int.from_bytes(payload[2:4], "little")  # RNG19 header: frame_id le16 at 2
                if max_sweeps is not None and fid not in last and len(last) >= max_sweeps:
                    break
            due = t0 + (ts - ts0)
            wait = due - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            late = max(late, -wait)
            if stream == STREAM_LIDAR:
                out.sendto(payload, ("127.0.0.1", lidar_port))
                sent["lidar"] += 1
                last[fid] = time.monotonic()
            else:
                out.sendto(payload, ("127.0.0.1", compass_port))
                sent["compass"] += 1
    finally:
        out.close()
    with open(out_path, "w") as f:
        json.dump({"sent": sent, "last_sent": last, "max_late_s": late}, f)


def _free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class LiveProbe:
    """Around a port app in a ``LivePipeline``: each ``process`` return
    time by frame id and the exceptions it raised (re-raised, so that the
    worker logs them as it would)."""

    def __init__(self, app):
        self.app, self.returned, self.raised, self.busy = app, {}, [], False

    def process(self, synced):
        self.busy = True
        try:
            self.app.process(synced)
        except Exception as e:
            self.raised.append(repr(e))
            raise
        finally:
            self.returned[synced.scan.frame_id] = time.monotonic()
            self.busy = False


def live_run(torch, cfg, app, replay_path, backend, tmp, max_sweeps=None, limit_s=120.0):
    """``app`` behind ``LivePipeline(cfg, ..., io_backend=backend)`` on two
    loopback ports while a sender process plays the replay at its recorded
    rate; ends once the sender has finished and the queue has drained.
    Returns (pipeline, probe, sender's record, datagrams received by stream,
    frames synced, host syncs, launches)."""
    import asyncio
    import multiprocessing

    from slamtpu_torch.ndt import fused_math
    from slamtpu_torch.runtime.live import LivePipeline
    from slamtpu_torch.runtime.udp import UdpConfig

    probe = LiveProbe(app)
    lp, cp = _free_port(), _free_port()
    pipeline = LivePipeline(cfg, probe, lidar_udp=UdpConfig(host="127.0.0.1", port=lp, buffer_size=1 << 22),
                            compass_udp=UdpConfig(host="127.0.0.1", port=cp), io_backend=backend)
    received, synced = Counter(), [0]
    on_lidar, on_compass, enqueue = pipeline._on_lidar, pipeline._on_compass, pipeline._enqueue

    def count_lidar(payload):
        received["lidar"] += 1
        on_lidar(payload)

    def count_compass(payload):
        received["compass"] += 1
        on_compass(payload)

    def count_synced(frame):
        synced[0] += 1
        enqueue(frame)

    pipeline._on_lidar, pipeline._on_compass, pipeline._enqueue = count_lidar, count_compass, count_synced
    record = os.path.join(tmp, f"sent_{backend}_{lp}.json")
    sender = multiprocessing.get_context("spawn").Process(
        target=send_replay, args=(replay_path, lp, cp, record, max_sweeps), daemon=True)

    async def supervise():
        task = asyncio.ensure_future(pipeline.run(duration_s=limit_s))
        while not pipeline.ready.is_set():
            if task.done():
                return await task  # the pipeline failed to start: raise its error
            await asyncio.sleep(0.01)
        sender.start()
        while sender.is_alive() or not (pipeline._q.empty() and not probe.busy
                                        and len(probe.returned) + pipeline.dropped_frames >= synced[0]):
            if task.done():
                return await task
            await asyncio.sleep(0.05)
        task.cancel()
        try:
            await task
        except asyncio.CancelledError:
            pass

    for k in fused_math.LAUNCHES:
        fused_math.LAUNCHES[k] = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            asyncio.run(supervise())
        finally:
            torch.cuda.set_sync_debug_mode("default")
            sender.join(timeout=30)
            if sender.is_alive():
                sender.kill()
    torch.cuda.synchronize()
    assert sender.exitcode == 0, f"the sender exited with {sender.exitcode}"
    with open(record) as f:
        sent = json.load(f)
    syncs = sum(n for site, n in sync_sites(caught).items() if not site.startswith("device_timer.py"))
    return pipeline, probe, sent, received, synced[0], syncs, dict(fused_math.LAUNCHES)


def live_phase(torch, cfg, tconfig, dev, card, replay_path, gt, odom_ate_replay, tmp):
    """The live runtime on the card: the circle replay sent over loopback at
    10 sweeps/s into ``LivePipeline(io_backend="native")`` with odom NDT_OMP
    and with lo_svn, and a short asyncio-backend run. Returns the launch
    counts of the native runs."""
    import numpy as np

    from slamtpu_torch.apps.common import ate_rmse, np_between
    from slamtpu_torch.apps.lo_svn import LoSvnApp
    from slamtpu_torch.apps.odom_ndt import OdomNdtApp
    from slamtpu_torch.core.se3 import Pose3
    from slamtpu_torch.ndt import fused_math
    from slamtpu_torch.runtime.replay import STREAM_COMPASS, STREAM_LIDAR

    fused_math._load()  # built already; the worker thread must never wait for nvcc
    # the reactor's decode, on this host: per datagram in Python (the live
    # path) against the replay path's batched native decode
    from slamtpu_torch.lidar.ouster import FrameAssembler, build_luts
    from slamtpu_torch.runtime.replay import read_replay

    luts = build_luts(cfg.meta, cfg.lidar)
    sweeps = [p for s_, _, p in read_replay(replay_path) if s_ == STREAM_LIDAR][:4 * 128]
    asm = FrameAssembler(cfg.meta, luts)
    t0 = time.perf_counter()
    for p in sweeps:
        asm.push_packet(p)
    one_ms = 1e3 * (time.perf_counter() - t0) / len(sweeps)
    asm = FrameAssembler(cfg.meta, luts)
    t0 = time.perf_counter()
    asm.push_packets(sweeps)
    batch_ms = 1e3 * (time.perf_counter() - t0) / len(sweeps)
    log(f"[{card}] LiDAR decode on this host: push_packet {one_ms:.4f} ms a datagram "
        f"({one_ms * 128:.2f} ms a sweep of 128), push_packets (native batch) {batch_ms:.4f} ms a datagram")
    launches = Counter()
    result = {}
    for label, make_app, kernels in (
            ("odom NDT_OMP", lambda: OdomNdtApp(odom_cfg(tconfig, cfg, "NDT_OMP"), dev, window=6), ("ndt_pair",)),
            ("lo_svn", lambda: LoSvnApp(cfg, dev), ("ndt_pair", "aniso_pair"))):
        pipeline, probe, sent, received, synced, syncs, counts = live_run(torch, cfg, make_app(), replay_path,
                                                                          "native", tmp)
        launches.update(counts)
        traj = probe.app.trajectory
        done = sorted(probe.returned)
        lat = sorted(1e3 * (probe.returned[f] - sent["last_sent"][str(f)]) for f in done)
        ends = [probe.returned[f] for f in done]
        kf_s = (len(ends) - 1) / (ends[-1] - ends[0]) if len(ends) > 1 else float("nan")
        drain = max(ends) - max(sent["last_sent"].values())
        ring = {"lidar": pipeline.rx_dropped.get(STREAM_LIDAR, 0), "compass": pipeline.rx_dropped.get(STREAM_COMPASS, 0)}
        lost = {k: sent["sent"][k] - received[k] - ring[k] for k in ring}
        gtp = [Pose3(np.asarray(R), np.asarray(p)) for R, p in gt]
        ate = ate_rmse([np_between(traj[0].pose, e.pose) for e in traj],
                       [np_between(gtp[traj[0].frame_id], gtp[e.frame_id]) for e in traj])
        log(f"[{card}] live {label} (native backend): datagrams sent {sent['sent']}, received {dict(received)}, "
            f"ring drops {ring}, lost before the ring {lost}; sender at most "
            f"{1e3 * sent['max_late_s']:.2f} ms late; frames synced {synced}, processed {len(done)}, dropped "
            f"{pipeline.dropped_frames}, errors {len(pipeline.errors)}, app exceptions {len(probe.raised)}; "
            f"{kf_s:.3f} keyframes/s over the run; latency last datagram -> process returned p50 "
            f"{statistics.median(lat):.1f} ms, p95 {lat[int(0.95 * (len(lat) - 1))]:.1f} ms, max {lat[-1]:.1f} ms; "
            f"drain after the last datagram {drain:.3f} s; ATE {ate:.6f} m over {len(traj)} keyframes (frames "
            f"{done[0]}..{done[-1]}); host syncs {syncs} ({syncs / len(done):.2f} a keyframe); launches {counts}")
        assert not probe.raised, probe.raised[:3]
        assert done and all(counts[k] > 0 for k in kernels), (label, counts)
        for e in traj:
            assert np.isfinite(e.pose.rot).all() and np.isfinite(e.pose.trans).all()
        clean = pipeline.dropped_frames == 0 and received == Counter(sent["sent"])
        if label.startswith("odom") and clean:
            assert ate <= 2.0 * odom_ate_replay, (ate, odom_ate_replay)
        result[label] = dict(synced=synced, processed=len(done), dropped=pipeline.dropped_frames, ring=ring,
                             kf_s=kf_s, ate=ate, lost=lost)
    # the asyncio backend, briefly: what it loses at 1280 datagrams/s
    pipeline, probe, sent, received, synced, _, _ = live_run(
        torch, cfg, OdomNdtApp(odom_cfg(tconfig, cfg, "NDT_OMP"), dev, window=6), replay_path, "asyncio", tmp,
        max_sweeps=LIVE_ASYNCIO_SWEEPS)
    log(f"[{card}] live odom NDT_OMP (asyncio backend, {LIVE_ASYNCIO_SWEEPS} sweeps): datagrams sent "
        f"{sent['sent']}, received {dict(received)}, lost {sent['sent']['lidar'] - received['lidar']} LiDAR / "
        f"{sent['sent']['compass'] - received['compass']} compass; frames synced {synced}, processed "
        f"{len(probe.returned)}, dropped {pipeline.dropped_frames}, errors {len(pipeline.errors)}, app "
        f"exceptions {len(probe.raised)}")
    assert not probe.raised, probe.raised[:3]
    return dict(launches)


def per_particle_phase(torch, inp, cfg, card):
    """svn_align_reg on the kernel phase's sweep with the shared gather and
    with per-particle gathers (``shared_gather=False``). Returns the launch
    counts."""
    from slamtpu_torch.core import se3
    from slamtpu_torch.ndt import fused_math
    from slamtpu_torch.ndt.svn import SvnConfig, svn_align_reg

    reg = cfg.register
    K = reg.svn_particles
    g = torch.Generator(device=inp["pts"].device)
    g.manual_seed(1)
    noise = torch.randn((K, 6), generator=g, device=inp["pts"].device)
    prior = se3.retract(inp["pose"], torch.tensor([0.002, -0.001, 0.003, 0.05, -0.04, 0.02],
                                                  device=inp["pts"].device))
    out, launches = {}, Counter()
    for shared in (True, False):
        scfg = SvnConfig(resolution=reg.svn_resolution, num_particles=K, max_iterations=reg.svn_max_iterations,
                         kernel_h=reg.svn_kernel_h, step_size=reg.svn_step_size, shared_gather=shared)

        def run():
            return svn_align_reg(inp["pts"], inp["mask"], inp["regmap"], prior, scfg, GRID, init_noise=noise)

        run()  # warm
        torch.cuda.synchronize()
        before = dict(fused_math.LAUNCHES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        res = run()
        end.record()
        end.synchronize()
        n = {k: fused_math.LAUNCHES[k] - before[k] for k in before}
        launches.update(n)
        out[shared] = res
        T = reg.svn_max_iterations
        log(f"[{card}] svn_align_reg shared_gather={shared}: K={K}, {T} trips, iterations "
            f"{int(res.iterations)}; B1 launches {n['ndt_pair']} ({(n['ndt_pair'] - 1) / T:.1f} an iteration, "
            f"+1 scoring the mean); {start.elapsed_time(end):.3f} ms by CUDA events, "
            f"{1e3 * (time.perf_counter() - t0):.3f} ms host clock")
        assert n["ndt_pair"] == (T if shared else K * T) + 1, n
        assert torch.isfinite(res.pose.trans).all() and torch.isfinite(res.covariance).all()
    d = se3.local(out[True].pose, out[False].pose).double().cpu()
    err = [float(d[3:].norm()), float(d[:3].norm())]
    true_err = [float(se3.local(inp["pose"], out[s].pose)[3:].norm()) for s in (True, False)]
    log(f"[{card}] per-particle vs shared gather: pose difference {err[0]:.3e} m, {err[1]:.3e} rad; distance "
        f"from the true pose {true_err[0]:.6f} m shared, {true_err[1]:.6f} m per-particle")
    return dict(launches)


def sorted_key_phase(torch, inp, card):
    """The sorted-key objective on the kernel phase's sweep and lo_svn map:
    against the NDT pair kernel at K = 1 at the same pose on the rows of a
    RegMap of the same map over SORTED_KEY_CHECK_GRID (no overflow, so both
    see the same neighbors), at the kernel checks' tolerances; device ms an
    evaluation at K = 1 and at K = 20 (the particles, one batched pass) and
    the K = 20 pass's peak memory."""
    from slamtpu_torch.ndt import fused_math, objective
    from slamtpu_torch.ndt.regmap import build_regmap, grid_rows

    gmap, pts, mask, pose, N = inp["gmap"], inp["pts"], inp["mask"], inp["pose"], inp["N"]
    d1, d2, particles = inp["d1"], inp["d2"], inp["particles"]
    regmap = build_regmap(gmap, grid_shape=SORTED_KEY_CHECK_GRID)
    assert int(regmap.overflow) == 0, int(regmap.overflow)
    rows = grid_rows(pts, mask, pose, regmap, SORTED_KEY_CHECK_GRID)
    b1 = fused_math.ndt_pair(inp["p_ndt1"], inp["ptsT"], regmap.packed, rows)

    def evaluate(p):
        return objective.score_grad_hess(pts, mask, p, gmap, d1, d2, hess_lambda=0.0)

    sk = evaluate(pose)
    sums = torch.cat([sk.score[None], sk.grad, sk.hess.reshape(36), sk.n_contrib.to(torch.float32)[None]])[None]
    log("sorted-key objective against the NDT pair kernel (K=1, same map and pose):")
    max_err = compare(sums, b1)
    one_ms = time_ms(lambda: evaluate(pose), torch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    batched = evaluate(particles)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    assert torch.isfinite(batched.hess).all() and batched.score.shape == (inp["K"],)
    k_ms = time_ms(lambda: evaluate(particles), torch)
    log(f"[{card}] sorted-key score_grad_hess: N={N}, max_abs_err {max_err:.6g} against B1 (count "
        f"{int(sk.n_contrib)}, RegMap grid {SORTED_KEY_CHECK_GRID}); {one_ms:.4f} ms an evaluation at K=1, "
        f"{k_ms:.4f} ms at K={inp['K']} ({k_ms / inp['K']:.4f} ms a particle); peak memory of the "
        f"K={inp['K']} pass {peak:.1f} MiB above its inputs")


def dist_phase(torch, inp, cfg, dev, card, tmp):
    """The multi-device layer over NCCL at world size 1 (one card) at the
    Berlin width, each function against its one-device counterpart.
    Returns the launch counts."""
    import torch.distributed as dist

    from slamtpu_torch import dist as tdist
    from slamtpu_torch.core import se3
    from slamtpu_torch.core.se3 import Pose3
    from slamtpu_torch.mapping import gaussian_map
    from slamtpu_torch.ndt import fused_math
    from slamtpu_torch.ndt.newton import NewtonConfig, newton_align
    from slamtpu_torch.ndt.svn import SvnConfig, svn_align_reg

    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"file://{os.path.join(tmp, 'dist_store')}", rank=0, world_size=1)
    launches = Counter()
    try:
        reg = cfg.register
        pts, mask, regmap = inp["pts"], inp["mask"], inp["regmap"]
        init = se3.retract(inp["pose"], torch.tensor([0.01, -0.008, 0.02, 0.25, -0.2, 0.05], device=dev))

        def timed(fn):
            """(result, ms by CUDA events, collectives, launches) of one call after a warm one."""
            fn()
            torch.cuda.synchronize()
            c0, l0 = dict(tdist.COLLECTIVES), dict(fused_math.LAUNCHES)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            r = fn()
            end.record()
            end.synchronize()
            n = {k: fused_math.LAUNCHES[k] - l0[k] for k in l0}
            launches.update(n)
            return r, start.elapsed_time(end), {k: v - c0[k] for k, v in tdist.COLLECTIVES.items() if v - c0[k]}, \
                n["ndt_pair"]

        def same(a, b):
            if isinstance(a, torch.Tensor):
                return torch.equal(a, b)
            return all(same(x, y) for x, y in zip(a, b))

        def report(name, equal, ms, coll, b1, ms_one=None, note=""):
            said = {True: "equal to its one-device counterpart", False: "NOT bit for bit equal to its one-device "
                    "counterpart", None: "no one-device counterpart"}[equal]
            log(f"[{card}] dist {name} ({dist.get_backend()}, 1 rank): {said}{note}; {ms:.3f} ms a call (CUDA events)"
                + (f" against {ms_one:.3f} ms on one device" if ms_one is not None else "")
                + f"; collectives {coll}; B1 launches {b1}")

        world_a, mask_a, origin = inp["world_a"], inp["mask_a"], inp["origin"]
        cap = reg.map_capacity
        g, ms, coll, b1 = timed(lambda: tdist.build_map_sharded(world_a, mask_a, origin, 1.0, cap, 4))
        one, ms1, _, _ = timed(lambda: gaussian_map.build_map(world_a, mask_a, origin, 1.0, cap, 4))
        eq = same(g, one)
        report("build_map_sharded", eq, ms, coll, b1, ms1)
        assert eq and coll == {"all_gather": 5}

        ncfg = NewtonConfig(resolution=1.0, max_iterations=30)
        gmap = inp["gmap"]
        r, ms, coll, b1 = timed(lambda: tdist.newton_align_sharded(pts, mask, gmap, init))
        one, ms1, _, _ = timed(lambda: newton_align(pts, mask, gmap, init, ncfg))
        eq = same(r, (one.pose, one.hessian, one.score, one.iterations))
        moved = float(se3.local(inp["pose"], r[0])[3:].norm())
        report("newton_align_sharded", eq, ms, coll, b1, ms1,
               f" ({int(r[3])} iterations, {moved:.6f} m from the true pose; sorted-key objective, no pair kernel)")
        assert eq and coll == {"all_reduce": int(r[3]) + 1} and b1 == 0 and moved < DIST_POSE_BOUND

        r, ms, coll, b1 = timed(lambda: tdist.newton_align_sharded_reg(pts, mask, regmap, init, GRID))
        one, ms1, _, _ = timed(lambda: fused_math.newton_align_fused(pts, mask, regmap, init, ncfg, GRID,
                                                                     final_eval=True))
        eq = same(r, (one.pose, one.hessian, one.score, one.iterations))
        moved = float(se3.local(inp["pose"], r[0])[3:].norm())
        report("newton_align_sharded_reg", eq, ms, coll, b1, ms1,
               f" ({int(r[3])} iterations, {moved:.6f} m from the true pose)")
        assert eq and coll == {"all_reduce": int(r[3]) + 1} and moved < DIST_POSE_BOUND

        fcfg = NewtonConfig(resolution=1.0, max_iterations=30, gather_stale_frac=0.25)
        r, ms, coll, b1 = timed(lambda: tdist.newton_align_sharded_fused(pts, mask, regmap, init, GRID))
        one, ms1, _, _ = timed(lambda: fused_math.newton_align_fused(pts, mask, regmap, init, fcfg, GRID,
                                                                     inner_iters=6, final_eval=True))
        eq = same(r, (one.pose, one.hessian, one.score, one.iterations))
        moved = float(se3.local(inp["pose"], r[0])[3:].norm())
        report("newton_align_sharded_fused", eq, ms, coll, b1, ms1,
               f" ({int(r[3])} iterations, {moved:.6f} m from the true pose)")
        assert eq and coll["all_reduce"] == b1 and moved < DIST_POSE_BOUND

        stats = gaussian_map.stats_from_points(world_a, mask_a, origin, 1.0, cap)
        r, ms, coll, b1 = timed(lambda: tdist.lo_train_step(pts, mask, stats, init, 1.0, cap, grid_shape=GRID,
                                                            min_points_per_voxel=4))
        grown = int(r[4].n.sum()) - int(stats.n.sum())
        moved = float(se3.local(inp["pose"], r[0])[3:].norm())
        report("lo_train_step", None, ms, coll, b1,
               note=f" ({int(r[3])} iterations, {moved:.6f} m from the true pose, "
                    f"map grew by {grown} points of {int(mask.sum())})")
        assert grown == int(mask.sum()) and moved < DIST_POSE_BOUND and coll.get("all_gather") == 5

        scfg = SvnConfig(resolution=reg.svn_resolution, num_particles=reg.svn_particles,
                         max_iterations=reg.svn_max_iterations, kernel_h=reg.svn_kernel_h,
                         step_size=reg.svn_step_size, polish_iters=4, polish_objective="ndt")
        noise = torch.randn((reg.svn_particles, 6), generator=torch.Generator(device=dev).manual_seed(2), device=dev)
        r, ms, coll, b1 = timed(lambda: tdist.svn_align_sharded(pts, mask, regmap, inp["pose"], noise, scfg, GRID))
        one, ms1, _, _ = timed(lambda: svn_align_reg(pts, mask, regmap, inp["pose"], scfg, GRID, init_noise=noise))
        eq = same(r, one)
        diff = float((r.pose.trans - one.pose.trans).abs().max())
        report(f"svn_align_sharded K={scfg.num_particles}", eq, ms, coll, b1, ms1, "" if eq else f" (max pose difference {diff:.3e} m)")
        assert diff < 1e-5

        B = LIVE_BATCH
        offsets = torch.linspace(0.2, 1.0, B, device=dev)[:, None] * torch.tensor(
            [0.01, -0.008, 0.02, 0.25, -0.2, 0.05], device=dev)
        inits = se3.retract(Pose3(inp["pose"].rot.expand(B, 3, 3), inp["pose"].trans.expand(B, 3)), offsets)
        bcfg = NewtonConfig(resolution=1.0, max_iterations=30, gather_stale_frac=0.25)
        bpts, bmask = pts.expand(B, -1, -1).contiguous(), mask.expand(B, -1).contiguous()
        r, ms, coll, b1 = timed(lambda: tdist.batch_align_sharded(bpts, bmask, regmap, inits, bcfg, GRID,
                                                                  inner_iters=2))
        ones = [fused_math.newton_align_fused(pts, mask, regmap, Pose3(inits.rot[b], inits.trans[b]), bcfg, GRID,
                                              inner_iters=2) for b in range(B)]
        eq = all(torch.equal(r.pose.trans[b], o.pose.trans) and torch.equal(r.pose.rot[b], o.pose.rot)
                 and torch.equal(r.iterations[b], o.iterations) for b, o in enumerate(ones))
        report(f"batch_align_sharded B={B}", eq, ms, coll, b1, note=f" ({B} calls of newton_align_fused; "
               f"iterations {r.iterations.tolist()})")
        assert eq and not coll
    finally:
        dist.destroy_process_group()
    return dict(launches)



def main():
    import dataclasses

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import simulator_np
    import slamtpu_torch  # noqa: F401  (sets the float32 matmul policy)
    import slamtpu_torch.__main__  # noqa: F401
    import slamtpu_torch.dist  # noqa: F401
    import slamtpu_torch.fusion  # noqa: F401
    import slamtpu_torch.runtime.live  # noqa: F401

    assert not torch.cuda.is_initialized(), "importing the port started a CUDA context"
    from slamtpu_torch import cuda_build
    from slamtpu_torch.apps.ligo_tc import LigoTcApp
    from slamtpu_torch.apps.lo_svn import LoSvnApp
    from slamtpu_torch.apps.odom_ndt import OdomNdtApp
    from slamtpu_torch.ins import imu_config
    from slamtpu_torch.lidar import ouster
    from slamtpu_torch.ndt import fused_math
    from slamtpu_torch.runtime import config as tconfig

    dev = torch.device("cuda")
    card = card_line()
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log(f"card: {card} | torch {torch.__version__} CUDA {torch.version.cuda} | {name} x{count}")

    t0 = time.perf_counter()
    fused_math._load()
    log(f"kernel build + load: {time.perf_counter() - t0:.2f} s")
    for stem, b in cuda_build.BUILD_LOG.items():
        log(f"nvcc {stem}: {b['seconds']:.2f} s\n{b['output'].strip()}")

    cfg = berlin_cfg(tconfig, ouster, imu_config)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "berlin.rpl")
        t0 = time.perf_counter()
        gt = simulator_np.simulate_replay(path, cfg.meta, cfg.lidar, n_sweeps=N_SWEEPS, skewed=True)
        log(f"simulated {N_SWEEPS} skewed sweeps in {time.perf_counter() - t0:.1f} s")
        entries, inp = kernel_phase(torch, path, gt, cfg, dev, card)
        sorted_key_phase(torch, inp, card)
        phases = {"lo_svn": (lambda: LoSvnApp(cfg, dev), ("ndt_pair", "aniso_pair"), 0.005)}
        cfg_kd = dataclasses.replace(
            cfg, register=dataclasses.replace(cfg.register, svn_search_method="KDTREE"))
        phases["lo_svn KDTREE"] = (lambda: LoSvnApp(cfg_kd, dev), ("ndt_pair_gated",),
                                   LO_SVN_KDTREE_ATE_BOUND)
        cfg_sk = dataclasses.replace(cfg, register=dataclasses.replace(cfg.register, use_regmap=False))
        phases["lo_svn sorted-key"] = (lambda: LoSvnApp(cfg_sk, dev), (), LO_SVN_SORTED_KEY_ATE_BOUND)
        for label, (method, change, kernel, bound) in ODOM_PHASES.items():
            phases[f"odom {label}"] = (
                lambda m=method, c=change: OdomNdtApp(odom_cfg(tconfig, cfg, m, **c), dev, window=6),
                (kernel,) if kernel else (), bound)
        phases["ligo"] = (lambda: LigoTcApp(ligo_cfg(tconfig, cfg), dev, window=6), ("ndt_pair",),
                          LIGO_ATE_BOUND)
        phases["ligo parity"] = (
            lambda: LigoTcApp(ligo_cfg(tconfig, cfg, map_rebuild_every=1, smoother_solver="qr"), dev,
                              window=6),
            ("ndt_pair",), LIGO_ATE_BOUND)
        launches = {k: 0 for k in fused_math.LAUNCHES}
        continuous, ates = {}, {}
        for label, (make_app, kernels, bound) in phases.items():
            counts, continuous[label], ates[label] = replay_phase(torch, label, make_app(), path, gt, card,
                                                                  kernels, bound)
            for k, v in counts.items():
                launches[k] += v
        log(f"[{card}] sorted-key path against the RegMap path, ATE m: " + "; ".join(
            f"{a} {ates[a]:.6f} vs {b} {ates[b]:.6f}" for a, b in (
                ("lo_svn sorted-key", "lo_svn"), ("odom NDT_OMP sorted-key", "odom NDT_OMP"),
                ("odom NDT_OMP sorted-key DIRECT1", "odom NDT_OMP"), ("odom GICP sorted-key", "odom GICP"))))
        for label, split in RESUME_AFTER.items():
            counts = resume_phase(torch, label, phases[label][0], path, split, continuous[label], card)
            for k, v in counts.items():
                launches[k] += v
        ins_map_phase(torch, path, cfg, dev, card)
        circle = os.path.join(tmp, "loop.rpl")
        t0 = time.perf_counter()
        circle_gt = simulator_np.simulate_replay(
            circle, cfg.meta, cfg.lidar, n_sweeps=LOOP_SWEEPS, skewed=True,
            traj=simulator_np.ArcTrajectory(v=LOOP_SPEED, yaw_rate=2 * math.pi / LOOP_PERIOD_S))
        log(f"simulated {LOOP_SWEEPS} skewed sweeps around the circle in {time.perf_counter() - t0:.1f} s")
        counts, loop_ate = loop_phase(torch, cfg, tconfig, dev, card, circle, circle_gt)
        for counts in (counts, cli_phase(torch, path, card, tmp),
                       live_phase(torch, cfg, tconfig, dev, card, circle, circle_gt, loop_ate, tmp),
                       per_particle_phase(torch, inp, cfg, card), dist_phase(torch, inp, cfg, dev, card, tmp)):
            for k, v in counts.items():
                launches[k] += v
        del inp
    posegraph_phase(torch, dev, card)
    for e in entries:
        e["launches"] = launches[e["name"]]
    log(card)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
