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
   ``index_add_``'s atomic one on the same sorted values.
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
Each replay phase prints the ATE, steady-state keyframes/s, iteration
counts, host syncs per keyframe, per-stage device times and peak memory.
The kernel phase also holds the NDT pair kernel at K = 1 against a
5-cloud map at the ligo operating point's capacity (2^16) and grid.

It imports neither JAX nor the JAX package. It exits non-zero, printing no
result line, when CUDA is unavailable or any check fails. The last line of
standard output is ``{"ok": true, "device": {...}}``.
"""
import json
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
    from slamtpu_torch.mapping.gaussian_map import build_map
    from slamtpu_torch.ndt import fused_math
    from slamtpu_torch.ndt.constants import gauss_constants
    from slamtpu_torch.ndt.gicp import (gicp_map, gicp_map_aniso, regularize_plane_covariance,
                                        stencil_point_covariances)
    from slamtpu_torch.ndt.regmap import build_regmap, grid_rows
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
        regmap_g=regmap_g, regmap_o=regmap_o, regmap_oa=regmap_oa, regmap_l=regmap_l, ring=ring,
        ptsT_l=scan_l.points.t().contiguous(),
        rows_l=grid_rows(scan_l.points, scan_l.mask, pose_l, regmap_l, LIGO_GRID),
        p_ndt1_l=fused_math.pose_params(Pose3(pose_l.rot[None], pose_l.trans[None]), d1, d2),
        rows=grid_rows(pts, mask, pose_b, regmap, GRID),
        rows_g=grid_rows(pts, mask, pose_b, regmap_g, GRID),
        rows_o=grid_rows(pts, mask, pose_b, regmap_o, ODOM_GRID),
        rows_oa=grid_rows(pts, mask, pose_b, regmap_oa, ODOM_GRID),
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
        f"{int(regmap_l.num_valid)} voxels from {LIGO_CLOUDS} sweeps, overflow {int(regmap_l.overflow)}")
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
COSTS = {"ndt_pair": 0, "gicp_pair": 1, "aniso_pair": 2}  # the kernel template's cost
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_S = 67e12  # H100 SXM fp32 outside the tensor cores


def pair_flops(name, K, mega):
    """(operations, valid pairs, points with a valid slot) of one call of a
    pair kernel for K poses over the points' mega rows (N, 96)."""
    valid = mega[:, 84:91] > 0.5
    pairs, active = int(valid.sum()), int(valid.any(1).sum())
    flops = K * (active * FLOPS_POINT[name] + pairs * FLOPS_PAIR[name])
    return flops, pairs, active


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
    ]
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
        flops, pairs, active = pair_flops(name, k, mega)
        t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_F32_S * 1e3
        bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        log(f"[{card}] {name} {label}: N={N} max_abs_err={max_err:.6g} (score {float(ref[0, 0]):.7g}, "
            f"count {int(ref[0, 43])}) kernel {ms:.4f} ms ({spread[0]}), plain {plain_ms:.4f} ms "
            f"({spread[1]}); bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.2f} MB, "
            f"{flops / 1e9:.4f} GFLOP: {active} points with a valid slot, {pairs} pairs; unique rows "
            f"{uniq}); {100 * bound_ms / ms:.1f}% of bound")
        measured.append(dict(
            name=name, label=label, K=k, N=N, max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, share_of_bound=bound_ms / ms, unique_rows=uniq,
            replaces=replaces,
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
    # one entry per kernel, from its first case; its other cases under "cases"
    entries = []
    for m in measured:
        if any(e["name"] == m["name"] for e in entries):
            continue
        e = {k: m[k] for k in ("name", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                               "share_of_bound", "unique_rows", "K", "N", "replaces")}
        e.update(route="cuda", source="slamtpu_torch/csrc/ndt_pair.cu", launches=0, library_ms=None)
        e["cases"] = [{k: x[k] for k in ("label", "K", "ms", "plain_ms", "bound_ms", "bound_by",
                                         "share_of_bound", "unique_rows", "max_abs_err")}
                      for x in measured if x["name"] == m["name"] and x is not m]
        if m["name"] == "ndt_pair":
            e["gather_megaT_ms"], e["grid_rows_ms"] = gather_ms, index_ms
        if m["name"] == "aniso_pair":
            e["gather_megaT_ms"], e["grid_rows_ms"] = gather_aux_ms, index_ms
            e["grid_rows_plus_kernel_ms"] = polish_ms
        entries.append(e)
    return entries


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
    every host sync; checks that ``kernels`` launched, that every pose and
    covariance is finite and that the ATE is below ``ate_bound``. Returns
    the launch counts of the run and its trajectory."""
    import numpy as np

    from slamtpu_torch.apps.common import ate_rmse, np_between
    from slamtpu_torch.core.se3 import Pose3
    from slamtpu_torch.ndt import fused_math

    torch.cuda.reset_peak_memory_stats()
    for k in fused_math.LAUNCHES:
        fused_math.LAUNCHES[k] = 0
    newton_reads = fused_math.HOST_READS["newton"]
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
    assert len(traj) == N_SWEEPS - 1, len(traj)
    for e in traj:
        assert np.isfinite(np.asarray(e.pose.rot)).all() and np.isfinite(np.asarray(e.pose.trans)).all()
        assert e.covariance is None or np.isfinite(e.covariance).all()
    gtp = [Pose3(np.asarray(R), np.asarray(p)) for R, p in gt[1:]]
    ate = ate_rmse([np_between(traj[0].pose, e.pose) for e in traj],
                   [np_between(gtp[0], g) for g in gtp[: len(traj)]])
    ins_ate = ate_rmse([np_between(traj[0].ins_pose, e.ins_pose) for e in traj],
                       [np_between(gtp[0], g) for g in gtp[: len(traj)]])
    ends = app.process_end_s
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
    for name, st in stages.items():
        log(f"[{card}]   {label} stage {name}: median {st['median_ms']:.3f} ms, "
            f"mean {st['mean_ms']:.3f} ms over {st['n']}")
    log(f"launches in the {label} run: {launches}")
    assert ate < ate_bound, f"{label}: ATE {ate} m"
    return launches, traj


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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import simulator_np
    import slamtpu_torch  # noqa: F401  (sets the float32 matmul policy)
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
        entries = kernel_phase(torch, path, gt, cfg, dev, card)
        phases = {"lo_svn": (lambda: LoSvnApp(cfg, dev), ("ndt_pair", "aniso_pair"), 0.005)}
        for label, (method, change, kernel, bound) in ODOM_PHASES.items():
            phases[f"odom {label}"] = (
                lambda m=method, c=change: OdomNdtApp(odom_cfg(tconfig, cfg, m, **c), dev, window=6),
                (kernel,), bound)
        phases["ligo"] = (lambda: LigoTcApp(ligo_cfg(tconfig, cfg), dev, window=6), ("ndt_pair",),
                          LIGO_ATE_BOUND)
        phases["ligo parity"] = (
            lambda: LigoTcApp(ligo_cfg(tconfig, cfg, map_rebuild_every=1, smoother_solver="qr"), dev,
                              window=6),
            ("ndt_pair",), LIGO_ATE_BOUND)
        launches = {k: 0 for k in fused_math.LAUNCHES}
        continuous = {}
        for label, (make_app, kernels, bound) in phases.items():
            counts, continuous[label] = replay_phase(torch, label, make_app(), path, gt, card, kernels,
                                                     bound)
            for k, v in counts.items():
                launches[k] += v
        for label, split in RESUME_AFTER.items():
            counts = resume_phase(torch, label, phases[label][0], path, split, continuous[label], card)
            for k, v in counts.items():
                launches[k] += v
    for e in entries:
        e["launches"] = launches[e["name"]]
    log(card)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
