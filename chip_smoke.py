#!/usr/bin/env python3
"""Smoke run of the PyTorch port (slamtpu_torch) on one CUDA card.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit, torch's device name).
2. Builds the CUDA pair kernels from slamtpu_torch/csrc (nvcc, into
   build/slamtpu_torch/) and prints the build time and the ptxas report.
3. Kernel phase: a Gaussian map from one simulated Berlin-shape sweep
   (2048 x 128 beams, stride 4: N = 65,536 points) at its true pose, the
   next sweep's mega rows gathered from it; each kernel against its plain
   PyTorch version on the card (the NDT pair kernel for K = 20 particle
   poses, the VGICP pair kernel against the map's ``gicp_map`` rows and the
   plane-to-plane kernel, both for K = 1), with max errors and device times
   per call (CUDA events around 20 back-to-back calls; median of 10 such
   rounds, kernel and plain version in turns).
4. lo_svn phase: ``LoSvnApp(cfg, "cuda").run_replay`` over a 12-sweep skewed
   replay at the Berlin operating point; checks that the NDT and
   plane-to-plane kernels launched, that every pose is finite and that the
   ATE against ground truth is below 5 mm.
5. odom phase: ``OdomNdtApp(cfg, "cuda", window=6).run_replay`` over the
   same replay with the NDT_OMP engine (Newton over the NDT pair kernel)
   and with the isotropic GICP engine (Newton over the VGICP pair kernel);
   checks that the engine's kernel launched, that every pose and
   covariance is finite and that the ATE is below the engine's bound.
Each replay phase prints the ATE, steady-state keyframes/s, iteration
counts, host syncs per keyframe and per-stage device times.

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
# ATE bounds of the odom phase. The reference's ATE on this replay is not
# measured (running the JAX app at this width is for an accelerator). NDT_OMP:
# 5 mm (the reference read 0.0022 m over 30 sweeps of this replay family).
# Isotropic GICP: 50 mm. The engine is coarse on this replay family in the
# reference itself: at 1024 x 64 beams, stride 2, 8 sweeps, the reference
# read 0.104 m on the CPU and the port 0.099 m; at this width the port
# read 0.034 m on the card.
ODOM_ATE_BOUND = {"NDT_OMP": 0.005, "GICP": 0.050}
ODOM_KERNEL = {"NDT_OMP": "ndt_pair", "GICP": "gicp_pair"}
TIMED_ROUNDS, TIMED_LAUNCHES = 10, 20
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


def odom_cfg(tconfig, cfg, method):
    """The odom_ndt operating point of bench.py's odom_berlin mode on the
    same sensor (resolution 1.0, 20 iterations, capacity 2^15, at least 4
    points per voxel, grid (160, 160, 32), deskew on, 2 Newton steps per
    gather)."""
    import dataclasses

    return dataclasses.replace(cfg, register=tconfig.RegisterConfig(
        method=method, ndt_resolution=1.0, ndt_max_iterations=20, map_capacity=1 << 15,
        min_points_per_voxel=4, reg_grid_shape=ODOM_GRID,
    ))


def time_ms(fn, torch):
    """Device ms per call, from CUDA events around TIMED_LAUNCHES calls."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
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


def kernel_phase(torch, replay_path, gt, cfg, dev, card):
    """Map from one sweep at its true pose, rows for the next; each kernel
    against its plain version. Returns the kernels' JSON entries."""
    import numpy as np

    from slamtpu_torch.apps.common import IngestPipeline, maybe_deskew
    from slamtpu_torch.core import se3
    from slamtpu_torch.core.se3 import Pose3
    from slamtpu_torch.mapping.gaussian_map import build_map
    from slamtpu_torch.ndt import fused_math
    from slamtpu_torch.ndt.constants import gauss_constants
    from slamtpu_torch.ndt.gicp import gicp_map, regularize_plane_covariance, stencil_point_covariances
    from slamtpu_torch.ndt.regmap import build_regmap
    from slamtpu_torch.ndt.svn import INIT_SIGMAS

    ing = IngestPipeline(cfg, dev)
    frames = ing.synced_frames(replay_path)
    a, b = next(frames), next(frames)  # synced frames k end at sweep k + 1
    ref_lla = np.asarray(a.ins[-1].lla)

    def world_scan(synced, k):
        scan = maybe_deskew(ing.project(synced), synced, ref_lla, True)
        R, p = gt[k]
        pose = Pose3(torch.as_tensor(R, dtype=torch.float32, device=dev),
                     torch.as_tensor(p, dtype=torch.float32, device=dev))
        return scan, pose

    scan_a, pose_a = world_scan(a, 1)
    scan_b, pose_b = world_scan(b, 2)
    res = cfg.register.svn_resolution
    origin = torch.floor(pose_a.trans / res) * res - 512.0 * res
    gmap = build_map(se3.transform_points(pose_a, scan_a.points), scan_a.mask, origin, res,
                     capacity=cfg.register.map_capacity, min_points_per_voxel=4)
    aux = torch.cat([gmap.mean, regularize_plane_covariance(gmap.cov).reshape(-1, 9)], dim=1)
    regmap = build_regmap(gmap, grid_shape=GRID, aux_payload=aux)
    N = scan_b.points.shape[0]
    ptsT = scan_b.points.t().contiguous()
    megaT = fused_math.gather_megaT(scan_b.points, scan_b.mask, pose_b, regmap, GRID)
    megaT_aux = fused_math.gather_megaT(scan_b.points, scan_b.mask, pose_b, regmap, GRID, table="aux")
    regmap_g = build_regmap(gicp_map(gmap, 0.05), grid_shape=GRID)
    megaT_g = fused_math.gather_megaT(scan_b.points, scan_b.mask, pose_b, regmap_g, GRID)
    scovT = stencil_point_covariances(
        scan_b.points, scan_b.mask, (cfg.meta.columns_per_frame, ing.luts.subset_channels)
    ).reshape(N, 9).t().contiguous()
    log(f"kernel phase: N={N} points, {int(scan_b.num_points)} kept, "
        f"{int(gmap.num_valid())} map voxels, overflow {int(regmap.overflow)}")

    K = cfg.register.svn_particles
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    sig = torch.tensor(INIT_SIGMAS, device=dev)
    xi = sig * torch.randn((K, 6), generator=g, device=dev)
    particles = se3.retract(Pose3(pose_b.rot.expand(K, 3, 3), pose_b.trans.expand(K, 3)), xi)
    d1, d2, _ = gauss_constants(res, cfg.register.svn_outlier_ratio)
    p_ndt = fused_math.pose_params(particles, d1, d2)
    p_aniso = fused_math.pose_params(Pose3(pose_b.rot[None], pose_b.trans[None]), 0.0, 25.0)
    # the VGICP pair at the 5 m default gate and the 3-sigma trim
    p_gicp = fused_math.pose_params(Pose3(pose_b.rot[None], pose_b.trans[None]), 0.0, 25.0, 9.0,
                                    gicp=True)
    cases = [
        ("ndt_pair", lambda: fused_math.ndt_pair(p_ndt, ptsT, megaT),
         lambda: fused_math._ndt_pair_plain(p_ndt, ptsT, megaT), K,
         "slamtpu/ndt/pallas_math.py:37 (_kernel, gicp=False; pallas_call :371)"),
        ("gicp_pair", lambda: fused_math.gicp_pair(p_gicp, ptsT, megaT_g),
         lambda: fused_math._gicp_pair_plain(p_gicp, ptsT, megaT_g), 1,
         "slamtpu/ndt/pallas_math.py:37 (_kernel, gicp=True, :96-103; pallas_call :371)"),
        ("aniso_pair", lambda: fused_math.aniso_pair(p_aniso, ptsT, megaT_aux, scovT),
         lambda: fused_math._aniso_pair_plain(p_aniso, ptsT, megaT_aux, scovT), 1,
         "slamtpu/ndt/pallas_math.py:185 (_kernel_aniso; pallas_call :355)"),
    ]
    entries = []
    for name, kern, plain, k, replaces in cases:
        out = kern()
        torch.cuda.synchronize()
        ref = plain()
        torch.cuda.synchronize()
        max_err = compare(out, ref)
        assert torch.isfinite(out).all() and float(out[:, 43].min()) > 0, (name, out[:, 43])
        # runs repeat bit for bit: no atomics in the reduction
        assert torch.equal(kern(), out), f"{name} is not deterministic"
        for _ in range(3):
            kern(), plain()
        t_k, t_p = [], []
        for i in range(TIMED_ROUNDS):  # in turns: plain, kernel, kernel, plain, ...
            order = ((plain, t_p), (kern, t_k)) if i % 2 == 0 else ((kern, t_k), (plain, t_p))
            for fn, acc in order:
                acc.append(time_ms(fn, torch))
        ms, plain_ms = statistics.median(t_k), statistics.median(t_p)
        log(f"[{card}] {name}: K={k} N={N} max_abs_err={max_err:.6g} (score {float(ref[0, 0]):.7g}, "
            f"count {int(ref[0, 43])}) kernel {ms:.4f} ms (rounds {min(t_k):.4f}..{max(t_k):.4f}), "
            f"plain {plain_ms:.4f} ms (rounds {min(t_p):.4f}..{max(t_p):.4f}); median over "
            f"{TIMED_ROUNDS} rounds of {TIMED_LAUNCHES} back-to-back calls")
        entries.append({
            "name": name, "route": "cuda", "source": "slamtpu_torch/csrc/ndt_pair.cu",
            "replaces": replaces, "launches": 0, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms,
        })
    return entries


def replay_phase(torch, label, app, replay_path, gt, card, kernels, ate_bound):
    """``app.run_replay`` with every launch count at 0 and a warning on
    every host sync; checks that ``kernels`` launched, that every pose and
    covariance is finite and that the ATE is below ``ate_bound``. Returns
    the launch counts of the run."""
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
        phases = [("lo_svn", lambda: LoSvnApp(cfg, dev), ("ndt_pair", "aniso_pair"), 0.005)]
        for method in ODOM_KERNEL:
            phases.append((f"odom {method}",
                           lambda m=method: OdomNdtApp(odom_cfg(tconfig, cfg, m), dev, window=6),
                           (ODOM_KERNEL[method],), ODOM_ATE_BOUND[method]))
        launches = {k: 0 for k in fused_math.LAUNCHES}
        for label, make_app, kernels, bound in phases:
            for k, v in replay_phase(torch, label, make_app(), path, gt, card, kernels, bound).items():
                launches[k] += v
    for e in entries:
        e["launches"] = launches[e["name"]]
    log(card)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
