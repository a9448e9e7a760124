"""Command-line entry: run any app on a replay file (port of
slamtpu/__main__.py, with the same flags, defaults and output files, and a
``--device``).

    python -m slamtpu_torch lo_svn --replay run.rpl --out out/
    python -m slamtpu_torch odom_ndt --replay run.rpl --loop-closure
    python -m slamtpu_torch odom_ndt --replay run.rpl --meta meta.json \\
        --lidar lidar.json --imu imu.json --register register.json

Every flag has a default; without config files the Berlin preset with
synthetic OS-2-128 metadata is used. The apps run on ``--device`` (default
``cuda``); without a card that fails, naming the flag, and never falls back
to the CPU. Outputs in ``--out``: ``trajectory.tum``, ``trajectory.npz``
and ``keyframe_stats.csv`` (lo_svn, odom_ndt, ligo_tc), the ``ndt_map_*``
files (ins_map), ``compass.csv`` (calib_compass), ``scan_*.ply``
(viz_lidar), and with ``--profile`` a ``torch.profiler`` trace,
``torch_trace.json``. ``--profile`` also switches on the apps' keyframe
record (``runtime.device_timer``): lo_svn, odom_ndt, ligo_tc and ins_map
print at exit, beside the ``stages:`` line, the pose latency p50 and p95
(sweep handed in to pose on the host), the device lag p95 (work queued to
work done on the card) and the most keyframes in flight on the host and on
the device.

Importing this module starts no CUDA context: the apps import, and the
device is checked, inside ``main``.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys

APPS = ["lo_svn", "odom_ndt", "ligo_tc", "ins_map", "calib_compass", "viz_lidar"]


def _viz_hold(viewer, hold_s: float) -> None:
    """Keep serving the viewer after the replay finishes: 0 returns at once
    (the daemon server ends with the process), a positive value sleeps that
    many seconds, a negative one blocks until Ctrl-C (the reference's viewer
    thread join at shutdown, run/pipeline.cpp:975-985)."""
    import time

    if hold_s == 0:
        return
    print(f"replay done; viewer still serving at {viewer.url}" + ("" if hold_s > 0 else " (Ctrl-C to exit)"))
    try:
        if hold_s > 0:
            time.sleep(hold_s)
        else:
            viewer.wait_forever()
    except KeyboardInterrupt:
        pass


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="slamtpu_torch")
    p.add_argument("app", choices=APPS)
    p.add_argument("--replay", required=True, help="replay file (runtime.replay format)")
    p.add_argument("--out", default="out", help="output directory")
    p.add_argument("--device", default="cuda",
                   help="torch device of the keyframe path (default cuda; cpu runs the plain versions)")
    p.add_argument("--meta", help="Ouster metadata JSON")
    p.add_argument("--lidar", help="lidar parameter JSON")
    p.add_argument("--imu", help="IMU config JSON")
    p.add_argument("--register", help="registration config JSON")
    p.add_argument("--max-keyframes", type=int, default=10**9)
    p.add_argument("--publish", default="svn", choices=["svn", "ins"], help="lo_svn only")
    p.add_argument("--anchor", default="ins", choices=["ins", "odom"],
                   help="lo_svn only: pose at which keyframe clouds enter the target ring")
    p.add_argument("--method", choices=["NDT_OMP", "SVNNDT", "GICP", "NDT_OMP_MULTIRES"],
                   help="odom_ndt only: override the registration engine "
                   "(default: registration_method from --register)")
    p.add_argument("--loop-closure", action="store_true",
                   help="odom_ndt only: detect loop closures and run the pose-graph refinement")
    p.add_argument("--resume", help="ins_map / lo_svn: resume from a checkpoint (.npz)")
    p.add_argument("--save-checkpoint", help="ins_map / lo_svn: write a checkpoint (.npz)")
    p.add_argument("--profile", action="store_true", help="write a torch.profiler trace")
    p.add_argument("--viz", action="store_true",
                   help="serve a live point-cloud/trajectory viewer on localhost "
                   "(the reference's PCL visualizer threads, run/pipeline.cpp:826-985)")
    p.add_argument("--viz-port", type=int, default=8433)
    p.add_argument("--viz-hold", type=float, default=0.0,
                   help="seconds to keep serving the viewer after the replay finishes "
                   "(0 exits immediately; negative holds until Ctrl-C)")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def _record_line(timer) -> str:
    """The keyframe record's summary as the command line prints it."""
    from .runtime.device_timer import keyframe_summary

    s = keyframe_summary(timer.keyframes())

    def ms(v):
        return "none" if v is None else f"{v:.3f} ms"

    def most(v):
        return "none" if v is None else str(v[0])

    return (f"keyframes: {s['keyframes']} after the first; pose latency p50 {ms(s['pose_latency_p50_ms'])}, "
            f"p95 {ms(s['pose_latency_p95_ms'])}; device lag p95 {ms(s['device_lag_p95_ms'])}; in flight at "
            f"most {most(s['host_in_flight'])} on the host, {most(s['device_in_flight'])} on the device")


def _device(name: str):
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"slamtpu_torch: --device {name}: torch.cuda.is_available() is False "
                         "(no CUDA card); pass --device cpu to run on the CPU")
    return device


def main(argv=None):
    args = _parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO if args.verbose else logging.WARNING)
    device = _device(args.device)
    os.makedirs(args.out, exist_ok=True)

    from .apps.common import VizHook
    from .runtime import checkpoint
    from .runtime.config import PipelineConfig
    from .runtime.export import write_trajectory_tum
    from .runtime.stats import StatsArchive

    viewer = None
    if args.viz:
        from .runtime.viewer import LiveViewer

        viewer = LiveViewer(port=args.viz_port)
        print(f"live viewer: {viewer.url}")

    def hooks(app):
        """The viewer's hook and, with --profile, the keyframe record."""
        if viewer is not None:
            app.viz = VizHook(viewer)
        if args.profile:
            app.device_timer.trace_keyframes()
        return app

    if args.meta:
        cfg = PipelineConfig.from_files(args.meta, args.lidar, args.imu, args.register)
    else:
        cfg = PipelineConfig.berlin()

    prof = None
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU]
                       + ([ProfilerActivity.CUDA] if device.type == "cuda" else []))
        prof.__enter__()
    try:
        if args.app == "calib_compass":
            from .apps import CalibCompassApp

            app = CalibCompassApp()
            frames = app.run_replay(args.replay, args.max_keyframes)
            app.export(os.path.join(args.out, "compass.csv"))
            print(f"decoded {len(frames)} nav frames -> {args.out}/compass.csv")
            return 0
        if args.app == "viz_lidar":
            from .apps import VizLidarApp

            app = VizLidarApp(cfg, device)
            frames = app.run_replay(args.replay, min(args.max_keyframes, 1000))
            for i, fr in enumerate(frames[:10]):
                n = app.export_frame(fr, os.path.join(args.out, f"scan_{i:04d}.ply"))
                print(f"frame {fr.frame_id}: {n} points")
            if viewer is not None:
                hook = VizHook(viewer)
                for fr in frames:
                    viewer.push_cloud(hook.subsample(app.project(fr)), fr.frame_id)
                _viz_hold(viewer, args.viz_hold)
            return 0
        if args.app == "ins_map":
            from .apps import InsMapApp

            app = hooks(InsMapApp(cfg, device))
            if args.resume:
                app.resume_from(args.resume)
            traj = app.run_replay(args.replay, args.max_keyframes)
            if args.save_checkpoint:
                app.save_checkpoint(args.save_checkpoint)
            app.finalize_and_export(os.path.join(args.out, "ndt_map"))
        elif args.app == "lo_svn":
            from .apps import LoSvnApp

            app = hooks(LoSvnApp(cfg, device, publish=args.publish, anchor=args.anchor))
            if args.resume:
                app.resume_from(args.resume)
            traj = app.run_replay(args.replay, args.max_keyframes)
            if args.save_checkpoint:
                app.save_checkpoint(args.save_checkpoint)
        elif args.app == "odom_ndt":
            from .apps import OdomNdtApp

            app = hooks(OdomNdtApp(cfg, device, loop_closure=args.loop_closure, method=args.method))
            traj = app.run_replay(args.replay, args.max_keyframes)
            if args.loop_closure:
                _, closures = app.refine_loop_closures()
                print(f"loop closures: {len(closures)}")
        else:  # ligo_tc
            from .apps import LigoTcApp

            app = hooks(LigoTcApp(cfg, device))
            traj = app.run_replay(args.replay, args.max_keyframes)

        stamps, poses = [e.timestamp for e in traj], [e.pose for e in traj]
        write_trajectory_tum(os.path.join(args.out, "trajectory.tum"), stamps, poses)
        checkpoint.save_trajectory(os.path.join(args.out, "trajectory.npz"), stamps, poses,
                                   [e.frame_id for e in traj])
        if isinstance(getattr(app, "stats", None), StatsArchive):
            app.stats.write_csv(os.path.join(args.out, "keyframe_stats.csv"))
        if hasattr(app, "timer"):
            print("stages:", app.timer.summary())
        if args.profile:
            print(_record_line(app.device_timer))
        print(f"{args.app}: {len(traj)} keyframes -> {args.out}/trajectory.tum")
        if viewer is not None:
            _viz_hold(viewer, args.viz_hold)
        return 0
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(os.path.join(args.out, "torch_trace.json"))
        if viewer is not None:
            viewer.close()


if __name__ == "__main__":
    sys.exit(main())
