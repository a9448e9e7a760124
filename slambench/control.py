"""Readings of the comparison that decides ``correct``, for its limits: the
control and the planted faults, each judged as a run's output is.

    python3 slambench/control.py --workload <cell> --seeds 11 12 13 --control [--window 90]
    python3 slambench/control.py --workload <cell> --seeds 11 12 13 --faults unchanged half [--seconds 8]

``--control`` puts the reference in the port's place, computed in float32
with every matrix product's inputs rounded to TF32, the precision below the
configuration's (float32, TF32 off): for each seed it generates the cell's
traffic, samples the keyframes of a window of ``--window`` keyframes after
the warm-up as a run does, and compares that control's poses, covariances
and points with the float64 reference's.

``--faults`` runs the cell (``harness.run_cell``, a window of ``--seconds``)
with the port broken underneath by one planted fault at a time:

- ``unchanged``: the keyframe step returns its state unchanged, so the
  published pose is the INS prior and the covariance the particles' initial
  spread;
- ``half``: half of each sweep's points left out (every other column);
- ``unpolished``: the plane-to-plane polish skipped, so the SVN particles'
  mean is published;
- ``altered``: each published pose moved by 5 mm where the step produces it.

Each line is JSON, with ``correct`` as ``harness.judge`` decides it. It runs
on the device the cell would (CUDA), or with ``--device cpu`` at whatever
size the configuration gives.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cell(cell):
    from slambench import harness

    return harness.load_cell(cell) if isinstance(cell, str) else cell


def control_readings(cell, seeds, window, device, limits=None):
    import torch

    from slambench import harness
    from slambench import sensor as sn
    from slambench import traffic as tr
    from slambench.reference import common as c

    _, _, cfg, traffic = _cell(cell)
    ref_mod = harness.importlib.import_module(f"slambench.reference.{cfg['app']}")
    limits = ref_mod.LIMITS if limits is None else limits
    dev = torch.device(device)
    out = []
    for seed in seeds:
        t = time.perf_counter()
        kf0 = int(cfg["warmup_keyframes"])
        n_sweeps = kf0 + window + 2
        long_lap = traffic["course"].get("sweeps_per_lap", 0) <= n_sweeps
        lap = tr.Lap(traffic, sn.Sensor.from_config(cfg["sensor"]), seed, dev,
                     n_sweeps=None if long_lap else n_sweeps)
        rec = harness.Record(lap, cfg, list(range(1, n_sweeps)), {}, dev)
        every = max(int(cfg["register"].get("map_rebuild_every", 1)), 1)
        window_kfs = range(kf0, kf0 + window)
        sample = harness.sample_keyframes(seed, window_kfs, every)
        numbers = ref_mod.gaps(ref_mod.published(rec, sample, c.TF32), ref_mod.published(rec, sample))
        # its points: the counts it keeps and its ring of the window's last clouds
        ref = ref_mod.Reference(rec, c.TF32)
        W = int(cfg["register"]["keyframe_window"])
        kept = {j: int(ref.sweep(j)[1].sum()) for j in sample}
        ring = {}
        for j in window_kfs[-W:]:
            p, m, prior = ref.sweep(j)
            ring[j] = (c.transform(prior, p, c.TF32).double().cpu().numpy(), m.cpu().numpy())
        numbers.update(ref_mod.point_gaps(rec, kept, ring, sample))
        row = {"seed": seed, "keyframes": sample, "control": numbers,
               "correct": harness.judge({k: numbers[k] for k in limits}, limits),
               "seconds": time.perf_counter() - t}
        out.append(row)
        print(json.dumps(row), flush=True)
    return out


# --- faults planted in the port's timed path; ``patch(obj, name, value)`` ---


def _edit_step(patch, edit):
    from slamtpu_torch.apps import lo_svn

    step = lo_svn._lo_svn_step_packed

    def broken(*a, **k):
        regmap, res = step(*a, **k)
        return regmap, edit(res, prior=a[5])

    patch(lo_svn, "_lo_svn_step_packed", broken)


def unchanged(patch):
    import torch
    from slamtpu_torch.ndt import svn

    def edit(res, prior):
        cov = torch.diag(torch.tensor(svn.INIT_SIGMAS, dtype=prior.rot.dtype, device=prior.rot.device) ** 2)
        return res._replace(pose=prior, covariance=cov)

    _edit_step(patch, edit)


def half(patch):
    import torch
    from slamtpu_torch.apps import lo_svn

    project = lo_svn.project_frame_packed

    def broken(packed, *a, **k):
        scan = project(packed, *a, **k)
        sub = scan.mask.shape[0] // packed.shape[0]
        keep = (torch.arange(scan.mask.shape[0], device=scan.mask.device) // sub) % 2 == 0
        mask = scan.mask & keep
        return scan._replace(mask=mask, num_points=torch.sum(mask.to(torch.int32)).to(torch.int32))

    patch(lo_svn, "project_frame_packed", broken)


def unpolished(patch):
    from slamtpu_torch.apps import lo_svn

    step = lo_svn._lo_svn_step_packed

    def broken(*a, **k):
        a = list(a)
        a[14] = a[14]._replace(polish_iters=0)  # the SvnConfig
        return step(*a, **k)

    patch(lo_svn, "_lo_svn_step_packed", broken)


def altered(patch):
    import torch

    def edit(res, prior):
        shift = torch.tensor([0.005, 0.0, 0.0], dtype=res.pose.trans.dtype, device=res.pose.trans.device)
        return res._replace(pose=res.pose._replace(trans=res.pose.trans + shift))

    _edit_step(patch, edit)


FAULTS = {"unchanged": unchanged, "half": half, "unpolished": unpolished, "altered": altered}


def fault_readings(cell, seeds, seconds, device, faults, limits=None, n_sweeps=None):
    from slambench import harness

    bench, cellw, cfg, traffic = _cell(cell)
    metrics = harness.cell_metrics(bench, cellw["name"], False)
    out = []
    for fault in faults:
        for seed in seeds:
            undo = []

            def patch(obj, name, value):
                undo.append((obj, name, getattr(obj, name)))
                setattr(obj, name, value)

            FAULTS[fault](patch)
            try:
                r = harness.run_cell(cellw["name"], cfg, traffic, metrics, seed, seconds, False, device,
                                     n_sweeps=n_sweeps, limits=limits)
            finally:
                for obj, name, value in reversed(undo):
                    setattr(obj, name, value)
            row = {"fault": fault, "seed": seed, "correct": r["correct"],
                   "compared": {k: v["value"] for k, v in r["compared"].items()}}
            out.append(row)
            print(json.dumps(row), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--window", type=int, default=90)
    ap.add_argument("--faults", nargs="*", default=[], choices=sorted(FAULTS))
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    if args.control:
        control_readings(args.workload, args.seeds, args.window, args.device)
    if args.faults:
        fault_readings(args.workload, args.seeds, args.seconds, args.device, args.faults)
    return 0


if __name__ == "__main__":
    sys.exit(main())
