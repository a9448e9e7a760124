"""One ``--trace 1`` run of a cell, as ``run.py`` makes it, with the port's
keyframe record (``DeviceStageTimer.trace_keyframes``) switched on after
the warm-up's ``flush()`` (``--record 1``) or left off (``--record 0``):

    python3 slambench/record_probe.py --workload <cell> --seed <n> --seconds <s> --record <0|1>

The harness does not switch the record on, so this script wraps the cell's
adapter (``apps/<app>.make``) to do so and keeps the harness's ``Run`` to
read the window's parts. It prints to standard error the host syncs by
source line (the sync-counted part), the device busy ms of every host range
in the profiled stretch, and with the record on the pose latency, device
lag and in-flight depths over the window's plain part and the clock check:
the median over the profiled keyframes of |done - end of the last kernel
launched before the keyframe's queued stamp| (each keyframe's signed
difference printed beside it, and the least and median time from a
kernel's launch call to its start on the profiler's clock, which a device
clock mapped early onto the host's makes negative). The last line of standard
output is one JSON object: these numbers, the card, and the run's
per-layer metrics and correctness.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def clock_offsets_ms(stamps, st, keys):
    """done - end of the last kernel launched before queued, a keyframe, ms."""
    launched = sorted((launch, e) for _, _, e, launch in st.kernels if launch is not None)
    times = np.asarray([x[0] for x in launched], np.int64)
    out = []
    for k in keys:
        s = stamps.get(k)
        if s is None or s.done is None or not times.size:
            continue
        i = int(np.searchsorted(times, s.queued, "right")) - 1
        if i >= 0:
            out.append(1e-6 * (s.done - launched[i][1]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--record", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", sub)
    os.environ["OMP_NUM_THREADS"] = "1"
    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(1)
    from slambench import harness
    from slambench.metrics import _busy
    from slamtpu_torch.runtime.device_timer import keyframe_summary

    bench, cell, cfg, traffic = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    adapter = importlib.import_module(f"slambench.apps.{cfg['app']}")
    make, apps, runs = adapter.make, [], []

    def make_recorded(cfg, device):
        app = make(cfg, device)
        apps.append(app)
        if args.record:
            def first_flush():  # the harness's first flush ends the warm-up
                del app.flush
                app.flush()
                app.device_timer.trace_keyframes()

            app.flush = first_flush
        return app

    class KeptRun(harness.Run):
        def __init__(self, **kw):
            super().__init__(**kw)
            runs.append(self)

    adapter.make, harness.Run = make_recorded, KeptRun
    metrics = harness.cell_metrics(bench, cell["name"], True)
    result = harness.run_cell(cell["name"], cfg, traffic, metrics, args.seed, args.seconds, True, "cuda",
                              t_start=T_START)
    run, timer = runs[0], apps[0].device_timer
    out = {"record": args.record, "seed": args.seed, "correct": result["correct"],
           "card": result["device"].get("card"),
           "metrics": {k: v["value"] for k, v in result["metrics"].items()}}
    print(f"host syncs by site over {run.sync_keyframes} keyframes: {dict(run.syncs.most_common())}",
          file=sys.stderr)
    out["syncs"] = dict(run.syncs.most_common())
    st = run.stretch
    if st is not None:
        busy = {}
        for name in sorted({n for n, _, _ in st.host_ranges}):
            ms = _busy.occurrence_kernel_ms(st, name)
            busy[name] = [round(sum(ms), 4), len(ms)]
        print(f"device busy ms (sum, occurrences) by host range over {len(run.stretch_kfs)} profiled keyframes: "
              f"{dict(sorted(busy.items(), key=lambda kv: -kv[1][0]))}", file=sys.stderr)
        out["busy_ms"] = busy
    if args.record and run.plain_returns:
        stamps = timer.keyframes()
        i0 = run.returns.index(run.plain_returns[0])
        plain = range(run.window_kfs.start + i0, run.window_kfs.start + i0 + len(run.plain_returns))
        summary = keyframe_summary(stamps, plain)
        print(f"keyframe record over the plain part (keyframes {plain.start}..{plain.stop - 1}): {summary}",
              file=sys.stderr)
        out["plain"] = summary
        if st is not None:
            offsets = clock_offsets_ms(stamps, st, run.stretch_kfs)
            print(f"done - end of the last kernel launched before queued, over {len(offsets)} profiled "
                  f"keyframes, ms: {[round(c, 4) for c in offsets]}", file=sys.stderr)
            out["clock_check_ms"] = float(np.median(np.abs(offsets))) if offsets else None
            starts = [1e-6 * (s - launch) for _, s, _, launch in st.kernels if launch is not None]
            if starts:
                out["launch_to_start_ms"] = [min(starts), float(np.median(starts))]
                print(f"kernel start - its launch call, ms: least {min(starts):.4f}, median "
                      f"{np.median(starts):.4f}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
