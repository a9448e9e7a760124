"""One run of one benchmark cell: set-up, the measured window, the check of
what the window produced, and the result.

The window drives the port's replay path over packets held in memory, as
``IngestPipeline.synced_frames`` drives it: each sweep's packets and INS
packets go through the app's ``FrameAssembler.push_packets`` (native batch
decode), ``AnppDecoder.push_packet`` and ``Synchronizer``, and each synced
frame into the app's ``process``. The loop is closed: the next sweep is
handed over as soon as ``process`` returns. The window ends with the app's
``flush()``, so every keyframe it counts has its pose on the host.

Everything that belongs to one configuration, traffic mix, metric or app is
found by name: ``configs/<config>.json`` (through ``BENCHMARK.json``),
``traffic/<traffic>.json``, ``metrics/<metric>.py``, ``apps/<app>.py`` (how
to build the port's app and read what it holds) and ``reference/<app>.py``
(its plain reference and the limits of the comparison).
"""
from __future__ import annotations

import gc
import importlib
import json
import os
import subprocess
import sys
import time
import warnings
from collections import Counter
from contextlib import nullcontext
from typing import List, Optional

import numpy as np
import torch

from . import kernel_costs
from . import sensor as sn
from . import trace as trc
from . import traffic as tr

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "slamtpu")
# A --trace 1 window: CYCLE_SWEEPS sweeps whose host syncs are counted (the
# sync debug mode slows the host while it is on); CYCLE_SWEEPS plain sweeps,
# which the host-clock readers read; then STRETCH_SWEEPS profiled sweeps,
# last because the profiler may leave the host slower. 64 is a whole cycle
# of lo_svn's in-flight queue (it reads its poses back every 64 keyframes),
# so each part holds one read-back; an app's adapter may set its own.
CYCLE_SWEEPS, STRETCH_SWEEPS = 64, 12
SAMPLE = 12  # keyframes the reference checks, drawn from the seed
SAMPLE_REBUILDS = 4  # of which rebuild keyframes


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, bench_file: str = None):
    """(benchmark, workload entry, configuration dict, traffic dict)."""
    bench = load_json(bench_file or os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(os.path.join(ROOT, conf["file"]))
    traffic = load_json(os.path.join(BENCH, "traffic", cell["traffic"] + ".json"))
    return bench, cell, cfg, traffic


def cell_metrics(bench, cell_name: str, trace: bool) -> List[dict]:
    """The metrics a run of the cell reports: its end-to-end metrics with
    ``--trace 0``, its per-layer metrics with ``--trace 1``."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", [cell_name])]


class Driver:
    """Feeds the traffic into the app, sweep by sweep."""

    def __init__(self, app, lap: tr.Lap, published):
        self.app = app
        self.published = published  # the app adapter's count of keyframes with a pose on the host
        self.feed = tr.Feed(lap)
        ing = app.ingest
        self.assembler, self.anpp, self.sync = ing.assembler, ing.anpp, ing.sync
        self.kf_sweeps: List[int] = []  # the global sweep of each keyframe, in order
        self.returns: List[float] = []  # host clock as each process() returns
        self.ingest_s: List[float] = []  # host seconds of each sweep's ingest
        self.handed: List[float] = []  # host clock as each keyframe's sweep starts to be handed over
        self.posed: List[float] = []  # host clock at the first return after which each keyframe is published

    def _ingest(self, events):
        out, batch = [], []

        def drain():
            for frame in self.assembler.push_packets(batch):
                out.extend(self.sync.push_scan(frame))
            batch.clear()

        for kind, payload in events:
            if kind == "L":
                batch.append(payload)
            else:
                if batch:
                    drain()
                nav = self.anpp.push_packet(payload)
                if nav is not None:
                    out.extend(self.sync.push_nav(nav))
        if batch:
            drain()
        return out

    def step(self, label: bool = False) -> int:
        """Hand over the next sweep; returns the keyframes it completed."""
        from torch.profiler import record_function

        rf = record_function if label else (lambda _name: nullcontext())
        g = self.feed.g
        events = self.feed.next_sweep()
        t = time.perf_counter()
        with rf("bench_ingest"):
            synced = self._ingest(events)
        self.ingest_s.append(time.perf_counter() - t)
        for s in synced:
            self.kf_sweeps.append(g - ((g - s.scan.frame_id) % 65536))
            self.handed.append(t)
            with rf("bench_process"):
                self.app.process(s)
            self.returns.append(time.perf_counter())
            self._note_published(self.returns[-1])
        return len(synced)

    def flush(self):
        """The app's flush(), after which every keyframe has its pose on the
        host."""
        self.app.flush()
        self._note_published(time.perf_counter())

    def _note_published(self, t: float):
        """Stamp ``t`` on each keyframe published since the last look: a
        count the app holds on the host, so the look reads nothing from the
        device and changes no schedule."""
        n = self.published(self.app)
        self.posed.extend([t] * (n - len(self.posed)))

    def pose_latency_s(self, k0: int, k1: int) -> List[float]:
        """Host seconds from hand-over to publication of keyframes k0..k1-1."""
        return [o - i for i, o in zip(self.handed[k0:k1], self.posed[k0:k1])]


class Record:
    """What the reference reads: the generated inputs, the configuration and
    what the port published."""

    def __init__(self, lap, cfg, kf_sweeps, published, device):
        self.lap, self.cfg, self.kf_sweeps = lap, cfg, list(kf_sweeps)
        self.published = published  # {keyframe: (rot, trans, cov)} host float64
        self.device = device


class Run:
    """What the metric readers read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def power_limit() -> Optional[str]:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def sample_keyframes(seed: int, window_kfs, every: int) -> List[int]:
    """Keyframes of the window that the reference checks: drawn from the
    seed, rebuild keyframes among them, and the window's last."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 7])
    ks = list(window_kfs)
    if not ks:
        return []
    rebuilds = [j for j in ks if (j - 1) % every == 0]
    others = [j for j in ks if (j - 1) % every != 0 and j != ks[-1]]
    pick = list(rng.choice(rebuilds, min(SAMPLE_REBUILDS, len(rebuilds)), replace=False))
    n_other = max(SAMPLE - len(pick) - 1, 0)
    pick += list(rng.choice(others, min(n_other, len(others)), replace=False))
    return sorted(set(int(j) for j in pick) | {ks[-1]})


def judge(numbers: dict, limits: dict) -> bool:
    """Whether every compared number is finite and within its limit."""
    return all(np.isfinite(numbers[k]) and numbers[k] <= lim for k, lim in limits.items())


def run_cell(name: str, cfg: dict, traffic: dict, metrics: List[dict], seed: int, seconds: float,
             trace: bool, device="cuda", t_start: float = None, n_sweeps: int = None,
             limits: dict = None) -> dict:
    """One run; returns the result line as a dict, the compared numbers
    under ``compared``. ``n_sweeps`` (tests) generates only that many
    sweeps, the window ending with them; ``limits`` (tests at a small size)
    replace the reference's."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    adapter = importlib.import_module(f"slambench.apps.{cfg['app']}")
    cycle = int(getattr(adapter, "CYCLE_SWEEPS", CYCLE_SWEEPS))
    reference = importlib.import_module(f"slambench.reference.{cfg['app']}")
    marks = [("imports", time.perf_counter())]
    app = adapter.make(cfg, device)
    marks.append(("app", time.perf_counter()))
    lap = tr.Lap(traffic, sn.Sensor.from_config(cfg["sensor"]), seed, device, n_sweeps=n_sweeps)
    _sync(device)
    marks.append(("traffic", time.perf_counter()))
    drv = Driver(app, lap, adapter.published)
    while len(drv.kf_sweeps) < int(cfg["warmup_keyframes"]):
        drv.step()
    drv.flush()
    _sync(device)
    marks.append(("warm-up", time.perf_counter()))
    setup_s = time.perf_counter() - t_start
    prev = t_start
    parts = []
    for what, t in marks:
        parts.append(f"{what} {t - prev:.3f} s")
        prev = t
    print("set-up: " + ", ".join(parts), file=sys.stderr)

    kf0, sw0 = len(drv.kf_sweeps), len(drv.ingest_s)
    timer_marks = {k: len(v) for k, v in app.device_timer.samples.items()}
    prof, stretch_prof, stretch_kf, sync_kf = None, None, (None, None), (kf0, kf0)
    caught: list = []
    t0 = time.perf_counter()
    plain = [None, None]  # (host clock, keyframes) where the plain part starts and ends
    i = 0
    counting = None
    # no collection pauses inside the window: what set-up made is frozen
    gc.collect()
    gc.freeze()
    gc.disable()
    host0 = _host_clocks()
    try:
        if trace and cuda:
            counting = warnings.catch_warnings(record=True)
            caught = counting.__enter__()
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            sync_kf = (kf0, None)
        while not drv.feed.exhausted():
            if trace and i == cycle:
                if counting is not None:
                    torch.cuda.set_sync_debug_mode("default")
                    counting.__exit__(None, None, None)
                    sync_kf = (sync_kf[0], len(drv.kf_sweeps))
                plain[0] = (time.perf_counter(), len(drv.kf_sweeps))
            if trace and i == 2 * cycle:
                plain[1] = (time.perf_counter(), len(drv.kf_sweeps))
                prof, stretch_cm, stretch_kf = _start_stretch(device, len(drv.kf_sweeps))
            drv.step(label=prof is not None)
            i += 1
            done = time.perf_counter() - t0 >= seconds or drv.feed.exhausted()
            if prof is not None and (i == 2 * cycle + STRETCH_SWEEPS or done):
                stretch_kf = (stretch_kf[0], len(drv.kf_sweeps))
                _stop_stretch(device, prof, stretch_cm)
                stretch_prof, prof = prof, None
            if done:
                break
        drv.flush()
        _sync(device)
        t1 = time.perf_counter()
        _print_host_share(host0, _host_clocks(), t1 - t0)
    finally:
        gc.enable()
        gc.unfreeze()
        if counting is not None and sync_kf[1] is None:
            torch.cuda.set_sync_debug_mode("default")
            counting.__exit__(None, None, None)
    kf1 = len(drv.kf_sweeps)
    if not trace:  # the whole window is plain
        plain = [(t0, kf0), (t1, kf1)]
    plain = [p or (t1, kf1) for p in plain]  # a --trace 1 window that closed early
    stretch = trc.summarize(stretch_prof) if stretch_prof is not None else None
    del stretch_prof
    if drv.returns[kf0:kf1]:
        fifths = np.histogram(np.asarray(drv.returns[kf0:kf1]) - t0, bins=5, range=(0, t1 - t0))[0]
        print(f"keyframes/s by fifth of the window: {[round(float(5 * n / (t1 - t0)), 3) for n in fifths]}",
              file=sys.stderr)
    latency_s = drv.pose_latency_s(kf0, kf1)
    if latency_s:
        p50, p95 = 1e3 * np.percentile(latency_s, [50, 95])
        print(f"pose latency, hand-over to publication, ms: p50 {p50:.6g}, p95 {p95:.6g}, "
              f"over {len(latency_s)} keyframes", file=sys.stderr)
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    traj = app.trajectory
    published = {j: (np.asarray(traj[j].pose.rot, np.float64), np.asarray(traj[j].pose.trans, np.float64),
                     None if traj[j].covariance is None else np.asarray(traj[j].covariance, np.float64))
                 for j in range(kf1)}
    ins = {j: (np.asarray(traj[j].ins_pose.rot, np.float64), np.asarray(traj[j].ins_pose.trans, np.float64))
           for j in range(kf0, kf1)}
    kept, ring = adapter.state(app)
    dev_mm = np.array([1e3 * np.linalg.norm(np.asarray(traj[j].pose.trans) - np.asarray(traj[j].ins_pose.trans))
                       for j in range(kf0, kf1)])
    if dev_mm.size:
        worst = np.argsort(dev_mm)[-3:][::-1]
        print(f"published - INS prior, mm: median {np.median(dev_mm):.4g}, p90 {np.percentile(dev_mm, 90):.4g}, "
              f"max {dev_mm.max():.4g} at keyframes {[int(kf0 + w) for w in worst]} "
              f"({[round(float(dev_mm[w]), 3) for w in worst]})", file=sys.stderr)
    stage_ms = {k: list(v[timer_marks.get(k, 0):]) for k, v in app.device_timer.samples.items()}
    timestamps = {j: traj[j].timestamp for j in range(kf0, kf1)}
    syncs = Counter(f"{os.path.basename(w.filename)}:{w.lineno}" for w in (caught or [])
                    if "synchroniz" in str(w.message) and f"slamtpu_torch{os.sep}" in w.filename
                    and not w.filename.endswith("device_timer.py"))
    del app, drv.app, traj
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    rec = Record(lap, cfg, drv.kf_sweeps, published, device)
    every = max(int(cfg["register"].get("map_rebuild_every", 1)), 1)
    sample = sample_keyframes(seed, range(kf0, kf1), every)
    mine = {j: published[j] for j in sample}
    theirs = reference.published(rec, sample)
    numbers = reference.gaps(mine, theirs)
    numbers.update(reference.point_gaps(rec, kept, ring, sample))
    for j in sample:
        one = reference.gaps({j: mine[j]}, theirs)
        print(f"keyframe {j} (sweep {rec.kf_sweeps[j]}{', rebuild' if (j - 1) % every == 0 else ''}): "
              + ", ".join(f"{k} {v:.6g}" for k, v in one.items()), file=sys.stderr)
    limits = reference.LIMITS if limits is None else limits
    correct = bool(sample) and judge(numbers, limits)
    for k in sorted(set(numbers) - set(limits)):
        print(f"{k} {numbers[k]!r} (printed, not compared)", file=sys.stderr)

    run = Run(name=name, cfg=cfg, seed=seed, seconds=seconds, setup_s=setup_s, t0=t0, t1=t1,
              window_s=t1 - t0, n_keyframes=kf1 - kf0, window_kfs=range(kf0, kf1),
              returns=drv.returns[kf0:kf1], pose_latency_s=latency_s, plain_t0=plain[0][0],
              plain_s=plain[1][0] - plain[0][0], plain_returns=drv.returns[plain[0][1]:plain[1][1]], ingest_s=drv.ingest_s[sw0:], stage_ms=stage_ms,
              map_span=adapter.MAP_SPAN, register_span=adapter.REGISTER_SPAN, rec=rec,
              timestamps=timestamps, syncs=syncs,
              sync_keyframes=(sync_kf[1] or kf1) - sync_kf[0] if counting else 0,
              stretch=stretch if trace else None,
              stretch_kfs=range(*stretch_kf) if trace and stretch_kf[0] is not None else range(0),
              kernel_work=None, peaks=None, device=device)
    if trace and run.stretch is not None:
        run.kernel_work = reference.kernel_work(rec, run.stretch_kfs, kernel_costs)
        kind = torch.cuda.get_device_name(device) if cuda else "cpu"
        run.peaks = load_json(os.path.join(BENCH, "peaks.json")).get(kind)
    from .metrics import rpe_mm

    ins_rpe = rpe_mm.rpe(run, ins)
    if ins_rpe is not None:
        print(f"rpe_mm of the INS prior over the same pairs: {ins_rpe!r}", file=sys.stderr)
    values = {}
    for m in metrics:
        reader = importlib.import_module(f"slambench.metrics.{m['name']}")
        v = reader.read(run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {
        "correct": bool(correct),
        "attempted": len(drv.ingest_s) - sw0,
        "failed": max(len(drv.ingest_s) - sw0 - (kf1 - kf0), 0),
        "metrics": values,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "count": 1,
            "memory_peak_bytes": peak,
        },
    }
    if cuda:
        result["device"]["card"] = power_limit()
    if trace and run.stretch is not None:
        result["device"]["busy_s"] = run.stretch.busy_s
        result["device"]["window_s"] = run.stretch.window_s
        result["breakdown"] = {"device_ops": run.stretch.top_ops(10),
                               "idle_gaps": [list(g) for g in run.stretch.gaps[:10]]}
    result["compared"] = {k: {"value": numbers[k], "limit": lim} for k, lim in limits.items()}
    return result


def _host_clocks():
    """(this thread's, this process's) CPU seconds."""
    return time.thread_time(), time.process_time()


def _print_host_share(a, b, wall):
    """How much of the window the main thread and the process spent on a
    CPU: near all of it means the host's own speed sets the rate."""
    print(f"host over the window: main thread on CPU {(b[0] - a[0]) / wall:.2%} of the wall time, "
          f"process {(b[1] - a[1]) / wall:.2%}", file=sys.stderr)


def _start_stretch(device, kf):
    from torch.profiler import ProfilerActivity, profile, record_function

    _sync(device)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    prof = profile(activities=acts)
    prof.__enter__()
    cm = record_function(trc.STRETCH)
    cm.__enter__()
    return prof, cm, (kf, None)


def _stop_stretch(device, prof, cm):
    _sync(device)
    cm.__exit__(None, None, None)
    prof.__exit__(None, None, None)


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
