"""Reading a ``torch.profiler`` trace of the profiled stretch of a window:
the device's busy intervals, kernel time by name, the host ranges
(``record_function``) each kernel was launched from, and the idle gaps
labelled by the range the host was in when the device went idle.

The stretch is the host range ``bench_stretch``; device activities are
kernels, copies and fills. A kernel is attributed to a host range by the
time of its launch call (the runtime event with its correlation id), or,
where the trace has no such link, by the device-side range around it.
"""
from __future__ import annotations

from collections import defaultdict
from typing import List, NamedTuple, Optional, Tuple

STRETCH = "bench_stretch"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_ACTIVITIES = ("cuda_runtime", "cuda_driver")


class Stretch(NamedTuple):
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, int, int, Optional[int]]]  # name, start ns, end ns, launch ns
    host_ranges: List[Tuple[str, int, int]]  # host record_function ranges in the stretch
    device_ranges: List[Tuple[str, int, int]]  # the same ranges on the device's timeline
    gaps: List[Tuple[str, float]]  # (host range at the gap's start, idle seconds), summed by range
    n_launches: int

    def range_kernel_s(self, name: str) -> float:
        """Device seconds of the kernels launched inside host range ``name``
        (by launch time), or inside its device-side range where no kernel
        has a launch time."""
        spans = [(s, e) for n, s, e in self.host_ranges if n == name]
        if any(k[3] is not None for k in self.kernels):
            tot = sum(e - s for _, s, e, launch in self.kernels
                      if launch is not None and any(a <= launch <= b for a, b in spans))
        else:
            dspans = [(s, e) for n, s, e in self.device_ranges if n == name]
            tot = sum(e - s for _, s, e, _ in self.kernels if any(a <= s and e <= b for a, b in dspans))
        return tot * 1e-9

    def top_ops(self, n: int = 10) -> List[list]:
        by = defaultdict(int)
        for name, s, e, _ in self.kernels:
            by[name] += e - s
        return [[k, v * 1e-9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _kinds(events):
    """Each event's activity: from ``activity_type()`` where the profiler
    has it, else from its device, ``is_user_annotation()`` and its name
    (operators carry a namespace, launch calls start with ``cu``)."""
    if events and hasattr(events[0], "activity_type"):
        return [e.activity_type() for e in events]
    host = []
    for e in events:
        if "CUDA" in str(e.device_type()):
            host.append(None)
            continue
        name = e.name()
        ann = getattr(e, "is_user_annotation", None)
        if ann is not None:
            user = ann()
        else:
            user = "::" not in name and not name.startswith("cu")
        host.append("user_annotation" if user else
                    "cuda_runtime" if name.startswith("cu") else "cpu_op")
    names = {e.name() for e, k in zip(events, host) if k == "user_annotation"}
    out = []
    for e, k in zip(events, host):
        if k is None:
            name = e.name()
            k = ("gpu_user_annotation" if name in names else "gpu_memcpy" if name.startswith("Memcpy")
                 else "gpu_memset" if name.startswith("Memset") else "kernel")
        out.append(k)
    return out


def summarize(prof) -> Optional[Stretch]:
    events = list(prof.profiler.kineto_results.events())
    host, dev_ranges, device, launch_at = [], [], [], {}
    for e, kind in zip(events, _kinds(events)):
        if kind == "user_annotation":
            host.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
        elif kind == "gpu_user_annotation":
            dev_ranges.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
        elif kind in LAUNCH_ACTIVITIES:
            launch_at[e.correlation_id()] = e.start_ns()
        elif kind in DEVICE_ACTIVITIES:
            device.append((e, kind))
    stretch = [(s, e) for n, s, e in host if n == STRETCH]
    if not stretch:
        return None
    w0, w1 = stretch[0]
    kernels, busy = [], []
    n_launch = 0
    for e, kind in device:
        s, t = max(e.start_ns(), w0), min(e.start_ns() + e.duration_ns(), w1)
        if t <= s:
            continue
        busy.append((s, t))
        if kind == "kernel":
            n_launch += 1
            launch = launch_at.get(e.correlation_id(), launch_at.get(e.linked_correlation_id()))
            kernels.append((e.name(), s, t, launch))
    merged = _union(busy)
    busy_ns = sum(t - s for s, t in merged)
    inner = [(n, s, e) for n, s, e in host if n != STRETCH and s < w1 and e > w0]
    # idle gaps, each labelled by the innermost host range open at its start
    gaps = defaultdict(int)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        open_ = [(e - s, n) for n, s, e in inner if s <= a < e]
        gaps[min(open_)[1] if open_ else "harness"] += b - a
    gap_list = [(k, v * 1e-9) for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])]
    return Stretch((w1 - w0) * 1e-9, busy_ns * 1e-9, kernels, inner,
                   [(n, s, e) for n, s, e in dev_ranges], gap_list, n_launch)
