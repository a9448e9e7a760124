"""Per-stage times of the device path without host syncs, and each
keyframe's life on the host's clock.

On a CUDA device each span records a pair of CUDA events on the current
stream; the times are read (one synchronize per event) only when a summary
is asked for. A span then measures the stream's time from the stage's
first enqueued work to its last, including any gap where the stream waited
for the host. On the CPU, work runs as it is issued and spans read the host
clock.

Every span also runs under a ``torch.profiler.record_function`` of its
name, so a profiler trace (``--profile``) splits the keyframe by stage
under the reference's scope names; with no timer, ``span`` opens that
alone.

The keyframe record (``trace_keyframes``, off by default) keeps four stamps
a keyframe in Unix-epoch nanoseconds, the clock of ``time.time_ns()`` and
of ``torch.profiler``'s events: ``begin`` as the app's ``process`` is
entered, ``queued`` once the keyframe's device work is all enqueued,
``done`` when the stream finished that work, and ``published`` when the
keyframe's pose is on the host. ``done`` comes from a CUDA event recorded
at ``queued``, placed on the host's clock by an anchor: an event the host
waits for and stamps as it completes, taken when the record is switched on
and at each ``collect`` (the apps' ``flush``). Off, each hook is one
attribute test.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, Iterable, List, NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

KEYFRAME_CAP = 4096  # keyframes the record keeps, the newest


class KeyframeStamps(NamedTuple):
    """One keyframe's stamps, ns since the Unix epoch (None: not yet, or
    never for this app: ins_map publishes no pose)."""

    begin: Optional[int]
    queued: Optional[int]
    done: Optional[int]
    published: Optional[int]


class DeviceStageTimer:
    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self._pending: list = []  # (name, start event, end event)
        self.samples: Dict[str, List[float]] = {}
        self._kf: Optional[Dict[int, list]] = None  # keyframe -> [begin, queued, done, published]; None: off
        self._kf_cap = KEYFRAME_CAP
        self._kf_events: list = []  # (keyframe, event recorded at its queued stamp), not yet placed
        self._anchor = None  # (event, ns at which the host saw it complete)

    @contextmanager
    def span(self, name: str):
        with record_function(name), self._timed(name):
            yield

    @contextmanager
    def _timed(self, name: str):
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self._pending.append((name, start, end))
        else:
            t0 = time.perf_counter()
            yield
            self.samples.setdefault(name, []).append(1e3 * (time.perf_counter() - t0))

    def collect(self):
        """Read the recorded events into ``samples`` (waits for them), and
        place the keyframes' ``done`` stamps."""
        for name, start, end in self._pending:
            end.synchronize()
            self.samples.setdefault(name, []).append(start.elapsed_time(end))
        self._pending.clear()
        if self._kf is not None and self.cuda:
            anchor, ns = self._anchor
            self._anchor = _take_anchor()
            for k, ev in self._kf_events:
                if k in self._kf:
                    self._kf[k][2] = ns + round(anchor.elapsed_time(ev) * 1e6)
            self._kf_events.clear()

    def summary(self, skip_first: int = 0) -> Dict[str, dict]:
        """{stage: {"median_ms", "mean_ms", "n"}} over the spans after the
        first ``skip_first`` of each stage."""
        self.collect()
        out = {}
        for name, ms in self.samples.items():
            ms = ms[skip_first:] or ms
            out[name] = {"median_ms": float(np.median(ms)), "mean_ms": float(np.mean(ms)), "n": len(ms)}
        return out

    def trace_keyframes(self, cap: int = KEYFRAME_CAP):
        """Switch the keyframe record on, empty, keeping the newest ``cap``
        keyframes."""
        self._kf, self._kf_cap, self._kf_events = {}, int(cap), []
        if self.cuda:
            self._anchor = _take_anchor()

    def keyframe_begin(self, k: int):
        if self._kf is None:
            return
        self._kf[k] = [time.time_ns(), None, None, None]
        if len(self._kf) > self._kf_cap:
            del self._kf[next(iter(self._kf))]

    def keyframe_queued(self, k: int):
        if self._kf is None:
            return
        entry = self._kf.get(k)
        if entry is None:
            return
        entry[1] = time.time_ns()
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._kf_events.append((k, ev))
        else:  # on the CPU the work ran as it was issued
            entry[2] = entry[1]

    def keyframe_published(self, k: int):
        if self._kf is None:
            return
        entry = self._kf.get(k)
        if entry is not None:
            entry[3] = time.time_ns()

    def keyframes(self) -> Dict[int, KeyframeStamps]:
        """The record, oldest keyframe first ({} when it is off); places the
        ``done`` stamps first, waiting for the device."""
        if self._kf is None:
            return {}
        self.collect()
        return {k: KeyframeStamps(*v) for k, v in self._kf.items()}


def span(timer, name: str):
    """``timer.span(name)``, or only the profiler's span when ``timer`` is None."""
    return timer.span(name) if timer is not None else record_function(name)


def _take_anchor():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    ev.synchronize()
    return ev, time.time_ns()


def keyframe_summary(stamps: Dict[int, KeyframeStamps], keys: Optional[Iterable[int]] = None) -> dict:
    """Over the keyframes ``keys`` of ``stamps`` (default: all but the first,
    which only seeds the apps): pose latency (published - begin) p50 and
    p95 ms, device lag (done - queued) p95 ms, and the in-flight depths at
    each begin as (max, mean): on the host, keyframes of the record queued
    and not yet published; on the device, keyframes queued and not yet
    done. A quantity with nothing to read is None."""
    keys = list(stamps)[1:] if keys is None else [k for k in keys if k in stamps]
    sel = [stamps[k] for k in keys]

    def pct(vals, q):
        return float(np.percentile(vals, q)) * 1e-6 if vals else None

    lat = [s.published - s.begin for s in sel if s.published is not None]
    lag = [s.done - s.queued for s in sel if s.done is not None and s.queued is not None]
    begins = np.asarray([s.begin for s in sel], np.float64)

    def depth(end_field):
        # queued <= end for every keyframe, so the keyframes queued by b and
        # not ended by b number #(queued <= b) - #(end <= b)
        queued = np.sort([s.queued for s in stamps.values() if s.queued is not None]).astype(np.float64)
        ends = np.sort([np.inf if getattr(s, end_field) is None else getattr(s, end_field)
                        for s in stamps.values() if s.queued is not None]).astype(np.float64)
        if not begins.size or not np.isfinite(ends).any():
            return None
        d = np.searchsorted(queued, begins, "right") - np.searchsorted(ends, begins, "right")
        return int(d.max()), float(d.mean())

    return {"keyframes": len(sel), "pose_latency_p50_ms": pct(lat, 50), "pose_latency_p95_ms": pct(lat, 95),
            "device_lag_p95_ms": pct(lag, 95), "host_in_flight": depth("published"),
            "device_in_flight": depth("done")}
