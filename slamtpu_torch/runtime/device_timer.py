"""Per-stage times of the device path without host syncs.

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
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function


class DeviceStageTimer:
    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self._pending: list = []  # (name, start event, end event)
        self.samples: Dict[str, List[float]] = {}

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
        """Read the recorded events into ``samples`` (waits for them)."""
        for name, start, end in self._pending:
            end.synchronize()
            self.samples.setdefault(name, []).append(start.elapsed_time(end))
        self._pending.clear()

    def summary(self, skip_first: int = 0) -> Dict[str, dict]:
        """{stage: {"median_ms", "mean_ms", "n"}} over the spans after the
        first ``skip_first`` of each stage."""
        self.collect()
        out = {}
        for name, ms in self.samples.items():
            ms = ms[skip_first:] or ms
            out[name] = {"median_ms": float(np.median(ms)), "mean_ms": float(np.mean(ms)), "n": len(ms)}
        return out


def span(timer, name: str):
    """``timer.span(name)``, or only the profiler's span when ``timer`` is None."""
    return timer.span(name) if timer is not None else record_function(name)
