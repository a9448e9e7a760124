"""Host copy of ``slamtpu/runtime/sync.py`` (numpy only, code unchanged).

The port cannot import it from ``slamtpu``: ``slamtpu/__init__.py``
imports JAX, so any ``import slamtpu.<module>`` pulls JAX in, and the
GPU port runs where JAX is absent. The docstring below is the
original's.

Time synchronization of LiDAR sweeps with the GNSS/INS stream.

Host-side port of the reference sync thread
(reference run/pipeline_lo_svn.cpp:196-289): each completed LiDAR sweep
defines the interval [previous keyframe end, this sweep end]; the INS stream
must cover it. The emitted SyncedFrame carries the sweep plus the INS samples
inside the interval, bracketed by frames interpolated exactly at both interval
ends (CompFrame::linearInterpolate semantics). A compass stream that starts
after the interval start is a data gap: the sweep is dropped (reference
":243-270").
"""
from __future__ import annotations

import dataclasses
import logging
from collections import deque
from typing import List, Optional

from ..ins.anpp import NavFrame, interpolate
from ..lidar.ouster import FrameGrid

log = logging.getLogger("slamtpu.sync")


@dataclasses.dataclass
class SyncedFrame:
    scan: FrameGrid
    ins: List[NavFrame]  # interpolated@start, inner samples, interpolated@end
    t_start: float
    t_end: float


def interpolate_at(window: List[NavFrame], t: float) -> NavFrame:
    """Piecewise-linear interpolation of the nav window at time t
    (reference getInterpolated, run/pipeline_lo_svn.cpp:200-215)."""
    if not window:
        return NavFrame()
    if t <= window[0].t:
        return window[0]
    if t >= window[-1].t:
        return window[-1]
    for a, b in zip(window, window[1:]):
        if a.t <= t <= b.t:
            u = (t - a.t) / (b.t - a.t) if (b.t - a.t) > 1e-9 else 0.0
            return interpolate(a, b, u)
    return window[-1]


class Synchronizer:
    """Feed nav frames and LiDAR sweeps (in time order per stream); collect
    SyncedFrames. The nav history holds ``nav_window`` most-recent samples
    (the reference uses a 24-frame sliding window at 50 Hz ~ 0.5 s)."""

    def __init__(self, nav_window: int = 256):
        self.nav: deque[NavFrame] = deque(maxlen=nav_window)
        self._pending: deque[FrameGrid] = deque()
        self._keyframe_ts: Optional[float] = None
        self.dropped_gaps = 0

    def push_nav(self, frame: NavFrame) -> List[SyncedFrame]:
        self.nav.append(frame)
        return self._drain()

    def push_scan(self, scan: FrameGrid) -> List[SyncedFrame]:
        if scan.num_columns < 2:
            log.warning("LiDAR frame %d has insufficient columns, skipping", scan.frame_id)
            return []
        if self._keyframe_ts is None:
            # first frame only sets the keyframe timestamp (reference :229-236)
            self._keyframe_ts = scan.timestamp_end
            return []
        self._pending.append(scan)
        return self._drain()

    def _drain(self) -> List[SyncedFrame]:
        out = []
        while self._pending:
            scan = self._pending[0]
            start = self._keyframe_ts
            end = scan.timestamp_end
            if not self.nav or self.nav[-1].t < end:
                break  # wait for more nav data
            window = list(self.nav)
            if window[0].t > start:
                log.error(
                    "CRITICAL: compass data gap — interval starts %.6f but data starts %.6f",
                    start,
                    window[0].t,
                )
                self.dropped_gaps += 1
                self._pending.popleft()
                self._keyframe_ts = end
                continue
            self._pending.popleft()
            self._keyframe_ts = end
            ins = [interpolate_at(window, start)]
            ins.extend(f for f in window if start < f.t < end)
            ins.append(interpolate_at(window, end))
            out.append(SyncedFrame(scan=scan, ins=ins, t_start=start, t_end=end))
        return out
