"""Host copy of ``slamtpu/runtime/stats.py`` (numpy only, code unchanged).

The port cannot import it from ``slamtpu``: ``slamtpu/__init__.py``
imports JAX, so any ``import slamtpu.<module>`` pulls JAX in, and the
GPU port runs where JAX is absent. The docstring below is the
original's.

Per-keyframe statistics and observability (KeyFrameStats equivalent).

Mirrors the reference's per-keyframe record (reference include/
map.hpp:91-108, filled at run/pipeline.cpp:522-527, 667-673, 745-761):
alignment time, iteration counts, sigma vectors, INS vs optimized pose, and
pose RMSE — collected as plain dataclasses, exportable to CSV."""
from __future__ import annotations

import csv
import dataclasses
import time
from contextlib import contextmanager
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class KeyFrameStats:
    frame_id: int = 0
    timestamp: float = 0.0
    num_points: int = 0
    align_time_ms: float = 0.0
    ndt_iterations: int = 0
    converged: bool = False
    score: float = 0.0
    ins_sigma: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(6))
    scaled_sigma: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(6))
    lidar_sigma: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(6))
    optimized_sigma: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(6))
    ins_pose: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(7))  # qwxyz,t
    optimized_pose: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(7))
    pose_rmse: float = 0.0
    trust_weight: float = 1.0


class StatsArchive:
    def __init__(self):
        self.records: List[KeyFrameStats] = []

    def add(self, s: KeyFrameStats):
        self.records.append(s)

    def write_csv(self, path: str):
        if not self.records:
            return
        fields = [f.name for f in dataclasses.fields(KeyFrameStats)]
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(fields)
            for r in self.records:
                row = []
                for name in fields:
                    v = getattr(r, name)
                    row.append(
                        " ".join(f"{x:.9g}" for x in np.ravel(v))
                        if isinstance(v, np.ndarray)
                        else v
                    )
                w.writerow(row)


class StageTimer:
    """Named wall-clock spans (the reference prints per-SVN-iteration stage
    timings, svn_ndt_impl.hpp:880-891; we accumulate them instead)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.last: Dict[str, float] = {}  # most recent span, seconds

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            self.last[name] = dt

    def last_ms(self, name: str) -> float:
        return 1e3 * self.last.get(name, 0.0)

    def summary(self) -> str:
        return " | ".join(
            f"{k}: {1e3 * v / max(self.counts[k], 1):.2f}ms x{self.counts[k]}"
            for k, v in sorted(self.totals.items())
        )
