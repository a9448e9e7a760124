"""The readers of the odom cell's per-layer metrics (``newton_ms``,
``newton_busy_ms``, ``newton_syncs_per_kf``, ``smoother_ms``, ``blend_ms``)
on synthetic runs: nothing read off the card or without the span or
counter, the median or ratio with them; and the metric set each cell
reports."""
from collections import Counter

import pytest
import torch

from slambench import harness
from slambench import trace as trc
from slambench.metrics import blend_ms, newton_busy_ms, newton_ms, newton_syncs_per_kf, smoother_ms

from .conftest import CELL, ROOT

CUDA, CPU = torch.device("cuda"), torch.device("cpu")
ODOM = "odom_ndt_berlin.stadium"
SPANS = {newton_ms: "newton", smoother_ms: "smoother", blend_ms: "blend"}


@pytest.mark.parametrize("reader", list(SPANS), ids=lambda r: r.__name__.split(".")[-1])
def test_span_median_on_the_card_only(reader):
    span = SPANS[reader]
    stage = {span: [3.0, 1.0, 2.0, 10.0], "other": [100.0]}
    assert reader.read(harness.Run(stage_ms=stage, device=CUDA)) == pytest.approx(2.5)
    assert reader.read(harness.Run(stage_ms=stage, device=CPU)) is None
    assert reader.read(harness.Run(stage_ms={"other": [1.0]}, device=CUDA)) is None
    assert reader.read(harness.Run(stage_ms={span: []}, device=CUDA)) is None


def test_newton_busy_by_launch_time():
    """Two newton occurrences with 300 and 100 ns of kernels launched inside
    them, a smoother with 50 ns: the median of the newton ones; nothing
    without a card's trace or without a newton range."""
    host = [("newton", 100, 200), ("smoother", 300, 400), ("newton", 1000, 1100)]
    kernels = [("k", 150, 350, 120), ("k", 400, 500, 200), ("k", 600, 650, 310), ("k", 1200, 1300, 1050)]
    st = trc.Stretch(1e-5, 0.0, kernels, host, [], [], len(kernels))
    assert newton_busy_ms.read(harness.Run(stretch=st, device=CUDA)) == pytest.approx(2e-4)
    assert newton_busy_ms.read(harness.Run(stretch=st, device=CPU)) is None
    assert newton_busy_ms.read(harness.Run(stretch=None, device=CUDA)) is None
    bare = trc.Stretch(1e-5, 0.0, kernels, [("smoother", 300, 400)], [], [], len(kernels))
    assert newton_busy_ms.read(harness.Run(stretch=bare, device=CUDA)) is None


def test_newton_syncs_count_the_driver_sites_only():
    syncs = Counter({"newton.py:149": 30, "fused_math.py:549": 2, "regmap.py:126": 50, "odom_ndt.py:306": 16})
    run = harness.Run(syncs=syncs, sync_keyframes=16, device=CUDA)
    assert newton_syncs_per_kf.read(run) == pytest.approx(32 / 16)
    assert newton_syncs_per_kf.read(harness.Run(syncs=syncs, sync_keyframes=16, device=CPU)) is None
    assert newton_syncs_per_kf.read(harness.Run(syncs=syncs, sync_keyframes=0, device=CUDA)) is None
    assert newton_syncs_per_kf.read(harness.Run(syncs=Counter(), sync_keyframes=16, device=CUDA)) == 0.0


def test_each_cell_reports_its_metric_set():
    """The odom cell: the end-to-end metrics and exactly the per-layer ones
    named for it; the lo_svn cell: the set it had, the odom cell's own
    readers in none of it."""
    import os

    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))

    def names(cell, trace):
        return {m["name"] for m in harness.cell_metrics(bench, cell, trace)}

    assert names(ODOM, False) == {"rpe_mm", "setup_s", "keyframes_per_s", "pose_latency_p95_ms"}
    assert names(ODOM, True) == {"host_keyframes_per_s", "host_sweep_time_p95_ms", "ingest_ms", "host_syncs_per_kf",
                                 "map_build_ms", "pair_kernel_roofline", "device_idle_pct", "launches_per_kf",
                                 "map_build_busy_ms", "newton_ms", "newton_busy_ms", "newton_syncs_per_kf",
                                 "smoother_ms", "blend_ms"}
    assert names(CELL, False) == {"rpe_mm", "setup_s", "keyframes_per_s", "pose_latency_p95_ms"}
    assert names(CELL, True) == {"host_keyframes_per_s", "host_sweep_time_p95_ms", "ingest_ms", "host_syncs_per_kf",
                                 "map_build_ms", "svn_ms", "pair_kernel_roofline", "device_idle_pct",
                                 "launches_per_kf", "svn_busy_ms", "map_build_busy_ms", "svn_graph_replay_share"}


@pytest.mark.cuda
def test_traced_odom_run_on_the_card(cuda_device):
    """A --trace 1 run of the odom cell at its own length on the card reads
    every per-layer metric of the cell, and its check passes."""
    bench, cell, cfg, traffic = harness.load_cell(ODOM)
    metrics = harness.cell_metrics(bench, ODOM, True)
    r = harness.run_cell(ODOM, cfg, traffic, metrics, 2**31 + 5, float(bench["run_seconds"]), True, cuda_device)
    assert r["correct"], r["compared"]
    assert set(r["metrics"]) == {m["name"] for m in metrics}, r["metrics"]
    assert 0 < r["metrics"]["pair_kernel_roofline"]["value"] < 100
