"""The ligo cell's own readers on hand-built runs: ``preintegrate_ms`` and
``fuse_ms`` (the median of their device-timer span on the card; None off it
or without the span); ``smoother_graph_replay_share`` reading the ligo
window's replay; and the metric set each cell reports."""
import os

import pytest
import torch

from slambench import harness
from slambench import trace as trc
from slambench.metrics import fuse_ms, preintegrate_ms, smoother_graph_replay_share

from .conftest import ROOT

LIGO, ODOM = "ligo_tc_berlin.stadium", "odom_ndt_berlin.stadium"


def _run(host_ranges):
    st = trc.Stretch(1e-6, 0.0, [], host_ranges, [], [], 0)
    return harness.Run(stretch=st)


@pytest.mark.parametrize("ranges, want", [
    # the full window: each keyframe's re-solve replays inside its smoother range
    ([("fuse", 100 * i, 100 * i + 60) for i in range(4)] + [("smoother", 100 * i + 5, 100 * i + 50) for i in range(4)]
     + [("smoother_graph_replay", 100 * i + 10, 100 * i + 20) for i in range(4)], 100.0),
    # the window still filling: eager, then three replays
    ([("smoother", 100 * i, 100 * i + 50) for i in range(4)]
     + [("smoother_graph_replay", 100 * i + 10, 100 * i + 20) for i in range(1, 4)], 75.0),
])
def test_the_window_replay_reads_as_the_smoother_replay(ranges, want):
    """The ligo window's replay span is the one ``smoother_graph_replay_share``
    reads (``WindowGraph``'s span, as odom's ``PoseWindowGraph``'s)."""
    from slamtpu_torch.apps import ligo_tc

    assert ligo_tc.WindowGraph().span == smoother_graph_replay_share.REPLAY
    assert smoother_graph_replay_share.read(_run(ranges)) == pytest.approx(want)


@pytest.mark.parametrize("reader, span", [(preintegrate_ms, "preintegrate"), (fuse_ms, "fuse")])
def test_span_medians_on_the_card_only(reader, span):
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert reader.read(harness.Run(stage_ms={span: [3.0, 1.0, 2.0, 9.0]}, device=cuda)) == 2.5
    assert reader.read(harness.Run(stage_ms={span: [3.0]}, device=cpu)) is None
    assert reader.read(harness.Run(stage_ms={"smoother": [3.0]}, device=cuda)) is None


def test_the_ligo_cell_reports_its_metrics():
    """A --trace 1 run of the ligo cell reports its own two metrics and the
    shared ones that read it, nothing of lo_svn's SVN stage or
    odom's blend; no other cell reports the ligo metrics."""
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))

    def names(cell, trace):
        return {m["name"] for m in harness.cell_metrics(bench, cell, trace)}

    assert names(LIGO, False) == {"rpe_mm", "setup_s", "keyframes_per_s", "pose_latency_p95_ms"}
    assert names(LIGO, True) == {
        "host_keyframes_per_s", "host_sweep_time_p95_ms", "ingest_ms", "host_syncs_per_kf", "map_build_ms",
        "map_build_busy_ms", "map_graph_replay_share", "newton_ms", "newton_busy_ms", "newton_syncs_per_kf",
        "smoother_ms", "pair_kernel_roofline", "device_idle_pct", "launches_per_kf", "preintegrate_ms", "fuse_ms",
        "smoother_graph_replay_share"}
    for cell in (ODOM, "lo_svn_berlin.stadium"):
        assert not {"preintegrate_ms", "fuse_ms"} & names(cell, True)
