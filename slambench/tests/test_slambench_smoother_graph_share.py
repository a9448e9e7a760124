"""``smoother_graph_replay_share`` on hand-built stretches: the share of
``smoother`` host ranges holding a ``smoother_graph_replay`` range, and None
where the stretch has no ``smoother`` range, no replay at all, or there is
no stretch; and the cells that report it."""
import os

import pytest

from slambench import harness
from slambench import trace as trc
from slambench.metrics import smoother_graph_replay_share

from .conftest import CELL, ROOT


def _run(host_ranges):
    st = trc.Stretch(1e-6, 0.0, [], host_ranges, [], [], 0)
    return harness.Run(stretch=st)


@pytest.mark.parametrize("ranges, want", [
    # four keyframes, each replaying inside its smoother range
    ([("smoother", 100 * i, 100 * i + 50) for i in range(4)]
     + [("smoother_graph_replay", 100 * i + 10, 100 * i + 20) for i in range(4)], 100.0),
    # the first keyframe eager (the window still filling), three replays
    ([("smoother", 100 * i, 100 * i + 50) for i in range(4)] + [("newton", 60, 90)]
     + [("smoother_graph_replay", 100 * i + 10, 100 * i + 20) for i in range(1, 4)], 75.0),
    # a replay outside every smoother range counts for none
    ([("smoother", 0, 50), ("smoother", 100, 150), ("smoother_graph_replay", 60, 70)], 0.0),
    # a replay that runs past its smoother range's end is not inside it
    ([("smoother", 0, 50), ("smoother", 100, 150), ("smoother_graph_replay", 40, 60),
      ("smoother_graph_replay", 110, 120)], 50.0),
])
def test_share_of_smoother_ranges_with_a_replay(ranges, want):
    assert smoother_graph_replay_share.read(_run(ranges)) == pytest.approx(want)


def test_no_smoother_range_no_replay_or_no_stretch_reads_none():
    assert smoother_graph_replay_share.read(_run([("newton", 0, 10), ("smoother_graph_replay", 2, 3)])) is None
    # every keyframe eager: a program without the replay path
    assert smoother_graph_replay_share.read(_run([("smoother", 0, 50), ("smoother", 100, 150)])) is None
    assert smoother_graph_replay_share.read(harness.Run(stretch=None)) is None


def test_reported_in_the_odom_cell_only():
    """A --trace 1 run of the odom cell reports the share; the lo_svn cell's
    runs and the untraced runs do not."""
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))

    def names(cell, trace):
        return {m["name"] for m in harness.cell_metrics(bench, cell, trace)}

    assert "smoother_graph_replay_share" in names("odom_ndt_berlin.stadium", True)
    assert "smoother_graph_replay_share" not in names(CELL, True)
    assert "smoother_graph_replay_share" not in names("odom_ndt_berlin.stadium", False)
