"""``map_graph_replay_share`` on hand-built stretches: the share of the
adapter's map-span host ranges (lo_svn ``map_rebuild``, odom ``map_build``)
holding a ``map_graph_replay`` range, and None where the stretch has no
such range, no replay at all, or there is no stretch; and the cells that
report it."""
import os

import pytest

from slambench import harness
from slambench import trace as trc
from slambench.apps import lo_svn as lo_svn_adapter
from slambench.apps import odom_ndt as odom_adapter
from slambench.metrics import map_graph_replay_share

from .conftest import CELL, ROOT

SPANS = [lo_svn_adapter.MAP_SPAN, odom_adapter.MAP_SPAN]


def _run(host_ranges, span):
    st = trc.Stretch(1e-6, 0.0, [], host_ranges, [], [], 0)
    return harness.Run(stretch=st, map_span=span)


@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("ranges, want", [
    # four builds, each replaying inside its map range
    (lambda m: [(m, 100 * i, 100 * i + 50) for i in range(4)]
     + [("map_graph_replay", 100 * i + 10, 100 * i + 20) for i in range(4)], 100.0),
    # the first build eager, three replays; other stages' ranges count for nothing
    (lambda m: [(m, 100 * i, 100 * i + 50) for i in range(4)] + [("newton", 60, 90), ("svn", 55, 95)]
     + [("map_graph_replay", 100 * i + 10, 100 * i + 20) for i in range(1, 4)], 75.0),
    # a replay outside every map range counts for none
    (lambda m: [(m, 0, 50), (m, 100, 150), ("map_graph_replay", 60, 70)], 0.0),
    # a replay that runs past its map range's end is not inside it
    (lambda m: [(m, 0, 50), (m, 100, 150), ("map_graph_replay", 40, 60), ("map_graph_replay", 110, 120)], 50.0),
])
def test_share_of_map_ranges_with_a_replay(ranges, want, span):
    assert map_graph_replay_share.read(_run(ranges(span), span)) == pytest.approx(want)


@pytest.mark.parametrize("span", SPANS)
def test_no_map_range_no_replay_or_no_stretch_reads_none(span):
    assert map_graph_replay_share.read(_run([("svn", 0, 10), ("map_graph_replay", 2, 3)], span)) is None
    # every build eager: a program without the replay path
    assert map_graph_replay_share.read(_run([(span, 0, 50), (span, 100, 150)], span)) is None
    assert map_graph_replay_share.read(harness.Run(stretch=None, map_span=span)) is None


def test_the_other_apps_span_is_not_read():
    """Each cell reads its own adapter's span: lo_svn's ``map_rebuild``
    ranges do not count in a run whose span is odom's ``map_build``."""
    ranges = [("map_rebuild", 0, 50), ("map_graph_replay", 10, 20)]
    assert map_graph_replay_share.read(_run(ranges, "map_build")) is None
    assert map_graph_replay_share.read(_run(ranges, "map_rebuild")) == pytest.approx(100.0)


def test_reported_in_both_cells_traced_runs():
    """A --trace 1 run of either cell reports the share; untraced runs do not."""
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))

    def names(cell, trace):
        return {m["name"] for m in harness.cell_metrics(bench, cell, trace)}

    for cell in (CELL, "odom_ndt_berlin.stadium"):
        assert "map_graph_replay_share" in names(cell, True)
        assert "map_graph_replay_share" not in names(cell, False)
