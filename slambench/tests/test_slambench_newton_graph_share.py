"""``newton_graph_replay_share`` on hand-built stretches: the share of
``newton`` host ranges holding a ``newton_graph_replay`` range (all
replayed, none, part), and None where the stretch has no ``newton`` range,
no replay at all, or there is no stretch; and the cells that report it."""
import os

import pytest

from slambench import harness
from slambench import trace as trc
from slambench.metrics import newton_graph_replay_share

from .conftest import CELL, ROOT


def _run(host_ranges):
    st = trc.Stretch(1e-6, 0.0, [], host_ranges, [], [], 0)
    return harness.Run(stretch=st)


def _replays(i, n=3):
    """Registration i's ``n`` outer iterations, each a replay inside it."""
    return [("newton_graph_replay", 100 * i + 10 * j + 5, 100 * i + 10 * j + 8) for j in range(n)]


@pytest.mark.parametrize("ranges, want", [
    # all replayed: four registrations, each with its outer iterations replayed inside its newton range
    ([("newton", 100 * i, 100 * i + 50) for i in range(4)] + sum((_replays(i) for i in range(4)), []), 100.0),
    # part: the first registration eager (its key's eager call and capture), three replayed;
    # other stages' ranges count for nothing
    ([("newton", 100 * i, 100 * i + 50) for i in range(4)] + [("map_build", 60, 90), ("smoother", 55, 95)]
     + sum((_replays(i) for i in range(1, 4)), []), 75.0),
    # none: a replay outside every newton range counts for none
    ([("newton", 0, 50), ("newton", 100, 150), ("newton_graph_replay", 60, 70)], 0.0),
    # a replay that runs past its newton range's end is not inside it
    ([("newton", 0, 50), ("newton", 100, 150), ("newton_graph_replay", 40, 60),
      ("newton_graph_replay", 110, 120)], 50.0),
])
def test_share_of_newton_ranges_with_a_replay(ranges, want):
    assert newton_graph_replay_share.read(_run(ranges)) == pytest.approx(want)


def test_no_newton_range_no_replay_or_no_stretch_reads_none():
    # no newton span: lo_svn registers with SVN
    assert newton_graph_replay_share.read(_run([("svn", 0, 10), ("newton_graph_replay", 2, 3)])) is None
    # every registration eager: a program without the replay path
    assert newton_graph_replay_share.read(_run([("newton", 0, 50), ("newton", 100, 150)])) is None
    assert newton_graph_replay_share.read(harness.Run(stretch=None)) is None


def test_reported_in_the_newton_cells_traced_runs():
    """A --trace 1 run of the odom or ligo cell reports the share; the lo_svn
    cell's runs and the untraced runs do not."""
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))

    def names(cell, trace):
        return {m["name"] for m in harness.cell_metrics(bench, cell, trace)}

    for cell in ("odom_ndt_berlin.stadium", "ligo_tc_berlin.stadium"):
        assert "newton_graph_replay_share" in names(cell, True)
        assert "newton_graph_replay_share" not in names(cell, False)
    assert "newton_graph_replay_share" not in names(CELL, True)
