"""``svn_graph_replay_share`` on hand-built stretches: the share of ``svn``
host ranges holding a ``svn_graph_replay`` range, and None where the
stretch has no ``svn`` range, no replay at all, or there is no stretch."""
import pytest

from slambench import harness
from slambench import trace as trc
from slambench.metrics import svn_graph_replay_share


def _run(host_ranges):
    st = trc.Stretch(1e-6, 0.0, [], host_ranges, [], [], 0)
    return harness.Run(stretch=st, register_span="svn")


@pytest.mark.parametrize("ranges, want", [
    # four keyframes, each replaying inside its svn range
    ([("svn", 100 * i, 100 * i + 50) for i in range(4)]
     + [("svn_graph_replay", 100 * i + 10, 100 * i + 20) for i in range(4)], 100.0),
    # the first keyframe eager (its stage ranges), three replays
    ([("svn", 100 * i, 100 * i + 50) for i in range(4)] + [("svn_gather", 5, 8), ("svn_retract", 9, 12)]
     + [("svn_graph_replay", 100 * i + 10, 100 * i + 20) for i in range(1, 4)], 75.0),
    # a replay outside every svn range counts for none
    ([("svn", 0, 50), ("svn", 100, 150), ("svn_graph_replay", 60, 70)], 0.0),
    # a replay that runs past its svn range's end is not inside it
    ([("svn", 0, 50), ("svn", 100, 150), ("svn_graph_replay", 40, 60), ("svn_graph_replay", 110, 120)], 50.0),
])
def test_share_of_svn_ranges_with_a_replay(ranges, want):
    assert svn_graph_replay_share.read(_run(ranges)) == pytest.approx(want)


def test_no_svn_range_no_replay_or_no_stretch_reads_none():
    assert svn_graph_replay_share.read(_run([("map_rebuild", 0, 10), ("svn_graph_replay", 2, 3)])) is None
    # every keyframe eager: a program without the replay path
    assert svn_graph_replay_share.read(_run([("svn", 0, 50), ("svn_gather", 5, 8), ("svn", 100, 150)])) is None
    assert svn_graph_replay_share.read(harness.Run(stretch=None, register_span="svn")) is None
