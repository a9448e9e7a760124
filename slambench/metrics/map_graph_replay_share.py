"""Share, in percent, of the port's map + RegMap build spans (the adapter's
``MAP_SPAN``: lo_svn ``map_rebuild``, one a rebuild keyframe; odom
``map_build``, one a keyframe) in the profiled stretch inside which the
build ran as a CUDA graph replay (a ``map_graph_replay`` host range within
the span's range): how often the captured graph engages. None where the
stretch has no such span, or no replay at all (a program without the graph
path)."""

REPLAY = "map_graph_replay"


def read(run):
    st = run.stretch
    if st is None:
        return None
    spans = [(s, e) for n, s, e in st.host_ranges if n == run.map_span]
    if not spans:
        return None
    replays = [(s, e) for n, s, e in st.host_ranges if n == REPLAY]
    if not replays:  # a program without the replay path
        return None
    hit = sum(any(a <= s and e <= b for s, e in replays) for a, b in spans)
    return 100.0 * hit / len(spans)
