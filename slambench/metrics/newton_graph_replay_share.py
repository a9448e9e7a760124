"""Share, in percent, of the port's Newton driver spans (``newton``, one a
registration) in the profiled stretch inside which the outer iterations ran
as CUDA graph replays (a ``newton_graph_replay`` host range within the
``newton`` range): how often the captured graph engages. None where the
stretch has no ``newton`` range, or no replay at all (a program without
the graph path)."""

SPAN, REPLAY = "newton", "newton_graph_replay"


def read(run):
    st = run.stretch
    if st is None:
        return None
    spans = [(s, e) for n, s, e in st.host_ranges if n == SPAN]
    if not spans:
        return None
    replays = [(s, e) for n, s, e in st.host_ranges if n == REPLAY]
    if not replays:  # a program without the replay path
        return None
    hit = sum(any(a <= s and e <= b for s, e in replays) for a, b in spans)
    return 100.0 * hit / len(spans)
