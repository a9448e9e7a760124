"""Keyframes the port published over the host's wall time (host clock), in
the window's plain part: with --trace 1 the harness.CYCLE_SWEEPS sweeps
after those whose syncs are counted, before the profiler starts. The
end-to-end rate is keyframes_per_s, over the whole --trace 0 window; this
one reads the traced run beside the per-layer spans."""


def read(run):
    n = len(run.plain_returns)
    return n / run.plain_s if n else None
