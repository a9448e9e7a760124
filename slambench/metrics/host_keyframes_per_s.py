"""Keyframes the port published over the host's wall time (host clock), in
the window's plain part: with --trace 1 the harness.CYCLE_SWEEPS sweeps
after those whose syncs are counted, before the profiler starts. It stands
per layer: the rate is set by the host's speed, which spreads too widely
between runs for an end-to-end bound."""


def read(run):
    n = len(run.plain_returns)
    return n / run.plain_s if n else None
