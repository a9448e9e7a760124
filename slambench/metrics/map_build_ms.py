"""Median device-timer ms of the port's map + RegMap build span over the
window's rebuild keyframes (stream time from the stage's first to its last
enqueued work, the stream's waits on the host included)."""
from ._stage import median_ms


def read(run):
    return median_ms(run, run.map_span)
