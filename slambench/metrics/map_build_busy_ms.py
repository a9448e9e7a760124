"""Median, over the occurrences of the port's map + RegMap build span
(``map_rebuild``, one a rebuild keyframe) in the profiled stretch, of the
device ms of the kernels launched inside it: the build's busy time on the
card, where ``map_build_ms`` spans the stream from the stage's first to its
last work, waits on the host included."""
from ._busy import median_ms


def read(run):
    return median_ms(run, run.map_span)
