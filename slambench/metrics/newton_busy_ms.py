"""Median, over the occurrences of the port's ``newton`` span (one a
keyframe) in the profiled stretch, of the device ms of the kernels
launched inside it: the Newton driver's busy time on the card, where
``newton_ms`` spans the stream from the stage's first to its last work,
waits on the host included."""
from ._busy import median_ms


def read(run):
    return median_ms(run, "newton")
