"""Median device-timer ms of the port's ``fuse`` span (the whole window
re-solve of the tightly coupled app: the factor arrays assembled on the
host, their copy, the solve and marginal, and the read of the solution)
over the window's keyframes; None off the card, or without the span."""
from ._stage import median_ms


def read(run):
    return median_ms(run, "fuse") if run.device.type == "cuda" else None
