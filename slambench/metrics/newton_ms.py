"""Median device-timer ms of the port's ``newton`` span (the Newton NDT
driver: its row lookups, pair-kernel evaluations, solves and exit reads)
over the window's keyframes; None off the card, or without the span."""
from ._stage import median_ms


def read(run):
    return median_ms(run, "newton") if run.device.type == "cuda" else None
