"""Median device-timer ms of the port's ``smoother`` span (the window's
Gauss-Newton solve and the newest pose's marginal covariance, float64)
over the window's keyframes; None off the card, or without the span."""
from ._stage import median_ms


def read(run):
    return median_ms(run, "smoother") if run.device.type == "cuda" else None
