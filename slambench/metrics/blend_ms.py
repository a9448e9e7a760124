"""Median device-timer ms of the port's ``blend`` span (the deviation gate
and the geodesic blend of the registration toward its seed) over the
window's keyframes; None off the card, or without the span (a program that
times the blend inside ``covariance``)."""
from ._stage import median_ms


def read(run):
    return median_ms(run, "blend") if run.device.type == "cuda" else None
