"""Median device-timer ms of the port's ``preintegrate`` span (the
sweep's IMU samples integrated into the deltas, their bias Jacobians and
the 15 x 15 noise covariance, and the prediction, float64) over the
window's keyframes; None off the card, or without the span."""
from ._stage import median_ms


def read(run):
    return median_ms(run, "preintegrate") if run.device.type == "cuda" else None
