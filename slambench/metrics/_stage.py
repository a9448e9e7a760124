"""Median of one device-timer span of the port over the window."""
import numpy as np


def median_ms(run, span):
    ms = run.stage_ms.get(span)
    return float(np.median(ms)) if ms else None
