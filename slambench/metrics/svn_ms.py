"""Median device-timer ms of the port's ``svn`` span (the SVN particle flow
and the polish) over the window's keyframes."""
from ._stage import median_ms


def read(run):
    return median_ms(run, "svn")
