"""Median host ms of one sweep's ingest: the benchmark's own span around
the calls into the port's FrameAssembler.push_packets, AnppDecoder and
Synchronizer for the sweep."""
import numpy as np


def read(run):
    return 1e3 * float(np.median(run.ingest_s)) if run.ingest_s else None
