"""95th percentile, over every sweep of the window's plain part (with
--trace 1 the harness.CYCLE_SWEEPS sweeps after those whose syncs are
counted, before the profiler starts), of the host time between
consecutive returns of the app's process() (the first from the part's
start): one sweep's ingest, decode and keyframe step as the sensor's feed
sees it."""
import numpy as np


def read(run):
    if len(run.plain_returns) < 2:
        return None
    times = np.diff(np.concatenate([[run.plain_t0], run.plain_returns]))
    return 1e3 * float(np.percentile(times, 95))
