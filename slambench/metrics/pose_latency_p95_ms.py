"""95th percentile, over the keyframes of the --trace 0 window, of the host
time from a keyframe's hand-over (the host clock as harness.Driver.step
starts the ingest of the sweep that completes it) to the first return of the
app's process(), or of the window's closing flush(), after which the app has
published it (the adapter's published()): packets in to pose out, as the
vehicle sees it, the harness's own packet generation left out. The warm-up's
keyframes are not counted."""
import numpy as np


def read(run):
    return 1e3 * float(np.percentile(run.pose_latency_s, 95)) if run.pose_latency_s else None
