"""Host waits for the device per keyframe at the Newton driver's host-read
sites (``ndt/newton.py``, whose exit test reads the iteration count and the
convergence flag once an outer iteration, and ``ndt/fused_math.py``),
counted as ``host_syncs_per_kf`` counts every site of the port, over the
same keyframes."""

SITES = ("newton.py", "fused_math.py")


def read(run):
    if run.device.type != "cuda" or not run.sync_keyframes:
        return None
    return sum(n for site, n in run.syncs.items() if site.split(":")[0] in SITES) / run.sync_keyframes
