"""Host waits for the device per keyframe, counted over the window's first
harness.CYCLE_SWEEPS sweeps (a whole cycle of the app's pose read-back)
under torch.cuda.set_sync_debug_mode("warn") at the port's own call sites
(its device timer's reads left out), as chip_smoke.sync_sites counts
them."""


def read(run):
    if run.device.type != "cuda" or not run.sync_keyframes:
        return None
    return sum(run.syncs.values()) / run.sync_keyframes
