"""Share of the profiled stretch (whole sweeps of the window) in which no
kernel, copy or fill ran on the device, from the torch.profiler trace."""


def read(run):
    st = run.stretch
    if st is None or st.window_s <= 0 or run.device.type != "cuda":
        return None
    return 100.0 * (1.0 - st.busy_s / st.window_s)
