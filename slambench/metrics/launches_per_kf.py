"""Kernel launches in the profiled stretch over its keyframes."""


def read(run):
    st = run.stretch
    n = len(run.stretch_kfs)
    if st is None or not n or run.device.type != "cuda":
        return None
    return st.n_launches / n
