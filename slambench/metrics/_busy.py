"""Device ms of the kernels launched inside each occurrence of one of the
port's host ranges (``record_function``) in the profiled stretch: a stage's
busy time on the card, apart from the stream's waits on the host that the
device-timer spans include. A kernel belongs to an occurrence by the time
of its launch call, as ``trace.Stretch.range_kernel_s`` attributes it, or,
where no kernel has a launch time, by lying inside the range's device-side
occurrence."""
import numpy as np


def occurrence_kernel_ms(st, name):
    """[device ms of each occurrence of range ``name``], in time order."""
    linked = [(launch, e - s) for _, s, e, launch in st.kernels if launch is not None]
    if linked:
        launch, dur = np.asarray(sorted(linked), np.int64).reshape(-1, 2).T
        csum = np.concatenate([[0], np.cumsum(dur)])
        spans = sorted((s, e) for n, s, e in st.host_ranges if n == name)
        return [1e-6 * float(csum[np.searchsorted(launch, b, "right")] - csum[np.searchsorted(launch, a, "left")])
                for a, b in spans]
    spans = sorted((s, e) for n, s, e in st.device_ranges if n == name)
    return [1e-6 * sum(e - s for _, s, e, _ in st.kernels if a <= s and e <= b) for a, b in spans]


def median_ms(run, name):
    """Median over the occurrences of ``name`` in the run's profiled
    stretch, or None without a card's trace or an occurrence."""
    st = run.stretch
    if st is None or run.device.type != "cuda":
        return None
    ms = occurrence_kernel_ms(st, name)
    return float(np.median(ms)) if ms else None
