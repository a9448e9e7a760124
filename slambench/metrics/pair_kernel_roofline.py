"""Share of the roofline of the registration's pair-kernel work in the
profiled stretch. The operations and bytes come from the configuration
(K, call counts) and the benchmark's own reference map at each keyframe's
published pose (``reference.<app>.kernel_work`` with ``kernel_costs``);
the least time is the larger of operations over the fp32 peak and bytes
over the memory peak (``peaks.json``). The time is the device time of the
kernels launched inside the port's registration span (``svn`` or
``newton``), so a kernel that replaces the pair kernel under another name
still counts."""


def read(run):
    st, work, peaks = run.stretch, run.kernel_work, run.peaks
    if st is None or work is None or not peaks or run.device.type != "cuda":
        return None
    t = st.range_kernel_s(run.register_span)
    if t <= 0:
        return None
    ops, nbytes = work
    return 100.0 * max(ops / peaks["fp32_flops_s"], nbytes / peaks["bytes_s"]) / t
