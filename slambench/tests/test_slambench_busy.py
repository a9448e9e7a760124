"""The per-occurrence busy readers (``svn_busy_ms``, ``map_build_busy_ms``)
on synthetic profiled stretches: kernels attributed to each occurrence of a
host range by their launch times, or by the range's device-side occurrence
where the trace links no launch; nothing read without a card's trace."""
import pytest
import torch

from slambench import harness
from slambench import trace as trc
from slambench.metrics import _busy, map_build_busy_ms, svn_busy_ms

CUDA = torch.device("cuda")


def _stretch(kernels, host_ranges, device_ranges=()):
    return trc.Stretch(1e-5, 0.0, kernels, list(host_ranges), list(device_ranges), [], len(kernels))


def _run(st, device=CUDA):
    return harness.Run(stretch=st, device=device, register_span="svn", map_span="map_rebuild")


def test_busy_by_launch_time():
    """Three svn occurrences with 300, 100 and 1000 ns of kernels launched
    inside (one kernel launched at an occurrence's last ns), one map
    build with 50 ns; a kernel launched between ranges and one on each
    side count for none; the kernels' own times may lie past the range."""
    host = [("svn", 100, 200), ("svn", 1000, 1100), ("map_rebuild", 2000, 2100), ("svn", 3000, 3100)]
    kernels = [
        ("k", 150, 350, 120), ("k", 400, 500, 200),  # svn 1: 200 + 100
        ("k", 1200, 1300, 1050),  # svn 2: 100
        ("k", 1400, 1450, 1500),  # between ranges
        ("k", 2300, 2350, 2010),  # map_rebuild: 50
        ("k", 3100, 4100, 3000),  # svn 3: 1000
        ("k", 5000, 5200, 3200), ("k", 10, 20, 5),  # after, before every range
    ]
    st = _stretch(kernels, host)
    assert _busy.occurrence_kernel_ms(st, "svn") == pytest.approx([3e-4, 1e-4, 1e-3])
    assert svn_busy_ms.read(_run(st)) == pytest.approx(3e-4)
    assert map_build_busy_ms.read(_run(st)) == pytest.approx(5e-5)
    # the occurrences sum to what range_kernel_s reads over the whole range
    assert sum(_busy.occurrence_kernel_ms(st, "svn")) == pytest.approx(1e3 * st.range_kernel_s("svn"))


def test_busy_by_device_range_without_launch_links():
    dev = [("svn", 100, 400), ("svn", 1000, 1100)]
    kernels = [("k", 100, 200, None), ("k", 300, 400, None), ("k", 1000, 1040, None), ("k", 1090, 1200, None)]
    st = _stretch(kernels, [("svn", 0, 50), ("svn", 900, 950)], dev)
    # the last kernel ends past its occurrence: it counts for none
    assert _busy.occurrence_kernel_ms(st, "svn") == pytest.approx([2e-4, 4e-5])
    assert svn_busy_ms.read(_run(st)) == pytest.approx(1.2e-4)


def test_nothing_to_read():
    st = _stretch([("k", 150, 350, 120)], [("svn", 100, 200)])
    assert map_build_busy_ms.read(_run(st)) is None  # no rebuild in the stretch
    assert svn_busy_ms.read(_run(st, torch.device("cpu"))) is None
    assert svn_busy_ms.read(_run(None)) is None
