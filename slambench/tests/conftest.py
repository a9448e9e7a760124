"""Shared pieces of the benchmark's own tests: a configuration cut to a size
the CPU can run, and the ``cuda`` fixture that skips a test without a card.
The decision to skip is taken inside the fixture, when a test runs."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CELL = "lo_svn_berlin.stadium"


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


def small_cell(cols=512, pix=64, particles=4, cell=CELL):
    """(benchmark, cell, configuration, traffic) of ``<config>.<traffic>``,
    read from their files, with the sensor (and lo_svn's particle count) cut
    so that a run takes seconds on the CPU."""
    from slambench import harness

    config, traffic_name = cell.split(".")
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cfg = harness.load_json(os.path.join(ROOT, "slambench", "configs", config + ".json"))
    traffic = harness.load_json(os.path.join(ROOT, "slambench", "traffic", traffic_name + ".json"))
    cellw = {"name": cell, "config": config, "traffic": traffic_name, "chips": 1}
    cfg["sensor"].update(columns_per_frame=cols, pixels_per_column=pix)
    if cfg["app"] == "lo_svn":
        cfg["register"].update(map_capacity=1 << 15, svn_particles=particles)
    return bench, cellw, cfg, traffic
