"""What the benchmark loads: no JAX and no JAX package anywhere in a run
(top-level module names compared whole: ``slamtpu_torch`` is not
``slamtpu``), nothing of the port in the traffic generator or the
reference, and no result without a card or without the port."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from .conftest import ROOT

RUN = os.path.join(ROOT, "slambench", "run.py")


def _python(code, cwd=ROOT, timeout=600):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_a_run_loads_no_jax():
    code = """
import json, sys, torch
torch.set_num_threads(2)
from slambench import harness
from slambench.tests.conftest import small_cell
bench, cell, cfg, traffic = small_cell(128, 32, 2)
r = harness.run_cell(cell["name"], cfg, traffic, harness.cell_metrics(bench, cell["name"], False),
                     5, 1e9, False, "cpu", n_sweeps=14)
import slambench.control, slambench.trace
print(json.dumps({"forbidden": harness.forbidden_modules(),
                  "top": sorted({m.split('.')[0] for m in sys.modules})}))
"""
    r = _python(code)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["forbidden"] == []
    assert "slamtpu_torch" in out["top"] and "slamtpu" not in out["top"] and "jax" not in out["top"]


def test_window_metrics_by_trace_mode_and_no_flush_from_the_reads():
    """A small run reports keyframes_per_s and pose_latency_p95_ms with
    --trace 0 and neither with --trace 1, and the adapter's published()
    makes the app flush no more often than a run without those reads."""
    code = """
import json, torch
torch.set_num_threads(2)
from slambench import harness
from slambench.apps import lo_svn
from slambench.tests.conftest import small_cell
from slamtpu_torch.apps.lo_svn import LoSvnApp
flushes = [0]
flush = LoSvnApp.flush
def counted(self):
    flushes[0] += 1
    flush(self)
LoSvnApp.flush = counted
bench, cell, cfg, traffic = small_cell(128, 32, 2)
def run(trace):
    flushes[0] = 0
    r = harness.run_cell(cell["name"], cfg, traffic, harness.cell_metrics(bench, cell["name"], trace),
                         5, 1e9, trace, "cpu", n_sweeps=14)
    return {"metrics": r["metrics"], "flushes": flushes[0]}
out = {"plain": run(False), "traced": run(True)}
lo_svn.published = lambda app: 0  # no reads
out["unread"] = run(False)
print(json.dumps(out))
"""
    r = _python(code)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    new = {"keyframes_per_s", "pose_latency_p95_ms"}
    assert new <= set(out["plain"]["metrics"]), out["plain"]
    assert all(out["plain"]["metrics"][k]["value"] > 0 for k in new)
    assert not new & set(out["traced"]["metrics"]), out["traced"]
    assert "pose_latency_p95_ms" not in out["unread"]["metrics"]
    assert out["plain"]["flushes"] == out["unread"]["flushes"] == out["traced"]["flushes"]


def test_traffic_and_reference_import_nothing_of_the_port():
    code = """
import json, sys, torch
from slambench import harness, sensor as sn, traffic as tr
from slambench.reference import common, lo_svn
from slambench.tests.conftest import small_cell
bench, cell, cfg, traffic = small_cell(128, 32, 2)
lap = tr.Lap(traffic, sn.Sensor.from_config(cfg["sensor"]), 5, "cpu", n_sweeps=12)
rec = harness.Record(lap, cfg, list(range(1, 12)), {}, torch.device("cpu"))
lo_svn.published(rec, [9])
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
"""
    r = _python(code)
    assert r.returncode == 0, r.stderr[-3000:]
    top = json.loads(r.stdout.strip().splitlines()[-1])
    assert not {"slamtpu_torch", "slamtpu", "jax", "jaxlib", "flax"} & set(top)


def test_no_result_without_a_card(cuda_absent):
    r = subprocess.run([sys.executable, RUN, "--workload", "lo_svn_berlin.stadium", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert "{" not in r.stdout


def test_no_result_with_the_benchmark_alone(tmp_path):
    """A directory with only BENCHMARK.json and slambench/ has no port."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "slambench"), tmp_path / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "slambench/run.py", "--workload", "lo_svn_berlin.stadium", "--seed",
                        "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                       timeout=300, env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert r.returncode != 0
    assert "{" not in r.stdout


@pytest.fixture
def cuda_absent():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
