"""Host side of the PyTorch port: import hygiene, the JAX-free simulator,
and the copied decode path (slamtpu_torch's host copies of slamtpu's
numpy modules)."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from slamtpu.apps.common import IngestPipeline as JIngest
from slamtpu.apps.common import ins_pose_ned as jins_pose_ned
from slamtpu.ins.imu_config import ImuConfig
from slamtpu.lidar.ouster import LidarParams
from slamtpu.runtime.config import PipelineConfig, RegisterConfig
from slamtpu_torch.apps.common import IngestPipeline, ins_pose_ned
from slamtpu_torch.lidar.ouster import LidarParams as TLidarParams
from slamtpu_torch.runtime import config as tconfig
from tests import simulator, simulator_np

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, os, pkgutil, sys
import slamtpu_torch
import slamtpu_torch.apps.lo_svn
for m in pkgutil.walk_packages(slamtpu_torch.__path__, 'slamtpu_torch.'):
    importlib.import_module(m.name)
import torch
from slamtpu_torch import cuda_build
from slamtpu_torch.ndt import fused_math
bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'triton', 'slamtpu'))
assert not bad, bad
assert not torch.cuda.is_initialized()
assert fused_math._lib is None and not cuda_build.BUILD_LOG
assert torch.backends.cuda.matmul.allow_tf32 is False
assert torch.get_float32_matmul_precision() == 'highest'
print('PORT_IMPORT_CLEAN', os.path.exists(cuda_build.BUILD_DIR))
"""


def test_import_pulls_in_no_jax_no_triton_and_builds_nothing():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    build_dir = REPO / "build" / "slamtpu_torch"
    existed = build_dir.exists()
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], capture_output=True, text=True,
                       timeout=120, cwd=REPO, env=env)
    assert r.returncode == 0, f"stdout={r.stdout}\nstderr={r.stderr}"
    assert "PORT_IMPORT_CLEAN" in r.stdout
    assert build_dir.exists() == existed  # importing made no build directory


@pytest.mark.parametrize("skewed", [False, True], ids=["rigid", "skewed"])
def test_simulator_np_writes_identical_replay(tmp_path, skewed):
    meta = simulator.small_meta()
    params = LidarParams(channel_stride=1, range_filter=(0.5, 150.0))
    a, b = str(tmp_path / "jax.rpl"), str(tmp_path / "np.rpl")
    gt_a = simulator.simulate_replay(a, meta, params, n_sweeps=3, skewed=skewed)
    gt_b = simulator_np.simulate_replay(
        b, simulator_np.small_meta(),
        TLidarParams(channel_stride=1, range_filter=(0.5, 150.0)),
        n_sweeps=3, skewed=skewed,
    )
    assert Path(a).read_bytes() == Path(b).read_bytes()
    for (ra, pa), (rb, pb) in zip(gt_a, gt_b):
        np.testing.assert_array_equal(ra, rb)
        np.testing.assert_array_equal(pa, pb)


def test_copied_decode_path_matches(tmp_path):
    path = str(tmp_path / "sim.rpl")
    meta = simulator.small_meta()
    lidar = dict(channel_stride=2, range_filter=(0.5, 150.0))
    simulator.simulate_replay(path, meta, LidarParams(**lidar), n_sweeps=4, skewed=True)
    jcfg = PipelineConfig(meta=meta, lidar=LidarParams(**lidar), imu=ImuConfig(), register=RegisterConfig())
    tcfg = tconfig.PipelineConfig(meta=simulator_np.small_meta(), lidar=TLidarParams(**lidar),
                                  imu=tconfig.ImuConfig(), register=tconfig.RegisterConfig())
    jf = list(JIngest(jcfg).synced_frames(path))
    tf = list(IngestPipeline(tcfg, "cpu").synced_frames(path))
    assert len(jf) == len(tf) == 3
    ref = np.asarray(jf[0].ins[-1].lla)
    for a, b in zip(jf, tf):
        assert (a.t_start, a.t_end, a.scan.frame_id) == (b.t_start, b.t_end, b.scan.frame_id)
        for field in ("ranges_m", "reflectivity", "signal", "nir", "col_timestamp_s", "col_valid"):
            np.testing.assert_array_equal(getattr(b.scan, field), getattr(a.scan, field))
        assert len(a.ins) == len(b.ins)
        for na, nb in zip(a.ins, b.ins):
            pa, pb = jins_pose_ned(na, ref), ins_pose_ned(nb, ref)
            np.testing.assert_array_equal(np.asarray(pb.rot), np.asarray(pa.rot))
            np.testing.assert_array_equal(np.asarray(pb.trans), np.asarray(pa.trans))


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "alone"])
def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path, alone):
    """Without CUDA (as here), and in a directory holding nothing else of the
    repo, chip_smoke.py must exit non-zero and print no result line."""
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if alone:
        (tmp_path / "chip_smoke.py").write_bytes(script.read_bytes())
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    r = subprocess.run([sys.executable, str(script)], capture_output=True, text=True, timeout=120,
                       cwd=cwd)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and '"kernels"' not in r.stdout
