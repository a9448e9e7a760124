"""ligo_tc on its normal path: ``flush``, the host record, and the two
capture-once CUDA graphs (``regmap.MapGraph`` for the 5-cloud DIRECT7
target, ``ligo_tc.WindowGraph`` for the full window's 15-dof re-solve).

On the CPU (these count in the default lane):

- every keyframe is published when ``process`` returns; ``flush`` adds
  none and collects the device timer's spans (``fuse`` and ``smoother``
  once a keyframe after the first);
- with ``keep_record``, ``record`` holds, per keyframe, the states
  ``_fuse`` wrote into the window, the ring's poses the target was fused
  at and the registration's pose, and keeping it reads nothing more: two
  reads a keyframe after the first (the step's result and the
  re-solve's); without it (the default) ``record`` stays empty;
- on the CPU both runners call their function inline and capture nothing;
  with the capture stood in (``test_torch_cuda_graph.py``'s ``stand_in``)
  the window runner runs eagerly once, captures, then loads and replays
  equal to ``_window_solve`` bit for bit, fill-up calls staying eager;
- a short replay whose heading passes +-pi, judged by the benchmark's
  plain reference (``slambench/reference/ligo_tc.py``).

On the card (marker ``cuda``, skipped without one; tests/conftest.py
imports JAX, so run it there as
``python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_ligo_graphs.py``):
replay equals eager bit for bit for the window graph and for ``MapGraph``
at the benchmark cell's key, both run clean under
``torch.cuda.set_sync_debug_mode("error")``, and the app through the
graphs publishes what it publishes eagerly.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from slamtpu_torch.apps import ligo_tc
from slamtpu_torch.core import cuda_graph
from slamtpu_torch.ins.imu_config import ImuConfig
from slamtpu_torch.lidar.ouster import LidarParams, synthetic_os2_metadata
from slamtpu_torch.ndt.regmap import MapGraph, RegMap, build_target
from slamtpu_torch.runtime.config import PipelineConfig, RegisterConfig
from test_torch_cuda_graph import stand_in  # noqa: F401 (the fixture)

torch.set_num_threads(1)
CPU, CUDA = torch.device("cpu"), torch.device("cuda")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WINDOW, SWEEPS = 4, 9  # fill-up at 1-3 states, full from the fourth keyframe on


def _cfg(cols=128, pix=16, capacity=1 << 12, grid=(64, 64, 16)):
    meta = synthetic_os2_metadata(columns_per_frame=cols, pixels_per_column=pix, columns_per_packet=16)
    reg = RegisterConfig(ndt_resolution=1.0, ndt_max_iterations=10, map_capacity=capacity, min_points_per_voxel=4,
                         reg_grid_shape=grid, keyframe_window=3, map_rebuild_every=1)
    return PipelineConfig(meta=meta, lidar=LidarParams(channel_stride=1, range_filter=(0.5, 150.0)),
                          imu=ImuConfig(), register=reg, deskew=True)


def _replay(path, cfg, n=SWEEPS):
    from simulator_np import simulate_replay

    simulate_replay(path, cfg.meta, cfg.lidar, n_sweeps=n, skewed=True)
    return path


@pytest.fixture(scope="module")
def small_replay(tmp_path_factory):
    return _replay(str(tmp_path_factory.mktemp("ligo_graphs") / "skewed.rpl"), _cfg())


def _published(traj):
    return [(np.asarray(e.pose.rot), np.asarray(e.pose.trans), e.covariance) for e in traj]


def _same(a, b):
    assert len(a) == len(b)
    for (r, t, c), (r2, t2, c2) in zip(a, b):
        assert np.array_equal(r, r2) and np.array_equal(t, t2)
        assert (c is None and c2 is None) or np.array_equal(c, c2)


def test_flush_publishes_every_keyframe_as_process_returns(small_replay):
    app = ligo_tc.LigoTcApp(_cfg(), "cpu", window=WINDOW)
    frames = list(app.ingest.synced_frames(small_replay))
    for k, s in enumerate(frames):
        app.process(s)
        assert len(app.trajectory) == k + 1
    app.flush()
    assert len(app.trajectory) == len(frames) == SWEEPS - 1
    ms = app.device_timer.samples
    assert len(ms["fuse"]) == len(ms["smoother"]) == len(frames) - 1
    app.flush()
    assert len(app.trajectory) == len(frames)


def test_record_is_what_fuse_wrote_and_reads_nothing_more(small_replay, monkeypatch):
    """After each keyframe the record's states are the window entries as
    ``_fuse`` wrote them (oldest first), its target poses the ring's as the
    step fused them and its registration the step's; ``process`` reads the
    device twice a keyframe after the first."""
    app = ligo_tc.LigoTcApp(_cfg(), "cpu", window=WINDOW, keep_record=True)
    reads = []
    cpu = torch.Tensor.cpu

    def counted(t, *a, **k):
        reads.append(tuple(t.shape))
        return cpu(t, *a, **k)

    steps = []
    step = ligo_tc._ligo_step

    def recorded(*a, **k):
        steps.append(a[2].clone())  # the ring's poses, as the step fuses its target
        return step(*a, **k)

    monkeypatch.setattr(ligo_tc, "_ligo_step", recorded)
    for k, s in enumerate(app.ingest.synced_frames(small_replay)):
        monkeypatch.setattr(torch.Tensor, "cpu", counted)
        app.process(s)
        monkeypatch.setattr(torch.Tensor, "cpu", cpu)
        assert len(reads) == (0 if k == 0 else 2), reads
        reads.clear()
        rec = app.record[k]
        want = np.stack([np.concatenate([np.ravel(w["pose"].rot), w["pose"].trans, w["vel"], w["bias"]])
                         for w in app._win])
        assert rec.states.dtype == np.float64 and np.array_equal(rec.states, want)
        assert np.array_equal(rec.states[-1, 9:12], app.trajectory[k].pose.trans)
        if k:
            assert np.array_equal(rec.target_poses, steps[-1].numpy())
            assert rec.newton.shape == (12,) and np.isfinite(rec.newton).all()
    assert sorted(app.record) == list(range(SWEEPS - 1))


def test_cpu_dispatch_stays_eager(small_replay):
    app = ligo_tc.LigoTcApp(_cfg(), "cpu", window=WINDOW)
    traj = app.run_replay(small_replay)
    assert len(traj) == SWEEPS - 1
    assert app.record == {}  # kept only with keep_record
    for runner in (app._map_graph, app._window_graph):
        assert runner.captures == 0 and not runner._graphs


def _window_calls(monkeypatch):
    """Record each ``_window_solve`` call's inputs."""
    calls = []
    solve = ligo_tc._window_solve

    def recorded(buf, fields, cur, cfg, tpl):
        calls.append((buf.clone(), fields, cur, cfg, tpl))
        return solve(buf, fields, cur, cfg, tpl)

    monkeypatch.setattr(ligo_tc, "_window_solve", recorded)
    return calls


@pytest.fixture(scope="module")
def window_inputs(small_replay):
    """The window solves of a CPU run: [(buf, fields, cur, cfg, tpl)], the
    fill-up ones first."""
    mp = pytest.MonkeyPatch()
    calls = _window_calls(mp)
    try:
        ligo_tc.LigoTcApp(_cfg(), "cpu", window=WINDOW).run_replay(small_replay)
    finally:
        mp.undo()
    return calls


def test_window_runner_runs_eager_captures_then_replays(stand_in, window_inputs):
    """The full windows of a run: the first eager, the second captures, the
    rest load and replay; each equals ``_window_solve`` bit for bit, kept
    results are untouched by later replays; fill-up calls stay eager."""
    runner = ligo_tc.WindowGraph()
    fill = [c for c in window_inputs if c[2] < WINDOW - 1]
    full = [c for c in window_inputs if c[2] == WINDOW - 1]
    assert len(fill) == WINDOW - 2 and len(full) >= 3
    kept = []
    for buf, fields, cur, cfg, tpl in fill + full:
        got = runner(buf, fields, cur, cfg, tpl, cur == WINDOW - 1)
        assert torch.equal(got, ligo_tc._window_solve(buf, fields, cur, cfg, tpl))
        kept.append((got, got.clone()))
    assert runner.captures == 1 and len(stand_in) == 1 and stand_in[0].replays == len(full) - 1
    (key,) = runner._graphs
    assert key == (WINDOW, full[0][3], torch.float64, CPU)
    for got, value in kept:
        assert torch.equal(got, value)


def test_short_replay_across_pi_matches_the_reference():
    """A short lap whose second straight heads along +-pi (the INS exact),
    run through the benchmark's harness at 256 x 32 beams: every keyframe
    where the INS heading passes +-pi is redone by the plain float64
    reference, and the port agrees with it there and at the sampled
    keyframes."""
    sys.path.insert(0, ROOT)
    from slambench import harness
    from slambench.tests.conftest import small_cell
    from slambench.tests.test_slambench_ligo_reference import SHORT_LAP, SMALL_SIZE_LIMITS

    bench, cellw, cfg, traffic = small_cell(256, 32, cell="ligo_tc_berlin.stadium")
    traffic = dict(traffic, course=dict(traffic["course"], **SHORT_LAP))
    traffic.pop("ins_error")
    metrics = harness.cell_metrics(bench, cellw["name"], False)
    r = harness.run_cell(cellw["name"], cfg, traffic, metrics, 2**31 + 9, 1e9, False, "cpu", n_sweeps=36,
                         limits=SMALL_SIZE_LIMITS)
    assert r["correct"], r["compared"]
    assert r["compared"]["cross_pose_gap_mm"]["value"] > 0.0  # a crossing was redone


# --- on the card ---


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernels)")


# the benchmark cell's target key (configs/ligo_tc_berlin.json): 5 clouds of
# 65,536 points, 2.0 m, capacity 8192, 6 points, grid (128, 128, 32), float64 statistics
LIGO_KEY = (5 * 65536, (2.0, 8192, 6, (128, 128, 32), torch.float64, False))


def _target_args(seed):
    from test_torch_map_graph import cloud

    n, settings = LIGO_KEY
    pts, mask, origin = cloud(seed, n=n, half=(60.0, 40.0), device=CUDA)
    return (pts, mask, origin) + settings


def _regmap_equal(got: RegMap, want: RegMap):
    for name, a, b in zip(RegMap._fields, got, want):
        assert (a is None and b is None) or (a.dtype == b.dtype and torch.equal(a, b)), name


@pytest.mark.cuda
def test_map_graph_replay_equals_eager_at_the_ligo_key():
    _need_card()
    runner = MapGraph()
    kept = []
    for k in range(5):
        args = _target_args(70 + k)
        got = runner(*args)
        _regmap_equal(got, build_target(*args))
        kept.append((got, RegMap(*(None if t is None else t.clone() for t in got))))
    torch.cuda.synchronize()
    assert runner.captures == 1
    for got, values in kept:
        _regmap_equal(got, values)
    assert all(int(v.overflow) == 0 for _, v in kept)


def _card_window_inputs(tmp_path):
    """The window solves of an eager run of the app on the card."""
    cfg = _cfg(512, 64, 1 << 14, (128, 128, 32))
    path = _replay(str(tmp_path / "card.rpl"), cfg, 14)
    mp = pytest.MonkeyPatch()
    calls = _window_calls(mp)
    mp.setattr(cuda_graph, "replays", lambda _device: False)
    try:
        ligo_tc.LigoTcApp(cfg, "cuda", window=WINDOW).run_replay(path)
    finally:
        mp.undo()
    return [c for c in calls if c[2] == WINDOW - 1]


@pytest.mark.cuda
def test_window_graph_replay_equals_eager_on_the_card(tmp_path):
    _need_card()
    full = _card_window_inputs(tmp_path)
    assert len(full) >= 6
    runner = ligo_tc.WindowGraph()
    kept = []
    for buf, fields, cur, cfg, tpl in full:
        got = runner(buf, fields, cur, cfg, tpl, True)
        assert torch.equal(got, ligo_tc._window_solve(buf, fields, cur, cfg, tpl))
        kept.append((got, got.clone()))
    torch.cuda.synchronize()
    assert runner.captures == 1
    for got, value in kept:
        assert torch.equal(got, value)


@pytest.mark.cuda
def test_both_graphs_run_clean_under_sync_error_mode_on_the_card(tmp_path):
    """After a warm call each, the window solve and the target build at the
    cell's key, eager and replayed, wait for the device nowhere."""
    _need_card()
    buf, fields, cur, cfg, tpl = _card_window_inputs(tmp_path)[0]
    args = _target_args(90)
    window, target = ligo_tc.WindowGraph(), MapGraph()
    for _ in range(2):  # eager, then the capture
        window(buf, fields, cur, cfg, tpl, True)
        target(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ligo_tc._window_solve(buf, fields, cur, cfg, tpl)
        build_target(*args)
        window(buf, fields, cur, cfg, tpl, True)
        target(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert window.captures == target.captures == 1


@pytest.mark.cuda
def test_app_through_the_graphs_on_the_card(tmp_path):
    """``LigoTcApp`` on the card through both graphs and eagerly publishes
    the same poses and covariances bit for bit; each graph captured once."""
    _need_card()
    cfg = _cfg(512, 64, 1 << 14, (128, 128, 32))
    cfg = dataclasses.replace(cfg, register=dataclasses.replace(cfg.register, ndt_resolution=2.0))
    path = _replay(str(tmp_path / "app.rpl"), cfg, 14)
    app = ligo_tc.LigoTcApp(cfg, "cuda", window=WINDOW)
    graph = _published(app.run_replay(path))
    mp = pytest.MonkeyPatch()
    mp.setattr(cuda_graph, "replays", lambda _device: False)
    try:
        eager = _published(ligo_tc.LigoTcApp(cfg, "cuda", window=WINDOW).run_replay(path))
    finally:
        mp.undo()
    _same(graph, eager)
    assert len(graph) == 13 and app._map_graph.captures == app._window_graph.captures == 1
