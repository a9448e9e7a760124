"""Stage names in the port's profiler traces: ``torch.profiler`` on the CPU
must see, as ``record_function`` spans, every stage scope that
tests/test_telemetry.py finds in the JAX package's lowered programs: the
SVN loop's (through ``svn_align_reg``, ``svn_align`` and
``dist.svn_align_sharded``, which share ``_svn_loop``) and a lo_svn
keyframe's, with the packed step's ``project`` and ``deskew`` and the
mean-start polish's ``svn_polish_pre`` beside them. Without them a
``--profile`` trace is one undivided list of operators.

The keyframe record of ``DeviceStageTimer`` (``trace_keyframes``): nothing
recorded while it is off; begin <= queued <= done and queued <= published;
lo_svn's poses published only at ``flush``; the newest keyframes kept; the
stamps on the profiler's clock; odom_ndt's and ligo_tc's poses published."""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from slamtpu_torch.apps.ligo_tc import LigoTcApp
from slamtpu_torch.apps.lo_svn import LoSvnApp
from slamtpu_torch.apps.odom_ndt import OdomNdtApp
from slamtpu_torch.core import se3
from slamtpu_torch.ins.imu_config import ImuConfig
from slamtpu_torch.lidar.ouster import LidarParams, synthetic_os2_metadata
from slamtpu_torch.mapping import gaussian_map
from slamtpu_torch.ndt.regmap import empty_regmap
from slamtpu_torch.ndt.svn import SvnConfig, svn_align, svn_align_reg
from slamtpu_torch.runtime.config import PipelineConfig, RegisterConfig
from slamtpu_torch.runtime.device_timer import KEYFRAME_CAP, keyframe_summary
from tests.simulator_np import simulate_replay

torch.set_num_threads(1)
GRID = (8, 8, 4)
N_SWEEPS = 6
N_KF = N_SWEEPS - 1  # the replay's first sweep completes no synced frame
TOL_NS = 500_000  # the shared-clock check's 0.5 ms
# tests/test_telemetry.py's lists
SVN_SCOPES = ("svn_gather", "svn_particle_eval", "svn_stein_update", "svn_retract", "svn_final_score",
              "svn_posterior")
LO_SVN_SCOPES = ("map_rebuild", "src_covariances", "svn_gather", "svn_polish", "ring_insert")


def _names(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name for e in prof.events()}


def _points():
    return torch.as_tensor(np.random.default_rng(0).normal(size=(64, 3)), dtype=torch.float32)


def test_svn_align_reg_stage_names():
    pts, mask = _points(), torch.ones(64, dtype=torch.bool)
    cfg = SvnConfig(num_particles=4, max_iterations=2, polish_iters=0)
    names = _names(lambda: svn_align_reg(pts, mask, empty_regmap(64, GRID, "cpu"), se3.expmap(torch.zeros(6)),
                                         cfg, GRID, init_noise=torch.zeros((4, 6))))
    missing = [s for s in SVN_SCOPES if s not in names]
    assert not missing, missing


def test_svn_align_stage_names():
    pts, mask = _points(), torch.ones(64, dtype=torch.bool)
    gmap = gaussian_map.build_map(pts, mask, torch.full((3,), -8.0), 1.0, capacity=64, min_points_per_voxel=3)
    for polish, scopes in ((0, SVN_SCOPES), (1, ("svn_polish",))):
        cfg = SvnConfig(num_particles=4, max_iterations=2, polish_iters=polish)
        names = _names(lambda: svn_align(pts, mask, gmap, se3.expmap(torch.zeros(6)), cfg,
                                         init_noise=torch.zeros((4, 6))))
        missing = [s for s in scopes if s not in names]
        assert not missing, (polish, missing)


@pytest.fixture(scope="module")
def lo_svn_setup(tmp_path_factory):
    meta = synthetic_os2_metadata(columns_per_frame=128, pixels_per_column=16, columns_per_packet=16)
    lidar = LidarParams(channel_stride=1, range_filter=(0.5, 150.0))
    reg = RegisterConfig(svn_resolution=2.0, svn_particles=4, svn_max_iterations=2, svn_polish_iters=1,
                         svn_polish_from="mean", map_capacity=1 << 12, min_points_per_voxel=4,
                         keyframe_window=2, reg_grid_shape=(64, 64, 16))
    cfg = PipelineConfig(meta=meta, lidar=lidar, imu=ImuConfig(), register=reg, deskew=True)
    path = str(tmp_path_factory.mktemp("telemetry") / "two.rpl")
    simulate_replay(path, meta, lidar, n_sweeps=N_SWEEPS)
    return cfg, path


def test_lo_svn_keyframe_stage_names(lo_svn_setup):
    """The second keyframe (the first only seeds the ring): map and RegMap
    rebuild, stencil source covariances, the SVN flow and the
    plane-to-plane polish from the particle mean (with its NDT pre-stage)."""
    cfg, path = lo_svn_setup
    app = LoSvnApp(cfg, "cpu")
    frames = app.ingest.synced_frames(path)
    app.process(next(frames))
    names = _names(lambda: app.process(next(frames)))
    missing = [s for s in LO_SVN_SCOPES + ("project", "deskew", "svn_polish_pre") if s not in names]
    assert not missing, missing


def test_lo_svn_sorted_key_keyframe_stage_names(lo_svn_setup):
    """``use_regmap=False``: the map build every keyframe and the SVN loop's
    stages, with no source covariances."""
    cfg, path = lo_svn_setup
    cfg = dataclasses.replace(cfg, register=dataclasses.replace(cfg.register, use_regmap=False))
    app = LoSvnApp(cfg, "cpu")
    frames = app.ingest.synced_frames(path)
    app.process(next(frames))
    names = _names(lambda: app.process(next(frames)))
    scopes = ("map_rebuild", "svn_gather", "svn_particle_eval", "svn_stein_update", "svn_retract", "svn_polish",
              "svn_posterior", "ring_insert", "project", "deskew")
    missing = [s for s in scopes if s not in names]
    assert not missing, missing
    assert "src_covariances" not in names


def _lo_svn_run(cfg, path, on=True, cap=KEYFRAME_CAP, flush=True):
    app = LoSvnApp(cfg, "cpu")
    if on:
        app.device_timer.trace_keyframes(cap)
    for synced in app.ingest.synced_frames(path):
        app.process(synced)
    if flush:
        app.flush()
    return app


def test_record_off_records_nothing(lo_svn_setup):
    app = _lo_svn_run(*lo_svn_setup, on=False)
    assert len(app.trajectory) == N_KF
    timer = app.device_timer
    assert timer.keyframes() == {} and timer._kf is None and timer._kf_events == []
    assert keyframe_summary(timer.keyframes())["keyframes"] == 0


def test_record_orders_each_keyframe(lo_svn_setup):
    app = _lo_svn_run(*lo_svn_setup)
    stamps = app.device_timer.keyframes()
    assert list(stamps) == list(range(N_KF))
    for k, s in list(stamps.items())[1:]:
        assert s.begin <= s.queued <= s.done, (k, s)
        assert s.queued <= s.published, (k, s)
    for a, b in zip(list(stamps.values()), list(stamps.values())[1:]):
        assert a.queued <= b.begin
    summary = keyframe_summary(stamps)
    assert summary["keyframes"] == N_KF - 1
    assert summary["device_lag_p95_ms"] == 0.0  # on the CPU the work runs as it is queued
    # lo_svn publishes at flush: every keyframe is still on the host's queue
    # when the next begins
    assert summary["host_in_flight"] == (N_KF - 2, pytest.approx((N_KF - 2) / 2))
    assert summary["pose_latency_p95_ms"] >= summary["pose_latency_p50_ms"] > 0


def test_published_waits_for_flush(lo_svn_setup):
    cfg, path = lo_svn_setup
    app = _lo_svn_run(cfg, path, flush=False)
    stamps = app.device_timer.keyframes()
    assert stamps[0].published is not None  # the first keyframe publishes the INS pose at once
    assert all(s.published is None and s.done is not None for s in list(stamps.values())[1:])
    app.flush()
    assert all(s.published is not None for s in app.device_timer.keyframes().values())


def test_record_keeps_the_newest(lo_svn_setup):
    app = _lo_svn_run(*lo_svn_setup, cap=3)
    assert list(app.device_timer.keyframes()) == list(range(N_KF - 3, N_KF))


def test_record_shares_the_profilers_clock(lo_svn_setup):
    """Each profiled keyframe's begin and queued stamps bracket its
    ``project`` ... ``ring_insert`` ranges on the profiler's clock, and lie
    between the ranges of the keyframes before and after it."""
    cfg, path = lo_svn_setup
    app = LoSvnApp(cfg, "cpu")
    app.device_timer.trace_keyframes()
    frames = app.ingest.synced_frames(path)
    app.process(next(frames))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for synced in frames:
            app.process(synced)
    events = prof.profiler.kineto_results.events()
    first = sorted(e.start_ns() for e in events if e.name() == "project")
    last = sorted(e.start_ns() + e.duration_ns() for e in events if e.name() == "ring_insert")
    stamps = list(app.device_timer.keyframes().values())[1:]
    assert len(first) == len(last) == len(stamps) == N_KF - 1
    seq = [t for s, a, b in zip(stamps, first, last) for t in (s.begin, a, b, s.queued)]
    for i, (a, b) in enumerate(zip(seq, seq[1:])):
        assert a <= b + TOL_NS, (i, a, b)


@pytest.mark.parametrize("app_cls", [OdomNdtApp, LigoTcApp], ids=["odom_ndt", "ligo_tc"])
def test_odom_and_ligo_publish(lo_svn_setup, app_cls):
    cfg, path = lo_svn_setup
    cfg = dataclasses.replace(cfg, register=dataclasses.replace(cfg.register, ndt_max_iterations=5))
    app = app_cls(cfg, "cpu", window=3)
    app.device_timer.trace_keyframes()
    app.run_replay(path)
    if hasattr(app, "flush"):
        app.flush()
    stamps = app.device_timer.keyframes()
    assert list(stamps) == list(range(N_KF))
    for k, s in stamps.items():
        assert s.begin <= s.queued <= s.published and s.queued <= s.done, (k, s)
