"""The live runtime of the port (runtime/live.py, udp.py, native_udp.py)
and the native ANPP decoder (ins/native.py), on the CPU.

- The same 6-sweep replay pushed through both packages' ``LivePipeline``
  callbacks (``_on_lidar``, ``_on_compass``; no sockets) queues the same
  SyncedFrames, exactly.
- Frames fed through the port's callbacks to its worker thread, with a port
  ``OdomNdtApp`` or ``LoSvnApp`` on the CPU, give ``run_replay``'s
  trajectory on that replay, bit for bit (the live path has no tail flush,
  so it ends one keyframe earlier).
- A blocked app makes the bounded queue drop a known number of frames.
- Sockets on loopback: ``open_udp`` delivers, its watchdog reports a silent
  stream, ``close`` stops both; ``NativeUdpReceiver`` polls, reports
  ``silent_ms`` and counts ring drops; without its library it raises, and
  a native-backend ``LivePipeline`` raises with it.
- ``ins.native.decode_batch`` against the port's ``AnppDecoder`` and the
  reference's ``decode_batch``.

Every wait on a socket or thread has a deadline and polls an event; none
depends on a fixed sleep. The one test whose result depends on the
machine's speed, the whole loopback run of the replay at its recorded
rate, is marked slow, as every test of tests/test_live.py is.
"""
import asyncio
import dataclasses
import socket
import threading
import time

import numpy as np
import pytest
import torch

from slamtpu.ins.imu_config import ImuConfig as JImu
from slamtpu.lidar.ouster import LidarParams as JLidar
from slamtpu.runtime import config as jconfig
from slamtpu.runtime.live import LivePipeline as JLivePipeline
from slamtpu_torch.apps.lo_svn import LoSvnApp
from slamtpu_torch.apps.odom_ndt import OdomNdtApp
from slamtpu_torch.ins import native as tnative
from slamtpu_torch.ins.anpp import AnppDecoder
from slamtpu_torch.ins.imu_config import ImuConfig as TImu
from slamtpu_torch.lidar.ouster import LidarParams as TLidar
from slamtpu_torch.lidar.ouster import synthetic_os2_metadata
from slamtpu_torch.runtime import config as tconfig
from slamtpu_torch.runtime import native_udp
from slamtpu_torch.runtime.live import LivePipeline
from slamtpu_torch.runtime.replay import STREAM_COMPASS, STREAM_LIDAR, read_replay
from slamtpu_torch.runtime.udp import UdpConfig, open_udp
from tests.simulator import simulate_replay, small_meta

torch.set_num_threads(1)
N_SWEEPS = 6
DEADLINE_S = 60.0
REGISTER = dict(
    ndt_resolution=np.float32(1.0), ndt_max_iterations=30, map_capacity=1 << 14, min_points_per_voxel=6,
    reg_grid_shape=(128, 128, 32), fused_inner_iters=1, svn_resolution=np.float32(2.0), svn_particles=6,
    svn_max_iterations=15, svn_kernel_h=1.0, svn_step_size=1.0, keyframe_window=3,
)


def configs(method="NDT_OMP"):
    lidar = dict(channel_stride=1, range_filter=(0.5, 150.0))
    reg = dict(REGISTER, method=method)
    jcfg = jconfig.PipelineConfig(meta=small_meta(cols=256), lidar=JLidar(**lidar), imu=JImu(),
                                  register=jconfig.RegisterConfig(**reg), deskew=True)
    tcfg = tconfig.PipelineConfig(
        meta=synthetic_os2_metadata(columns_per_frame=256, pixels_per_column=32, columns_per_packet=16),
        lidar=TLidar(**lidar), imu=TImu(), register=tconfig.RegisterConfig(**reg), deskew=True,
    )
    return jcfg, tcfg


@pytest.fixture(scope="module")
def replay(tmp_path_factory):
    jcfg, tcfg = configs()
    path = str(tmp_path_factory.mktemp("live") / "skewed.rpl")
    simulate_replay(path, jcfg.meta, jcfg.lidar, n_sweeps=N_SWEEPS, skewed=True)
    return path, jcfg, tcfg


class Collector:
    def __init__(self):
        self.frames = []

    def process(self, synced):
        self.frames.append(synced)


def _feed(pipeline, path):
    """The replay's datagrams through the pipeline's receive callbacks."""
    for stream, _ts, payload in read_replay(path):
        (pipeline._on_lidar if stream == STREAM_LIDAR else pipeline._on_compass)(payload)


def _queued(pipeline):
    out = []
    while not pipeline._q.empty():
        out.append(pipeline._q.get_nowait())
    return out


def _wait(cond, what, deadline_s=DEADLINE_S):
    end = time.monotonic() + deadline_s
    while not cond():
        if time.monotonic() > end:
            pytest.fail(f"{what} within {deadline_s} s")
        time.sleep(0.005)


def test_callbacks_queue_the_references_frames(replay):
    path, jcfg, tcfg = replay
    j = JLivePipeline(jcfg, Collector(), queue_capacity=64)
    t = LivePipeline(tcfg, Collector(), queue_capacity=64)
    _feed(j, path)
    _feed(t, path)
    jf, tf = _queued(j), _queued(t)
    assert len(tf) == len(jf) == N_SWEEPS - 2  # the first sweep opens the sync, the last never completes
    assert j.dropped_frames == t.dropped_frames == 0
    for a, b in zip(jf, tf):
        assert (a.t_start, a.t_end) == (b.t_start, b.t_end)
        for f in dataclasses.fields(a.scan):
            np.testing.assert_array_equal(getattr(b.scan, f.name), getattr(a.scan, f.name), err_msg=f.name)
        assert len(a.ins) == len(b.ins) > 2
        for na, nb in zip(a.ins, b.ins):
            for f in dataclasses.fields(na):
                np.testing.assert_array_equal(getattr(nb, f.name), getattr(na, f.name), err_msg=f.name)


class CountingApp:
    """An app's ``process`` with a count of returns and of exceptions."""

    def __init__(self, app):
        self.app, self.done, self.raised = app, 0, 0

    def process(self, synced):
        try:
            self.app.process(synced)
        except Exception:
            self.raised += 1
            raise
        finally:
            self.done += 1


@pytest.mark.parametrize("make_app", [
    lambda cfg: OdomNdtApp(cfg, "cpu", window=4),
    lambda cfg: LoSvnApp(dataclasses.replace(cfg, register=dataclasses.replace(cfg.register, method="SVNNDT")),
                         "cpu"),
], ids=["odom_ndt", "lo_svn"])
def test_worker_gives_the_replay_trajectory(replay, make_app):
    path, _, tcfg = replay
    live = CountingApp(make_app(tcfg))
    pipeline = LivePipeline(tcfg, live, queue_capacity=64)
    worker = threading.Thread(target=pipeline._worker, daemon=True)
    worker.start()
    try:
        _feed(pipeline, path)
        _wait(lambda: live.done == N_SWEEPS - 2, "the worker did not process the frames")
    finally:
        pipeline._stop.set()
        worker.join(timeout=DEADLINE_S)
    assert not worker.is_alive() and live.raised == 0 and pipeline.dropped_frames == 0
    got = live.app.trajectory
    want = make_app(tcfg).run_replay(path)
    assert len(got) == len(want) - 1 == N_SWEEPS - 2
    for a, b in zip(got, want):
        assert a.frame_id == b.frame_id
        np.testing.assert_array_equal(a.pose.rot, b.pose.rot)
        np.testing.assert_array_equal(a.pose.trans, b.pose.trans)


def test_blocked_app_drops_frames(replay):
    path, _, tcfg = replay

    class Blocked:
        def __init__(self):
            self.entered, self.release, self.done = threading.Event(), threading.Event(), 0

        def process(self, synced):
            self.entered.set()
            self.release.wait(DEADLINE_S)
            self.done += 1

    app = Blocked()
    capacity = 1
    pipeline = LivePipeline(tcfg, app, queue_capacity=capacity)
    worker = threading.Thread(target=pipeline._worker, daemon=True)
    worker.start()
    try:
        packets = list(read_replay(path))
        first_done = None
        for i, (stream, _ts, payload) in enumerate(packets):
            (pipeline._on_lidar if stream == STREAM_LIDAR else pipeline._on_compass)(payload)
            if first_done is None and not pipeline._q.empty():
                # the worker takes the first frame and blocks in process
                assert app.entered.wait(DEADLINE_S)
                first_done = i
        n = N_SWEEPS - 2
        assert pipeline.dropped_frames == n - 1 - capacity
        app.release.set()
        _wait(lambda: app.done == 1 + capacity, "the released worker did not drain the queue")
    finally:
        app.release.set()
        pipeline._stop.set()
        worker.join(timeout=DEADLINE_S)
    assert not worker.is_alive()


def _free_port():
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_open_udp_delivers_reports_silence_and_closes():
    async def main():
        loop = asyncio.get_running_loop()
        got, errors = asyncio.Queue(), asyncio.Queue()
        port = _free_port()
        ep = await open_udp(UdpConfig(host="127.0.0.1", port=port, receive_timeout_s=0.2),
                            got.put_nowait, errors.put_nowait)
        out = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            for k in range(3):
                out.sendto(bytes([k]) * 100, ("127.0.0.1", port))
            data = [await asyncio.wait_for(got.get(), DEADLINE_S) for _ in range(3)]
            assert data == [bytes([k]) * 100 for k in range(3)]
            # nothing more arrives: the watchdog fires through the error path
            err = await asyncio.wait_for(errors.get(), DEADLINE_S)
            assert isinstance(err, TimeoutError) and f":{port}" in str(err)
            ep.close()
            assert ep.transport.is_closing() and ep._watchdog is None
            out.sendto(b"late", ("127.0.0.1", port))
            await asyncio.sleep(0)  # let the loop run any callback that was due
            assert got.empty()
        finally:
            out.close()
            ep.close()
        assert loop.is_running()

    asyncio.run(main())


def test_native_receiver_polls_reports_silence_and_counts_drops():
    if not native_udp.available():
        pytest.skip("no g++ to build native/udp_ingest.cpp")
    port = _free_port()
    rx = native_udp.NativeUdpReceiver(host="127.0.0.1", port=port, max_packet=256, ring_capacity=4, batch=8)
    out = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        for k in range(3):
            out.sendto(bytes([k]) * 50, ("127.0.0.1", port))
        got = []
        _wait(lambda: got.extend(rx.poll()) or len(got) == 3, "3 datagrams did not arrive")
        assert got == [bytes([k]) * 50 for k in range(3)] and rx.dropped == 0
        _wait(lambda: rx.silent_ms >= 100, "silent_ms did not grow")
        # a ring of 4 that nobody drains keeps the newest 4 of 10
        for k in range(10):
            out.sendto(bytes([k]) * 50, ("127.0.0.1", port))
        _wait(lambda: rx.dropped == 6, "the ring did not drop the 6 oldest")
        assert rx.poll() == [bytes([k]) * 50 for k in range(6, 10)]
        assert rx.silent_ms < 60_000
    finally:
        out.close()
        rx.close()


def test_native_backend_raises_without_its_library(monkeypatch, replay):
    _, _, tcfg = replay
    monkeypatch.setattr(native_udp, "_load", lambda: None)
    with pytest.raises(RuntimeError, match="native udp ingest unavailable"):
        native_udp.NativeUdpReceiver(port=_free_port())
    pipeline = LivePipeline(tcfg, Collector(), lidar_udp=UdpConfig(host="127.0.0.1", port=_free_port()),
                            compass_udp=UdpConfig(host="127.0.0.1", port=_free_port()), io_backend="native")
    with pytest.raises(RuntimeError, match="native udp ingest unavailable"):
        asyncio.run(pipeline.run(duration_s=1.0))
    assert not pipeline.ready.is_set()


def test_native_anpp_decode_matches_the_decoder_and_the_reference():
    from slamtpu.ins import native as jnative
    from tests.test_ins import make_pkt20, make_pkt25, make_pkt26, make_pkt28, make_pkt29

    if not tnative.available():
        pytest.skip("no g++ to build native/anpp_decode.cpp")
    pkts = [
        make_pkt20(t=3600.5, lla=(0.91, 0.23, 40.0), vel=(1.5, -2.0, 0.3), rpy=(0.02, -0.04, 2.1),
                   sys_status=0x0041, filt_status=0x1F),
        make_pkt25((0.01, 0.02, 0.03)),
        make_pkt26((0.002, 0.001, 0.004)),
        make_pkt28(list(np.arange(12) * 0.25)),
        make_pkt29(t=3600.55, status=0x5A),
        b"\x00\x14\x05\x00\x00bad",  # malformed
    ]
    pids, fields = tnative.decode_batch(pkts)
    jpids, jfields = jnative.decode_batch(pkts)
    np.testing.assert_array_equal(pids, jpids)
    np.testing.assert_array_equal(fields, jfields)
    np.testing.assert_array_equal(pids, [20, 25, 26, 28, 29, 0])
    # the Python decoder's NavFrame (complete at packet 29) carries the same values
    dec = AnppDecoder()
    navs = [dec.push_packet(p) for p in pkts]
    assert [n is not None for n in navs] == [False, False, False, False, True, False]
    nav = navs[4]
    np.testing.assert_allclose(nav.t, fields[0][0], atol=1e-9)
    np.testing.assert_array_equal(nav.lla, fields[0][1:4])
    np.testing.assert_array_equal(nav.vel_ned, fields[0][4:7])
    np.testing.assert_array_equal(nav.rpy, fields[0][11:14])
    np.testing.assert_array_equal(nav.sigma_vel, fields[1][:3])
    np.testing.assert_array_equal(nav.sigma_rpy, fields[2][:3])
    np.testing.assert_array_equal(np.concatenate([nav.imu_accel, nav.imu_gyro, nav.mag, nav.env]), fields[3][:12])
    np.testing.assert_allclose(nav.t29, fields[4][0], atol=1e-9)


@pytest.mark.slow
def test_loopback_native_backend_end_to_end(replay):
    """The replay over loopback at its recorded rate into the native
    backend: frames arrive in order and the silent streams are reported."""
    path, _, tcfg = replay
    if not native_udp.available():
        pytest.skip("no g++ to build native/udp_ingest.cpp")
    app = Collector()
    lp, cp = _free_port(), _free_port()
    pipeline = LivePipeline(tcfg, app, lidar_udp=UdpConfig(host="127.0.0.1", port=lp, receive_timeout_s=1.0),
                            compass_udp=UdpConfig(host="127.0.0.1", port=cp, receive_timeout_s=1.0),
                            io_backend="native")

    def sender():
        assert pipeline.ready.wait(DEADLINE_S)
        out = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        packets = list(read_replay(path))
        t0, ts0 = time.monotonic(), packets[0][1]
        for stream, ts, payload in packets:
            wait = t0 + (ts - ts0) - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            out.sendto(payload, ("127.0.0.1", lp if stream == STREAM_LIDAR else cp))
        out.close()

    t = threading.Thread(target=sender, daemon=True)
    t.start()
    asyncio.run(pipeline.run(duration_s=4.0))
    t.join(DEADLINE_S)
    ids = [f.scan.frame_id for f in app.frames]
    assert len(ids) >= 1 and ids == sorted(ids)
    assert any(isinstance(e, TimeoutError) for e in pipeline.errors)
