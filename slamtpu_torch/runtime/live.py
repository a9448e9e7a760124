"""Host copy of ``slamtpu/runtime/live.py`` (standard library only, code
unchanged; ``app`` is any port app with ``.process``: ``LoSvnApp``,
``OdomNdtApp``, ``LigoTcApp`` or ``InsMapApp``).

The port cannot import it from ``slamtpu``: ``slamtpu/__init__.py``
imports JAX, so any ``import slamtpu.<module>`` pulls JAX in, and the
GPU port runs where JAX is absent. The worker thread makes the app's
first device calls; an app on the card builds its kernels at their first
launch, so a caller loads them before ``run()``
(``slamtpu_torch.ndt.fused_math._load()``) to keep the build out of the
stream. The docstring below is the original's.

Live UDP pipeline runner: sensors -> decoders -> synchronizer -> app.

The reference's primary operating mode is live UDP ingest with a thread per
stage connected by queues (run/pipeline_lo_svn.cpp:90-130). Here one asyncio
loop owns both sockets; packet decode runs in the receive callbacks (they are
memcpy-shaped), and completed SyncedFrames are handed to the app's ``process``
on a worker thread so device computation never blocks the reactor. Optionally
tees both streams into a replay file (the recording path the reference lacks).
"""
from __future__ import annotations

import asyncio
import logging
import queue
import threading
from typing import Optional

from ..ins.anpp import AnppDecoder
from ..lidar.ouster import FrameAssembler, build_luts
from .replay import STREAM_COMPASS, STREAM_LIDAR, ReplayWriter
from .sync import Synchronizer
from .udp import UdpConfig, open_udp

log = logging.getLogger("slamtpu.live")


class LivePipeline:
    """Wire UDP ingest to an app (any object with .process(SyncedFrame))."""

    def __init__(
        self,
        cfg,  # PipelineConfig
        app,
        lidar_udp: UdpConfig = UdpConfig(port=7502, buffer_size=1 << 22),
        compass_udp: UdpConfig = UdpConfig(port=16718),
        record_path: Optional[str] = None,
        queue_capacity: int = 8,
        io_backend: str = "asyncio",  # "asyncio" | "native" (C++ receiver
        #   threads + batched ring drain, runtime.native_udp — the analog of
        #   the reference's C++ UdpSocket for production ingest rates)
    ):
        self.cfg = cfg
        self.app = app
        self.lidar_udp = lidar_udp
        self.compass_udp = compass_udp
        self.luts = build_luts(cfg.meta, cfg.lidar)
        self.assembler = FrameAssembler(cfg.meta, self.luts)
        self.anpp = AnppDecoder()
        self.sync = Synchronizer(cfg.nav_window)
        self.recorder = ReplayWriter(record_path) if record_path else None
        # bounded handoff to the device worker (the reference's FrameQueue
        # equivalent; bounded so a slow consumer drops frames instead of
        # growing without bound)
        self.io_backend = io_backend
        self._q: queue.Queue = queue.Queue(maxsize=queue_capacity)
        self._stop = threading.Event()
        # set once both sockets are bound and the drain loop is live —
        # senders/supervisors can gate on this instead of sleeping
        self.ready = threading.Event()
        self.dropped_frames = 0
        self.rx_dropped: dict = {}  # per-stream ring drops (native backend)
        # UDP-level failures, incl. receive-timeout stalls (observable by
        # supervisors; the reference surfaces these via its error callback)
        self.errors: list = []

    # --- reactor-side callbacks ---------------------------------------
    def _on_lidar(self, payload: bytes):
        frame = self.assembler.push_packet(payload)
        if frame is not None:
            for synced in self.sync.push_scan(frame):
                self._enqueue(synced)

    def _on_compass(self, payload: bytes):
        nav = self.anpp.push_packet(payload)
        if nav is not None:
            for synced in self.sync.push_nav(nav):
                self._enqueue(synced)

    def _enqueue(self, synced):
        try:
            self._q.put_nowait(synced)
        except queue.Full:
            self.dropped_frames += 1
            log.warning("device worker behind; dropping frame %d", synced.scan.frame_id)

    def _on_error(self, exc):
        self.errors.append(exc)
        log.error("UDP error: %s", exc)

    # --- device worker -------------------------------------------------
    def _worker(self):
        while not self._stop.is_set():
            try:
                synced = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                self.app.process(synced)
            except Exception:  # keep the pipeline alive on app errors
                log.exception("app.process failed for frame %d", synced.scan.frame_id)

    # --- lifecycle -------------------------------------------------------
    async def run(self, duration_s: Optional[float] = None):
        if self.io_backend == "native":
            await self._run_native(duration_s)
            return
        worker = threading.Thread(target=self._worker, daemon=True)
        worker.start()
        lidar_t = await open_udp(
            self.lidar_udp, self._on_lidar, self._on_error,
            recorder=self.recorder, stream_id=STREAM_LIDAR,
        )
        comp_t = await open_udp(
            self.compass_udp, self._on_compass, self._on_error,
            recorder=self.recorder, stream_id=STREAM_COMPASS,
        )
        log.info(
            "live pipeline up (lidar :%d, compass :%d)",
            self.lidar_udp.port, self.compass_udp.port,
        )
        self.ready.set()
        try:
            if duration_s is None:
                while True:
                    await asyncio.sleep(3600)
            else:
                await asyncio.sleep(duration_s)
        finally:
            lidar_t.close()
            comp_t.close()
            self._stop.set()
            worker.join(timeout=2.0)
            if self.recorder is not None:
                self.recorder.close()

    async def _run_native(self, duration_s: Optional[float]):
        """Native backend: C++ receiver threads (runtime.native_udp), the
        reactor drains both rings in batches. Receive-timeout watchdogs use
        the receivers' silent_ms, mirroring the asyncio backend."""
        import time as _time

        from .native_udp import NativeUdpReceiver

        # open both sockets BEFORE starting anything: a failed second bind
        # must not leak the first receiver's C++ thread or a live worker
        rx = []
        try:
            for ucfg, cb, stream in (
                (self.lidar_udp, self._on_lidar, STREAM_LIDAR),
                (self.compass_udp, self._on_compass, STREAM_COMPASS),
            ):
                rx.append(
                    (
                        NativeUdpReceiver(
                            host=ucfg.host, port=ucfg.port,
                            buffer_size=ucfg.buffer_size,
                        ),
                        cb, stream, ucfg,
                    )
                )
        except Exception:
            for r, *_ in rx:
                r.close()
            raise
        worker = threading.Thread(target=self._worker, daemon=True)
        worker.start()
        log.info(
            "live pipeline up [native io] (lidar :%d, compass :%d)",
            self.lidar_udp.port, self.compass_udp.port,
        )
        self.ready.set()
        deadline = None if duration_s is None else _time.monotonic() + duration_s
        warned_at = [0.0] * len(rx)
        loop = asyncio.get_running_loop()
        try:
            while deadline is None or _time.monotonic() < deadline:
                idle = True
                for i, (r, cb, stream, ucfg) in enumerate(rx):
                    for payload in r.poll():
                        idle = False
                        if self.recorder is not None:
                            self.recorder.write(stream, loop.time(), payload)
                        cb(payload)
                    t = ucfg.receive_timeout_s
                    if t and r.silent_ms >= 1e3 * t:
                        now = _time.monotonic()
                        if now - warned_at[i] >= t:  # once per silent window
                            warned_at[i] = now
                            self._on_error(
                                TimeoutError(
                                    f"no datagrams on :{ucfg.port} for "
                                    f"{r.silent_ms / 1e3:.1f}s"
                                )
                            )
                await asyncio.sleep(0.0 if not idle else 0.002)
        finally:
            # ring/kernel drop totals, observable after run() returns
            self.rx_dropped = {stream: r.dropped for r, _cb, stream, _u in rx}
            for r, *_ in rx:
                r.close()
            self._stop.set()
            worker.join(timeout=2.0)
            if self.recorder is not None:
                self.recorder.close()
