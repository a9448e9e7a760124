"""Host copy of ``slamtpu/runtime/native_udp.py`` (numpy only, code unchanged).

The port cannot import it from ``slamtpu``: ``slamtpu/__init__.py``
imports JAX, so any ``import slamtpu.<module>`` pulls JAX in, and the
GPU port runs where JAX is absent. It builds ``native/udp_ingest.cpp``
through the port's ``native_build``. The docstring below is the
original's; its last sentence names what a caller may do when
``available()`` is False: ``NativeUdpReceiver`` itself raises, and a
``LivePipeline`` with ``io_backend="native"`` raises with it and never
switches to asyncio.

ctypes wrapper for the native C++ UDP receiver (native/udp_ingest.cpp).

The native path exists for production ingest rates (the Berlin LiDAR stream
is 1280 x 24832-byte datagrams/s): one dedicated C++ receiver thread per
socket, Python drains the ring in batches so the GIL is taken once per batch
instead of once per packet. Falls back to None when the toolchain is absent
(callers then use the asyncio backend, runtime/udp.py).
"""
from __future__ import annotations

import ctypes
import logging
import os
import threading
from typing import List, Optional

import numpy as np

log = logging.getLogger("slamtpu.runtime.native_udp")

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_SRC = os.path.abspath(os.path.join(_NATIVE_DIR, "udp_ingest.cpp"))
_lock = threading.Lock()
_lib = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        from ..native_build import build_from_source

        so_path = build_from_source(_SRC, "udp_ingest", extra_flags=("-pthread",))
        if so_path is None:
            return None
        try:
            lib = ctypes.CDLL(so_path)
        except OSError as e:  # pragma: no cover
            log.warning("native udp load failed: %s", e)
            return None
        lib.udp_ingest_start.restype = ctypes.c_void_p
        lib.udp_ingest_start.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
        ]
        lib.udp_ingest_poll.restype = ctypes.c_int
        lib.udp_ingest_poll.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ]
        lib.udp_ingest_silent_ms.restype = ctypes.c_int64
        lib.udp_ingest_silent_ms.argtypes = [ctypes.c_void_p]
        lib.udp_ingest_dropped.restype = ctypes.c_uint64
        lib.udp_ingest_dropped.argtypes = [ctypes.c_void_p]
        lib.udp_ingest_stop.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


class NativeUdpReceiver:
    """One bound socket + C++ receiver thread + bounded datagram ring."""

    def __init__(
        self,
        host: str = "0.0.0.0",
        port: int = 7502,
        buffer_size: int = 1 << 22,
        max_packet: int = 25_000,
        ring_capacity: int = 4096,
        batch: int = 256,
    ):
        lib = _load()
        if lib is None:
            raise RuntimeError("native udp ingest unavailable (no toolchain)")
        self._lib = lib
        self._max_packet = max_packet
        self._batch = batch
        self._out = np.empty((batch, max_packet), np.uint8)
        self._lens = (ctypes.c_int * batch)()
        self._handle = lib.udp_ingest_start(
            host.encode(), port, buffer_size, max_packet, ring_capacity
        )
        if not self._handle:
            raise OSError(f"could not bind native UDP socket {host}:{port}")

    def poll(self) -> List[bytes]:
        """Drain up to one batch of pending datagrams (non-blocking)."""
        n = self._lib.udp_ingest_poll(
            self._handle,
            self._out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self._lens,
            self._batch,
        )
        return [bytes(self._out[i, : self._lens[i]]) for i in range(n)]

    @property
    def silent_ms(self) -> int:
        return int(self._lib.udp_ingest_silent_ms(self._handle))

    @property
    def dropped(self) -> int:
        return int(self._lib.udp_ingest_dropped(self._handle))

    def close(self):
        if self._handle:
            self._lib.udp_ingest_stop(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover - GC order dependent
        try:
            self.close()
        except Exception:
            pass
