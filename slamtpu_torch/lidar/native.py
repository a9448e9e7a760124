"""Host copy of ``slamtpu/lidar/native.py`` (numpy only, code unchanged).

The port cannot import it from ``slamtpu``: ``slamtpu/__init__.py``
imports JAX, so any ``import slamtpu.<module>`` pulls JAX in, and the
GPU port runs where JAX is absent. The docstring below is the
original's.

ctypes bindings to the native C++ Ouster packet decoder.

Builds native/ouster_decode.cpp on first use (g++ -O3 -march=native) and
caches the shared object next to the source. Falls back cleanly: callers
should use ``available()`` and keep slamtpu.lidar.ouster.parse_packet as the
pure-Python path (both are golden-tested against each other in
tests/test_native.py).
"""
from __future__ import annotations

import ctypes
import logging
import os
import threading
from typing import Optional

import numpy as np

log = logging.getLogger("slamtpu.lidar.native")

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_SRC = os.path.abspath(os.path.join(_NATIVE_DIR, "ouster_decode.cpp"))
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

        so_path = build_from_source(_SRC, "ouster_decode")
        if so_path is None:
            return None
        try:
            lib = ctypes.CDLL(so_path)
        except OSError as e:  # pragma: no cover
            log.warning("native decoder load failed: %s", e)
            return None
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
        u16p = np.ctypeslib.ndpointer(np.uint16, flags="C")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
        argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            i32p, ctypes.c_int32,
            u16p, f64p, i32p, u8p,
            f32p, u8p, u16p, u16p, u8p,
        ]
        for name in ("ouster_decode_rng19", "ouster_decode_legacy"):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def decode_batch(buf: bytes, meta, luts, profile: Optional[str] = None):
    """Decode a batch of concatenated packets.

    Returns dict of arrays with leading dim (n_packets * columns_per_packet),
    plus ``pkt_ok`` (n_packets,). None if the native library is unavailable
    or the buffer size is not a whole number of packets.
    """
    lib = _load()
    if lib is None:
        return None
    from .ouster import packet_size

    psize = packet_size(meta)
    if len(buf) % psize != 0:
        return None
    n_pkts = len(buf) // psize
    n_rows = n_pkts * meta.columns_per_packet
    n_sub = luts.subset_channels
    data = np.frombuffer(buf, np.uint8)
    out = dict(
        frame_ids=np.empty(n_rows, np.uint16),
        timestamps_s=np.empty(n_rows, np.float64),
        m_ids=np.empty(n_rows, np.int32),
        col_valid=np.empty(n_rows, np.uint8),
        ranges_m=np.empty((n_rows, n_sub), np.float32),
        reflectivity=np.empty((n_rows, n_sub), np.uint8),
        signal=np.empty((n_rows, n_sub), np.uint16),
        nir=np.empty((n_rows, n_sub), np.uint16),
        pkt_ok=np.empty(n_pkts, np.uint8),
    )
    profile = profile or meta.udp_profile
    fn = (
        lib.ouster_decode_rng19
        if profile == "RNG19_RFL8_SIG16_NIR16"
        else lib.ouster_decode_legacy
    )
    rc = fn(
        np.ascontiguousarray(data), psize, n_pkts,
        meta.pixels_per_column, meta.columns_per_packet, meta.columns_per_frame,
        np.ascontiguousarray(luts.subset_c_ids.astype(np.int32)), n_sub,
        out["frame_ids"], out["timestamps_s"], out["m_ids"], out["col_valid"],
        out["ranges_m"], out["reflectivity"], out["signal"], out["nir"],
        out["pkt_ok"],
    )
    if rc != 0:
        return None
    out["col_valid"] = out["col_valid"].astype(bool)
    return out
