"""Host copy of ``slamtpu/ins/native.py`` (numpy only, code unchanged).

The port cannot import it from ``slamtpu``: ``slamtpu/__init__.py``
imports JAX, so any ``import slamtpu.<module>`` pulls JAX in, and the
GPU port runs where JAX is absent. The docstring below is the
original's.

ctypes bindings to the native C++ ANPP batch decoder (native/anpp_decode.cpp).

Same build-on-first-use scheme as slamtpu.lidar.native. The returned field
blocks mirror the layout documented in the C++ source; tests/test_native.py
checks exact parity with the Python AnppDecoder.
"""
from __future__ import annotations

import ctypes
import logging
import os
import threading
from typing import Optional

import numpy as np

log = logging.getLogger("slamtpu.ins.native")

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_SRC = os.path.abspath(os.path.join(_NATIVE_DIR, "anpp_decode.cpp"))
_lock = threading.Lock()
_lib = None
_tried = False

FIELDS_PER_PACKET = 40


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        from ..native_build import build_from_source

        so_path = build_from_source(_SRC, "anpp_decode")
        if so_path is None:
            return None
        try:
            lib = ctypes.CDLL(so_path)
        except OSError as e:  # pragma: no cover
            log.warning("native anpp load failed: %s", e)
            return None
        lib.anpp_decode_batch.argtypes = [
            np.ctypeslib.ndpointer(np.uint8, flags="C"),
            np.ctypeslib.ndpointer(np.int64, flags="C"),
            np.ctypeslib.ndpointer(np.int32, flags="C"),
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int32, flags="C"),
            np.ctypeslib.ndpointer(np.float64, flags="C"),
        ]
        lib.anpp_decode_batch.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def decode_batch(packets):
    """Decode a list of ANPP payloads. Returns (pids (n,), fields (n, 40))."""
    lib = _load()
    if lib is None:
        return None
    data = np.frombuffer(b"".join(packets), np.uint8)
    lengths = np.asarray([len(p) for p in packets], np.int32)
    offsets = np.concatenate([[0], np.cumsum(lengths[:-1], dtype=np.int64)]).astype(np.int64)
    n = len(packets)
    pids = np.empty(n, np.int32)
    fields = np.zeros((n, FIELDS_PER_PACKET), np.float64)
    rc = lib.anpp_decode_batch(
        np.ascontiguousarray(data), offsets, lengths, n, pids, fields
    )
    if rc != 0:
        return None
    return pids, fields
