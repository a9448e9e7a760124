"""Host copy of ``slamtpu/runtime/replay.py`` (numpy only, code unchanged).

The port cannot import it from ``slamtpu``: ``slamtpu/__init__.py``
imports JAX, so any ``import slamtpu.<module>`` pulls JAX in, and the
GPU port runs where JAX is absent. The docstring below is the
original's.

Packet replay files: the offline ingest path (and test harness).

The reference consumes live UDP only; recorded-data replay is the de-facto
integration harness it lacks (SURVEY.md section 4). Format: a stream of
records ``<u8 stream_id><f64 recv_time><u32 size><payload bytes>`` — stream 0
= LiDAR, stream 1 = compass/ANPP. Records must be written in receive order.
"""
from __future__ import annotations

import struct
from typing import Iterator, Tuple

STREAM_LIDAR = 0
STREAM_COMPASS = 1
_HEADER = struct.Struct("<BdI")


class ReplayWriter:
    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, stream_id: int, recv_time: float, payload: bytes):
        self._f.write(_HEADER.pack(stream_id, recv_time, len(payload)))
        self._f.write(payload)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_replay(path: str) -> Iterator[Tuple[int, float, bytes]]:
    """Yield (stream_id, recv_time, payload) records."""
    with open(path, "rb") as f:
        while True:
            hdr = f.read(_HEADER.size)
            if len(hdr) < _HEADER.size:
                return
            sid, ts, size = _HEADER.unpack(hdr)
            payload = f.read(size)
            if len(payload) < size:
                return
            yield sid, ts, payload
