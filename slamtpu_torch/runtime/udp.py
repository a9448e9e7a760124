"""Host copy of ``slamtpu/runtime/udp.py`` (standard library only, code unchanged).

The port cannot import it from ``slamtpu``: ``slamtpu/__init__.py``
imports JAX, so any ``import slamtpu.<module>`` pulls JAX in, and the
GPU port runs where JAX is absent. The docstring below is the
original's.

Asyncio UDP ingest (host side).

Replaces the reference's Boost.Asio receive loop
(reference/include/udpsocket.hpp) with asyncio datagram endpoints. Same
semantics: per-socket receive buffer size, optional multicast join, optional
broadcast, an error callback, and delivery of each datagram to a user
callback. Optionally tees every datagram into a ReplayWriter for offline
replay. Never on the device critical path.
"""
from __future__ import annotations

import asyncio
import dataclasses
import socket
import struct
from typing import Callable, Optional

from .replay import ReplayWriter


@dataclasses.dataclass
class UdpConfig:
    host: str = "0.0.0.0"
    port: int = 7502
    buffer_size: int = 1 << 20
    multicast_group: Optional[str] = None
    broadcast: bool = False
    reuse_address: bool = True
    # stalled-stream watchdog: if no datagram arrives within this window the
    # error callback fires with a TimeoutError and the watchdog re-arms
    # (the reference arms every async_receive with a deadline timer,
    # udpsocket.hpp:213-254). None disables.
    receive_timeout_s: Optional[float] = None
    # multicast scope (IP_MULTICAST_TTL, udpsocket.hpp:126-185). None keeps
    # the OS default (1).
    multicast_ttl: Optional[int] = None
    # hostname resolution budget (resolve-with-timeout, udpsocket.hpp:101-114)
    resolve_timeout_s: float = 5.0


class _Protocol(asyncio.DatagramProtocol):
    def __init__(self, on_data, on_error, recorder, stream_id, loop):
        self.on_data = on_data
        self.on_error = on_error
        self.recorder = recorder
        self.stream_id = stream_id
        self.loop = loop
        self.last_rx = loop.time()

    def datagram_received(self, data, addr):
        self.last_rx = self.loop.time()
        if self.recorder is not None:
            self.recorder.write(self.stream_id, self.loop.time(), data)
        self.on_data(data)

    def error_received(self, exc):
        if self.on_error:
            self.on_error(exc)


class UdpEndpoint:
    """Handle for an open endpoint: the transport plus the receive-timeout
    watchdog (if armed). ``close()`` stops both. Keeps transport attribute
    access working for callers that treat it as a bare transport."""

    def __init__(self, transport, watchdog: Optional[asyncio.Task]):
        self.transport = transport
        self._watchdog = watchdog

    def close(self):
        if self._watchdog is not None:
            self._watchdog.cancel()
            self._watchdog = None
        self.transport.close()

    def __getattr__(self, name):
        return getattr(self.transport, name)


async def _resolve(host: str, timeout_s: float) -> str:
    """Resolve ``host`` to an IPv4 address with a timeout (the reference's
    resolve-with-deadline, udpsocket.hpp:101-114)."""
    try:
        socket.inet_aton(host)
        return host  # already dotted-quad
    except OSError:
        pass
    loop = asyncio.get_running_loop()
    infos = await asyncio.wait_for(
        loop.getaddrinfo(host, None, family=socket.AF_INET, type=socket.SOCK_DGRAM),
        timeout=timeout_s,
    )
    return infos[0][4][0]


async def open_udp(
    cfg: UdpConfig,
    on_data: Callable[[bytes], None],
    on_error: Optional[Callable[[Exception], None]] = None,
    recorder: Optional[ReplayWriter] = None,
    stream_id: int = 0,
) -> UdpEndpoint:
    """Open a UDP endpoint; returns a UdpEndpoint (call .close() to stop)."""
    loop = asyncio.get_running_loop()
    host = await _resolve(cfg.host, cfg.resolve_timeout_s)
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    if cfg.reuse_address:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    if cfg.broadcast:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_BROADCAST, 1)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, cfg.buffer_size)
    sock.bind((host, cfg.port))
    if cfg.multicast_group:
        mreq = struct.pack(
            "4s4s",
            socket.inet_aton(cfg.multicast_group),
            socket.inet_aton(host if host != "0.0.0.0" else "0.0.0.0"),
        )
        sock.setsockopt(socket.IPPROTO_IP, socket.IP_ADD_MEMBERSHIP, mreq)
        if cfg.multicast_ttl is not None:
            sock.setsockopt(
                socket.IPPROTO_IP, socket.IP_MULTICAST_TTL, int(cfg.multicast_ttl)
            )
    sock.setblocking(False)
    proto = _Protocol(on_data, on_error, recorder, stream_id, loop)
    transport, _ = await loop.create_datagram_endpoint(lambda: proto, sock=sock)

    watchdog = None
    if cfg.receive_timeout_s:

        async def _watch():
            # fires on_error(TimeoutError) once per silent window, then
            # re-arms — the stream keeps running (softening, not teardown)
            while True:
                await asyncio.sleep(cfg.receive_timeout_s)
                silent = loop.time() - proto.last_rx
                if silent >= cfg.receive_timeout_s and on_error is not None:
                    on_error(
                        TimeoutError(
                            f"no datagrams on :{cfg.port} for {silent:.1f}s"
                        )
                    )

        watchdog = loop.create_task(_watch())
    return UdpEndpoint(transport, watchdog)
