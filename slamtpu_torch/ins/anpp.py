"""Host copy of ``slamtpu/ins/anpp.py`` (numpy only, code unchanged).

The port cannot import it from ``slamtpu``: ``slamtpu/__init__.py``
imports JAX, so any ``import slamtpu.<module>`` pulls JAX in, and the
GPU port runs where JAX is absent. The docstring below is the
original's.

ANPP GNSS/INS ("compass") packet decoding and the fused NavFrame.

Re-implementation of the reference CompCallback/CompFrame
(reference src/compcallback.cpp:159-403,
reference include/dataframe.hpp:19-297) with the 80-field struct
regrouped into semantically-typed arrays. A NavFrame is emitted once all five
ANPP packet IDs have been accumulated (20 = system state, 25 = velocity
sigmas, 26 = attitude sigmas, 28 = raw IMU/mag/baro, 29 = external GNSS),
matching CompFrame::isValid (dataframe.hpp:173-175).

Interpolation uses the reference's five strategies
(dataframe.hpp:184-296): lerp for numerics, slerp for the quaternion, OR for
failure/event bits, AND for init/valid bits, nearest for GNSS fix status.

Wire layout notes (offsets are absolute within the 5-byte-header packet):
- header: [LRC, packet_id, length, crc16_lo, crc16_hi]; like the reference we
  dispatch on id/length only (compcallback.cpp:186-188).
- timestamps are unix seconds + microseconds folded mod 86400 s
  (compcallback.cpp:242-243), the same time base as the LiDAR decoder.
- packet 20 Euler angles are converted ZYX -> quaternion
  (compcallback.cpp:278-287), i.e. q = Rz(yaw) Ry(pitch) Rx(roll).
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Optional

import numpy as np

SECONDS_PER_DAY = 86400.0

# Failure/event bits packed into NavFrame.fail_bits (interp: OR)
FAIL_BIT_NAMES = [
    "system_failure",
    "accel_failure",
    "gyro_failure",
    "mag_failure",
    "gnss_failure_secondary",
    "gnss_failure_primary",
    "accel_over_range",
    "gyro_over_range",
    "mag_over_range",
    "min_temp_alarm",
    "max_temp_alarm",
    "gnss_antenna_broken",
    "data_overflow_alarm",
    "event1",
    "event2",
    "gnss_fix_interrupted",
]
# Init/valid bits packed into NavFrame.init_bits (interp: AND)
INIT_BIT_NAMES = [
    "orientation_filter_init",
    "navigation_filter_init",
    "heading_init",
    "utc_time_init",
    "internal_gnss_enabled",
    "dual_antenna_heading",
    "velocity_heading_enabled",
    "external_position_active",
    "external_velocity_active",
    "external_heading_active",
    "doppler_velocity_valid_29",
    "time_valid_29",
    "external_gnss_29",
    "tilt_valid_29",
]


def _euler_zyx_to_quat(roll, pitch, yaw):
    """q = Rz(yaw) Ry(pitch) Rx(roll), [w,x,y,z] (float32 like the reference)."""
    cr, sr = np.cos(roll / 2), np.sin(roll / 2)
    cp, sp = np.cos(pitch / 2), np.sin(pitch / 2)
    cy, sy = np.cos(yaw / 2), np.sin(yaw / 2)
    return np.array(
        [
            cy * cp * cr + sy * sp * sr,
            cy * cp * sr - sy * sp * cr,
            cy * sp * cr + sy * cp * sr,
            sy * cp * cr - cy * sp * sr,
        ],
        dtype=np.float64,
    )


@dataclasses.dataclass
class NavFrame:
    """Fused GNSS/INS navigation state (one 50 Hz sample)."""

    t: float = 0.0  # packet-20 timestamp, s since midnight UTC
    lla: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))  # rad,rad,m
    vel_ned: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    quat: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([1.0, 0, 0, 0])
    )  # body->NED, [w,x,y,z]
    rpy: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    accel_nav: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))  # pkt 20
    gyro_nav: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))  # pkt 20
    g_force: float = 0.0
    sigma_pos: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    sigma_vel: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))  # pkt 25
    sigma_rpy: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))  # pkt 26
    imu_accel: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))  # pkt 28
    imu_gyro: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    mag: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    env: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3)
    )  # imu temp, pressure, pressure temp
    # packet 29 (external GNSS)
    t29: float = 0.0
    lla29: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    vel29: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    sigma_pos29: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    tilt_heading29: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(4)
    )  # tilt, heading, sigma_tilt, sigma_heading
    fail_bits: int = 0
    init_bits: int = 0
    fix_status: int = 0  # pkt 20 GNSS fix (3 bits)
    fix_status29: int = 0
    valid_mask: int = 0  # bit per packet id {20,25,26,28,29} -> {1,2,4,8,16}

    def is_complete(self) -> bool:
        return self.valid_mask == 0b11111


def _np_slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    """Shortest-arc quaternion slerp in host numpy f64 (same semantics as
    core.so3.quat_slerp, kept on the host)."""
    q0 = np.asarray(q0, np.float64)
    q1 = np.asarray(q1, np.float64)
    dot = float(q0 @ q1)
    if dot < 0.0:
        q1, dot = -q1, -dot
    dot = min(dot, 1.0)
    theta = float(np.arccos(dot))
    sin_theta = float(np.sin(theta))
    if sin_theta < 1e-6:
        w0, w1 = 1.0 - t, t
    else:
        w0 = float(np.sin((1.0 - t) * theta)) / sin_theta
        w1 = float(np.sin(t * theta)) / sin_theta
    q = w0 * q0 + w1 * q1
    return q / np.linalg.norm(q)


def interpolate(a: NavFrame, b: NavFrame, t: float) -> NavFrame:
    """Five-strategy interpolation (dataframe.hpp:184-296)."""
    t = float(np.clip(t, 0.0, 1.0))

    def lerp(x, y):
        return np.asarray(x) + t * (np.asarray(y) - np.asarray(x))

    q = _np_slerp(a.quat, b.quat, t)
    return NavFrame(
        t=float(lerp(a.t, b.t)),
        lla=lerp(a.lla, b.lla),
        vel_ned=lerp(a.vel_ned, b.vel_ned),
        quat=q,
        rpy=lerp(a.rpy, b.rpy),
        accel_nav=lerp(a.accel_nav, b.accel_nav),
        gyro_nav=lerp(a.gyro_nav, b.gyro_nav),
        g_force=float(lerp(a.g_force, b.g_force)),
        sigma_pos=lerp(a.sigma_pos, b.sigma_pos),
        sigma_vel=lerp(a.sigma_vel, b.sigma_vel),
        sigma_rpy=lerp(a.sigma_rpy, b.sigma_rpy),
        imu_accel=lerp(a.imu_accel, b.imu_accel),
        imu_gyro=lerp(a.imu_gyro, b.imu_gyro),
        mag=lerp(a.mag, b.mag),
        env=lerp(a.env, b.env),
        t29=float(lerp(a.t29, b.t29)),
        lla29=lerp(a.lla29, b.lla29),
        vel29=lerp(a.vel29, b.vel29),
        sigma_pos29=lerp(a.sigma_pos29, b.sigma_pos29),
        tilt_heading29=lerp(a.tilt_heading29, b.tilt_heading29),
        fail_bits=a.fail_bits | b.fail_bits,
        init_bits=a.init_bits & b.init_bits,
        fix_status=a.fix_status if t < 0.5 else b.fix_status,
        fix_status29=a.fix_status29 if t < 0.5 else b.fix_status29,
        valid_mask=a.valid_mask & b.valid_mask,
    )


class AnppDecoder:
    """Accumulates ANPP packets 20/25/26/28/29 into complete NavFrames."""

    HEADER = 5
    SIZES = {20: 100, 25: 12, 26: 12, 28: 48, 29: 74}

    def __init__(self):
        self._frame = NavFrame()

    def push_packet(self, buf: bytes) -> Optional[NavFrame]:
        if len(buf) < self.HEADER:
            return None
        pid = buf[1]
        plen = buf[2]
        expect = self.SIZES.get(pid)
        if expect is None or plen != expect or len(buf) != expect + self.HEADER:
            return None
        f = self._frame
        if pid == 20:
            (sys_status, filt_status, secs, usecs) = struct.unpack_from("<HHII", buf, 5)
            if usecs > 999_999:
                return None
            f.t = float((secs + usecs * 1e-6) % SECONDS_PER_DAY)
            lat, lon, alt = struct.unpack_from("<ddd", buf, 17)
            f.lla = np.array([lat, lon, alt])
            vn, ve, vd, ax, ay, az, gf, r, p, y, wx, wy, wz, sla, slo, sal = (
                struct.unpack_from("<16f", buf, 41)
            )
            f.vel_ned = np.array([vn, ve, vd])
            f.accel_nav = np.array([ax, ay, az])
            f.g_force = gf
            f.rpy = np.array([r, p, y])
            f.gyro_nav = np.array([wx, wy, wz])
            f.sigma_pos = np.array([sla, slo, sal])
            f.quat = _euler_zyx_to_quat(np.float32(r), np.float32(p), np.float32(y))
            # failure/event bits (compcallback.cpp:196-231); note bits 9,13
            # of the wire word are reserved and skipped, matching the struct.
            fb = 0
            wire_fail = [0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 11, 14, 15]
            for i, w in enumerate(wire_fail):
                if sys_status & (1 << w):
                    fb |= 1 << i
            if filt_status & 0x0080:
                fb |= 1 << FAIL_BIT_NAMES.index("event1")
            if filt_status & 0x0100:
                fb |= 1 << FAIL_BIT_NAMES.index("event2")
            if filt_status & 0x1000:
                fb |= 1 << FAIL_BIT_NAMES.index("gnss_fix_interrupted")
            f.fail_bits = fb
            ib = f.init_bits & ~0x3FF  # keep pkt-29 bits
            wire_init = [(0, 0), (1, 1), (2, 2), (3, 3), (9, 4), (10, 5), (11, 6), (13, 7), (14, 8), (15, 9)]
            for w, i in wire_init:
                if filt_status & (1 << w):
                    ib |= 1 << i
            f.init_bits = ib
            f.fix_status = (filt_status >> 4) & 0x07
            f.valid_mask |= 1
        elif pid == 25:
            f.sigma_vel = np.array(struct.unpack_from("<3f", buf, 5))
            f.valid_mask |= 2
        elif pid == 26:
            f.sigma_rpy = np.array(struct.unpack_from("<3f", buf, 5))
            f.valid_mask |= 4
        elif pid == 28:
            vals = struct.unpack_from("<12f", buf, 5)
            f.imu_accel = np.array(vals[0:3])
            f.imu_gyro = np.array(vals[3:6])
            f.mag = np.array(vals[6:9])
            f.env = np.array(vals[9:12])
            f.valid_mask |= 8
        elif pid == 29:
            secs, usecs = struct.unpack_from("<II", buf, 5)
            if usecs > 999_999:
                return None
            f.t29 = float((secs + usecs * 1e-6) % SECONDS_PER_DAY)
            lat, lon, alt = struct.unpack_from("<ddd", buf, 13)
            f.lla29 = np.array([lat, lon, alt])
            vals = struct.unpack_from("<10f", buf, 37)
            f.vel29 = np.array(vals[0:3])
            f.sigma_pos29 = np.array(vals[3:6])
            f.tilt_heading29 = np.array(vals[6:10])
            (status,) = struct.unpack_from("<H", buf, 77)
            f.fix_status29 = status & 0x07
            ib = f.init_bits & 0x3FF
            for i, bit in enumerate([3, 4, 5, 6]):  # doppler, time, ext gnss, tilt
                if status & (1 << bit):
                    ib |= 1 << (10 + i)
            f.init_bits = ib
            f.valid_mask |= 16
        if f.is_complete():
            self._frame = NavFrame()
            return f
        return None
