"""The benchmark's frozen copies of the sensor's definition: the synthetic
OS-2 metadata, the beam LUTs, the WGS-84 conversions and the packet
encoders. The yardstick keeps its own copies so that a later change to the
port cannot move it; nothing here imports the port.

Copied from (as they stood when the benchmark was written):
- ``Sensor`` (``synthetic_os2_metadata``, ``packet_size``), ``build_luts``:
  slamtpu_torch/lidar/ouster.py
- ``lla2ned``, ``ned2lla``, ``symmetrical_angle``: slamtpu_torch/ins/geodesy.py
- ``euler_zyx_to_quat``, ``quat_to_rot``: slamtpu_torch/ins/anpp.py
  (``_euler_zyx_to_quat``) and slamtpu_torch/apps/common.py (``np_quat_to_rot``)
- ``encode_anpp*``: tests/simulator_np.py;
  ``encode_rng19_sweeps`` is its ``encode_rng19_packet`` vectorised over a
  whole sweep in PyTorch (byte for byte the same packets).
"""
from __future__ import annotations

import dataclasses
import struct

import numpy as np
import torch

WGS84_A = 6378137.0
WGS84_E2 = 0.00669437999014132
WGS84_F = 1.0 / 298.257223563
REF_LLA = np.array([np.deg2rad(52.52), np.deg2rad(13.40), 35.0])
GRAVITY_NED = np.array([0.0, 0.0, 9.81])


@dataclasses.dataclass(frozen=True)
class Sensor:
    columns_per_frame: int = 2048
    pixels_per_column: int = 128
    columns_per_packet: int = 16
    channel_stride: int = 4
    fov_deg: float = 22.5
    lidar_origin_to_beam_origin_mm: float = 12.163

    @classmethod
    def from_config(cls, sensor: dict) -> "Sensor":
        keys = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in sensor.items() if k in keys})

    @property
    def beam_altitude_deg(self) -> np.ndarray:
        return np.linspace(self.fov_deg / 2, -self.fov_deg / 2, self.pixels_per_column)

    @property
    def beam_azimuth_deg(self) -> np.ndarray:
        pix = self.pixels_per_column
        return np.tile([1.0, -1.0, 2.0, -2.0], pix // 4 + 1)[:pix]

    @property
    def packet_size(self) -> int:
        return 32 + self.columns_per_packet * self.column_block + 32

    @property
    def column_block(self) -> int:
        return 12 + self.pixels_per_column * 12


def build_luts(sensor: Sensor, channel_stride: int):
    """(direction (cols, sub, 3), offset (cols, 3)) float32 in the body frame,
    with the identity body-to-lidar transform the configurations use."""
    cols, pix = sensor.columns_per_frame, sensor.pixels_per_column
    sub_ids = np.arange(0, pix, channel_stride, dtype=np.int32)
    m = np.arange(cols, dtype=np.float64)
    meas_az = 2.0 * np.pi * (1.0 - m / cols)
    r0 = sensor.lidar_origin_to_beam_origin_mm * 1e-3
    off = np.stack([r0 * np.cos(meas_az), r0 * np.sin(meas_az), np.zeros(cols)], -1)
    az_rad = np.deg2rad(sensor.beam_azimuth_deg[sub_ids])
    alt_rad = np.deg2rad(sensor.beam_altitude_deg[sub_ids])
    total_az = meas_az[:, None] + az_rad[None, :]
    cos_alt, sin_alt = np.cos(alt_rad), np.sin(alt_rad)
    direction = np.stack([
        cos_alt[None, :] * np.cos(total_az),
        cos_alt[None, :] * np.sin(total_az),
        np.broadcast_to(sin_alt[None, :], total_az.shape),
    ], axis=-1)
    return direction.astype(np.float32), off.astype(np.float32)


# --- geodesy (WGS-84, float64) ---


def symmetrical_angle(x):
    two_pi = 2.0 * np.pi
    y = x - two_pi * np.round(x / two_pi)
    return np.where(y == np.pi, -np.pi, y)


def lla2ned(lla, ref_lla):
    """Small-angle series expansion of geodetic -> local NED."""
    lat, lon, alt = lla[..., 0], lla[..., 1], lla[..., 2]
    rlat, rlon, ralt = ref_lla[..., 0], ref_lla[..., 1], ref_lla[..., 2]
    dphi = lat - rlat
    dlam = symmetrical_angle(lon - rlon)
    dh = alt - ralt
    cp, sp = np.cos(rlat), np.sin(rlat)
    tmp1 = np.sqrt(1.0 - WGS84_E2 * sp * sp)
    tmp3 = tmp1**3
    dlam2, dphi2 = dlam * dlam, dphi * dphi
    a, e2 = WGS84_A, WGS84_E2
    E = ((a / tmp1 + ralt) * cp * dlam - (a * (1 - e2) / tmp3 + ralt) * sp * dphi * dlam
         + cp * dlam * dh)
    N = ((a * (1 - e2) / tmp3 + ralt) * dphi + 1.5 * cp * sp * a * e2 * dphi2
         + sp * sp * dh * dphi + 0.5 * sp * cp * (a / tmp1 + ralt) * dlam2)
    D = -(dh - 0.5 * (a - 1.5 * a * e2 * cp * cp + 0.5 * a * e2 + ralt) * dphi2
          - 0.5 * cp * cp * (a / tmp1 - ralt) * dlam2)
    return np.stack([N, E, D], axis=-1)


def ned2lla(ned, ref_lla, iterations: int = 5):
    """Exact NED -> geodetic via ECEF with a fixed 5-step Bowring solve."""
    n, e, d = ned[..., 0], ned[..., 1], ned[..., 2]
    rlat, rlon, ralt = ref_lla[..., 0], ref_lla[..., 1], ref_lla[..., 2]
    a, f = WGS84_A, WGS84_F
    b = (1.0 - f) * a
    e2 = f * (2.0 - f)
    ep2 = e2 / (1.0 - e2)
    slat, clat = np.sin(rlat), np.cos(rlat)
    slon, clon = np.sin(rlon), np.cos(rlon)
    Nval = a / np.sqrt(1.0 - e2 * slat * slat)
    rho0 = (Nval + ralt) * clat
    z0 = (Nval * (1.0 - e2) + ralt) * slat
    x0, y0 = rho0 * clon, rho0 * slon
    t = clat * (-d) - slat * n
    dz = slat * (-d) + clat * n
    dx = clon * t - slon * e
    dy = slon * t + clon * e
    x, y, z = x0 + dx, y0 + dy, z0 + dz
    lon = np.arctan2(y, x)
    rho = np.hypot(x, y)
    beta = np.arctan2(z, (1.0 - f) * rho)
    lat = np.arctan2(z + b * ep2 * np.sin(beta) ** 3, rho - a * e2 * np.cos(beta) ** 3)
    for _ in range(iterations):
        beta = np.arctan2((1.0 - f) * np.sin(lat), np.cos(lat))
        lat = np.arctan2(z + b * ep2 * np.sin(beta) ** 3, rho - a * e2 * np.cos(beta) ** 3)
    slat = np.sin(lat)
    Nl = a / np.sqrt(1.0 - e2 * slat * slat)
    alt = rho * np.cos(lat) + (z + e2 * Nl * slat) * slat - Nl
    return np.stack([lat, lon, alt], axis=-1)


# --- attitude ---


def euler_zyx_to_quat(roll, pitch, yaw):
    """q = Rz(yaw) Ry(pitch) Rx(roll), [w,x,y,z], computed in the precision of
    the angles (the decoder passes float32)."""
    cr, sr = np.cos(roll / 2), np.sin(roll / 2)
    cp, sp = np.cos(pitch / 2), np.sin(pitch / 2)
    cy, sy = np.cos(yaw / 2), np.sin(yaw / 2)
    return np.array([
        cy * cp * cr + sy * sp * sr,
        cy * cp * sr - sy * sp * cr,
        cy * sp * cr + sy * cp * sr,
        sy * cp * cr - cy * sp * sr,
    ], dtype=np.float64)


def quat_to_rot(q) -> np.ndarray:
    qw, qx, qy, qz = np.asarray(q, np.float64)
    n = qw * qw + qx * qx + qy * qy + qz * qz
    s = 2.0 / n if n > 0 else 2.0
    wx, wy, wz = s * qw * qx, s * qw * qy, s * qw * qz
    xx, xy, xz = s * qx * qx, s * qx * qy, s * qx * qz
    yy, yz, zz = s * qy * qy, s * qy * qz, s * qz * qz
    return np.array([
        [1.0 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1.0 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1.0 - (xx + yy)],
    ])


# --- packet encoders ---


def encode_rng19_sweeps(sensor: Sensor, frame_ids, ts_ns, ranges_mm) -> torch.Tensor:
    """RNG19_RFL8_SIG16_NIR16 packets of whole sweeps on the device:
    frame_ids (S,) int64, ts_ns (S, cols) int64, ranges_mm (S, cols, pix)
    int64 -> (S, packets, packet_size) uint8, reflectivity 80 everywhere."""
    S, cols, pix = ranges_mm.shape
    cpp = sensor.columns_per_packet
    P = cols // cpp
    dev = ranges_mm.device
    block = torch.zeros((S, cols, sensor.column_block), dtype=torch.uint8, device=dev)
    block[:, :, 0:8] = ts_ns.contiguous().view(torch.uint8).view(S, cols, 8)
    m = torch.arange(cols, device=dev)
    block[:, :, 8] = (m & 0xFF).to(torch.uint8)
    block[:, :, 9] = (m >> 8).to(torch.uint8)
    block[:, :, 10] = 1
    ch = block[:, :, 12:].view(S, cols, pix, 12)
    r = ranges_mm & 0x7FFFF
    ch[..., 0] = (r & 0xFF).to(torch.uint8)
    ch[..., 1] = ((r >> 8) & 0xFF).to(torch.uint8)
    ch[..., 2] = ((r >> 16) & 0xFF).to(torch.uint8)
    ch[..., 4] = 80
    out = torch.zeros((S, P, sensor.packet_size), dtype=torch.uint8, device=dev)
    out[:, :, 0] = 1
    fid = (frame_ids & 0xFFFF)[:, None]
    out[:, :, 2] = (fid & 0xFF).to(torch.uint8)
    out[:, :, 3] = (fid >> 8).to(torch.uint8)
    out[:, :, 32:32 + cpp * sensor.column_block] = block.view(S, P, cpp * sensor.column_block)
    return out


def encode_anpp20(t, lla, vel_ned, rpy, accel, gyro, sigma_pos, filt_status=0x000F):
    secs = int(t)
    usecs = int(round((t - secs) * 1e6))
    payload = struct.pack("<HHII", 0, filt_status, secs, usecs)
    payload += struct.pack("<ddd", *lla)
    payload += struct.pack("<16f", *vel_ned, *accel, float(np.linalg.norm(accel)) / 9.81,
                           *rpy, *gyro, *sigma_pos)
    return bytes([0, 20, 100, 0, 0]) + payload


def encode_anpp25(s=(0.03, 0.03, 0.05)):
    return bytes([0, 25, 12, 0, 0]) + struct.pack("<3f", *s)


def encode_anpp26(s=(0.002, 0.002, 0.004)):
    return bytes([0, 26, 12, 0, 0]) + struct.pack("<3f", *s)


def encode_anpp28(accel, gyro, mag=np.zeros(3), env=(25.0, 101325.0, 25.0)):
    return bytes([0, 28, 48, 0, 0]) + struct.pack("<12f", *accel, *gyro, *mag, *env)


def encode_anpp29(t, lla, vel_ned, sigma=(0.02, 0.02, 0.05)):
    secs = int(t)
    usecs = int(round((t - secs) * 1e6))
    payload = struct.pack("<II", secs, usecs)
    payload += struct.pack("<ddd", *lla)
    payload += struct.pack("<10f", *vel_ned, *sigma, 0.01, 0.0, 0.001, 0.002)
    payload += struct.pack("<H", 0x7F)
    return bytes([0, 29, 74, 0, 0]) + payload
