"""Synthetic sensor simulator without JAX: a copy of tests/simulator.py that
imports only numpy and the PyTorch port's host modules, so it runs where
JAX is absent (the GPU port's smoke run). It writes the same replay bytes
as tests/simulator.py (pinned by tests/test_torch_host.py).

Synthetic sensor simulator: generates correlated Ouster + ANPP packet
streams along a ground-truth trajectory and writes them to a replay file.

World model: analytic axis-aligned planes (ground + two walls) raycast in
closed form — enough structure to constrain all 6 dofs of NDT registration.
Trajectory: constant body velocity + constant yaw rate (circular arc), which
gives exact closed-form position/velocity/acceleration for the IMU stream.
"""
import struct

import numpy as np

from slamtpu_torch.ins.geodesy import ned2lla
from slamtpu_torch.lidar.ouster import SensorMeta, build_luts, packet_size
from slamtpu_torch.runtime.replay import STREAM_COMPASS, STREAM_LIDAR, ReplayWriter


def rpy_to_rot(rpy):
    """R = Rz(yaw) Ry(pitch) Rx(roll), numpy float64."""
    r, p, y = rpy
    cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(p), np.sin(p), np.cos(y), np.sin(y)
    return np.array([
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr],
    ])


def rot_to_rpy(R):
    """Inverse of rpy_to_rot: [roll, pitch, yaw]."""
    return np.array([
        np.arctan2(R[2, 1], R[2, 2]),
        np.arcsin(np.clip(-R[2, 0], -1.0, 1.0)),
        np.arctan2(R[1, 0], R[0, 0]),
    ])

REF_LLA = np.array([np.deg2rad(52.52), np.deg2rad(13.40), 35.0])
GRAVITY_NED = np.array([0.0, 0.0, 9.81])


# ---------------------------------------------------------------------------
# trajectory
# ---------------------------------------------------------------------------

class ArcTrajectory:
    """Constant body-frame forward speed v, constant yaw rate w (NED)."""

    def __init__(self, v=3.0, yaw_rate=0.05, z=0.0):
        self.v = v
        self.w = yaw_rate
        self.z = z

    def pose(self, t):
        w, v = self.w, self.v
        yaw = w * t
        if abs(w) > 1e-9:
            pos = np.array([v / w * np.sin(yaw), v / w * (1 - np.cos(yaw)), self.z])
        else:
            pos = np.array([v * t, 0.0, self.z])
        R = rpy_to_rot([0.0, 0.0, yaw])
        return R, pos

    def poses(self, ts):
        """Vectorized pose(t): ts (T,) -> (R (T,3,3), pos (T,3)). Pure numpy
        closed form (the skewed-sweep renderer calls this per column; the
        scalar path would cost minutes at 2048 cols)."""
        ts = np.asarray(ts, np.float64)
        yaw = self.w * ts
        if abs(self.w) > 1e-9:
            pos = np.stack(
                [
                    self.v / self.w * np.sin(yaw),
                    self.v / self.w * (1 - np.cos(yaw)),
                    np.full_like(yaw, self.z),
                ],
                -1,
            )
        else:
            pos = np.stack(
                [self.v * ts, np.zeros_like(yaw), np.full_like(yaw, self.z)], -1
            )
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.zeros(ts.shape + (3, 3))
        R[..., 0, 0] = c
        R[..., 0, 1] = -s
        R[..., 1, 0] = s
        R[..., 1, 1] = c
        R[..., 2, 2] = 1.0
        return R, pos

    def vel_world(self, t):
        yaw = self.w * t
        return np.array([self.v * np.cos(yaw), self.v * np.sin(yaw), 0.0])

    def accel_world(self, t):
        yaw = self.w * t
        return self.w * self.v * np.array([-np.sin(yaw), np.cos(yaw), 0.0])

    def imu_sample(self, t):
        """(specific force body, angular rate body)."""
        R, _ = self.pose(t)
        f_body = R.T @ (self.accel_world(t) - GRAVITY_NED)
        return f_body, np.array([0.0, 0.0, self.w])


# ---------------------------------------------------------------------------
# analytic plane world + raycaster
# ---------------------------------------------------------------------------

class PlaneWorld:
    """Ground + walls + vertical pillars.

    Infinite planes alone are translation-degenerate for scan matching (any
    in-plane slide fits), so a field of cylinders provides the texture that
    makes registration observable in all 6 dofs."""

    def __init__(self, ground_z=2.0, wall_x=60.0, wall_y=40.0, noise=0.0, seed=3,
                 n_pillars=24, pillar_radius=0.6):
        self.planes = [  # (axis, value)
            (2, ground_z),
            (0, wall_x),
            (1, wall_y),
            (0, -wall_x),
            (1, -wall_y),
        ]
        self.noise = noise
        self.rng = np.random.default_rng(seed)
        # deterministic pillar field inside the arena, z from -6 (up) to ground
        prng = np.random.default_rng(1234)
        self.pillars = np.stack(
            [
                prng.uniform(-wall_x * 0.8, wall_x * 0.8, n_pillars),
                prng.uniform(-wall_y * 0.8, wall_y * 0.8, n_pillars),
            ],
            axis=-1,
        )
        self.pillar_radius = pillar_radius
        self.ground_z = ground_z

    def raycast(self, origins, dirs, max_range=200.0):
        """origins/dirs: (..., 3) world frame -> ranges (...,) (0 = no hit)."""
        best = np.full(origins.shape[:-1], np.inf)
        for axis, value in self.planes:
            d = dirs[..., axis]
            denom = np.where(np.abs(d) < 1e-9, 1e-9, d)
            t = (value - origins[..., axis]) / denom
            t = np.where(t > 0.1, t, np.inf)
            best = np.minimum(best, t)
        # vertical cylinders: solve |oxy + t dxy - c|^2 = r^2
        oxy = origins[..., :2]
        dxy = dirs[..., :2]
        a = np.sum(dxy * dxy, axis=-1)
        a = np.where(a < 1e-12, 1e-12, a)
        for c in self.pillars:
            rel = oxy - c
            b = 2.0 * np.sum(rel * dxy, axis=-1)
            cc = np.sum(rel * rel, axis=-1) - self.pillar_radius**2
            disc = b * b - 4 * a * cc
            ok = disc > 0
            t = np.where(ok, (-b - np.sqrt(np.where(ok, disc, 0.0))) / (2 * a), np.inf)
            t = np.where(t > 0.1, t, np.inf)
            # height extent: from 6 m above ground down to the ground plane
            z_hit = origins[..., 2] + t * dirs[..., 2]
            t = np.where(
                (z_hit <= self.ground_z) & (z_hit >= self.ground_z - 6.0), t, np.inf
            )
            best = np.minimum(best, t)
        ranges = np.where(np.isfinite(best) & (best <= max_range), best, 0.0)
        if self.noise > 0:
            ranges = np.where(
                ranges > 0, ranges + self.rng.normal(0, self.noise, ranges.shape), 0.0
            )
        return ranges


# ---------------------------------------------------------------------------
# packet encoders (independent golden encoders; layouts per
# reference src/lidarcallback.cpp:632-891, src/compcallback.cpp:159-403)
# ---------------------------------------------------------------------------

def encode_rng19_packet(meta, frame_id, m_ids, ts_ns, ranges_mm, refl):
    """Vectorized golden encoder (byte-identical to the original per-point
    struct.pack loop — pinned by TestSimulatorEncoder): the Python loop cost
    ~0.27 ms/column, i.e. ~35 s per Berlin-scale sweep of pure packing."""
    pix = meta.pixels_per_column
    ncols = len(m_ids)
    # one column block = 12-byte header ("<QHBx") + pix * 12-byte channels
    block = np.zeros((ncols, 12 + pix * 12), np.uint8)
    hdr = block[:, :12]
    hdr[:, 0:8] = np.asarray(ts_ns, np.uint64)[:, None].view(np.uint8).reshape(
        ncols, 8
    )
    m = np.asarray(m_ids, np.uint16)
    hdr[:, 8] = (m & 0xFF).astype(np.uint8)
    hdr[:, 9] = (m >> 8).astype(np.uint8)
    hdr[:, 10] = 1  # column status
    ch = block[:, 12:].reshape(ncols, pix, 12)
    r = np.asarray(ranges_mm, np.uint32)[:ncols] & 0x7FFFF
    ch[..., 0] = (r & 0xFF).astype(np.uint8)
    ch[..., 1] = ((r >> 8) & 0xFF).astype(np.uint8)
    ch[..., 2] = ((r >> 16) & 0xFF).astype(np.uint8)
    ch[..., 4] = np.asarray(refl, np.uint8)[:ncols]
    out = (
        struct.pack("<HH", 0x0001, frame_id & 0xFFFF) + bytes(28)
        + block.tobytes() + bytes(32)
    )
    assert len(out) == packet_size(meta)
    return out


def encode_anpp20(t, lla, vel_ned, rpy, accel=np.zeros(3), gyro=np.zeros(3),
                  sigma_pos=(0.02, 0.02, 0.05), filt_status=0x000F):
    secs = int(t)
    usecs = int(round((t - secs) * 1e6))
    payload = struct.pack("<HHII", 0, filt_status, secs, usecs)
    payload += struct.pack("<ddd", *lla)
    payload += struct.pack(
        "<16f", *vel_ned, *accel, float(np.linalg.norm(accel)) / 9.81,
        *rpy, *gyro, *sigma_pos,
    )
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


# ---------------------------------------------------------------------------
# full scenario writer
# ---------------------------------------------------------------------------

def small_meta(cols=128, pix=32, cpp=16):
    from slamtpu_torch.lidar.ouster import synthetic_os2_metadata

    return synthetic_os2_metadata(
        columns_per_frame=cols, pixels_per_column=pix, columns_per_packet=cpp
    )


def simulate_replay(
    path,
    meta: SensorMeta,
    params,
    n_sweeps=12,
    sweep_hz=10.0,
    nav_hz=50.0,
    traj=None,
    world=None,
    t0=1000.0,
    nav_sigma_pos=(0.02, 0.02, 0.05),
    nav_pos_noise=0.0,
    imu_noise=0.0,
    seed=11,
    skewed=False,
):
    """Write an interleaved lidar+compass replay along the trajectory.

    Returns the list of ground-truth (R, pos) at each sweep END time (the
    pipeline's keyframe timestamps)."""
    traj = traj or ArcTrajectory()
    world = world or PlaneWorld(noise=0.005)
    rng = np.random.default_rng(seed)
    luts = build_luts(meta, params)
    # full-resolution directions for encoding (stride handled by decoder)
    from slamtpu_torch.lidar.ouster import LidarParams

    full_luts = build_luts(meta, LidarParams(
        body_to_lidar_rotation=params.body_to_lidar_rotation,
        body_to_lidar_translation=params.body_to_lidar_translation,
        channel_stride=1,
    ))

    sweep_period = 1.0 / sweep_hz
    nav_period = 1.0 / nav_hz
    cols = meta.columns_per_frame
    cpp = meta.columns_per_packet

    events = []  # (time, stream, payload)

    # nav stream covering [t0 - 0.5, end + 0.5]
    t_end = t0 + n_sweeps * sweep_period
    t = t0 - 0.5
    while t < t_end + 0.5:
        R, pos = traj.pose(t - t0)
        rpy = rot_to_rpy(R)
        # numpy float64: float32 would quantize lat/lon by ~0.6 m
        lla = ned2lla(
            np.asarray(pos + rng.normal(0, nav_pos_noise, 3), np.float64),
            REF_LLA,
        )
        vel = traj.vel_world(t - t0)
        f_body, w_body = traj.imu_sample(t - t0)
        if imu_noise > 0:
            f_body = f_body + rng.normal(0, imu_noise, 3)
            w_body = w_body + rng.normal(0, imu_noise * 0.1, 3)
        events.append((t, STREAM_COMPASS, encode_anpp20(t, lla, vel, rpy,
                                                        accel=traj.accel_world(t - t0),
                                                        gyro=w_body,
                                                        sigma_pos=nav_sigma_pos)))
        events.append((t, STREAM_COMPASS, encode_anpp25()))
        events.append((t, STREAM_COMPASS, encode_anpp26()))
        events.append((t, STREAM_COMPASS, encode_anpp28(f_body, w_body)))
        events.append((t, STREAM_COMPASS, encode_anpp29(t, lla, vel)))
        t += nav_period

    # lidar stream
    gt = []
    dirs_body = full_luts.direction  # (cols, pix, 3)
    offs_body = full_luts.offset  # (cols, 3)
    for s in range(n_sweeps):
        t_sweep = t0 + s * sweep_period
        col_ts = t_sweep + np.arange(cols) / cols * sweep_period * 0.95
        R, pos = traj.pose(t_sweep + sweep_period * 0.95 - t0)  # pose at sweep end
        gt.append((R, pos))
        if skewed and hasattr(traj, "poses"):
            # motion-skewed sweep, vectorized over columns
            Rc, pc = traj.poses(col_ts - t0)  # (cols,3,3), (cols,3)
            dirs_w = np.einsum("cij,cpj->cpi", Rc, dirs_body)
            orig_w = np.einsum("cij,cj->ci", Rc, offs_body) + pc
        elif skewed:
            # motion-skewed sweep: each column sampled from the sensor pose at
            # its own timestamp (what a real spinning lidar measures)
            dirs_w = np.empty((cols,) + dirs_body.shape[1:])
            orig_w = np.empty((cols, 3))
            for c in range(cols):
                Rc, pc = traj.pose(col_ts[c] - t0)
                dirs_w[c] = dirs_body[c] @ Rc.T
                orig_w[c] = Rc @ offs_body[c] + pc
        else:
            dirs_w = dirs_body @ R.T  # (cols, pix, 3)
            orig_w = offs_body @ R.T + pos  # (cols, 3)
        ranges = world.raycast(
            np.broadcast_to(orig_w[:, None, :], dirs_w.shape), dirs_w
        )
        ranges_mm = np.round(ranges * 1000.0).astype(np.uint32)
        refl = np.full(ranges.shape, 80, np.uint8)
        for p0 in range(0, cols, cpp):
            m_ids = list(range(p0, min(p0 + cpp, cols)))
            pkt = encode_rng19_packet(
                meta, s, m_ids, (col_ts[m_ids] * 1e9).astype(np.uint64),
                ranges_mm[m_ids], refl[m_ids],
            )
            events.append((col_ts[m_ids[0]], STREAM_LIDAR, pkt))

    events.sort(key=lambda e: e[0])
    with ReplayWriter(path) as w:
        for ts, sid, payload in events:
            w.write(sid, ts, payload)
    return gt
