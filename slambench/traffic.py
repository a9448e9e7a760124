"""The benchmark's one traffic generator: a simulated OS-2 LiDAR and ANPP
GNSS/INS driving a course through an arena of planes and pillars, read from
a traffic file (``slambench/traffic/<name>.json``).

It is ``tests/simulator_np.py`` (world, trajectory, encoders) rewritten in
PyTorch: the sweeps are raycast on the device and encoded into packets a
whole sweep at a time, and the course is generated once as a lap. A
periodic course (``stadium``) is played again and again, each lap with its
column timestamps, frame ids and ANPP times advanced by a lap, so a window
never runs short. The seed draws the range noise (on the device); the
arena, the pillars, the course and the INS's error (``ins_error``: a
first-order Gauss-Markov drift of the position and attitude with the
sigmas the packets report, drawn from the file's own seed) come from the
traffic file alone, so every seed asks for the same work.

Nothing here imports the port: the sensor's definition is the benchmark's
own frozen copy (``sensor.py``).
"""
from __future__ import annotations

import math
from typing import Iterator, List, Tuple

import numpy as np
import torch

from . import sensor as sn


# --- courses: vectorised poses over course time tau (s) ---


class ArcCourse:
    """Constant forward speed v, constant yaw rate w (tests/simulator_np's
    ArcTrajectory); not periodic."""

    periodic = False

    def __init__(self, speed: float = 3.0, yaw_rate: float = 0.05, height_m: float = 0.0):
        self.v, self.w, self.z = float(speed), float(yaw_rate), float(height_m)

    def state(self, tau):
        """(yaw, pos (T, 3), yaw rate (T,), curvature sign) at course times."""
        tau = np.asarray(tau, np.float64)
        yaw = self.w * tau
        if abs(self.w) > 1e-9:
            pos = np.stack([self.v / self.w * np.sin(yaw), self.v / self.w * (1 - np.cos(yaw)),
                            np.full_like(yaw, self.z)], -1)
        else:
            pos = np.stack([self.v * tau, np.zeros_like(yaw), np.full_like(yaw, self.z)], -1)
        return yaw, pos, np.full_like(yaw, self.w)


class StadiumCourse:
    """Two straights joined by half turns, driven clockwise seen from above
    (NED, turning right) at the speed that makes one lap a whole number of
    sweeps. Each half turn is a circular arc of ``radius_m`` between two
    clothoids of ``transition_m``, over which the curvature ramps linearly
    (the easement of a road: the yaw rate of a vehicle cannot jump). The
    course is tabulated on a fine grid of arc length and centred on the
    arena's middle."""

    periodic = True
    STEP = 0.002  # m of arc length between table points

    def __init__(self, straight_m: float, radius_m: float, transition_m: float, sweeps_per_lap: int,
                 sweep_hz: float, height_m: float = 0.0):
        a, r, lt = float(straight_m), float(radius_m), float(transition_m)
        self.z = float(height_m)
        arc = np.pi * r - lt  # the arc's length: the clothoids turn lt / (2 r) each
        # curvature profile over one lap: (length, curvature at its start, at its end)
        half = [(a, 0.0, 0.0), (lt, 0.0, 1.0 / r), (arc, 1.0 / r, 1.0 / r), (lt, 1.0 / r, 0.0)]
        pieces = half + half
        self.length = sum(p[0] for p in pieces)
        n = int(round(self.length / self.STEP))
        s = np.linspace(0.0, self.length, n + 1)
        kappa = np.zeros_like(s)
        s0 = 0.0
        for length, k0, k1 in pieces:
            sel = (s >= s0) & (s <= s0 + length)
            kappa[sel] = k0 + (k1 - k0) * (s[sel] - s0) / length
            s0 += length
        ds = np.diff(s)
        yaw = np.concatenate([[0.0], np.cumsum(0.5 * (kappa[1:] + kappa[:-1]) * ds)])
        x = np.concatenate([[0.0], np.cumsum(0.5 * (np.cos(yaw[1:]) + np.cos(yaw[:-1])) * ds)])
        y = np.concatenate([[0.0], np.cumsum(0.5 * (np.sin(yaw[1:]) + np.sin(yaw[:-1])) * ds)])
        x -= 0.5 * (x.max() + x.min())
        y -= 0.5 * (y.max() + y.min())
        self._s, self._x, self._y, self._yaw, self._kappa = s, x, y, yaw, kappa
        self.period = sweeps_per_lap / float(sweep_hz)
        self.v = self.length / self.period

    def state(self, tau):
        s = np.mod(np.asarray(tau, np.float64) * self.v, self.length)
        yaw = np.interp(s, self._s, self._yaw)
        pos = np.stack([np.interp(s, self._s, self._x), np.interp(s, self._s, self._y),
                        np.full_like(s, self.z)], -1)
        rate = self.v * np.interp(s, self._s, self._kappa)
        return np.arctan2(np.sin(yaw), np.cos(yaw)), pos, rate

    def distance(self, xy):
        """Distance of points (n, 2) from the course."""
        d = np.hypot(xy[:, None, 0] - self._x[None, ::50], xy[:, None, 1] - self._y[None, ::50])
        return d.min(1)


def make_course(course: dict, sweep_hz: float):
    kind = course["kind"]
    if kind == "stadium":
        return StadiumCourse(course["straight_m"], course["radius_m"], course["transition_m"],
                             course["sweeps_per_lap"], sweep_hz, course.get("height_m", 0.0))
    if kind == "arc":
        return ArcCourse(course["speed"], course["yaw_rate"], course.get("height_m", 0.0))
    raise ValueError(f"unknown course kind {kind!r}")


def yaw_rot(yaw) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.zeros(np.shape(yaw) + (3, 3))
    R[..., 0, 0], R[..., 0, 1], R[..., 1, 0], R[..., 1, 1], R[..., 2, 2] = c, -s, s, c, 1.0
    return R


def course_kinematics(course, tau):
    """(R (T,3,3), pos (T,3), vel world (T,3), accel world (T,3), yaw rate (T,))."""
    yaw, pos, rate = course.state(tau)
    v = course.v
    fwd = np.stack([np.cos(yaw), np.sin(yaw), np.zeros_like(yaw)], -1)
    left = np.stack([-np.sin(yaw), np.cos(yaw), np.zeros_like(yaw)], -1)
    return yaw_rot(yaw), pos, v * fwd, (rate * v)[..., None] * left, rate


# --- the arena ---


class World:
    """Ground, four walls and vertical pillars (tests/simulator_np's
    PlaneWorld); pillars closer than ``pillar_clearance_m`` to the course
    (surface to path) are left out."""

    def __init__(self, w: dict, course=None):
        gz, wx, wy = w["ground_z"], w["wall_x"], w["wall_y"]
        self.planes = [(2, gz), (0, wx), (1, wy), (0, -wx), (1, -wy)]
        self.ground_z = gz
        self.radius = w["pillar_radius"]
        self.height = w.get("pillar_height_m", 6.0)
        prng = np.random.default_rng(w["pillar_seed"])
        n = w["n_pillars"]
        pillars = np.stack([prng.uniform(-wx * 0.8, wx * 0.8, n),
                            prng.uniform(-wy * 0.8, wy * 0.8, n)], axis=-1)
        clear = w.get("pillar_clearance_m")
        if clear is not None and hasattr(course, "distance"):
            pillars = pillars[course.distance(pillars) - self.radius >= clear]
        self.pillars = pillars

    def raycast(self, origins, dirs, max_range):
        """origins/dirs (..., 3) float64 tensors -> ranges (...) (0 = no hit)."""
        inf = torch.tensor(float("inf"), dtype=dirs.dtype, device=dirs.device)
        best = torch.full(origins.shape[:-1], float("inf"), dtype=dirs.dtype, device=dirs.device)
        for axis, value in self.planes:
            d = dirs[..., axis]
            denom = torch.where(d.abs() < 1e-9, 1e-9, d)
            t = (value - origins[..., axis]) / denom
            best = torch.minimum(best, torch.where(t > 0.1, t, inf))
        oxy, dxy = origins[..., :2], dirs[..., :2]
        a = torch.sum(dxy * dxy, dim=-1)
        a = torch.where(a < 1e-12, 1e-12, a)
        for c in self.pillars:
            rel = oxy - torch.as_tensor(c, dtype=dirs.dtype, device=dirs.device)
            b = 2.0 * torch.sum(rel * dxy, dim=-1)
            cc = torch.sum(rel * rel, dim=-1) - self.radius ** 2
            disc = b * b - 4 * a * cc
            ok = disc > 0
            t = torch.where(ok, (-b - torch.sqrt(torch.where(ok, disc, 0.0))) / (2 * a), inf)
            t = torch.where(t > 0.1, t, inf)
            z_hit = origins[..., 2] + t * dirs[..., 2]
            t = torch.where((z_hit <= self.ground_z) & (z_hit >= self.ground_z - self.height), t, inf)
            best = torch.minimum(best, t)
        return torch.where(torch.isfinite(best) & (best <= max_range), best, 0.0)


# --- one lap of traffic ---


def gauss_markov(n: int, dt: float, tau: float, rng) -> np.ndarray:
    """(n, 6) unit-variance first-order Gauss-Markov errors at spacing dt
    with correlation time tau, circular over the n samples, so that a lap's
    error closes on itself as the course does."""
    a = math.exp(-dt / tau)
    w = 2.0 * np.pi * np.fft.fftfreq(n)
    h = np.sqrt((1.0 - a * a) / np.abs(1.0 - a * np.exp(-1j * w)) ** 2)
    x = np.fft.ifft(np.fft.fft(rng.standard_normal((n, 6)), axis=0) * h[:, None], axis=0).real
    return x / math.sqrt(float(np.mean(h * h)))


class Lap:
    """One lap (or, for a course that is not periodic, the whole run) of
    packets and the ground truth behind them.

    Host: ``packets`` (S, P, packet_size) uint8 of lap 0, ``base_ts_ns`` (S,
    cols) int64, the nav samples of one lap by phase. Device:
    ``ranges_mm`` (S, cols, sub) int32, the decoded channels' ranges as
    encoded, for the reference."""

    def __init__(self, traffic: dict, sens: sn.Sensor, seed: int, device, n_sweeps: int = None):
        self.sensor = sens
        self.sweep_hz = float(traffic["sweep_hz"])
        self.nav_hz = float(traffic["nav_hz"])
        self.t0 = float(traffic["t0"])
        self.span = float(traffic["column_span"])
        self.course = make_course(traffic["course"], self.sweep_hz)
        self.world = World(traffic["world"], self.course)
        self.periodic = self.course.periodic
        if self.periodic:
            self.S = int(traffic["course"]["sweeps_per_lap"])
            self.lap_ns = int(round(self.S / self.sweep_hz * 1e9))
        else:
            self.S = int(traffic["course"]["sweeps"])
            self.lap_ns = None
        # sweeps generated: the lap, or (tests) its first n_sweeps, after
        # which the feed ends
        self.n_gen = min(int(n_sweeps), self.S) if n_sweeps else self.S
        self.ends = self.n_gen < self.S or not self.periodic
        self.nav_per_sweep = int(round(self.nav_hz / self.sweep_hz))
        self.nav_lead = int(round(traffic["nav_lead_s"] * self.nav_hz))
        self.M = self.S * self.nav_per_sweep  # nav samples a lap
        self.sigma_pos = tuple(traffic["nav_sigma_pos"])
        self._make_nav(traffic, seed)
        self._make_sweeps(traffic, seed, device)

    # nav samples: index m >= -nav_lead at t0 + m / nav_hz
    def nav_time(self, m: int) -> float:
        return self.t0 + m / self.nav_hz

    def _phase(self, m: int) -> int:
        return m % self.M if self.periodic else m + self.nav_lead

    def _make_nav(self, traffic, seed):
        rng = np.random.default_rng(seed)
        if self.periodic:
            ms = np.arange(self.M)
        else:
            ms = np.arange(-self.nav_lead, self.M + self.nav_lead)
        tau = ms / self.nav_hz
        R, pos, vel, acc, rate = course_kinematics(self.course, tau)
        n = len(ms)
        pos_noise = float(traffic.get("nav_pos_noise_m", 0.0))
        imu_noise = float(traffic.get("imu_noise", 0.0))
        self.nav_pos = pos + (rng.normal(0, pos_noise, (n, 3)) if pos_noise > 0 else 0.0)
        yaw = np.arctan2(R[:, 1, 0], R[:, 0, 0])  # the course is level: roll = pitch = 0
        self.nav_rpy = np.stack([np.zeros(n), np.zeros(n), yaw], -1)
        err = traffic.get("ins_error")
        if err:
            e = gauss_markov(n, 1.0 / self.nav_hz, float(err["tau_s"]), np.random.default_rng(int(err["seed"])))
            self.nav_rpy = self.nav_rpy + e[:, :3] * np.asarray(err["rpy_rad"], np.float64)
            self.nav_pos = self.nav_pos + e[:, 3:] * np.asarray(err["pos_m"], np.float64)
        self.nav_lla = sn.ned2lla(self.nav_pos, sn.REF_LLA)
        self.nav_vel, self.nav_acc = vel, acc
        gyro = np.stack([np.zeros(n), np.zeros(n), rate], -1)
        f_body = np.einsum("nji,nj->ni", R, acc - sn.GRAVITY_NED)
        if imu_noise > 0:
            f_body = f_body + rng.normal(0, imu_noise, (n, 3))
            gyro = gyro + rng.normal(0, imu_noise * 0.1, (n, 3))
        self.nav_gyro, self.nav_fbody = gyro, f_body

    def nav_packets(self, m: int) -> List[bytes]:
        k = self._phase(m)
        t = self.nav_time(m)
        lla, vel = self.nav_lla[k], self.nav_vel[k]
        return [
            sn.encode_anpp20(t, lla, vel, self.nav_rpy[k], self.nav_acc[k], self.nav_gyro[k],
                             self.sigma_pos),
            sn.encode_anpp25(), sn.encode_anpp26(),
            sn.encode_anpp28(self.nav_fbody[k], self.nav_gyro[k]),
            sn.encode_anpp29(t, lla, vel),
        ]

    def col_offsets(self) -> np.ndarray:
        cols = self.sensor.columns_per_frame
        return np.arange(cols) / cols * (1.0 / self.sweep_hz) * self.span

    def _make_sweeps(self, traffic, seed, device):
        sens = self.sensor
        cols, pix, cpp = sens.columns_per_frame, sens.pixels_per_column, sens.columns_per_packet
        P = cols // cpp
        stride = int(traffic.get("decode_stride", sens.channel_stride))
        dev = torch.device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        noise = float(traffic["range_noise_m"])
        max_range = float(traffic["max_range_m"])
        dir_b, off_b = sn.build_luts(sens, 1)
        dir_b = torch.as_tensor(dir_b, dtype=torch.float64, device=dev)
        off_b = torch.as_tensor(off_b, dtype=torch.float64, device=dev)
        offs = self.col_offsets()
        self.packets = np.empty((self.n_gen, P, sens.packet_size), np.uint8)
        self.base_ts_ns = np.empty((self.n_gen, cols), np.int64)
        self.ranges_mm = torch.empty((self.n_gen, cols, len(range(0, pix, stride))), dtype=torch.int32,
                                     device=dev)
        chunk = 8
        for s0 in range(0, self.n_gen, chunk):
            ss = np.arange(s0, min(s0 + chunk, self.n_gen))
            col_ts = self.t0 + ss[:, None] * (1.0 / self.sweep_hz) + offs[None, :]  # (n, cols)
            Rc, pc, _, _, _ = course_kinematics(self.course, col_ts - self.t0)
            Rc = torch.as_tensor(Rc, device=dev)
            pc = torch.as_tensor(pc, device=dev)
            dirs_w = torch.einsum("scij,cpj->scpi", Rc, dir_b)
            orig_w = torch.einsum("scij,cj->sci", Rc, off_b) + pc
            ranges = self.world.raycast(orig_w[:, :, None, :].expand(dirs_w.shape), dirs_w, max_range)
            if noise > 0:
                eps = torch.randn(ranges.shape, generator=gen, dtype=torch.float64, device=dev)
                ranges = torch.where(ranges > 0, ranges + noise * eps, 0.0)
            rmm = torch.round(ranges * 1000.0).to(torch.int64)
            ts_ns = torch.as_tensor((col_ts * 1e9).astype(np.uint64).astype(np.int64), device=dev)
            pk = sn.encode_rng19_sweeps(sens, torch.as_tensor(ss, device=dev), ts_ns, rmm)
            self.packets[ss[0]:ss[-1] + 1] = pk.cpu().numpy()
            self.base_ts_ns[ss[0]:ss[-1] + 1] = ts_ns.cpu().numpy()
            self.ranges_mm[ss[0]:ss[-1] + 1] = (rmm[:, :, ::stride] & 0x7FFFF).to(torch.int32)
        # writable views of each packet's column timestamps and frame id
        B = sens.packet_size
        self._ts_view = np.lib.stride_tricks.as_strided(
            self.packets[:, :, 32:], shape=(self.n_gen, P, cpp, 8), strides=(P * B, B, sens.column_block, 1))
        # order of one sweep's events: nav sample i (at i / nav_hz) before the
        # packets whose first column comes at or after it
        pkt_t = offs[::cpp]
        nav_t = np.arange(self.nav_per_sweep) / self.nav_hz
        self.sweep_order = sorted([(t, 0, i) for i, t in enumerate(nav_t)]
                                  + [(t, 1, p) for p, t in enumerate(pkt_t)])

    # --- the global sweep index g: lap g // S, sweep g % S ---

    def col_ts_ns(self, g: int) -> np.ndarray:
        lap, s = divmod(g, self.S)
        return self.base_ts_ns[s] + (lap * self.lap_ns if lap else 0)

    def stamp(self, g: int) -> np.ndarray:
        """Write sweep g's timestamps and frame id into its packets; returns
        them (P, packet_size)."""
        lap, s = divmod(g, self.S)
        pk = self.packets[s]
        ts = self.col_ts_ns(g).astype("<u8").view(np.uint8).reshape(pk.shape[0], -1, 8)
        self._ts_view[s] = ts
        fid = g & 0xFFFF
        pk[:, 2], pk[:, 3] = fid & 0xFF, fid >> 8
        return pk

    def ranges_of(self, g: int) -> torch.Tensor:
        return self.ranges_mm[g % self.S]

    def gt_pose(self, t: float) -> Tuple[np.ndarray, np.ndarray]:
        """Ground-truth body pose (R, pos) in the arena's NED frame at time t."""
        tau = t - self.t0
        R, pos, _, _, _ = course_kinematics(self.course, np.array([tau]))
        return R[0], pos[0]


class Feed:
    """The closed-loop feed: ``next_sweep()`` returns the events of the next
    sweep in arrival order, [("L", packet) or ("C", nav packet)], the first
    call preceded by the nav lead-in."""

    def __init__(self, lap: Lap):
        self.lap = lap
        self.g = 0

    def exhausted(self) -> bool:
        return self.lap.ends and self.g >= self.lap.n_gen

    def next_sweep(self) -> List[Tuple[str, object]]:
        lap, g = self.lap, self.g
        events: List[Tuple[str, object]] = []
        if g == 0:
            for m in range(-lap.nav_lead, 0):
                events += [("C", p) for p in lap.nav_packets(m)]
        pk = lap.stamp(g)
        for _t, kind, i in lap.sweep_order:
            if kind == 0:
                events += [("C", p) for p in lap.nav_packets(g * lap.nav_per_sweep + i)]
            else:
                events.append(("L", memoryview(pk[i])))
        self.g += 1
        return events

    def tail(self) -> List[Tuple[str, object]]:
        """Nav samples after the last sweep of a course that ends (so the
        last sweep can sync)."""
        lap = self.lap
        m0 = self.g * lap.nav_per_sweep
        return [("C", p) for m in range(m0, m0 + lap.nav_lead) for p in lap.nav_packets(m)]


def sweep_events(feed: Feed) -> Iterator[List[Tuple[str, object]]]:
    while not feed.exhausted():
        yield feed.next_sweep()
