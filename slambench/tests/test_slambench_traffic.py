"""The traffic generator against tests/simulator_np.py, and the lap's
re-stamping."""
import os
import struct
import sys

import numpy as np
import pytest
import torch

from slambench import sensor as sn
from slambench import traffic as tr

from .conftest import ROOT

ARC = dict(
    course=dict(kind="arc", speed=3.0, yaw_rate=0.05, sweeps=4),
    world=dict(ground_z=2.0, wall_x=60.0, wall_y=40.0, n_pillars=24, pillar_radius=0.6, pillar_seed=1234),
    sweep_hz=10.0, nav_hz=50.0, t0=1000.0, column_span=0.95, nav_lead_s=0.5, range_noise_m=0.0,
    max_range_m=200.0, nav_sigma_pos=[0.02, 0.02, 0.05],
)


def _all_events(lap):
    feed = tr.Feed(lap)
    out = []
    for ev in tr.sweep_events(feed):
        out += ev
    return out + feed.tail()


def test_packets_match_simulator_np(tmp_path):
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import simulator_np
    from slamtpu_torch.lidar.ouster import LidarParams
    from slamtpu_torch.runtime.replay import STREAM_LIDAR, read_replay

    meta = simulator_np.small_meta(128, 32, 16)
    path = str(tmp_path / "arc.replay")
    simulator_np.simulate_replay(path, meta, LidarParams(channel_stride=4), n_sweeps=4,
                                 world=simulator_np.PlaneWorld(noise=0.0), skewed=True)
    theirs = list(read_replay(path))
    mine = _all_events(tr.Lap(ARC, sn.Sensor(128, 32, 16, 4), 5, "cpu"))
    lid_t = [bytes(p) for s, _, p in theirs if s == STREAM_LIDAR]
    lid_m = [bytes(p) for k, p in mine if k == "L"]
    assert lid_m == lid_t  # byte for byte
    nav_t = [bytes(p) for s, _, p in theirs if s != STREAM_LIDAR]
    nav_m = [bytes(p) for k, p in mine if k == "C"]
    # the simulator's accumulated nav clock may add one sample past the end
    assert 0 <= len(nav_t) - len(nav_m) <= 5
    for a, b in zip(nav_t, nav_m):
        if a[1] == 28:  # specific force: the same up to the order of a 3-term sum
            np.testing.assert_allclose(struct.unpack_from("<12f", b, 5), struct.unpack_from("<12f", a, 5),
                                       rtol=0, atol=1e-12)
        elif a[1] in (20, 29):
            # the simulator's clock adds up nav periods, so a sample can come
            # out as (secs, 1000000 us); the generator writes (secs + 1, 0)
            # (and evaluates the course at that time, a few 1e-13 s off)
            off = 9 if a[1] == 20 else 5
            ta, tb = (struct.unpack_from("<II", x, off) for x in (a, b))
            assert abs((ta[0] + ta[1] * 1e-6) - (tb[0] + tb[1] * 1e-6)) < 1.5e-6
            assert a[:off] == b[:off] and len(a) == len(b)
            lla = off + 8
            np.testing.assert_allclose(struct.unpack_from("<ddd", b, lla), struct.unpack_from("<ddd", a, lla),
                                       rtol=0, atol=1e-9)
            n = (len(a) - lla - 24) // 4
            np.testing.assert_allclose(struct.unpack_from(f"<{n}f", b, lla + 24),
                                       struct.unpack_from(f"<{n}f", a, lla + 24), rtol=1e-6, atol=1e-12)
        else:
            assert a == b
    order_t = ["L" if s == STREAM_LIDAR else "C" for s, _, _ in theirs][:len(mine)]
    assert [k for k, _ in mine] == order_t


def test_range_noise_comes_from_the_seed():
    cfg = dict(ARC, range_noise_m=0.005)
    a = tr.Lap(cfg, sn.Sensor(128, 32, 16, 4), 2**31 + 5, "cpu")
    b = tr.Lap(cfg, sn.Sensor(128, 32, 16, 4), 2**31 + 5, "cpu")
    c = tr.Lap(cfg, sn.Sensor(128, 32, 16, 4), 2**31 + 6, "cpu")
    clean = tr.Lap(ARC, sn.Sensor(128, 32, 16, 4), 1, "cpu")
    assert torch.equal(a.ranges_mm, b.ranges_mm)
    assert not torch.equal(a.ranges_mm, c.ranges_mm)
    d = (a.ranges_mm - clean.ranges_mm).double()[clean.ranges_mm > 0]
    assert 3.5 < float(d.std()) < 6.5  # mm


def test_stadium_lap_is_a_whole_number_of_sweeps_and_closes():
    import json

    with open(os.path.join(ROOT, "slambench", "traffic", "stadium.json")) as f:
        stadium = json.load(f)
    course = tr.make_course(stadium["course"], stadium["sweep_hz"])
    assert course.period == pytest.approx(22.3)
    assert course.v == pytest.approx(8.0, abs=0.01)
    R0, p0, _, _, _ = tr.course_kinematics(course, np.array([0.0]))
    R1, p1, _, _, _ = tr.course_kinematics(course, np.array([course.period]))
    np.testing.assert_allclose(p1, p0, atol=1e-7)
    np.testing.assert_allclose(R1, R0, atol=1e-9)
    # position, heading and yaw rate continuous all round: the largest change
    # over 1 ms is what 8 m/s, 0.53 rad/s and the clothoids' ramp allow
    tau = np.arange(0.0, course.period, 1e-3)
    yaw, pos, rate = course.state(tau)
    assert np.abs(np.diff(pos, axis=0)).max() < 8.1e-3
    assert np.abs(np.angle(np.exp(1j * np.diff(yaw)))).max() < 6e-4
    assert np.abs(np.diff(rate)).max() < 4e-4
    assert rate.max() == pytest.approx(course.v / 15.0, rel=1e-6)
    world = tr.World(stadium["world"], course)
    assert len(world.pillars) == 23  # one of the 24 lies within 2 m of the course
    assert np.all(course.distance(world.pillars) - world.radius >= 2.0)
    assert np.abs(pos[:, 0]).max() < 40.0 and np.abs(pos[:, 1]).max() < 20.0


def test_restamping_keeps_time_monotonic():
    """Across the lap boundary the columns, frame ids and ANPP times go on
    increasing, by one sweep and one nav period."""
    cfg = dict(ARC, course=dict(kind="stadium", straight_m=3.0, radius_m=2.0, transition_m=1.0, sweeps_per_lap=5))
    lap = tr.Lap(cfg, sn.Sensor(64, 16, 16, 4), 3, "cpu")
    feed = tr.Feed(lap)
    last_ts, last_fid, last_nav = -1, None, -1.0
    for g in range(3 * lap.S + 2):
        events = feed.next_sweep()
        for kind, p in events:
            p = bytes(p)
            if kind == "L":
                fid = struct.unpack_from("<H", p, 2)[0]
                assert fid == g & 0xFFFF
                block = 12 + 16 * 12
                for c in range(16):
                    ts = struct.unpack_from("<Q", p, 32 + c * block)[0]
                    assert ts > last_ts
                    last_ts = ts
            elif p[1] == 20:
                secs, usecs = struct.unpack_from("<II", p, 9)
                t = secs + usecs * 1e-6
                assert t > last_nav
                last_nav = t
        if last_fid is not None:
            assert (last_fid + 1) & 0xFFFF == g & 0xFFFF
        last_fid = g
    # lap L's sweep s is lap 0's sweep s, a lap later
    assert np.all(lap.col_ts_ns(lap.S + 2) - lap.col_ts_ns(2) == lap.lap_ns)


def test_ins_error_is_fixed_by_the_traffic_file():
    """The INS's error comes from the traffic file's own seed (every run's
    seed sees the same), has about the sigmas the packets report, drifts
    slowly (a Gauss-Markov error) and closes on itself over a lap."""
    err = dict(kind="gauss_markov", pos_m=[0.02, 0.02, 0.05], rpy_rad=[0.002, 0.002, 0.004], tau_s=5.0, seed=2718)
    cfg = dict(ARC, course=dict(kind="stadium", straight_m=30.0, radius_m=15.0, transition_m=12.0,
                                sweeps_per_lap=223), ins_error=err)
    sens = sn.Sensor(64, 16, 16, 4)
    a = tr.Lap(cfg, sens, 1, "cpu", n_sweeps=1)
    b = tr.Lap(cfg, sens, 2**31 + 9, "cpu", n_sweeps=1)
    clean = tr.Lap(dict(cfg, ins_error=None), sens, 1, "cpu", n_sweeps=1)
    np.testing.assert_array_equal(a.nav_lla, b.nav_lla)
    np.testing.assert_array_equal(a.nav_rpy, b.nav_rpy)
    dp = a.nav_pos - clean.nav_pos
    drpy = a.nav_rpy - clean.nav_rpy
    e = np.concatenate([drpy / err["rpy_rad"], dp / err["pos_m"]], axis=1)
    assert np.all((0.3 < e.std(0)) & (e.std(0) < 2.0))
    # one nav period apart the error moves by about sqrt(2 dt / tau) of a sigma,
    # and as little across the lap's seam
    step = np.abs(np.diff(np.concatenate([e, e[:1]]), axis=0))
    assert step.max() < 5 * np.sqrt(2 * 0.02 / 5.0)
    u = tr.gauss_markov(4000, 0.02, 5.0, np.random.default_rng(3))
    assert u.std() == pytest.approx(1.0, rel=0.5)
