"""The metric arithmetic: the p95 over sweeps, the window's rate and pose
latency from the harness's stamps, RPE against a known trajectory, the pair-kernel work against chip_smoke.pair_flops, and the
reading of a profiler trace."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from slambench import harness, kernel_costs
from slambench.apps import lo_svn as lo_svn_adapter
from slambench import sensor as sn
from slambench import trace as trc
from slambench import traffic as tr
from slambench.metrics import (device_idle_pct, host_keyframes_per_s, host_sweep_time_p95_ms, keyframes_per_s,
                               launches_per_kf, pair_kernel_roofline, pose_latency_p95_ms, rpe_mm)
from slambench.reference import common as c

from .test_slambench_traffic import ARC


def test_sweep_time_p95_is_over_every_sweep():
    gaps = np.r_[np.full(95, 0.1), np.full(5, 0.5)]  # 100 sweeps, 5 slow
    returns = list(100.0 + np.cumsum(gaps))
    run = harness.Run(plain_t0=100.0, plain_returns=returns, plain_s=12.5)
    assert host_sweep_time_p95_ms.read(run) == pytest.approx(1e3 * np.percentile(gaps, 95))
    assert 100.0 < host_sweep_time_p95_ms.read(run) < 500.0
    # 100 keyframes over the 12.5 s of the window's plain part
    assert host_keyframes_per_s.read(run) == pytest.approx(100 / 12.5)
    run = harness.Run(plain_t0=100.0, plain_returns=[], plain_s=1.0)
    assert host_keyframes_per_s.read(run) is None and host_sweep_time_p95_ms.read(run) is None


class _QueueApp:
    """An app that keeps its keyframes in flight and publishes them
    ``depth`` at a time, as lo_svn does 64 at a time; ``trajectory``, which
    would flush, must not be read."""

    def __init__(self, depth):
        self.depth, self.flushes, self.pending, self._trajectory = depth, 0, 0, []
        self.ingest = SimpleNamespace(assembler=None, anpp=None, sync=None)

    @property
    def trajectory(self):
        raise AssertionError("read through the property that flushes")

    def process(self, _synced):
        self.pending += 1
        if self.pending == self.depth:
            self.flush()

    def flush(self):
        self.flushes += 1
        self._trajectory += [None] * self.pending
        self.pending = 0


def _stamped_window(monkeypatch, n_kf, depth):
    """A window of ``n_kf`` keyframes, one a sweep, through the harness's
    Driver on a clock that moves 0.05 s a reading: keyframe k is handed
    over at 0.15 k and returns from process() at 0.15 k + 0.1; the app
    publishes ``depth`` at a time, and the closing flush (read at 0.15 n_kf)
    publishes the rest."""
    ticks = iter(0.05 * np.arange(10_000))
    monkeypatch.setattr(harness, "time", SimpleNamespace(perf_counter=lambda: float(next(ticks))))
    app = _QueueApp(depth)
    drv = harness.Driver(app, None, lo_svn_adapter.published)
    drv.feed = SimpleNamespace(g=0, next_sweep=lambda: [])
    drv._ingest = lambda _events: [SimpleNamespace(scan=SimpleNamespace(frame_id=0))]
    for _ in range(n_kf):
        drv.step()
    drv.flush()
    assert app.flushes == n_kf // depth + 1
    return harness.Run(n_keyframes=n_kf, window_s=0.15 * n_kf, pose_latency_s=drv.pose_latency_s(0, n_kf))


# keyframes 0-3 and 4-7 published at the return of the 4th's process()
# (0.55, 0.4, 0.25, 0.1 s after their hand-over), 8 and 9 by the closing
# flush at 1.5 s (handed over at 1.2 and 1.35)
LATENCY_S = [0.55, 0.4, 0.25, 0.1] * 2 + [0.3, 0.15]


@pytest.mark.parametrize("metric, n_kf, want", [
    ("keyframes_per_s", 10, 10 / 1.5),
    ("pose_latency_p95_ms", 10, 1e3 * np.percentile(LATENCY_S, 95)),
    ("keyframes_per_s", 0, None),
    ("pose_latency_p95_ms", 0, None),
])
def test_window_rate_and_pose_latency(monkeypatch, metric, n_kf, want):
    """The end-to-end readers over a window stamped by the harness's
    Driver, keyframes published only by the closing flush among them, and
    nothing read from an empty window."""
    run = _stamped_window(monkeypatch, n_kf, depth=4)
    if n_kf:
        assert run.pose_latency_s == pytest.approx(LATENCY_S)
    reader = {"keyframes_per_s": keyframes_per_s, "pose_latency_p95_ms": pose_latency_p95_ms}[metric]
    got = reader.read(run)
    assert got is None if want is None else got == pytest.approx(want)


def test_rpe_against_a_known_trajectory():
    """Published poses = ground truth with a known translation error on
    every other keyframe: the relative error of each pair is that error."""
    cfg = dict(ARC, course=dict(kind="stadium", straight_m=30.0, radius_m=15.0, transition_m=12.0,
                                sweeps_per_lap=223))
    lap = tr.Lap(cfg, sn.Sensor(64, 16, 16, 4), 1, "cpu", n_sweeps=2)
    ts = {j: lap.t0 + 0.1 * j + 0.09 for j in range(40)}
    err = np.array([0.003, -0.004, 0.0])
    pub = {}
    for j, t in ts.items():
        R, p = lap.gt_pose(t)
        pub[j] = (R, p + (err if j % 2 else 0.0), None)
    rec = harness.Record(lap, {}, [], pub, torch.device("cpu"))
    run = harness.Run(window_kfs=range(40), rec=rec, timestamps=ts)
    # each pair's error is +-err rotated into the first keyframe's frame
    assert rpe_mm.read(run) == pytest.approx(1e3 * np.linalg.norm(err), rel=1e-9)


def test_pair_count_matches_chip_smoke_pair_flops():
    """The benchmark's own count of the pair kernels' work, from its voxel
    map, equals chip_smoke.pair_flops's count from the port's gathered rows
    on a toy map (both DIRECT7, no RegMap overflow)."""
    import chip_smoke
    from slamtpu_torch.core.se3 import Pose3
    from slamtpu_torch.mapping import gaussian_map
    from slamtpu_torch.ndt import fused_math, regmap

    g = torch.Generator().manual_seed(3)
    # a floor and a wall of noisy points
    n = 4000
    xy = torch.rand((n, 2), generator=g) * 20.0
    floor = torch.cat([xy, 0.01 * torch.randn((n, 1), generator=g) + 2.0], 1)
    yz = torch.rand((n, 2), generator=g) * torch.tensor([20.0, 4.0])
    wall = torch.cat([torch.full((n, 1), 18.0) + 0.01 * torch.randn((n, 1), generator=g), yz], 1)
    pts = torch.cat([floor, wall]).float()
    mask = torch.ones(pts.shape[0], dtype=torch.bool)
    origin = torch.tensor([-50.0, -50.0, -50.0])
    gm = gaussian_map.build_map(pts, mask, origin, 1.0, capacity=1 << 12, min_points_per_voxel=4)
    rm = regmap.build_regmap(gm, grid_shape=(64, 64, 64))
    scan = pts[::3] + torch.tensor([0.3, -0.2, 0.05])
    smask = torch.ones(scan.shape[0], dtype=torch.bool)
    pose = Pose3(torch.eye(3), torch.tensor([-0.25, 0.15, -0.04]))
    mega = fused_math.gather_megaT(scan, smask, pose, rm, (64, 64, 64)).t()
    flops, pairs, active = chip_smoke.pair_flops("ndt_pair", 20, mega)

    vm = c.build_map(pts.double(), mask, origin.double(), 1.0, 1 << 12, 4, c.F64)
    # the same voxels valid as in the port's float32 map (near-flat voxels
    # can pass its eigenvalue test in one precision and not the other)
    from slamtpu_torch.mapping import voxel
    pc = voxel.unpack(gm.keys).long()
    port_valid = dict(zip(((pc[:, 0] * 1024 + pc[:, 1]) * 1024 + pc[:, 2]).tolist(), gm.valid.tolist()))
    vm = vm._replace(valid=torch.tensor([port_valid.get(int(k), False) for k in vm.keys]))
    wp = c.transform(c.Pose(pose.rot.double(), pose.trans.double()), scan.double())
    _, valid = c.neighbors(vm, wp, smask)
    assert int(valid.sum()) == pairs
    assert int(valid.any(1).sum()) == active
    K = 20
    assert K * (active * kernel_costs.FLOPS_POINT["ndt_pair"] + pairs * kernel_costs.FLOPS_PAIR["ndt_pair"]) == flops


class _Ev:
    def __init__(self, name, dev, start, dur, corr=0, linked=0, kind=None):
        self._v = (name, dev, start, dur, corr, linked)
        if kind is not None:
            self.activity_type = lambda: kind

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type("K", (), {"events": lambda self: events})()})()


@pytest.mark.parametrize("typed", [True, False])
def test_trace_reading(typed):
    """A stretch of 1000 ns: kernels 100-300 (launched inside svn) and
    600-700 (launched in map_rebuild); the rest idle."""
    k = (lambda kind: kind) if typed else (lambda kind: None)
    ev = [
        _Ev("bench_stretch", "DeviceType.CPU", 0, 1000, kind=k("user_annotation")),
        _Ev("svn", "DeviceType.CPU", 50, 250, kind=k("user_annotation")),
        _Ev("map_rebuild", "DeviceType.CPU", 400, 400, kind=k("user_annotation")),
        _Ev("cudaLaunchKernel", "DeviceType.CPU", 60, 5, corr=7, kind=k("cuda_runtime")),
        _Ev("cudaLaunchKernel", "DeviceType.CPU", 450, 5, corr=8, kind=k("cuda_runtime")),
        _Ev("aten::add", "DeviceType.CPU", 440, 20, kind=k("cpu_op")),
        _Ev("ndt_pair_kernel", "DeviceType.CUDA", 100, 200, corr=7, kind=k("kernel")),
        _Ev("elementwise", "DeviceType.CUDA", 600, 100, corr=8, kind=k("kernel")),
    ]
    st = trc.summarize(_Prof(ev))
    assert st.window_s == pytest.approx(1e-6)
    assert st.busy_s == pytest.approx(3e-7)
    assert st.range_kernel_s("svn") == pytest.approx(2e-7)
    assert st.n_launches == 2
    # idle 0-100 and 300-600 with no range open at their start, 700-1000
    # with the host in map_rebuild
    assert dict(st.gaps) == pytest.approx({"harness": 4e-7, "map_rebuild": 3e-7})
    run = harness.Run(stretch=st, stretch_kfs=range(2), device=torch.device("cuda"), kernel_work=(2e5, 1e3),
                      peaks={"fp32_flops_s": 1e12, "bytes_s": 1e12}, register_span="svn")
    assert device_idle_pct.read(run) == pytest.approx(70.0)
    assert launches_per_kf.read(run) == 1.0
    # least time 2e5 / 1e12 = 2e-7 s over 2e-7 s of kernels in svn: 100 %
    assert pair_kernel_roofline.read(run) == pytest.approx(100.0)


@pytest.mark.cuda
def test_traced_run_on_the_card(cuda_device):
    """A --trace 1 run of the cell at its own length on the card reads a
    device trace and every per-layer metric of the cell, and its check
    passes."""
    from .conftest import CELL

    bench, cell, cfg, traffic = harness.load_cell(CELL)
    metrics = harness.cell_metrics(bench, CELL, True)
    r = harness.run_cell(CELL, cfg, traffic, metrics, 2**31 + 5, float(bench["run_seconds"]), True, cuda_device)
    assert r["correct"], r["compared"]
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    want = {m["name"] for m in metrics}
    assert set(r["metrics"]) == want, (r["metrics"], r["attempted"])
    assert 0 < r["metrics"]["pair_kernel_roofline"]["value"] < 100
