"""``regmap.MapGraph``: the apps' DIRECT7 map and RegMap build
(``regmap.build_target``) replayed as one CUDA graph.

On the CPU (these count in the default lane):

- ``build_target`` is the sequence the two apps ran inline, field for
  field and bit for bit: odom_ndt's (float64 statistics cast to float32, no
  aux table; and with ``odom_ndt.MAP_DTYPE`` set to float32) and lo_svn's
  (float32, with and without the plane-regularized aux table);
- the dispatch rule: ``core.cuda_graph.replays`` (a CUDA device); on the
  CPU the runner calls ``build_target`` inline and captures nothing;
- the runner's buffers, with the capture stood in by a plain call whose
  outputs are overwritten in place at each replay
  (``test_torch_cuda_graph.py``'s ``stand_in``): one eager call, one
  capture, then loads and replays equal to ``build_target`` bit for bit,
  with kept results unchanged by later replays; another N or ``map_dtype``
  captures again;
- the apps: both call the runner on every DIRECT7 build and publish what
  they publish without it; a patched ``odom_ndt.MAP_DTYPE`` lands in the
  capture; the other map paths (odom GICP and KDTREE, lo_svn KDTREE and
  sorted-key) never call it.

On the card (marker ``cuda``, skipped without one; tests/conftest.py
imports JAX, so run it there as
``python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_map_graph.py``):
replay equals eager bit for bit at both benchmark cells' keys; the RegMap
built on the card equals the one built on the CPU from the same map; both
builds run clean under ``torch.cuda.set_sync_debug_mode("error")``; each
app through the graph publishes what it publishes eagerly.
"""
import inspect

import numpy as np
import pytest
import torch

from slamtpu_torch.apps import lo_svn as tlo
from slamtpu_torch.apps import odom_ndt
from slamtpu_torch.core import cuda_graph
from slamtpu_torch.ins.imu_config import ImuConfig
from slamtpu_torch.lidar.ouster import LidarParams, synthetic_os2_metadata
from slamtpu_torch.mapping import gaussian_map
from slamtpu_torch.ndt.gicp import regularize_plane_covariance
from slamtpu_torch.ndt.regmap import MapGraph, RegMap, build_regmap, build_target
from slamtpu_torch.runtime.config import PipelineConfig, RegisterConfig
from test_torch_cuda_graph import stand_in  # noqa: F401 (the fixture)

torch.set_num_threads(1)
CPU, CUDA = torch.device("cpu"), torch.device("cuda")
GRID, CAPACITY = (32, 32, 16), 1 << 11

# (resolution, capacity, min_points, grid_shape, map_dtype, aux) as each app passes them
SETTINGS = {
    "odom": (1.0, CAPACITY, 4, GRID, torch.float64, False),
    "odom_float32_map": (1.0, CAPACITY, 4, GRID, torch.float32, False),
    "lo_svn": (1.0, CAPACITY, 4, GRID, None, True),
    "lo_svn_no_aux": (1.0, CAPACITY, 4, GRID, None, False),
}
# the benchmark cells' keys: odom_ndt_berlin (one 65,536-point cloud) and
# lo_svn_berlin (the 5-cloud ring), as their configuration files set them
CELLS = {
    "odom_ndt_berlin": (65536, (2.0, 4096, 6, (128, 128, 32), torch.float64, False)),
    "lo_svn_berlin": (5 * 65536, (1.0, 1 << 17, 4, (256, 256, 32), None, True)),
}


def cloud(seed, n=6144, half=(12.0, 12.0), device=CPU):
    """A ground and two walls inside a box of half-widths ``half`` (m),
    moved by a small seeded offset, every 17th point masked, and a map
    origin below it all: (points (n, 3) float32, mask, origin (3,))."""
    rng = np.random.default_rng(seed)
    hx, hy = half
    k = n // 4
    ground = np.c_[rng.uniform(-hx, hx, (n - 2 * k, 1)), rng.uniform(-hy, hy, (n - 2 * k, 1)),
                   rng.normal(0, 0.02, (n - 2 * k, 1))]
    wall_x = np.c_[np.full(k, 0.7 * hx) + rng.normal(0, 0.02, k), rng.uniform(-hy, hy, k), rng.uniform(0, 5, k)]
    wall_y = np.c_[rng.uniform(-hx, hx, k), np.full(k, -0.5 * hy) + rng.normal(0, 0.02, k), rng.uniform(0, 5, k)]
    pts = np.concatenate([ground, wall_x, wall_y]) + rng.normal(0, 0.3, 3)
    mask = np.ones(n, bool)
    mask[seed % 17::17] = False
    origin = np.array([-hx - 4.0, -hy - 4.0, -4.0])
    return (torch.as_tensor(pts, dtype=torch.float32, device=device), torch.as_tensor(mask, device=device),
            torch.as_tensor(origin, dtype=torch.float32, device=device))


def inline_build(points, mask, origin, resolution, capacity, min_points, grid_shape, map_dtype, aux):
    """The map span as the apps ran it inline: odom_ndt's ``_register_step``
    (``map_dtype`` set) and lo_svn's ``_lo_svn_core`` (not)."""
    if map_dtype is not None:
        gmap = gaussian_map.to_float32(gaussian_map.build_map(
            points.to(map_dtype), mask, origin, resolution, capacity=capacity, min_points_per_voxel=min_points))
        return build_regmap(gmap, grid_shape=grid_shape)
    gmap = gaussian_map.build_map(points, mask, origin, resolution, capacity=capacity,
                                  min_points_per_voxel=min_points)
    payload = None
    if aux:
        cov_r = regularize_plane_covariance(gmap.cov)
        payload = torch.cat([gmap.mean, cov_r.reshape(-1, 9)], dim=1)
    return build_regmap(gmap, grid_shape=grid_shape, aux_payload=payload)


def _equal(got: RegMap, want: RegMap):
    assert type(got) is RegMap and len(got) == len(want)
    for name, a, b in zip(RegMap._fields, got, want):
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype and a.device == b.device and torch.equal(a, b), name


@pytest.mark.parametrize("case", sorted(SETTINGS))
def test_build_target_is_the_inline_sequence(case):
    pts, mask, origin = cloud(3)
    want = inline_build(pts, mask, origin, *SETTINGS[case])
    got = build_target(pts, mask, origin, *SETTINGS[case])
    _equal(got, want)
    assert got.packed.dtype == torch.float32 and (got.packed_aux is not None) == SETTINGS[case][-1]
    assert int(got.num_valid) > 100 and int(got.overflow) == 0


REPLAYS = cuda_graph.replays


@pytest.mark.parametrize("device, want", [(CUDA, True), (torch.device("cuda", 1), True), (CPU, False)])
def test_replays_only_on_a_card(stand_in, monkeypatch, device, want):
    """The runner follows ``cuda_graph.replays`` with its inputs taken to be
    on ``device``: it captures at the second call where it replays, and
    keeps no graph where it does not; each call is ``build_target``'s."""
    assert REPLAYS(device) is want
    monkeypatch.setattr(cuda_graph, "replays", lambda _device: REPLAYS(device))
    runner = MapGraph()
    args = cloud(5) + SETTINGS["lo_svn"]
    for _ in range(3):
        _equal(runner(*args), build_target(*args))
    assert runner.captures == int(want) and len(stand_in) == int(want) and bool(runner._graphs) is want


@pytest.mark.parametrize("case", sorted(SETTINGS))
def test_cpu_runner_is_build_target(case):
    runner = MapGraph()
    for seed in range(3):
        args = cloud(seed) + SETTINGS[case]
        _equal(runner(*args), inline_build(*args))
    assert runner.captures == 0 and not runner._graphs


@pytest.mark.parametrize("case", ["odom", "lo_svn"])
def test_runner_runs_eager_captures_then_replays(stand_in, case):
    """Five clouds of one key: the first eager, the second captures, the
    rest load and replay; each result equals ``build_target`` on its cloud
    bit for bit, and the results kept from earlier calls are untouched by
    later replays."""
    runner = MapGraph()
    kept = []
    for k in range(5):
        args = cloud(20 + k) + SETTINGS[case]
        got = runner(*args)
        _equal(got, build_target(*args))
        kept.append((got, RegMap(*(None if t is None else t.clone() for t in got))))
        if k >= 1:
            (graph,) = stand_in
            assert graph.replays == k
    assert runner.captures == 1
    (graph,) = stand_in
    buffers = {t.data_ptr() for t in graph.out if t is not None}
    for got, values in kept:
        assert not any(t.data_ptr() in buffers for t in got if t is not None)
        _equal(got, values)
    assert len({float(v.packed.sum()) for _, v in kept}) == len(kept)


def test_another_key_captures_again(stand_in):
    """Another N or another ``map_dtype`` runs eagerly once and captures its
    own graph; the key holds all the capture bakes in."""
    runner = MapGraph()
    small = cloud(9, n=2048)
    for args in [cloud(8) + SETTINGS["odom"]] * 2 + [cloud(8) + SETTINGS["odom_float32_map"]] * 3 \
            + [small + SETTINGS["odom"]] * 2:
        _equal(runner(*args), build_target(*args))
    assert runner.captures == 3 and len(stand_in) == 3
    assert set(runner._graphs) == {
        (n, torch.float32, torch.float32, CAPACITY, 4, GRID, 1.0, dt, False, CPU)
        for n, dt in [(6144, torch.float64), (6144, torch.float32), (2048, torch.float64)]}


# --- the apps on the CPU ---


def _odom_cfg(**change):
    meta = synthetic_os2_metadata(columns_per_frame=128, pixels_per_column=16, columns_per_packet=16)
    reg = dict(method="NDT_OMP", ndt_resolution=1.0, ndt_max_iterations=10, map_capacity=1 << 12,
               min_points_per_voxel=4, reg_grid_shape=(64, 64, 16), fused_inner_iters=1)
    reg.update(change)
    return PipelineConfig(meta=meta, lidar=LidarParams(channel_stride=1, range_filter=(0.5, 150.0)),
                          imu=ImuConfig(), register=RegisterConfig(**reg), deskew=True)


def _lo_svn_cfg(**change):
    meta = synthetic_os2_metadata(columns_per_frame=128, pixels_per_column=16, columns_per_packet=16)
    reg = RegisterConfig(svn_resolution=2.0, svn_particles=4, svn_max_iterations=2, svn_polish_iters=1,
                         map_capacity=1 << 12, min_points_per_voxel=4, keyframe_window=3,
                         reg_grid_shape=(16, 16, 8), map_rebuild_every=2, **change)
    return PipelineConfig(meta=meta, lidar=LidarParams(channel_stride=1, range_filter=(0.5, 150.0)),
                          imu=ImuConfig(), register=reg, deskew=True)


SWEEPS = 7


@pytest.fixture(scope="module")
def small_replay(tmp_path_factory):
    from tests.simulator_np import simulate_replay

    cfg = _odom_cfg()
    path = str(tmp_path_factory.mktemp("map_graph") / "skewed.rpl")
    simulate_replay(path, cfg.meta, cfg.lidar, n_sweeps=SWEEPS, skewed=True)
    return path


def _published(traj):
    return [(np.asarray(e.pose.rot), np.asarray(e.pose.trans), e.covariance) for e in traj]


def _same(a, b):
    assert len(a) == len(b)
    for (r, t, c), (r2, t2, c2) in zip(a, b):
        assert np.array_equal(r, r2) and np.array_equal(t, t2)
        assert (c is None and c2 is None) or np.array_equal(c, c2)


def _calls(monkeypatch):
    """Record each ``MapGraph`` call's (device type, map_dtype, aux)."""
    calls = []
    call = MapGraph.__call__
    signature = inspect.signature(call)

    def counted(*args, **kwargs):
        bound = signature.bind(*args, **kwargs)
        bound.apply_defaults()
        a = bound.arguments
        calls.append((a["points"].device.type, a["map_dtype"], a["aux"]))
        return call(*args, **kwargs)

    monkeypatch.setattr(MapGraph, "__call__", counted)
    return calls


APPS = {
    "odom": (lambda: odom_ndt.OdomNdtApp(_odom_cfg(), "cpu", window=3), SWEEPS - 2, torch.float64, False),
    "lo_svn": (lambda: tlo.LoSvnApp(_lo_svn_cfg(), "cpu"), 3, None, True),
}


@pytest.mark.parametrize("app_name", sorted(APPS))
def test_apps_on_the_cpu_build_through_the_runner(small_replay, monkeypatch, app_name):
    """Every DIRECT7 build of the app's CPU run goes to its runner, inline
    (odom each keyframe after the first, lo_svn each rebuild), and the app
    publishes what it publishes with the runner left out, bit for bit."""
    make, builds, map_dtype, aux = APPS[app_name]
    calls = _calls(monkeypatch)
    app = make()
    got = _published(app.run_replay(small_replay))
    monkeypatch.undo()
    eager = make()
    eager._map_graph = None
    _same(got, _published(eager.run_replay(small_replay)))
    assert calls == [("cpu", map_dtype, aux)] * builds
    assert app._map_graph.captures == 0 and not app._map_graph._graphs


def test_patched_map_dtype_lands_in_the_capture(stand_in, small_replay, monkeypatch):
    """``odom_ndt.MAP_DTYPE`` as the benchmark's float32 control sets it: the
    app passes it at each call, so the runner keys and captures a float32
    build, and the app publishes what its eager run with the same patch
    publishes."""
    monkeypatch.setattr(odom_ndt, "MAP_DTYPE", torch.float32)
    app = odom_ndt.OdomNdtApp(_odom_cfg(), "cpu", window=3)
    got = _published(app.run_replay(small_replay))
    (key,) = app._map_graph._graphs
    assert key[7] is torch.float32 and app._map_graph.captures == 1
    monkeypatch.setattr(cuda_graph, "replays", lambda _device: False)
    _same(got, _published(odom_ndt.OdomNdtApp(_odom_cfg(), "cpu", window=3).run_replay(small_replay)))


@pytest.mark.parametrize("app_name, make", [
    ("odom GICP", lambda: odom_ndt.OdomNdtApp(_odom_cfg(method="GICP"), "cpu", window=3)),
    ("odom NDT_OMP KDTREE", lambda: odom_ndt.OdomNdtApp(_odom_cfg(search_method="KDTREE"), "cpu", window=3)),
    ("lo_svn KDTREE", lambda: tlo.LoSvnApp(_lo_svn_cfg(svn_search_method="KDTREE"), "cpu")),
    ("lo_svn sorted-key", lambda: tlo.LoSvnApp(_lo_svn_cfg(use_regmap=False), "cpu")),
])
def test_other_map_paths_never_call_the_runner(small_replay, monkeypatch, app_name, make):
    def refuse(*_a, **_k):
        raise AssertionError(f"{app_name} called MapGraph")

    monkeypatch.setattr(MapGraph, "__call__", refuse)
    traj = make().run_replay(small_replay)
    assert len(traj) == SWEEPS - 1 and all(np.isfinite(np.asarray(e.pose.trans)).all() for e in traj)


# --- on the card ---


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernels)")


def _cell_args(cell, seed):
    n, settings = CELLS[cell]
    # an arena the size of the benchmark's stadium, the ring's clouds stacked
    pts, mask, origin = cloud(seed, n=n, half=(60.0, 40.0), device=CUDA)
    return (pts, mask, origin) + settings


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_replay_equals_eager_on_the_card(cell):
    """Five clouds at the cell's key: the first eager, the second captures,
    every result equals ``build_target`` run eagerly on the same cloud bit
    for bit, and every kept result is unchanged after the last replay."""
    _need_card()
    runner = MapGraph()
    kept = []
    for k in range(5):
        args = _cell_args(cell, 40 + k)
        got = runner(*args)
        _equal(got, build_target(*args))
        kept.append((got, RegMap(*(None if t is None else t.clone() for t in got))))
    torch.cuda.synchronize()
    assert runner.captures == 1
    for got, values in kept:
        _equal(got, values)
    assert len({float(v.packed.sum()) for _, v in kept}) == len(kept)
    assert all(int(v.overflow) == 0 for _, v in kept)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_build_runs_clean_under_sync_error_mode_on_the_card(cell):
    """After one build to warm the libraries, a build at the cell's key
    waits for the device nowhere; its RegMap equals ``build_regmap`` run on
    the CPU from the card's map, field for field (the table's writes move
    numbers, they add none)."""
    _need_card()
    args = _cell_args(cell, 60)
    build_target(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = build_target(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    pts, mask, origin, resolution, capacity, min_points, grid_shape, map_dtype, aux = args
    if map_dtype is not None:
        pts = pts.to(map_dtype)
    gmap = gaussian_map.build_map(pts, mask, origin, resolution, capacity=capacity, min_points_per_voxel=min_points)
    if map_dtype is not None:
        gmap = gaussian_map.to_float32(gmap)
    payload = torch.cat([gmap.mean, regularize_plane_covariance(gmap.cov).reshape(-1, 9)], dim=1) if aux else None
    host = gaussian_map.GaussianMap(*(t.cpu() for t in gmap))
    want = build_regmap(host, grid_shape=grid_shape, aux_payload=None if payload is None else payload.cpu())
    _equal(RegMap(*(None if t is None else t.cpu() for t in got)), want)


def _card_odom_cfg():
    meta = synthetic_os2_metadata(columns_per_frame=512, pixels_per_column=64, columns_per_packet=16)
    reg = RegisterConfig(method="NDT_OMP", ndt_resolution=2.0, ndt_max_iterations=30, map_capacity=4096,
                         min_points_per_voxel=6, reg_grid_shape=(128, 128, 32))
    return PipelineConfig(meta=meta, lidar=LidarParams(channel_stride=1, range_filter=(0.5, 150.0)),
                          imu=ImuConfig(), register=reg, deskew=True)


def _card_lo_svn_cfg():
    meta = synthetic_os2_metadata(columns_per_frame=512, pixels_per_column=64, columns_per_packet=16)
    reg = RegisterConfig(svn_resolution=1.0, svn_particles=20, svn_max_iterations=8, svn_kernel_h=5.0,
                         svn_step_size=1.0, map_capacity=1 << 17, min_points_per_voxel=4, keyframe_window=5,
                         reg_grid_shape=(256, 256, 32), map_rebuild_every=2, map_exclude_recent=3)
    return PipelineConfig(meta=meta, lidar=LidarParams(channel_stride=1, range_filter=(0.5, 150.0)),
                          imu=ImuConfig(), register=reg, deskew=True)


CARD_SWEEPS = 12


@pytest.mark.cuda
@pytest.mark.parametrize("app_name", ["odom", "lo_svn"])
def test_app_through_the_graph_on_the_card(tmp_path, monkeypatch, app_name):
    """The app on the card with its map runner and with the runner left
    out publishes the same poses and covariances bit for bit; the runner
    captured once and replayed the builds after the capture."""
    _need_card()
    from simulator_np import simulate_replay

    cfg = _card_odom_cfg() if app_name == "odom" else _card_lo_svn_cfg()
    path = str(tmp_path / "skewed.rpl")
    simulate_replay(path, cfg.meta, cfg.lidar, n_sweeps=CARD_SWEEPS, skewed=True)

    def make():
        return (odom_ndt.OdomNdtApp(cfg, "cuda", window=4) if app_name == "odom"
                else tlo.LoSvnApp(cfg, "cuda"))

    calls = _calls(monkeypatch)
    app = make()
    graph = _published(app.run_replay(path))
    monkeypatch.undo()
    eager = make()
    eager._map_graph = None
    _same(graph, _published(eager.run_replay(path)))
    assert len(graph) == CARD_SWEEPS - 1
    assert app._map_graph.captures == 1 and len(calls) >= 3 and all(c[0] == "cuda" for c in calls)
