"""``fused_math.NewtonGraph``: each Newton outer iteration of
``newton_align_fused`` (the row lookup, up to ``inner_iters`` steps with the
pull, the staleness freeze, the state's update) replayed as one CUDA graph;
the host loop and its one read an outer iteration stay as they are.

On the CPU (these count in the default lane):

- on the CPU the runner is the eager path: equal bit for bit, nothing
  captured;
- with the capture stood in (``test_torch_cuda_graph.py``'s ``stand_in``)
  the first outer iteration runs eagerly, the second captures, the rest
  load and replay, over registrations that swap in a new RegMap; every
  result equals ``newton_align_fused`` without the runner bit for bit, with
  as many host reads, with and without the pull toward a prior pose;
- another ``NewtonConfig`` (``reg_weight`` 0), N or cost captures its own
  graph and never replays another key's;
- ``newton_align_fused_batch``, the sorted-key ``newton_align``, a
  ``reduce``, the pyramid and the lo_svn app never call the runner; the
  odom and ligo apps through the stand-in publish what they publish
  eagerly.

On the card (marker ``cuda``, skipped without one; tests/conftest.py
imports JAX, so run it there as
``python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_newton_graph.py``):
over the first keyframes of the odom and ligo apps at their benchmark
cells' key (65,536 points, 2.0 m, grid (128, 128, 32), two steps a lookup,
ligo with the pull), each registration through the graph equals the same
registration run eagerly bit for bit, with as many reads; one capture per
key; the replayed body (and the eager one) waits for the device nowhere
under ``torch.cuda.set_sync_debug_mode("error")``, the read outside.
"""
import numpy as np
import pytest
import torch

from slamtpu_torch.apps import ligo_tc, odom_ndt
from slamtpu_torch.apps import lo_svn as tlo
from slamtpu_torch.core import cuda_graph, se3
from slamtpu_torch.core.se3 import Pose3
from slamtpu_torch.mapping import gaussian_map
from slamtpu_torch.ndt import fused_math, newton
from slamtpu_torch.ndt.fused_math import NewtonGraph, newton_align_fused, newton_align_fused_batch
from slamtpu_torch.ndt.gicp import gicp_map
from slamtpu_torch.ndt.multires import build_pyramid, multires_align
from slamtpu_torch.ndt.newton import NewtonConfig, NewtonResult, newton_align
from slamtpu_torch.ndt.regmap import build_regmap
from test_torch_cuda_graph import stand_in  # noqa: F401 (the fixture)
from test_torch_map_graph import _lo_svn_cfg, _odom_cfg
from test_torch_map_graph import small_replay as odom_replay  # noqa: F401 (the fixture)

torch.set_num_threads(1)
CPU, CUDA = torch.device("cpu"), torch.device("cuda")
GRID = (32, 32, 16)
CFG = NewtonConfig(resolution=1.0, max_iterations=30, trans_eps=1e-4)
PULL = 10.0  # ligo's reg_weight (regularization_scale_factor)
INNER = 2  # the apps' fused_inner_iters


def _world(seed, n=1536, shift=(0.0, 0.0, 0.0)):
    """A ground and two walls (float32), every 17th point masked."""
    rng = np.random.default_rng(seed)
    ground = np.c_[rng.uniform(-12, 12, (n, 2)), rng.normal(0, 0.02, n)]
    wall_x = np.c_[np.full(n // 2, 8.0) + rng.normal(0, 0.02, n // 2), rng.uniform(-12, 12, n // 2),
                   rng.uniform(0, 5, n // 2)]
    wall_y = np.c_[rng.uniform(-12, 12, n // 2), np.full(n // 2, -6.0) + rng.normal(0, 0.02, n // 2),
                   rng.uniform(0, 5, n // 2)]
    pts = torch.as_tensor((np.concatenate([ground, wall_x, wall_y]) + np.asarray(shift)).astype(np.float32))
    mask = torch.ones(pts.shape[0], dtype=torch.bool)
    mask[::17] = False
    return pts, mask


def _gmap(pts, mask):
    return gaussian_map.build_map(pts, mask, torch.full((3,), -16.0), 1.0, capacity=1 << 11,
                                  min_points_per_voxel=4)


@pytest.fixture(scope="module")
def maps():
    """Two RegMaps of one key (the second of the scene moved 0.4 m) and a
    VGICP RegMap of the first, with the map's cloud."""
    pts, mask = _world(7)
    moved, _ = _world(7, shift=(0.4, -0.2, 0.1))
    g = _gmap(pts, mask)
    return pts, mask, build_regmap(g, grid_shape=GRID), build_regmap(_gmap(moved, mask), grid_shape=GRID), \
        build_regmap(gicp_map(g), grid_shape=GRID)


TRUTH = se3.expmap(torch.tensor([0.01, -0.02, 0.03, 0.3, -0.2, 0.1]))


def _registration(pts, mask, k, n=None):
    """The k-th source scan (the map's points seen from ``TRUTH``, noised),
    an initial pose near the identity and a prior pose near the truth."""
    rng = np.random.default_rng(100 + k)
    src = se3.transform_points(se3.inverse(TRUTH), pts) + torch.as_tensor(
        rng.normal(0, 0.01, tuple(pts.shape)), dtype=torch.float32)
    init = se3.expmap(torch.as_tensor(rng.normal(0, 0.02, 6), dtype=torch.float32))
    prior = se3.retract(TRUTH, torch.as_tensor(rng.normal(0, 0.03, 6), dtype=torch.float32))
    n = n or src.shape[0]
    return src[:n], mask[:n], init, prior


def _align(src, mask, regmap, init, cfg, prior, runner=None, gicp=False):
    """(result, host reads) of one registration, as the apps call it."""
    reads = newton.HOST_READS["newton"]
    res = newton_align_fused(src, mask, regmap, init, cfg, GRID, inner_iters=INNER, reg_pose=prior, _gicp=gicp,
                             newton_graph=runner)
    return res, newton.HOST_READS["newton"] - reads


def _equal(got: NewtonResult, want: NewtonResult):
    a, b = cuda_graph._leaves(got), cuda_graph._leaves(want)
    assert len(a) == len(b) == 7
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.device == y.device and torch.equal(x, y)


SCENES = {"no_pull": (CFG, False), "pull": (CFG._replace(reg_weight=PULL), True)}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_cpu_runner_is_the_eager_path(maps, scene):
    pts, mask, regmap, _, _ = maps
    cfg, pulled = SCENES[scene]
    runner = NewtonGraph()
    for k in range(2):
        src, m, init, prior = _registration(pts, mask, k)
        prior = prior if pulled else None
        got, reads = _align(src, m, regmap, init, cfg, prior, runner)
        want, want_reads = _align(src, m, regmap, init, cfg, prior)
        _equal(got, want)
        assert reads == want_reads >= 2
    assert runner.captures == 0 and not runner._graphs


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_eager_capture_then_replay_is_newton_align_fused(stand_in, maps, scene):
    """Four registrations, a new RegMap from the third: the first outer
    iteration runs eagerly, the second captures, every later one loads and
    replays (the RegMap and the scan copied in once a registration); each
    result equals ``newton_align_fused`` without the runner bit for bit,
    after as many host reads."""
    pts, mask, regmap, rebuilt, _ = maps
    cfg, pulled = SCENES[scene]
    runner = NewtonGraph()
    outer = 0
    for k in range(4):
        target = regmap if k < 2 else rebuilt
        src, m, init, prior = _registration(pts, mask, k)
        prior = prior if pulled else None
        got, reads = _align(src, m, target, init, cfg, prior, runner)
        want, want_reads = _align(src, m, target, init, cfg, prior)
        _equal(got, want)
        assert reads == want_reads >= 2
        outer += reads
        assert runner.captures == 1 and len(stand_in) == 1 and stand_in[0].replays == outer - 1
        (run,) = runner._graphs.values()
        assert run.sources[-1] is target and run.sources[-2] is prior


CHANGES = {
    # the benchmark's ``unpulled`` fault: ligo's configuration with reg_weight 0
    "unpulled": lambda pts, mask, maps: (_registration(pts, mask, 5), maps[2], CFG, False),
    "N": lambda pts, mask, maps: (_registration(pts, mask, 5, n=2048), maps[2], CFG._replace(reg_weight=PULL),
                                  False),
    "VGICP": lambda pts, mask, maps: (_registration(pts, mask, 5), maps[4], CFG._replace(reg_weight=PULL), True),
}


@pytest.mark.parametrize("change", sorted(CHANGES))
def test_another_key_captures_its_own_graph(stand_in, maps, change):
    """After the pulled NDT key has captured, another NewtonConfig, N or
    cost runs eagerly once and captures a graph of its own; the first key's
    graph replays none of its iterations, and both keys' results stay
    equal to the eager runs."""
    pts, mask, regmap, _, _ = maps
    pulled = CFG._replace(reg_weight=PULL)
    runner = NewtonGraph()
    src, m, init, prior = _registration(pts, mask, 0)
    _equal(_align(src, m, regmap, init, pulled, prior, runner)[0], _align(src, m, regmap, init, pulled, prior)[0])
    first = stand_in[0].replays
    (src, m, init, prior), target, cfg, gicp = CHANGES[change](pts, mask, maps)
    got, reads = _align(src, m, target, init, cfg, prior, runner, gicp)
    want, want_reads = _align(src, m, target, init, cfg, prior, gicp=gicp)
    _equal(got, want)
    assert reads == want_reads >= 3
    assert runner.captures == 2 and len(runner._graphs) == 2 and stand_in[0].replays == first
    assert stand_in[1].replays == reads - 1
    keys = list(runner._graphs)
    assert keys[0][0] == pulled and keys[1][0] == cfg


def _refuse(*_a, **_k):
    raise AssertionError("called the Newton graph runner")


def _batch(pts, mask, regmap):
    scans = [_registration(pts, mask, k) for k in range(2)]
    inits = Pose3(torch.stack([s[2].rot for s in scans]), torch.stack([s[2].trans for s in scans]))
    return newton_align_fused_batch(torch.stack([s[0] for s in scans]), torch.stack([s[1] for s in scans]),
                                    regmap, inits, CFG, GRID, INNER)


def _sorted_key(pts, mask, _regmap):
    src, m, init, prior = _registration(pts, mask, 0)
    return newton_align(src, m, _gmap(pts, mask), init, CFG._replace(reg_weight=PULL), reg_pose=prior)


def _reduce(pts, mask, regmap):
    src, m, init, prior = _registration(pts, mask, 0)
    return newton_align_fused(src, m, regmap, init, CFG._replace(reg_weight=PULL), GRID, INNER, reg_pose=prior,
                              reduce=lambda sums: sums + 0.0, newton_graph=NewtonGraph())


def _pyramid(pts, mask, _regmap):
    src, m, init, _ = _registration(pts, mask, 0)
    levels = build_pyramid(pts, mask, torch.full((3,), -16.0), [2.0, 1.0], 1 << 11, GRID, 4, [3, 10])
    return multires_align(src, m, levels, init)


OTHER_CALLERS = {"batch": _batch, "sorted_key": _sorted_key, "reduce": _reduce, "pyramid": _pyramid}


@pytest.mark.parametrize("caller", sorted(OTHER_CALLERS))
def test_other_callers_never_call_the_runner(stand_in, monkeypatch, maps, caller):
    """With every device taken to replay, these paths stay eager: the
    runner's ``advance`` and ``run`` are never reached."""
    pts, mask, regmap, _, _ = maps
    monkeypatch.setattr(NewtonGraph, "advance", _refuse)
    monkeypatch.setattr(NewtonGraph, "run", _refuse)
    res = OTHER_CALLERS[caller](pts, mask, regmap)
    assert torch.isfinite(res.pose.trans).all() and not stand_in


def _published(traj):
    return [(np.asarray(e.pose.rot), np.asarray(e.pose.trans), e.covariance) for e in traj]


def _same(a, b):
    assert len(a) == len(b) > 0
    for (r, t, c), (r2, t2, c2) in zip(a, b):
        assert np.array_equal(r, r2) and np.array_equal(t, t2)
        assert (c is None and c2 is None) or np.array_equal(c, c2)


def _ligo_cfg():
    from test_torch_ligo_graphs import _cfg

    return _cfg()


APPS = {
    "odom": lambda: odom_ndt.OdomNdtApp(_odom_cfg(fused_inner_iters=INNER), "cpu", window=3),
    "ligo": lambda: ligo_tc.LigoTcApp(_ligo_cfg(), "cpu", window=4),
}


@pytest.mark.parametrize("app_name", sorted(APPS))
def test_apps_through_the_stand_in_publish_the_eager_results(stand_in, monkeypatch, odom_replay, app_name):
    """The odom and ligo apps with every graph stood in publish what they
    publish with every graph left out, bit for bit; their Newton runner
    captured once and replayed the outer iterations after the capture."""
    app = APPS[app_name]()
    got = _published(app.run_replay(odom_replay))
    assert app._newton_graph.captures == 1 and len(app._newton_graph._graphs) == 1
    (key,) = app._newton_graph._graphs
    assert key[0] == app.newton_cfg and (key[0].reg_weight > 0) is (app_name == "ligo")
    monkeypatch.setattr(cuda_graph, "replays", lambda _device: False)
    _same(got, _published(APPS[app_name]().run_replay(odom_replay)))


def test_lo_svn_never_calls_the_runner(stand_in, monkeypatch, odom_replay):
    monkeypatch.setattr(NewtonGraph, "advance", _refuse)
    monkeypatch.setattr(NewtonGraph, "run", _refuse)
    traj = tlo.LoSvnApp(_lo_svn_cfg(), "cpu").run_replay(odom_replay)
    assert len(traj) > 3 and all(np.isfinite(np.asarray(e.pose.trans)).all() for e in traj)


# --- on the card ---


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernels)")


def _card_cfg(app_name):
    """The cell's register block (``slambench/configs/<cell>.json``) on a
    sensor of the cell's point count (1,024 x 64 beams = 65,536)."""
    from slamtpu_torch.ins.imu_config import ImuConfig
    from slamtpu_torch.lidar.ouster import LidarParams, synthetic_os2_metadata
    from slamtpu_torch.runtime.config import PipelineConfig, RegisterConfig

    meta = synthetic_os2_metadata(columns_per_frame=1024, pixels_per_column=64, columns_per_packet=16)
    reg = dict(method="NDT_OMP", ndt_resolution=2.0, ndt_transform_epsilon=1e-4, ndt_max_iterations=30,
               fused_inner_iters=INNER, min_points_per_voxel=6, reg_grid_shape=(128, 128, 32))
    if app_name == "odom":
        reg.update(map_capacity=4096, keyframe_window=1)
    else:
        reg.update(map_capacity=8192, keyframe_window=5, map_rebuild_every=1, regularization_scale_factor=PULL)
    return PipelineConfig(meta=meta, lidar=LidarParams(channel_stride=1, range_filter=(0.0, 250.0)),
                          imu=ImuConfig(), register=RegisterConfig(**reg), deskew=True)


CARD_SWEEPS = 9
CARD_APPS = {"odom": lambda cfg: odom_ndt.OdomNdtApp(cfg, "cuda", window=8),
             "ligo": lambda cfg: ligo_tc.LigoTcApp(cfg, "cuda", window=6)}


def _counted_reads(fn):
    reads = newton.HOST_READS["newton"]
    return fn(), newton.HOST_READS["newton"] - reads


@pytest.fixture(scope="module", params=sorted(CARD_APPS))
def card_run(request, tmp_path_factory):
    """The app's first keyframes on the card at the cell's key, each of its
    registrations also run eagerly on the same inputs: (app name, the app,
    [((through the graph, reads), (eager, reads), pulled)] a keyframe)."""
    _need_card()
    from simulator_np import simulate_replay

    app_name = request.param
    cfg = _card_cfg(app_name)
    path = str(tmp_path_factory.mktemp("newton_graph") / "card.rpl")
    simulate_replay(path, cfg.meta, cfg.lidar, n_sweeps=CARD_SWEEPS, skewed=True)
    pairs = []

    def both(*a, **k):
        graph = _counted_reads(lambda: newton_align_fused(*a, **k))
        eager = _counted_reads(lambda: newton_align_fused(*a, **{**k, "newton_graph": None}))
        pairs.append((graph, eager, k.get("reg_pose") is not None))
        return graph[0]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(odom_ndt, "newton_align_fused", both)
        app = CARD_APPS[app_name](cfg)
        assert len(app.run_replay(path)) == CARD_SWEEPS - 1
    return app_name, app, pairs


@pytest.mark.cuda
def test_replay_equals_eager_over_the_cells_first_keyframes(card_run):
    """Every registration of the app's first keyframes at the cell's key,
    through the graph, equals the same registration run eagerly bit for
    bit (pose, Hessian, score, iterations, converged, contributing pairs)
    after as many reads; ligo's are pulled, odom's not."""
    app_name, _, pairs = card_run
    assert len(pairs) == CARD_SWEEPS - 2
    for (got, reads), (want, want_reads), pulled in pairs:
        _equal(got, want)
        assert reads == want_reads >= 1 and pulled is (app_name == "ligo")
        assert int(got.n_contrib) > 1000


@pytest.mark.cuda
def test_one_capture_per_key_on_the_card(card_run):
    """The app's runner holds one key, the cell's, captured once and
    replayed at every outer iteration after the capture; each replay
    counts its pair kernels in the launch counter."""
    app_name, app, pairs = card_run
    runner = app._newton_graph
    assert runner.captures == 1 and len(runner._graphs) == 1
    (key,) = runner._graphs
    assert key[0] == app.newton_cfg and key[1] == INNER and key[2] == 65536 and key[-1].type == "cuda"
    assert {k: n for k, n in runner._graphs[key].counts.items() if n} == {"ndt_pair": INNER}
    assert sum(reads for (_, reads), _, _ in pairs) >= 3  # the eager call, the capture, a replay


@pytest.mark.cuda
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_replayed_body_runs_clean_under_sync_error_mode(maps, scene):
    """After an eager outer iteration and the capture, outer iterations
    replayed (and run eagerly) wait for the device nowhere; only the loop's
    read, outside, does."""
    _need_card()
    pts, mask, regmap, _, _ = maps
    cfg, pulled = SCENES[scene]
    regmap = type(regmap)(*(t if t is None or t is regmap.resolution else t.to(CUDA) for t in regmap))
    src, m, init, prior = (x.to(CUDA) if isinstance(x, torch.Tensor) else Pose3(x.rot.to(CUDA), x.trans.to(CUDA))
                           for x in _registration(pts, mask, 0))
    prior = prior if pulled else None
    runner = NewtonGraph()

    def run(graph):
        r = fused_math._fused_run(src, m, regmap, init, cfg, GRID, INNER, prior, newton_graph=graph)
        for _ in range(3):
            r.outer_iteration()
        return r

    run(runner), run(runner)  # eager, then the capture and replays
    want = run(None)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, eager = run(runner), run(None)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert runner.captures == 1
    for r in (got, eager):
        assert r.read.tolist() == want.read.tolist()
        assert torch.equal(r.pose.trans, want.pose.trans) and torch.equal(r.obj.hess, want.obj.hess)
