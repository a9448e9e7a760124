"""``core.cuda_graph``: the port's one capture-once CUDA graph runner, on the
CPU with the capture stood in by a plain call whose outputs are overwritten
in place at each replay, as a graph's are (``_StandInGraph``; the
``stand_in`` fixture, which the window smoother's tests use too).

- a key's first call runs eagerly, the second captures, later calls load
  and replay, each equal to the function run directly, bit for bit; kept
  outputs are untouched by later replays; another key captures again;
- per-call inputs are copied in at every call, sticky ones only when the
  caller passes another object; leaves off the capture device pass through;
- the counts the captured call added are added back at each replay;
- ``svn.SvnGraph`` through the stand-in equals ``svn_align_reg`` bit for bit
  over keyframes that swap in a new RegMap midway.

The card tests of the clients are in ``test_torch_svn_graph.py``,
``test_torch_pose_window_graph.py`` and ``test_torch_map_graph.py``.
"""
from typing import NamedTuple

import numpy as np
import pytest
import torch

from slamtpu_torch.core import cuda_graph, se3
from slamtpu_torch.core.se3 import Pose3
from slamtpu_torch.mapping import gaussian_map
from slamtpu_torch.ndt import fused_math
from slamtpu_torch.ndt.gicp import regularize_plane_covariance
from slamtpu_torch.ndt.regmap import build_regmap
from slamtpu_torch.ndt.svn import SvnGraph, svn_align_reg
from test_torch_svn_graph import CASES, GRID, scene

torch.set_num_threads(1)
CPU = torch.device("cpu")


class _StandInGraph:
    """A captured graph stood in by a plain call: each replay recomputes
    the captured function from its static inputs and writes the results
    into the outputs of the capture, in place, as a graph's replay does;
    what the call adds to the counters is taken back, as a replay runs no
    Python."""

    def __init__(self, fn, out, counters):
        self.fn, self.out, self.counters, self.replays = fn, out, counters, 0

    def replay(self):
        fresh, _ = cuda_graph.uncounted(self.fn, self.counters)
        for buf, t in zip(cuda_graph._leaves(self.out), cuda_graph._leaves(fresh)):
            buf.copy_(t)
        self.replays += 1


@pytest.fixture
def stand_in(monkeypatch):
    """CPU inputs take the replay path, captured by ``_StandInGraph``;
    yields the graphs made."""
    graphs = []

    def capture(fn, device, counters=None):
        fn()  # the run on the capture stream before the capture
        out, counts = cuda_graph.uncounted(fn, counters)
        graphs.append(_StandInGraph(fn, out, counters))
        return graphs[-1], out, counts

    monkeypatch.setattr(cuda_graph, "replays", lambda device: True)
    monkeypatch.setattr(cuda_graph, "capture", capture)
    return graphs


class Table(NamedTuple):
    w: torch.Tensor
    bias: torch.Tensor


COUNTERS = {"calls": 0, "kernels": 0}


def stage(x, pose: Pose3, scale, nothing, table: Table):
    """A stand-in stage: nested outputs from per-call inputs (a tensor, a
    NamedTuple, a number, None) and a sticky table; counts one call and
    three kernels."""
    assert nothing is None
    COUNTERS["calls"] += 1
    COUNTERS["kernels"] += 3
    y = se3.transform_points(pose, x) * scale
    return (Pose3(pose.rot @ pose.rot, y.sum(0)), y @ table.w + table.bias), torch.sum(y * y)


def inputs(seed, n=16):
    g = torch.Generator().manual_seed(seed)
    pose = se3.expmap(0.1 * torch.randn(6, generator=g, dtype=torch.float64))
    return torch.randn((n, 3), generator=g, dtype=torch.float64), pose


def table(seed):
    g = torch.Generator().manual_seed(seed)
    return Table(torch.randn((3, 4), generator=g, dtype=torch.float64),
                 torch.randn(4, generator=g, dtype=torch.float64))


def _equal(got, want):
    a, b = cuda_graph._leaves(got), cuda_graph._leaves(want)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_eager_then_capture_then_replay(stand_in):
    """Six calls of one key with changing inputs: the first eager, the
    second captures, the rest load and replay; each equals the stage run
    directly, bit for bit, and the outputs kept from earlier calls own
    their memory and are untouched by later replays."""
    runner = cuda_graph.GraphRunner(stage, "test_replay")
    tab = table(0)
    kept = []
    for k in range(6):
        x, pose = inputs(k)
        got = runner.run("key", CPU, (x, pose, 2.0, None), sticky=(tab,))
        _equal(got, stage(x, pose, 2.0, None, tab))
        kept.append((got, [t.clone() for t in cuda_graph._leaves(got)]))
        assert len(stand_in) == min(k, 1) and (k == 0 or stand_in[0].replays == k)
    assert runner.captures == 1 and list(runner._graphs) == ["key"]
    buffers = {t.data_ptr() for t in cuda_graph._leaves(stand_in[0].out)}
    for got, values in kept:
        for t, v in zip(cuda_graph._leaves(got), values):
            assert t.data_ptr() not in buffers and torch.equal(t, v)
    assert len({float(v[-1]) for _, v in kept}) == len(kept)


def test_each_key_captures_once(stand_in):
    """Keys a, a, b, b, b, a: one eager call and one capture each; every
    call equals the stage run directly."""
    runner = cuda_graph.GraphRunner(stage, "test_replay")
    tab = table(1)
    for k, key in enumerate("aabbba"):
        x, pose = inputs(10 + k, n=8 if key == "a" else 5)
        _equal(runner.run(key, CPU, (x, pose, 0.5, None), sticky=(tab,)), stage(x, pose, 0.5, None, tab))
    assert runner.captures == 2 and len(stand_in) == 2
    assert [g.replays for g in stand_in] == [2, 2]
    assert set(runner._graphs) == {"a", "b"}


def test_sticky_inputs_are_copied_only_when_the_object_changes(stand_in):
    """A table changed in place under the same object is not copied in (the
    replay reads the values of the last copy); another object is, and its
    values hold from then on. Per-call inputs are copied every call."""
    runner = cuda_graph.GraphRunner(stage, "test_replay")
    first, second = table(2), table(3)
    held = Table(first.w.clone(), first.bias.clone())  # first's values at the capture

    def check(seed, tab, values):
        x, pose = inputs(seed)
        _equal(runner.run("key", CPU, (x, pose, 1.0, None), sticky=(tab,)), stage(x, pose, 1.0, None, values))

    check(20, first, first)  # eager
    check(20, first, first)  # capture
    first.w.add_(1.0)
    check(21, first, held)
    check(21, second, second)
    check(21, first, first)
    check(22, first, first)


def test_leaves_off_the_capture_device_pass_through(stand_in):
    """Tensors on another device than the capture's, numbers and None are
    what the captured call reads, as passed at the capture, and a load
    copies nothing into them."""
    x, pose = inputs(30)
    cpu_scale = torch.tensor(3.0)
    cap = cuda_graph._Captured(lambda *a: a[0] * a[1], torch.device("meta"), (x, cpu_scale, None, 2.0),
                               (), None)
    assert cap.inputs[0] is x and cap.inputs[1] is cpu_scale and cap.inputs[2:] == (None, 2.0)
    cap.load((x + 1, torch.tensor(5.0), None, 2.0), ())
    assert float(cpu_scale) == 3.0 and torch.equal(cap.out, x * 3.0)


def test_counters_are_added_back_at_each_replay(stand_in):
    """The eager call counts itself; the capture call counts the run before
    the capture and one replay (the capture itself adds nothing); each
    replay adds what the captured call added."""
    runner = cuda_graph.GraphRunner(stage, "test_replay", COUNTERS)
    tab = table(4)
    start = dict(COUNTERS)
    seen = []
    for k in range(5):
        x, pose = inputs(40 + k)
        runner.run("key", CPU, (x, pose, 1.0, None), sticky=(tab,))
        seen.append(COUNTERS["kernels"] - start["kernels"])
    assert seen == [3, 9, 12, 15, 18]
    assert stand_in[0].replays == 4 and runner._graphs["key"].counts == {"calls": 1, "kernels": 3}
    plain = cuda_graph.GraphRunner(stage, "test_replay")  # no counters: none added back
    for _ in range(3):
        plain.run("key", CPU, (x, pose, 1.0, None), sticky=(tab,))
    assert plain._graphs["key"].counts == {}


def _second_regmap(src, mask):
    """Another RegMap of the same key as ``scene()``'s: the map of the
    source points moved 0.4 m, with the aux table."""
    moved = src + torch.tensor([0.4, -0.2, 0.1])
    gmap = gaussian_map.build_map(moved, mask, torch.full((3,), -16.0), 1.0, capacity=1 << 11,
                                  min_points_per_voxel=4)
    aux = torch.cat([gmap.mean, regularize_plane_covariance(gmap.cov).reshape(-1, 9)], dim=1)
    return build_regmap(gmap, grid_shape=GRID, aux_payload=aux)


@pytest.mark.parametrize("case", sorted(CASES))
def test_svn_graph_through_the_stand_in_is_svn_align_reg(stand_in, case):
    """Six keyframes, a new RegMap from the fourth on: eager, capture, then
    replays that copy the new RegMap's tables in once; every result equals
    ``svn_align_reg``'s bit for bit."""
    src, mask, regmap, _, src_cov, _ = scene()
    rebuilt = _second_regmap(src, mask)
    assert rebuilt.packed.shape == regmap.packed.shape and not torch.equal(rebuilt.packed, regmap.packed)
    cfg = CASES[case]
    runner = SvnGraph()
    rng = np.random.default_rng(11)
    for k in range(6):
        prior = se3.expmap(torch.as_tensor(rng.normal(0, 0.02, 6), dtype=torch.float32))
        noise = torch.as_tensor(rng.standard_normal((cfg.num_particles, 6)), dtype=torch.float32)
        target = regmap if k < 3 else rebuilt
        launches = dict(fused_math.LAUNCHES)
        got = runner(src, mask, target, prior, cfg, GRID, src_cov=src_cov, init_noise=noise)
        assert fused_math.LAUNCHES == launches  # no pair kernel runs on the CPU
        want = svn_align_reg(src, mask, target, prior, cfg, GRID, src_cov=src_cov, init_noise=noise)
        _equal(got, want)
    assert runner.captures == 1 and stand_in[0].replays == 5
    assert runner._graphs[next(iter(runner._graphs))].sources == (rebuilt,)
