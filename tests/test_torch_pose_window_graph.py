"""``odom_ndt.PoseWindowGraph``: odom_ndt's full-window pose smoother (the
ring's slide, ``optimize_pose_window`` and ``pose_marginal_covariance``)
replayed as one CUDA graph.

On the CPU (these count in the default lane):

- the dispatch rule: only a full window on a CUDA device replays, and the
  runner keys its graphs by (W, iterations, dtype, device);
- the CPU runner, over the window's fill-up and once full, is the window
  solve as ``_odom_fused_step`` ran it inline (roll, write, masks,
  ``optimize_pose_window``, ``pose_marginal_covariance``), bit for bit, and
  captures nothing; the app's CPU run goes through it on every keyframe;
- the runner's buffers, with the capture stood in by a plain call whose
  outputs are overwritten in place at each replay as a graph's are: one
  eager call, one capture, then loads and replays equal to the eager solve
  bit for bit, with kept results unchanged by later replays; fill-up calls
  stay eager; another key captures again;
- the benchmark's ``unsmoothed`` fault (``odom_ndt.optimize_pose_window``
  patched) is what the runner captures and what the app's CPU run calls.

On the card (marker ``cuda``, skipped without one; tests/conftest.py
imports JAX, so run it there as
``python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_pose_window_graph.py``):
the runner over six full-window keyframes of changing inputs against the
eager solve, kept results not aliased; ``OdomNdtApp`` through the graph and
eagerly, continuous and split by a checkpoint, publishes the same poses and
covariances; with the ``unsmoothed`` fault planted the poses differ.
"""
import numpy as np
import pytest
import torch

from slamtpu_torch.apps import odom_ndt
from slamtpu_torch.core import se3
from slamtpu_torch.fusion.smoother import optimize_pose_window, pose_marginal_covariance
from slamtpu_torch.ins.imu_config import ImuConfig
from slamtpu_torch.lidar.ouster import LidarParams, synthetic_os2_metadata
from slamtpu_torch.runtime.config import PipelineConfig, RegisterConfig

torch.set_num_threads(1)
W, ITERS = 4, 4
CPU, CUDA = torch.device("cpu"), torch.device("cuda")


def window_inputs(seed, n=W, device=CPU):
    """A window ring holding ``n`` states of a vehicle driving along x with
    small turns (unused slots as ``OdomNdtApp._start`` leaves them) and the
    keyframe's new entries, float64, in ``odom_ndt.RING``'s order."""
    rng = np.random.default_rng(seed)
    f64 = dict(dtype=torch.float64)

    def poses(k, noise):
        xi = np.c_[rng.normal(0, 0.02, (k, 3)), np.arange(k)[:, None] * [1.0, 0.0, 0.0]]
        xi = xi + rng.normal(0, noise, (k, 6))
        p = se3.expmap(torch.as_tensor(xi, **f64))
        return p.rot, p.trans

    def sqrt_info(k, scale):
        a = rng.normal(0, 0.1, (k, 6, 6))
        return torch.as_tensor(scale * (np.eye(6) + a @ a.transpose(0, 2, 1)), **f64)

    win_rot, win_trans = (torch.eye(3, **f64).repeat(W, 1, 1), torch.zeros((W, 3), **f64))
    fp_rot, fp_trans = win_rot.clone(), win_trans.clone()
    fp_sig = torch.ones((W, 6), **f64)
    fb_rot, fb_trans, fb_si = win_rot.clone(), win_trans.clone(), torch.eye(6, **f64).repeat(W, 1, 1)
    win_rot[:n], win_trans[:n] = poses(n, 0.0)
    fp_rot[:n], fp_trans[:n] = poses(n, 0.01)
    fp_sig[:n] = torch.as_tensor(rng.uniform(0.01, 0.2, (n, 6)), **f64)
    odo = se3.between(se3.Pose3(win_rot[:n - 1], win_trans[:n - 1]), se3.Pose3(win_rot[1:n], win_trans[1:n]))
    noise = se3.expmap(torch.as_tensor(rng.normal(0, 0.005, (n - 1, 6)), **f64))
    odo = se3.compose(odo, noise)
    fb_rot[1:n], fb_trans[1:n], fb_si[1:n] = odo.rot, odo.trans, sqrt_info(n - 1, 30.0)
    ring = (win_rot, win_trans, fp_rot, fp_trans, fp_sig, fb_rot, fb_trans, fb_si)
    new_rot, new_trans = poses(n + 1, 0.01)
    ins_rot, ins_trans = poses(n + 1, 0.02)
    rel = se3.between(se3.Pose3(win_rot[n - 1], win_trans[n - 1]), se3.Pose3(new_rot[n], new_trans[n]))
    new = (new_rot[n], new_trans[n], ins_rot[n], ins_trans[n],
           torch.as_tensor(rng.uniform(0.01, 0.2, 6), **f64), rel.rot, rel.trans, sqrt_info(1, 30.0)[0])
    return tuple(t.to(device) for t in ring), tuple(t.to(device) for t in new)


def inline_window_solve(ring, new, n, iterations=ITERS):
    """The window solve as ``_odom_fused_step`` ran it inline before the
    runner: (solved rot, trans, rolled fp_rot, fp_trans, fp_sig, fb_rot,
    fb_trans, fb_si), marginal covariance."""
    window = ring[1].shape[0]
    full = n >= window
    idx = min(n, window - 1)

    def roll_in(a, new_val):
        rolled = torch.roll(a, -1, dims=0) if full else a.clone()
        rolled[idx] = new_val.to(a.dtype)
        return rolled

    win_rot, win_trans, fp_rot, fp_trans, fp_sig, fb_rot, fb_trans, fb_si = (
        roll_in(a, v) for a, v in zip(ring, new))
    ks = torch.arange(window, device=win_trans.device)
    active = ks <= idx
    b_active = (ks >= 1) & (ks <= idx)
    sm = optimize_pose_window(
        win_rot, win_trans, active, fp_rot, fp_trans, torch.diag_embed(1.0 / fp_sig),
        fb_rot[1:], fb_trans[1:], fb_si[1:], b_active[1:], iterations=iterations,
    )
    return (sm.rot, sm.trans, fp_rot, fp_trans, fp_sig, fb_rot, fb_trans, fb_si), \
        pose_marginal_covariance(sm.hessian, idx)


def _equal(got, want):
    (ring, cov), (ring2, cov2) = got, want
    assert len(ring) == len(ring2) == len(odom_ndt.RING)
    for a, b in zip(ring + (cov,), ring2 + (cov2,)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _differ(got, want):
    return any(not torch.equal(a, b) for a, b in zip(got[0] + (got[1],), want[0] + (want[1],)))


@pytest.mark.parametrize("device, full, want", [
    (CUDA, True, True), (CUDA, False, False), (CPU, True, False), (CPU, False, False),
    (torch.device("cuda", 1), True, True),
])
def test_replays_only_a_full_window_on_a_card(device, full, want):
    assert odom_ndt.replays(device, full) is want


@pytest.mark.parametrize("n", range(1, W + 1))
def test_cpu_runner_is_the_inline_solve(n):
    """Fill-up (n < W) and a full window: the runner on the CPU gives the
    inline solve's bits, every call, and captures nothing."""
    ring, new = window_inputs(n, n)
    want = inline_window_solve(ring, new, n)
    runner = odom_ndt.PoseWindowGraph()
    for _ in range(3):
        _equal(runner(ring, new, min(n, W - 1), n >= W, ITERS), want)
    assert runner.captures == 0 and not runner._graphs


class _StandInGraph:
    """A captured graph stood in by a plain call: each replay recomputes
    the captured function from its static inputs and writes the results
    into the outputs of the capture, in place, as a graph's replay does."""

    def __init__(self, fn, out):
        self.fn, self.out, self.replays = fn, out, 0

    def replay(self):
        ring, cov = self.fn()
        for buf, t in zip(self.out[0] + (self.out[1],), ring + (cov,)):
            buf.copy_(t)
        self.replays += 1


@pytest.fixture
def stand_in(monkeypatch):
    """CPU windows take the replay path, captured by ``_StandInGraph``;
    yields the graphs made."""
    graphs = []

    def capture(fn, device):
        assert device == CPU
        fn()  # the run on the capture stream before the capture
        out = fn()
        graphs.append(_StandInGraph(fn, out))
        return graphs[-1], out, {}

    monkeypatch.setattr(odom_ndt, "replays", lambda device, full: full)
    monkeypatch.setattr(odom_ndt, "capture_graph", capture)
    return graphs


def test_runner_runs_eager_captures_then_replays(stand_in):
    """Six full-window keyframes of changing inputs, with fill-up calls
    between: the first full one eager, the second captures, the rest load
    and replay; each result equals the eager solve bit for bit, and the
    results kept from earlier calls are untouched by later replays."""
    runner = odom_ndt.PoseWindowGraph()
    kept, buffers = [], None
    for k in range(6):
        ring, new = window_inputs(100 + k)
        want = odom_ndt._window_solve(ring, new, W - 1, True, ITERS)
        got = runner(ring, new, W - 1, True, ITERS)
        _equal(got, want)
        _equal(inline_window_solve(ring, new, W), want)
        kept.append((got, tuple(t.clone() for t in got[0] + (got[1],))))
        fill_ring, fill_new = window_inputs(200 + k, 2)
        _equal(runner(fill_ring, fill_new, 2, False, ITERS), inline_window_solve(fill_ring, fill_new, 2))
        if k >= 1:
            (graph,) = stand_in
            buffers = {t.data_ptr() for t in graph.out[0] + (graph.out[1],)}
            assert graph.replays == k
    assert runner.captures == 1
    assert list(runner._graphs) == [(W, ITERS, torch.float64, CPU)]
    for (ring, cov), values in kept:
        for t, v in zip(ring + (cov,), values):
            assert t.data_ptr() not in buffers and torch.equal(t, v)
    assert len({v[0].sum().item() for _, v in kept}) == len(kept)


def test_another_key_captures_again(stand_in):
    """The key is (W, iterations, dtype, device): another iteration count
    or window size runs eagerly once and captures its own graph."""
    runner = odom_ndt.PoseWindowGraph()
    ring, new = window_inputs(7)
    for iterations in (ITERS, ITERS, 2, 2, 2):
        _equal(runner(ring, new, W - 1, True, iterations), inline_window_solve(ring, new, W, iterations))
    assert runner.captures == 2 and len(stand_in) == 2
    assert set(runner._graphs) == {(W, ITERS, torch.float64, CPU), (W, 2, torch.float64, CPU)}
    three = tuple(t[1:].clone() for t in ring)
    _equal(runner(three, new, 2, True, ITERS), odom_ndt._window_solve(three, new, 2, True, ITERS))
    assert runner._graphs[(3, ITERS, torch.float64, CPU)] is None and runner.captures == 2


def _unsmoothed(monkeypatch):
    """The benchmark's ``unsmoothed`` fault: the window's Gauss-Newton
    iterations skipped, planted where the benchmark plants it."""
    solve = odom_ndt.optimize_pose_window
    monkeypatch.setattr(odom_ndt, "optimize_pose_window", lambda *a, **k: solve(*a, **dict(k, iterations=0)))


def test_unsmoothed_fault_lands_in_the_capture(stand_in, monkeypatch):
    """The patched ``odom_ndt.optimize_pose_window`` is what the runner
    runs eagerly and captures: every call gives the patched solve's
    results, which differ from the sound solve's."""
    inputs = [window_inputs(300 + k) for k in range(4)]
    sound = [inline_window_solve(ring, new, W) for ring, new in inputs]
    _unsmoothed(monkeypatch)
    runner = odom_ndt.PoseWindowGraph()
    for (ring, new), good in zip(inputs, sound):
        got = runner(ring, new, W - 1, True, ITERS)
        _equal(got, inline_window_solve(ring, new, W, iterations=0))
        assert _differ(got, good)
    assert runner.captures == 1


# --- the app on the CPU ---


def _app_cfg():
    meta = synthetic_os2_metadata(columns_per_frame=128, pixels_per_column=16, columns_per_packet=16)
    reg = RegisterConfig(method="NDT_OMP", ndt_resolution=1.0, ndt_max_iterations=10, map_capacity=1 << 12,
                         min_points_per_voxel=4, reg_grid_shape=(64, 64, 16), fused_inner_iters=1)
    return PipelineConfig(meta=meta, lidar=LidarParams(channel_stride=1, range_filter=(0.5, 150.0)),
                          imu=ImuConfig(), register=reg, deskew=True)


APP_WINDOW, APP_SWEEPS = 3, 7  # fill-up at n = 1, 2; full from the third step on


@pytest.fixture(scope="module")
def small_replay(tmp_path_factory):
    from tests.simulator_np import simulate_replay

    cfg = _app_cfg()
    path = str(tmp_path_factory.mktemp("pose_window_graph") / "skewed.rpl")
    simulate_replay(path, cfg.meta, cfg.lidar, n_sweeps=APP_SWEEPS, skewed=True)
    return path


def _published(traj):
    return [(np.asarray(e.pose.rot), np.asarray(e.pose.trans), e.covariance) for e in traj]


def test_app_on_the_cpu_runs_the_inline_solve(small_replay, monkeypatch):
    """Every step of the app's CPU run hands the runner its window, which
    solves it as the inline code did (fill-up and full), bit for bit; the
    carry holds what it returned; nothing is captured."""
    calls = []
    solve = odom_ndt._window_solve

    def recorded(ring, new, idx, full, iterations):
        out = solve(ring, new, idx, full, iterations)
        calls.append((tuple(t.clone() for t in ring), tuple(t.clone() for t in new), idx, full, iterations, out))
        return out

    monkeypatch.setattr(odom_ndt, "_window_solve", recorded)
    app = odom_ndt.OdomNdtApp(_app_cfg(), "cpu", window=APP_WINDOW)
    traj = app.run_replay(small_replay)
    assert len(traj) == APP_SWEEPS - 1 == len(calls) + 1
    assert [c[2:5] for c in calls] == [(1, False, 4), (2, False, 4)] + [(2, True, 4)] * (len(calls) - 2)
    for ring, new, idx, full, iterations, out in calls:
        _equal(out, inline_window_solve(ring, new, idx + 1 if full else idx, iterations))
    ring, cov = calls[-1][-1]
    assert all(app._carry[k] is t for k, t in zip(odom_ndt.RING, ring))
    assert app._window_graph.captures == 0 and not app._window_graph._graphs


def test_unsmoothed_fault_moves_the_cpu_app(small_replay, monkeypatch):
    sound = _published(odom_ndt.OdomNdtApp(_app_cfg(), "cpu", window=APP_WINDOW).run_replay(small_replay))
    _unsmoothed(monkeypatch)
    broken = _published(odom_ndt.OdomNdtApp(_app_cfg(), "cpu", window=APP_WINDOW).run_replay(small_replay))
    assert len(sound) == len(broken)
    assert any(not np.array_equal(t, t2) for (_, t, _), (_, t2, _) in zip(sound, broken))


# --- on the card ---


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernels)")


@pytest.mark.cuda
def test_graph_replay_equals_eager_solve_on_the_card():
    """Six full-window keyframes on the card: the first eager, the second
    captures, all equal ``_window_solve`` run eagerly on the same inputs
    bit for bit; every kept result is unchanged after the last replay."""
    _need_card()
    runner = odom_ndt.PoseWindowGraph()
    kept = []
    for k in range(6):
        ring, new = window_inputs(400 + k, device=CUDA)
        want = odom_ndt._window_solve(ring, new, W - 1, True, ITERS)
        got = runner(ring, new, W - 1, True, ITERS)
        _equal(got, want)
        kept.append((got, tuple(t.clone() for t in got[0] + (got[1],))))
    torch.cuda.synchronize()
    assert runner.captures == 1
    for (ring, cov), values in kept:
        for t, v in zip(ring + (cov,), values):
            assert torch.equal(t, v)
    assert len({float(v[0].sum()) for _, v in kept}) == len(kept)


def _card_app_cfg():
    meta = synthetic_os2_metadata(columns_per_frame=512, pixels_per_column=64, columns_per_packet=16)
    reg = RegisterConfig(method="NDT_OMP", ndt_resolution=1.0, ndt_max_iterations=30, map_capacity=1 << 16,
                         min_points_per_voxel=4, reg_grid_shape=(128, 128, 32))
    return PipelineConfig(meta=meta, lidar=LidarParams(channel_stride=1, range_filter=(0.5, 150.0)),
                          imu=ImuConfig(), register=reg, deskew=True)


CARD_WINDOW, CARD_SWEEPS, CARD_SPLIT = 4, 16, 9  # the split falls after the capture


@pytest.mark.cuda
def test_app_through_the_graph_on_the_card(tmp_path, monkeypatch):
    """``OdomNdtApp`` on the card through the graph and eagerly publishes
    the same poses and covariances, continuous and split by a checkpoint
    after the capture (the resumed app runs eagerly once and captures
    again); with the ``unsmoothed`` fault planted the poses differ."""
    _need_card()
    from simulator_np import simulate_replay

    cfg = _card_app_cfg()
    path = str(tmp_path / "skewed.rpl")
    simulate_replay(path, cfg.meta, cfg.lidar, n_sweeps=CARD_SWEEPS, skewed=True)

    def run(replay: bool, split: bool = False):
        mp = pytest.MonkeyPatch()
        if not replay:
            mp.setattr(odom_ndt, "replays", lambda *_a: False)
        try:
            app = odom_ndt.OdomNdtApp(cfg, "cuda", window=CARD_WINDOW)
            frames = list(app.ingest.synced_frames(path))
            if not split:
                for s in frames:
                    app.process(s)
                return _published(app.trajectory), [app._window_graph.captures]
            for s in frames[:CARD_SPLIT]:
                app.process(s)
            head = list(app.trajectory)
            ckpt = str(tmp_path / f"odom_{replay}.npz")
            app.save_checkpoint(ckpt)
            resumed = odom_ndt.OdomNdtApp(cfg, "cuda", window=CARD_WINDOW)
            resumed.resume_from(ckpt)
            for s in frames[CARD_SPLIT:]:
                resumed.process(s)
            return (_published(head + list(resumed.trajectory)),
                    [app._window_graph.captures, resumed._window_graph.captures])
        finally:
            mp.undo()

    def same(a, b):
        assert len(a) == len(b) == CARD_SWEEPS - 1
        for (r, t, c), (r2, t2, c2) in zip(a, b):
            assert np.array_equal(r, r2) and np.array_equal(t, t2)
            assert (c is None and c2 is None) or np.array_equal(c, c2)

    graph, caps = run(True)
    eager, eager_caps = run(False)
    assert caps == [1] and eager_caps == [0]
    same(graph, eager)
    graph_split, split_caps = run(True, split=True)
    eager_split, _ = run(False, split=True)
    assert split_caps == [1, 1]
    same(graph_split, eager_split)
    for (_, t, _), (_, t2, _) in zip(graph_split, graph):
        np.testing.assert_allclose(t, t2, rtol=0, atol=1e-5)
    _unsmoothed(monkeypatch)
    broken, broken_caps = run(True)
    assert broken_caps == [1]
    assert any(not np.array_equal(t, t2) for (_, t, _), (_, t2, _) in zip(broken, graph))
