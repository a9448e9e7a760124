"""``svn.SvnGraph``: lo_svn's SVN flow and polish replayed as one CUDA graph.

On the CPU (these count in the default lane):

- ``svn_align_reg`` on a fixed three-plane scene gives the values the eager
  loop gave before the flow was split from the posterior (the plane-to-plane
  polish, the NDT polish from the mean, no polish);
- the path choice: CPU points run ``svn_align_reg`` itself (nothing
  captured, equal bit for bit); the sorted-key app (``use_regmap=False``)
  never calls the runner; the RegMap app on the CPU calls it and publishes
  what ``svn_align_reg`` publishes. The shared runner under ``SvnGraph``,
  a RegMap rebuild included, is held on the CPU in
  ``test_torch_cuda_graph.py``.

On the card (marker ``cuda``, skipped without one; tests/conftest.py imports
JAX, so run it there as
``python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_svn_graph.py``):
``LoSvnApp`` over 65 keyframes (a map rebuild every 4) through the graph and
eagerly publishes the same poses, covariances, iteration counts and scores,
captures once, and keeps 64 distinct results in flight.
"""
import numpy as np
import pytest
import torch

from slamtpu_torch.apps import lo_svn as tlo
from slamtpu_torch.core import cuda_graph, se3
from slamtpu_torch.ins.imu_config import ImuConfig
from slamtpu_torch.lidar.ouster import LidarParams, synthetic_os2_metadata
from slamtpu_torch.mapping import gaussian_map
from slamtpu_torch.ndt.gicp import regularize_plane_covariance, source_point_covariances
from slamtpu_torch.ndt.regmap import build_regmap
from slamtpu_torch.ndt.svn import SvnConfig, SvnGraph, svn_align_reg
from slamtpu_torch.runtime.config import PipelineConfig, RegisterConfig

torch.set_num_threads(1)
GRID = (32, 32, 16)


def scene():
    """A ground and two walls, their map's RegMap with the aux table, the
    same points seen from a pose 0.37 m and 0.04 rad away, their source
    covariances, the identity prior and six particle draws."""
    rng = np.random.default_rng(7)
    n = 1536
    ground = np.c_[rng.uniform(-12, 12, (n, 2)), rng.normal(0, 0.02, n)]
    wall_x = np.c_[np.full(n // 2, 8.0) + rng.normal(0, 0.02, n // 2), rng.uniform(-12, 12, n // 2),
                   rng.uniform(0, 5, n // 2)]
    wall_y = np.c_[rng.uniform(-12, 12, n // 2), np.full(n // 2, -6.0) + rng.normal(0, 0.02, n // 2),
                   rng.uniform(0, 5, n // 2)]
    world = np.concatenate([ground, wall_x, wall_y]).astype(np.float32)
    pts = torch.as_tensor(world)
    mask = torch.ones(pts.shape[0], dtype=torch.bool)
    mask[::17] = False
    gmap = gaussian_map.build_map(pts, mask, torch.full((3,), -16.0), 1.0, capacity=1 << 11,
                                  min_points_per_voxel=4)
    aux = torch.cat([gmap.mean, regularize_plane_covariance(gmap.cov).reshape(-1, 9)], dim=1)
    regmap = build_regmap(gmap, grid_shape=GRID, aux_payload=aux)
    truth = se3.expmap(torch.tensor([0.01, -0.02, 0.03, 0.3, -0.2, 0.1]))
    src = se3.transform_points(se3.inverse(truth), pts) + torch.as_tensor(
        rng.normal(0, 0.01, world.shape), dtype=torch.float32)
    src_cov = source_point_covariances(src, mask, 1.0, capacity=1 << 11, min_points_per_voxel=4)
    noise = torch.as_tensor(rng.standard_normal((6, 6)), dtype=torch.float32)
    return src, mask, regmap, se3.expmap(torch.zeros(6)), src_cov, noise


CASES = {
    "aniso": SvnConfig(num_particles=6, max_iterations=5, step_size=1.0, polish_iters=2,
                       polish_objective="gicp_aniso"),
    "ndt_mean": SvnConfig(num_particles=6, max_iterations=5, step_size=1.0, polish_iters=2,
                          polish_from="mean"),
    "no_polish": SvnConfig(num_particles=6, max_iterations=5, step_size=1.0),
}

# svn_align_reg's results on scene() with the flow and the posterior in one
# function (the eager loop as it was): rotation, translation, covariance
# diagonal, iterations, converged, score; the first two particles'
# translations are the same in every case
PARENT = {
    "aniso": ([0.9994412660598755, -0.028191164135932922, -0.017956500872969627, 0.028013287112116814,
               0.9995567202568054, -0.010082217864692211, 0.018232759088277817, 0.009573585353791714,
               0.9997879266738892],
              [0.2840404510498047, -0.18829941749572754, 0.09139858931303024],
              [7.828651723684743e-05, 0.00015852619253564626, 0.00024978150031529367, 0.0021746063139289618,
               0.00342531013302505, 0.0012813645880669355], 5, False, -7033.10595703125),
    "ndt_mean": ([0.9993917346000671, -0.029189208522439003, -0.019083349034190178, 0.02900988981127739,
                  0.99953293800354, -0.009606708772480488, 0.01935485005378723, 0.009047257713973522,
                  0.9997717142105103],
                 [0.29321491718292236, -0.19335001707077026, 0.1021660566329956],
                 [7.843611820135266e-05, 0.00015844097652006894, 0.0002497171808499843, 0.002171738538891077,
                  0.0034277825616300106, 0.0012819679686799645], 5, False, 2619.995849609375),
    "no_polish": ([0.9996817708015442, -0.02072523906826973, -0.014380907639861107, 0.020626336336135864,
                   0.999762773513794, -0.006991492584347725, 0.014522405341267586, 0.00669262558221817,
                   0.9998721480369568],
                  [0.20713573694229126, -0.1405612677335739, 0.08553887903690338],
                  [7.761830056551844e-05, 0.00015861274732742459, 0.0002503616560716182, 0.00218591233715415,
                   0.003420016495510936, 0.0012660676147788763], 5, False, 1754.8043212890625),
}
PARENT_PARTICLES = [0.193952277302742, -0.16849713027477264, 0.1317604035139084, 0.1959695816040039,
                    -0.19555389881134033, 0.11569155752658844]


@pytest.fixture(scope="module")
def fixed_scene():
    return scene()


def _same(a, b):
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            _same(x, y)
        else:
            assert torch.equal(x, y)


@pytest.mark.parametrize("case", sorted(CASES))
def test_svn_align_reg_gives_the_eager_loops_values(fixed_scene, case):
    src, mask, regmap, prior, src_cov, noise = fixed_scene
    res = svn_align_reg(src, mask, regmap, prior, CASES[case], GRID, src_cov=src_cov, init_noise=noise)
    rot, trans, cov_diag, iters, converged, score = PARENT[case]
    t = dict(dtype=torch.float32)
    torch.testing.assert_close(res.pose.rot.flatten(), torch.tensor(rot, **t), rtol=0, atol=2e-6)
    torch.testing.assert_close(res.pose.trans, torch.tensor(trans, **t), rtol=0, atol=2e-6)
    torch.testing.assert_close(torch.diagonal(res.covariance), torch.tensor(cov_diag, **t), rtol=1e-4, atol=0)
    torch.testing.assert_close(res.particles.trans.flatten()[:6], torch.tensor(PARENT_PARTICLES, **t),
                               rtol=0, atol=2e-6)
    assert int(res.iterations) == iters and bool(res.converged) == converged
    assert float(res.score) == pytest.approx(score, rel=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_runner_on_the_cpu_is_svn_align_reg(fixed_scene, case):
    """CPU points take ``svn_align_reg``: the same results bit for bit,
    every call, and no capture."""
    src, mask, regmap, prior, src_cov, noise = fixed_scene
    want = svn_align_reg(src, mask, regmap, prior, CASES[case], GRID, src_cov=src_cov, init_noise=noise)
    runner = SvnGraph()
    for _ in range(3):
        _same(runner(src, mask, regmap, prior, CASES[case], GRID, src_cov=src_cov, init_noise=noise), want)
    assert runner.captures == 0 and not runner._graphs


def _small_app_cfg(**change):
    meta = synthetic_os2_metadata(columns_per_frame=128, pixels_per_column=16, columns_per_packet=16)
    reg = RegisterConfig(svn_resolution=2.0, svn_particles=4, svn_max_iterations=2, svn_polish_iters=1,
                         map_capacity=1 << 12, min_points_per_voxel=4, keyframe_window=3,
                         reg_grid_shape=(16, 16, 8), map_rebuild_every=2, **change)
    return PipelineConfig(meta=meta, lidar=LidarParams(channel_stride=1, range_filter=(0.5, 150.0)),
                          imu=ImuConfig(), register=reg, deskew=True)


@pytest.fixture(scope="module")
def small_replay(tmp_path_factory):
    from tests.simulator_np import simulate_replay

    cfg = _small_app_cfg()
    path = str(tmp_path_factory.mktemp("svn_graph") / "skewed.rpl")
    simulate_replay(path, cfg.meta, cfg.lidar, n_sweeps=6, skewed=True)
    return path


def _published(traj):
    return [(np.asarray(e.pose.rot), np.asarray(e.pose.trans), e.covariance) for e in traj]


def test_lo_svn_app_routes_through_the_runner_on_the_cpu(small_replay, monkeypatch):
    """The RegMap app calls its runner on every keyframe, which on the CPU
    runs ``svn_align_reg``: the trajectory equals the one with the runner
    left out, bit for bit."""
    calls = []
    call = SvnGraph.__call__

    def counted(self, *a, **k):
        calls.append(a[0].device.type)
        return call(self, *a, **k)

    app = tlo.LoSvnApp(_small_app_cfg(), "cpu")
    monkeypatch.setattr(SvnGraph, "__call__", counted)
    got = _published(app.run_replay(small_replay))
    monkeypatch.undo()
    eager = tlo.LoSvnApp(_small_app_cfg(), "cpu")
    eager._svn_graph = None
    want = _published(eager.run_replay(small_replay))
    assert calls == ["cpu"] * (len(got) - 1) and app._svn_graph.captures == 0
    assert len(got) == len(want)
    for (r, t, c), (r2, t2, c2) in zip(got, want):
        assert np.array_equal(r, r2) and np.array_equal(t, t2)
        assert (c is None and c2 is None) or np.array_equal(c, c2)


def test_sorted_key_app_never_calls_the_runner(small_replay, monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the sorted-key path called SvnGraph")

    monkeypatch.setattr(SvnGraph, "__call__", refuse)
    traj = tlo.LoSvnApp(_small_app_cfg(use_regmap=False), "cpu").run_replay(small_replay)
    assert len(traj) > 1 and all(np.isfinite(np.asarray(e.pose.trans)).all() for e in traj)


# --- on the card ---


def _card_cfg():
    meta = synthetic_os2_metadata(columns_per_frame=512, pixels_per_column=64, columns_per_packet=16)
    reg = RegisterConfig(svn_resolution=1.0, svn_particles=20, svn_max_iterations=8, svn_kernel_h=5.0,
                         svn_step_size=1.0, map_capacity=1 << 17, min_points_per_voxel=4, keyframe_window=5,
                         reg_grid_shape=(256, 256, 32), map_rebuild_every=4, map_exclude_recent=3)
    return PipelineConfig(meta=meta, lidar=LidarParams(channel_stride=1, range_filter=(0.5, 150.0)),
                          imu=ImuConfig(), register=reg, deskew=True)


CARD_SWEEPS = 66  # 65 keyframes: the seed sweep, then 64 in flight at the first flush


@pytest.mark.cuda
def test_graph_replay_equals_eager_on_the_card(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernels)")
    from simulator_np import simulate_replay

    cfg = _card_cfg()
    path = str(tmp_path / "skewed.rpl")
    simulate_replay(path, cfg.meta, cfg.lidar, n_sweeps=CARD_SWEEPS, skewed=True)

    def run(replay: bool):
        if not replay:
            monkeypatch.setattr(cuda_graph, "replays", lambda *_a, **_k: False)
        app = tlo.LoSvnApp(cfg, "cuda")
        flush, held = app.flush, []

        def flush_and_keep():
            if len(app._pending) == 64:  # the in-flight results, before they are read
                held.append([(res.pose.rot.data_ptr(), res.pose.trans.clone(), res.covariance.data_ptr())
                             for *_, res, _viz in app._pending])
            flush()

        app.flush = flush_and_keep
        rebuilds = []
        tick = app._cadence.tick
        app._cadence.tick = lambda force=False: rebuilds.append(tick(force)) or rebuilds[-1]
        traj = app.run_replay(path)
        monkeypatch.undo()
        recs = app.stats.records
        return app, traj, recs, held, sum(rebuilds)

    g_app, g_traj, g_recs, g_held, n_rebuilds = run(True)
    e_app, e_traj, e_recs, _, _ = run(False)
    assert len(g_traj) == len(e_traj) == CARD_SWEEPS - 1 and n_rebuilds >= 2
    assert g_app._svn_graph.captures == 1 and e_app._svn_graph.captures == 0
    for a, b in zip(g_traj, e_traj):
        assert np.array_equal(np.asarray(a.pose.rot), np.asarray(b.pose.rot))
        assert np.array_equal(np.asarray(a.pose.trans), np.asarray(b.pose.trans))
        assert (a.covariance is None and b.covariance is None) or np.array_equal(a.covariance, b.covariance)
    for a, b in zip(g_recs, e_recs):
        assert (a.ndt_iterations, a.converged, a.score) == (b.ndt_iterations, b.converged, b.score)
    # the 64 results in flight at the first flush own their memory and differ
    assert len(g_held) == 1 and len(g_held[0]) == 64
    rot_ptrs, trans, cov_ptrs = zip(*g_held[0])
    assert len(set(rot_ptrs)) == 64 and len(set(cov_ptrs)) == 64
    assert len({tuple(t.cpu().tolist()) for t in trans}) == 64
