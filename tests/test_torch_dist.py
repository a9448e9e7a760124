"""The multi-device layer (slamtpu_torch.dist) on the CPU: D = 2 and 4 gloo
ranks, spawned once per D with ``torch.multiprocessing`` and a ``file://``
store under the test's temporary directory (xdist workers never share a
port), under a deadline so that a deadlock fails instead of hanging.

Each rank runs every function of the layer on numpy inputs made from
seeds and returns numpy results; the ranks import no JAX. The results are
held to
- the other ranks: equal bit for bit, iteration counts included (every
  rank takes its loop decisions from the same collective results);
- the JAX functions on a D-device sub-mesh of the 8 CPU devices (those
  that run the reference's Pallas kernel at D = 2 only: interpreted on the
  CPU, each takes ~9 s to trace);
- the port's single-device functions;
- their collective counts, pinned.

Tolerances (float32 sums in other orders: the gloo ring, the reference's
``psum`` and the one-device sums): voxel keys, counts and validity exact,
means 1e-5 m, inverse covariances rtol 1e-3; Newton poses 1e-4 m / 1e-4
rad with equal iterations (the reference's tests hold its own sharded and
one-device runs at 1e-6 and 5e-3, tests/test_dist.py:68-74, 182-188), in
``newton_align_sharded`` (the sorted-key objective) as in the RegMap ones,
the one-device port's Newton at 1e-5 m / 1e-5 rad; ``lo_train_step``'s
statistics against the one-device merge exact in keys and counts, rtol
1e-5 in the sums, and against the reference's exact in keys and the
total, a point or so across a voxel face (its pose differs by rounding);
SVN poses 1e-4, the covariance rtol 2e-2 and particles 5e-4, as
tests/test_dist.py:233-249 holds the reference's own.
``newton_align_fused_batch`` equals B calls of ``newton_align_fused`` bit
for bit, and the reference's batch within 1e-5 m / 1e-5 rad.
"""
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from slamtpu_torch import dist as tdist
from slamtpu_torch import interop
from slamtpu_torch.core import se3
from slamtpu_torch.core.se3 import Pose3
from slamtpu_torch.mapping import gaussian_map
from slamtpu_torch.ndt import fused_math
from slamtpu_torch.ndt.newton import NewtonConfig
from slamtpu_torch.ndt.regmap import build_regmap
from slamtpu_torch.ndt.svn import SvnConfig, svn_align_reg

torch.set_num_threads(1)
SPAWN_DEADLINE_S = 240.0
ORIGIN = np.array([-8.0, -8.0, -8.0], np.float32)
GRID_MAP = (64, 64, 64)  # tests/test_dist.py's map and Newton setup
GRID_SMALL = (48, 48, 16)  # its fused, SVN and batch setup
GT_MAP = [0.01, -0.02, 0.03, 0.2, -0.1, 0.05]
GT_FUSED = [0.01, -0.008, 0.02, 0.25, -0.2, 0.05]
GT_SVN = [0.01, -0.008, 0.02, 0.15, -0.1, 0.05]
PRIOR_OFFSET = [0.004, -0.003, 0.002, 0.02, -0.01, 0.015]
SVN_CFG = dict(resolution=1.0, num_particles=16, max_iterations=6, polish_iters=2, polish_from="prior")
BATCH = 8
BATCH_CFG = dict(resolution=1.0, max_iterations=24, trans_eps=1e-4)
# the reference's functions that run its Pallas kernel (interpreted on the
# CPU) take ~9 s each to trace; they are compared at this D, the others at both
JAX_PALLAS_D = 2


def _pose_np(xi):
    p = se3.expmap(torch.tensor(xi, dtype=torch.float64))
    return p.rot.numpy(), p.trans.numpy()


def _unposed(xi, pts):
    """The points seen from the pose Exp(xi): T^-1 pts, float32."""
    R, t = _pose_np(xi)
    return ((pts.astype(np.float64) - t) @ R).astype(np.float32)


def _blobs(n, seed, squash=False):
    rng = np.random.default_rng(seed)
    if squash:
        centers = rng.uniform(2, 30, (24, 3)) * np.array([1, 1, 0.25])
        return (centers[rng.integers(0, 24, n)] + rng.normal(0, 0.3, (n, 3))).astype(np.float32)
    centers = rng.uniform(0, 30, (32, 3))
    return (centers[rng.integers(0, 32, n)] + rng.normal(0, 0.3, (n, 3))).astype(np.float32)


def inputs():
    """Every case's numpy inputs (the same in the ranks and the tests)."""
    world = _blobs(4096, 21)
    fused = _blobs(2048, 11, squash=True)
    svn = _blobs(2048, 5, squash=True)
    batch = _blobs(256, 5, squash=True)
    prior = se3.retract(se3.expmap(torch.tensor(GT_SVN, dtype=torch.float32)),
                        torch.tensor(PRIOR_OFFSET, dtype=torch.float32))
    return dict(
        world=world, src_map=_unposed(GT_MAP, world),
        fused=fused, src_fused=_unposed(GT_FUSED, fused),
        svn=svn, src_svn=_unposed(GT_SVN, svn), prior_rot=prior.rot.numpy(), prior_trans=prior.trans.numpy(),
        lo_map=_blobs(2048, 3), lo_scan=_blobs(2048, 4),
        batch=batch,
        batch_src=np.stack([_unposed(np.array(GT_FUSED) * (0.5 + b / BATCH), batch) for b in range(BATCH)]),
    )


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _regmap(points, min_points, grid):
    gmap = gaussian_map.build_map(_t(points), torch.ones(len(points), dtype=torch.bool), _t(ORIGIN), 1.0,
                                  capacity=4096, min_points_per_voxel=min_points)
    return build_regmap(gmap, grid_shape=grid)


def _identity(n=None):
    eye = Pose3(torch.eye(3), torch.zeros(3))
    return eye if n is None else Pose3(eye.rot.expand(n, 3, 3).contiguous(), eye.trans.expand(n, 3).contiguous())


def _run(name, out, fn):
    """``fn()``'s results into ``out`` under ``name``, with the collectives
    and Newton host reads it issued."""
    before, reads = dict(tdist.COLLECTIVES), fused_math.HOST_READS["newton"]
    res = fn()
    for k, v in res.items():
        out[f"{name}.{k}"] = np.asarray(v.detach().numpy() if torch.is_tensor(v) else v)
    for k in before:
        out[f"{name}.collectives.{k}"] = np.int64(tdist.COLLECTIVES[k] - before[k])
    out[f"{name}.host_reads"] = np.int64(fused_math.HOST_READS["newton"] - reads)


def _rank_worker(rank, world, init_file, out_dir, noise):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world)
    try:
        x = inputs()
        out = {}
        mine = lambda a: _t(np.array_split(a, world)[rank])  # noqa: E731  (contiguous shards)
        ones = lambda a: torch.ones(a.shape[0], dtype=torch.bool)  # noqa: E731

        def build():
            g = tdist.build_map_sharded(mine(x["world"]), ones(mine(x["world"])), _t(ORIGIN), 1.0, 4096)
            return dict(keys=g.keys, count=g.count, valid=g.valid, mean=g.mean, icov=g.icov)

        rmap = _regmap(x["world"], 6, GRID_MAP)
        gmap = gaussian_map.build_map(_t(x["world"]), ones(x["world"]), _t(ORIGIN), 1.0, capacity=4096,
                                      min_points_per_voxel=6)

        def newton_sorted():
            p, h, s, it = tdist.newton_align_sharded(mine(x["src_map"]), ones(mine(x["src_map"])), gmap,
                                                     _identity(), max_iterations=20)
            return dict(rot=p.rot, trans=p.trans, hess=h, score=s, iterations=it)

        def newton_reg():
            p, h, s, it = tdist.newton_align_sharded_reg(mine(x["src_map"]), ones(mine(x["src_map"])), rmap,
                                                         _identity(), GRID_MAP, max_iterations=20)
            return dict(rot=p.rot, trans=p.trans, hess=h, score=s, iterations=it)

        rmap_f = _regmap(x["fused"], 4, GRID_SMALL)

        def newton_fused():
            p, h, s, it = tdist.newton_align_sharded_fused(
                mine(x["src_fused"]), ones(mine(x["src_fused"])), rmap_f, _identity(), GRID_SMALL,
                max_iterations=12, inner_iters=4)
            return dict(rot=p.rot, trans=p.trans, hess=h, score=s, iterations=it)

        def lo_step():
            stats = gaussian_map.stats_from_points(_t(x["lo_map"]), ones(x["lo_map"]), _t(ORIGIN), 1.0, 4096)
            p, h, s, it, st = tdist.lo_train_step(mine(x["lo_scan"]), ones(mine(x["lo_scan"])), stats,
                                                  _identity(), 1.0, 4096, grid_shape=GRID_MAP,
                                                  max_iterations=4, inner_iters=2)
            return dict(rot=p.rot, trans=p.trans, score=s, iterations=it, keys=st.keys, n=st.n, sx=st.sx,
                        sxx=st.sxx, overflow=st.overflow)

        rmap_s = _regmap(x["svn"], 4, GRID_SMALL)

        def svn():
            r = tdist.svn_align_sharded(_t(x["src_svn"]), ones(x["src_svn"]), rmap_s,
                                        Pose3(_t(x["prior_rot"]), _t(x["prior_trans"])), _t(noise),
                                        SvnConfig(**SVN_CFG), GRID_SMALL)
            return dict(rot=r.pose.rot, trans=r.pose.trans, cov=r.covariance, iterations=r.iterations,
                        converged=r.converged, particles=r.particles.trans, score=r.score)

        rmap_b = _regmap(x["batch"], 4, GRID_SMALL)

        def batch():
            src = mine(x["batch_src"])
            r = tdist.batch_align_sharded(src, torch.ones(src.shape[:2], dtype=torch.bool), rmap_b,
                                          _identity(src.shape[0]), NewtonConfig(**BATCH_CFG), GRID_SMALL,
                                          inner_iters=2)
            return dict(rot=r.pose.rot, trans=r.pose.trans, iterations=r.iterations)

        for name, fn in (("build", build), ("newton_sorted", newton_sorted), ("newton_reg", newton_reg),
                         ("newton_fused", newton_fused),
                         ("lo_step", lo_step), ("svn", svn), ("batch", batch)):
            _run(name, out, fn)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _spawn(world, tmp):
    """The ranks' results, one dict per rank; fails past the deadline."""
    import jax
    import jax.numpy as jnp

    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (SVN_CFG["num_particles"], 6), jnp.float32))
    ctx = mp.start_processes(_rank_worker, args=(world, str(tmp / "store"), str(tmp), noise), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_DEADLINE_S
    while not ctx.join(timeout=5.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} gloo ranks did not finish within {SPAWN_DEADLINE_S} s")
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module", params=[2, 4], ids=["D2", "D4"])
def ranks(request, tmp_path_factory):
    world = request.param
    return world, _spawn(world, tmp_path_factory.mktemp(f"gloo{world}"))


def _same_on_every_rank(outs, name):
    keys = [k for k in outs[0] if k.startswith(name + ".")]
    for o in outs[1:]:
        for k in keys:
            np.testing.assert_array_equal(o[k], outs[0][k], err_msg=k)
    return {k[len(name) + 1:]: outs[0][k] for k in keys}


def _mesh(world):
    import jax

    from slamtpu.dist import make_mesh

    return make_mesh(jax.devices()[:world])


def _jpose(xi):
    import jax.numpy as jnp

    from slamtpu.core import se3 as jse3

    return jse3.expmap(jnp.asarray(xi, jnp.float32))


def _jregmap(points, min_points, grid):
    import jax.numpy as jnp

    from slamtpu.mapping import gaussian_map as jgm
    from slamtpu.ndt import build_regmap as jbuild

    gmap = jgm.build_map(jnp.asarray(points), jnp.ones(len(points), bool), jnp.asarray(ORIGIN),
                         np.float32(1.0), capacity=4096, min_points_per_voxel=min_points)
    return jbuild(gmap, grid_shape=grid)


def _assert_pose(rot, trans, ref_rot, ref_trans, atol_m, atol_rad):
    np.testing.assert_allclose(np.asarray(trans, np.float64), np.asarray(ref_trans, np.float64), atol=atol_m)
    dR = np.asarray(ref_rot, np.float64).swapaxes(-1, -2) @ np.asarray(rot, np.float64)
    W = 0.5 * (dR - dR.swapaxes(-1, -2))
    angle = np.linalg.norm(np.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1), axis=-1)
    assert np.max(angle) < atol_rad, angle


def _collectives(r, all_reduce=0, all_gather=0, reduce_scatter=0):
    assert (int(r["collectives.all_reduce"]), int(r["collectives.all_gather"]),
            int(r["collectives.reduce_scatter"])) == (all_reduce, all_gather, reduce_scatter)


def test_build_map_sharded(ranks):
    import jax
    import jax.numpy as jnp

    from slamtpu.dist import build_map_sharded as jbuild

    world, outs = ranks
    r = _same_on_every_rank(outs, "build")
    _collectives(r, all_gather=5)
    x = inputs()
    mesh = _mesh(world)
    j = jax.jit(lambda p, m, o: jbuild(mesh, p, m, o, 1.0, 4096))(
        jnp.asarray(x["world"]), jnp.ones(4096, bool), jnp.asarray(ORIGIN))
    one = gaussian_map.build_map(_t(x["world"]), torch.ones(4096, dtype=torch.bool), _t(ORIGIN), 1.0, 4096)
    for ref in ({k: np.asarray(getattr(j, k)) for k in ("keys", "count", "valid", "mean", "icov")},
                interop.to_numpy(one)):
        np.testing.assert_array_equal(r["keys"], ref["keys"])
        np.testing.assert_array_equal(r["count"], ref["count"])
        np.testing.assert_array_equal(r["valid"], ref["valid"])
        np.testing.assert_allclose(r["mean"], ref["mean"], atol=1e-5)
        np.testing.assert_allclose(r["icov"], ref["icov"], rtol=1e-3, atol=1e-3 * np.abs(ref["icov"]).max())
    assert int(r["valid"].sum()) > 20


def test_newton_align_sharded(ranks):
    """The sorted-key objective summed over the ranks: one all_reduce an
    evaluation, against the reference's ``newton_align_sharded`` (its
    XLA objective, at D = 2 and 4) and the port's one-device
    ``newton_align``."""
    import jax
    import jax.numpy as jnp

    from slamtpu.core import se3 as jse3
    from slamtpu.dist import newton_align_sharded as jnewton
    from slamtpu.mapping import gaussian_map as jgm
    from slamtpu_torch.ndt.newton import newton_align

    world, outs = ranks
    r = _same_on_every_rank(outs, "newton_sorted")
    it = int(r["iterations"])
    _collectives(r, all_reduce=it + 1)  # one per evaluation, and the one at the returned pose
    assert int(r["host_reads"]) == it
    x = inputs()
    mesh = _mesh(world)
    jmap = jgm.build_map(jnp.asarray(x["world"]), jnp.ones(4096, bool), jnp.asarray(ORIGIN), np.float32(1.0),
                         capacity=4096, min_points_per_voxel=6)
    jp, _jh, js, jit = jax.jit(lambda p, m, g, i: jnewton(mesh, p, m, g, i, max_iterations=20))(
        jnp.asarray(x["src_map"]), jnp.ones(4096, bool), jmap, jse3.identity(dtype=jnp.float32))
    assert it == int(jit)
    _assert_pose(r["rot"], r["trans"], jp.rot, jp.trans, 1e-4, 1e-4)
    np.testing.assert_allclose(float(r["score"]), float(js), rtol=1e-4)
    gmap = gaussian_map.build_map(_t(x["world"]), torch.ones(4096, dtype=torch.bool), _t(ORIGIN), 1.0,
                                  capacity=4096, min_points_per_voxel=6)
    one = newton_align(_t(x["src_map"]), torch.ones(4096, dtype=torch.bool), gmap, _identity(),
                       NewtonConfig(max_iterations=20))
    assert it == int(one.iterations)
    _assert_pose(r["rot"], r["trans"], one.pose.rot, one.pose.trans, 1e-5, 1e-5)
    gt = _jpose(GT_MAP)
    _assert_pose(r["rot"], r["trans"], gt.rot, gt.trans, 0.05, 0.035)


def test_newton_align_sharded_reg(ranks):
    import jax
    import jax.numpy as jnp

    from slamtpu.core import se3 as jse3
    from slamtpu.dist import newton_align_sharded_reg as jnewton

    world, outs = ranks
    r = _same_on_every_rank(outs, "newton_reg")
    it = int(r["iterations"])
    _collectives(r, all_reduce=it + 1)  # one per evaluation, and the one at the returned pose
    assert int(r["host_reads"]) == it
    x = inputs()
    mesh = _mesh(world)
    jp, _jh, js, jit = jax.jit(lambda p, m, rm, g: jnewton(mesh, p, m, rm, g, GRID_MAP, max_iterations=20))(
        jnp.asarray(x["src_map"]), jnp.ones(4096, bool), _jregmap(x["world"], 6, GRID_MAP),
        jse3.identity(dtype=jnp.float32))
    assert it == int(jit)
    _assert_pose(r["rot"], r["trans"], jp.rot, jp.trans, 1e-4, 1e-4)
    np.testing.assert_allclose(float(r["score"]), float(js), rtol=1e-4)
    # the one-device Newton with the same settings
    rmap = _regmap(x["world"], 6, GRID_MAP)
    one = fused_math.newton_align_fused(_t(x["src_map"]), torch.ones(4096, dtype=torch.bool), rmap, _identity(),
                                        NewtonConfig(max_iterations=20), GRID_MAP, final_eval=True)
    assert it == int(one.iterations)
    _assert_pose(r["rot"], r["trans"], one.pose.rot, one.pose.trans, 1e-5, 1e-5)
    gt = _jpose(GT_MAP)
    _assert_pose(r["rot"], r["trans"], gt.rot, gt.trans, 0.05, 0.035)


def test_newton_align_sharded_fused(ranks):
    world, outs = ranks
    r = _same_on_every_rank(outs, "newton_fused")
    reads = int(r["host_reads"])  # one a lookup; each lookup takes 4 steps, one all_reduce each
    _collectives(r, all_reduce=4 * reads + 1)
    x = inputs()
    one = fused_math.newton_align_fused(
        _t(x["src_fused"]), torch.ones(2048, dtype=torch.bool), _regmap(x["fused"], 4, GRID_SMALL), _identity(),
        NewtonConfig(max_iterations=12, gather_stale_frac=0.25), GRID_SMALL, inner_iters=4, final_eval=True)
    refs = [(int(one.iterations), one.pose, float(one.score))]
    if world == JAX_PALLAS_D:
        import jax
        import jax.numpy as jnp

        from slamtpu.core import se3 as jse3
        from slamtpu.dist import newton_align_sharded_fused as jnewton

        mesh = _mesh(world)
        jp, _jh, js, jit = jax.jit(lambda p, m, rm, g: jnewton(mesh, p, m, rm, g, GRID_SMALL, max_iterations=12,
                                                               inner_iters=4, block=128))(
            jnp.asarray(x["src_fused"]), jnp.ones(2048, bool), _jregmap(x["fused"], 4, GRID_SMALL),
            jse3.identity(dtype=jnp.float32))
        refs.append((int(jit), jp, float(js)))
    for it, pose, score in refs:
        assert int(r["iterations"]) == it
        _assert_pose(r["rot"], r["trans"], pose.rot, pose.trans, 1e-4, 1e-4)
        np.testing.assert_allclose(float(r["score"]), score, rtol=1e-4)
    gt = _jpose(GT_FUSED)
    _assert_pose(r["rot"], r["trans"], gt.rot, gt.trans, 0.03, 0.02)


def test_lo_train_step(ranks):
    world, outs = ranks
    r = _same_on_every_rank(outs, "lo_step")
    _collectives(r, all_reduce=2 * int(r["host_reads"]) + 1, all_gather=5)
    x = inputs()
    mask = torch.ones(2048, dtype=torch.bool)
    stats = gaussian_map.stats_from_points(_t(x["lo_map"]), mask, _t(ORIGIN), 1.0, 4096)
    # on one device: the registration, then the scan's statistics at the
    # returned pose merged in one piece (the ranks merge theirs in turn)
    one = fused_math.newton_align_fused(
        _t(x["lo_scan"]), mask, build_regmap(gaussian_map.finalize(stats, 6), grid_shape=GRID_MAP), _identity(),
        NewtonConfig(max_iterations=4, gather_stale_frac=0.25), GRID_MAP, inner_iters=2, final_eval=True)
    assert int(r["iterations"]) == int(one.iterations)
    _assert_pose(r["rot"], r["trans"], one.pose.rot, one.pose.trans, 1e-4, 1e-4)
    scan = gaussian_map.stats_from_points(se3.transform_points(Pose3(_t(r["rot"]), _t(r["trans"])), _t(x["lo_scan"])),
                                          mask, _t(ORIGIN), 1.0, 4096)
    merged = interop.to_numpy(gaussian_map.merge_stats(stats, scan, 4096))
    for k in ("keys", "n", "overflow"):
        np.testing.assert_array_equal(r[k], merged[k])
    np.testing.assert_allclose(r["sx"], merged["sx"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(r["sxx"], merged["sxx"], rtol=1e-5, atol=1e-5)
    assert int(r["n"].sum()) == 4096
    if world == JAX_PALLAS_D:
        import jax
        import jax.numpy as jnp

        from slamtpu.core import se3 as jse3
        from slamtpu.dist import lo_train_step as jstep
        from slamtpu.mapping import gaussian_map as jgm

        jstats = jgm.stats_from_points(jnp.asarray(x["lo_map"]), jnp.ones(2048, bool), jnp.asarray(ORIGIN),
                                       jnp.asarray(1.0, jnp.float32), 4096)
        mesh = _mesh(world)
        jp, _h, _s, jit, jst = jax.jit(lambda p, m, st, g: jstep(
            mesh, p, m, st, g, resolution=1.0, capacity=4096, grid_shape=GRID_MAP, max_iterations=4,
            inner_iters=2, block=128))(jnp.asarray(x["lo_scan"]), jnp.ones(2048, bool), jstats,
                                       jse3.identity(dtype=jnp.float32))
        assert int(r["iterations"]) == int(jit)
        _assert_pose(r["rot"], r["trans"], jp.rot, jp.trans, 1e-4, 1e-4)
        # the poses differ by float rounding, so a point on a voxel face may
        # land on its other side: keys and the total exact, counts equal but
        # in a few voxels
        np.testing.assert_array_equal(r["keys"], np.asarray(jst.keys))
        assert int(np.asarray(jst.n).sum()) == 4096 and int(r["overflow"]) == int(jst.overflow)
        assert (r["n"] != np.asarray(jst.n)).sum() <= 4 and np.abs(r["n"] - np.asarray(jst.n)).max() <= 1


def test_svn_align_sharded(ranks):
    import jax
    import jax.numpy as jnp

    world, outs = ranks
    r = _same_on_every_rank(outs, "svn")
    T = SVN_CFG["max_iterations"]
    # a trip: one all_gather, one reduce_scatter, one all_reduce; the
    # posterior two all_reduces, the returned particles one all_gather
    _collectives(r, all_reduce=T + 2, all_gather=T + 1, reduce_scatter=T)
    assert int(r["host_reads"]) == 0
    x = inputs()
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (SVN_CFG["num_particles"], 6), jnp.float32))
    one = svn_align_reg(_t(x["src_svn"]), torch.ones(2048, dtype=torch.bool), _regmap(x["svn"], 4, GRID_SMALL),
                        interop.pose_from_numpy(x["prior_rot"], x["prior_trans"]), SvnConfig(**SVN_CFG),
                        GRID_SMALL, init_noise=_t(noise))
    refs = [dict(rot=one.pose.rot.numpy(), trans=one.pose.trans.numpy(), cov=one.covariance.numpy(),
                 iterations=int(one.iterations), particles=one.particles.trans.numpy(), score=float(one.score))]
    if world == JAX_PALLAS_D:
        from slamtpu.core import se3 as jse3
        from slamtpu.dist import svn_align_sharded as jsvn
        from slamtpu.ndt import SvnConfig as JSvnConfig

        jprior = jse3.Pose3(jnp.asarray(x["prior_rot"]), jnp.asarray(x["prior_trans"]))
        mesh, jcfg = _mesh(world), JSvnConfig(**SVN_CFG, shared_gather=True)
        j = jax.jit(lambda p, m, rm, pr, k: jsvn(mesh, p, m, rm, pr, k, jcfg, GRID_SMALL))(
            jnp.asarray(x["src_svn"]), jnp.ones(2048, bool), _jregmap(x["svn"], 4, GRID_SMALL), jprior,
            jax.random.PRNGKey(3))
        refs.append(dict(rot=np.asarray(j.pose.rot), trans=np.asarray(j.pose.trans), cov=np.asarray(j.covariance),
                         iterations=int(j.iterations), particles=np.asarray(j.particles.trans),
                         score=float(j.score)))
    for ref in refs:
        assert int(r["iterations"]) == ref["iterations"]
        _assert_pose(r["rot"], r["trans"], ref["rot"], ref["trans"], 1e-4, 1e-4)
        np.testing.assert_allclose(r["cov"], ref["cov"], rtol=2e-2, atol=1e-7)
        np.testing.assert_allclose(r["particles"], ref["particles"], atol=5e-4)
        np.testing.assert_allclose(float(r["score"]), ref["score"], rtol=1e-3)


def test_batch_align_sharded(ranks):
    world, outs = ranks
    parts = []
    for o in outs:
        b = {k[len("batch."):]: v for k, v in o.items() if k.startswith("batch.")}
        _collectives(b)
        parts.append(b)
    got = {k: np.concatenate([p[k] for p in parts]) for k in ("rot", "trans", "iterations")}
    x = inputs()
    # the ranks' scans are the one-device batch's, bit for bit
    one = fused_math.newton_align_fused_batch(_t(x["batch_src"]), torch.ones((BATCH, 256), dtype=torch.bool),
                                              _regmap(x["batch"], 4, GRID_SMALL), _identity(BATCH),
                                              NewtonConfig(**BATCH_CFG), GRID_SMALL, inner_iters=2)
    np.testing.assert_array_equal(got["rot"], one.pose.rot.numpy())
    np.testing.assert_array_equal(got["trans"], one.pose.trans.numpy())
    np.testing.assert_array_equal(got["iterations"], one.iterations.numpy())
    if world == JAX_PALLAS_D:
        import jax
        import jax.numpy as jnp

        from slamtpu.core import se3 as jse3
        from slamtpu.dist import batch_align_sharded as jbatch
        from slamtpu.ndt import NewtonConfig as JNewtonConfig

        init = jax.tree.map(lambda a: jnp.broadcast_to(a, (BATCH,) + a.shape), jse3.identity(dtype=jnp.float32))
        mesh, jcfg = _mesh(world), JNewtonConfig(**BATCH_CFG)
        j = jax.jit(lambda p, m, rm, i: jbatch(mesh, p, m, rm, i, jcfg, GRID_SMALL, inner_iters=2, block=128))(
            jnp.asarray(x["batch_src"]), jnp.ones((BATCH, 256), bool), _jregmap(x["batch"], 4, GRID_SMALL), init)
        np.testing.assert_array_equal(got["iterations"], np.asarray(j.iterations))
        _assert_pose(got["rot"], got["trans"], j.pose.rot, j.pose.trans, 1e-5, 1e-5)


def test_newton_align_fused_batch_equals_its_scans():
    """Each scan of the batch equals its own newton_align_fused, bit for bit,
    with one host read per outer iteration for the whole batch."""
    x = inputs()
    rmap = _regmap(x["batch"], 4, GRID_SMALL)
    cfg = NewtonConfig(**BATCH_CFG)
    src = _t(x["batch_src"])
    mask = torch.ones((BATCH, 256), dtype=torch.bool)
    for final_eval in (False, True):
        reads = fused_math.HOST_READS["newton"]
        res = fused_math.newton_align_fused_batch(src, mask, rmap, _identity(BATCH), cfg, GRID_SMALL,
                                                  inner_iters=2, final_eval=final_eval)
        batch_reads = fused_math.HOST_READS["newton"] - reads
        outer = []
        for b in range(BATCH):
            reads = fused_math.HOST_READS["newton"]
            one = fused_math.newton_align_fused(src[b], mask[b], rmap, _identity(), cfg, GRID_SMALL,
                                                inner_iters=2, final_eval=final_eval)
            outer.append(fused_math.HOST_READS["newton"] - reads)
            for f in ("hessian", "score", "iterations", "converged", "n_contrib"):
                assert torch.equal(getattr(res, f)[b], getattr(one, f)), (b, f)
            assert torch.equal(res.pose.rot[b], one.pose.rot) and torch.equal(res.pose.trans[b], one.pose.trans)
        assert batch_reads == max(outer)
        assert len(set(res.iterations.tolist())) > 1  # the scans stop at different iterations


def test_importing_dist_starts_no_process_group():
    assert not dist.is_initialized()
    assert not torch.cuda.is_initialized()
