"""The CUDA pair kernels on the card, against their plain versions.

These tests need an NVIDIA card and ``nvcc`` (marker ``cuda``) and skip
without them. tests/conftest.py imports JAX, which the card's machine need
not have, so run them there from the repository root without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

chip_smoke.py checks the three kernels (NDT, VGICP, plane-to-plane) and
the gated NDT and VGICP kernels (the KDTREE search mode) at the main
paths' shapes (N = 65,536). These add, for each of the three, ragged
N (below one 32-point tile, not a multiple of it, more tiles than
persistent blocks), K poses in one launch against K launches, rows
gathered in the kernel against the same rows pre-gathered, points sharing
rows, sentinel and out-of-range rows, repeatability, the launch counter
and the wrappers' input checks. Tolerances are
chip_smoke.py's (``compare``): float32 sums of the same pair terms in
another order.

Then ligo_tc's float64 preintegration and 15-dof window smoother (both
solvers) on the card against the same calls on the CPU: within 1e-10 (the
same float64 formulas; the factorizations and matrix products of another
library), the marginal covariance within 1e-8 of the largest entry of
H^-1.

The gated kernels (B1, B2 with the KDTREE radius gate) are held against
their plain versions with a radius that cuts slots, ragged N, the
sentinel row, K = 20 poses around the gather pose (the gate is the gather
pose's, not each pose's own), and an infinite radius, which must give the
ungated kernel's sums bit for bit.

The last tests hold what checkpoints and the odom engines need on the
card: the map build's segment sums repeat bit for bit (a resumed run
equals a continuous one), a generator state saved on the card restores
there, and the plane-to-plane engine (B3 on a ``gicp_map_aniso`` table
through ``gicp_align_aniso``) and the multi-resolution engine (B1 at two
levels) register as on the CPU (pose within 1e-4 m / 1e-4 rad).
"""
import numpy as np
import pytest
import torch

from chip_smoke import compare
from slamtpu_torch.core import se3
from slamtpu_torch.fusion import graph, preintegration, smoother
from slamtpu_torch.mapping import gaussian_map
from slamtpu_torch.ndt import fused_math, gicp, multires
from slamtpu_torch.ndt.constants import gauss_constants
from slamtpu_torch.ndt.newton import NewtonConfig
from slamtpu_torch.ndt.regmap import build_regmap
from slamtpu_torch.runtime import checkpoint

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernels)")
    return torch.device("cuda")


def _inputs(n, k, dev, seed=0):
    """Random points, a row table (its last row the all-zero sentinel) with
    each point's row index, the same rows pre-gathered (96, N), source
    covariances, and the (K, 16) parameters of K poses near identity for
    the three kernels. The table's matrices are SPD: the icov of the NDT
    and VGICP costs, the target covariance of the plane-to-plane cost."""
    rng = np.random.default_rng(seed)
    R = max(n // 2, 1) + 1
    # point pairs (2r, 2r + 1) share table row perm[r], whose means sit near them
    centers = rng.uniform(-20.0, 20.0, (R - 1, 3))
    pair = np.minimum(np.arange(n) // 2, R - 2)
    pts = centers[pair] + rng.normal(scale=0.3, size=(n, 3))
    perm = rng.permutation(R - 1)
    rows = perm[pair]
    rows[rng.random(n) < 0.1] = R - 1  # sentinel: no valid slot
    table = np.zeros((R, 96))
    for s in range(7):
        a = rng.normal(scale=0.3, size=(R - 1, 3, 3))
        table[perm, 12 * s:12 * s + 3] = centers + rng.normal(scale=0.5, size=(R - 1, 3))
        # SPD: the icov of the NDT mode, the target covariance of the plane-to-plane mode
        table[:-1, 12 * s + 3:12 * s + 12] = (a @ a.transpose(0, 2, 1) + 0.01 * np.eye(3)).reshape(R - 1, 9)
        table[:-1, 84 + s] = rng.random(R - 1) < 0.7
    c = rng.normal(scale=0.1, size=(n, 3, 3))
    scov = (c @ c.transpose(0, 2, 1) + 1e-3 * np.eye(3)).reshape(n, 9)
    xi = rng.normal(scale=[0.01, 0.01, 0.02, 0.05, 0.05, 0.05], size=(k, 6))

    def t(a, dtype=torch.float32):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    poses = se3.expmap(t(xi))
    d1, d2, _ = gauss_constants(1.0, 0.55)
    tab, idx = t(table), t(rows, torch.int32)
    megaT = tab[idx.long()].t().contiguous()
    return (t(pts.T), tab, idx, megaT, t(scov.T), fused_math.pose_params(poses, d1, d2),
            fused_math.pose_params(poses, 0.0, 25.0),
            fused_math.pose_params(poses, 0.0, 2.0, 9.0, gicp=True))  # the VGICP distance gate bites


def _kernels(scovT, p_ndt, p_aniso, p_gicp):
    """(name, kernel, plain, params) of the three kernels, each called as
    fn(params, ptsT, table, rows)."""
    def aniso(fn):
        return lambda p, ptsT, table, rows: fn(p, ptsT, table, rows, scovT)

    return [
        ("ndt_pair", fused_math.ndt_pair, fused_math._ndt_pair_plain, p_ndt),
        ("aniso_pair", aniso(fused_math.aniso_pair), aniso(fused_math._aniso_pair_plain), p_aniso),
        ("gicp_pair", fused_math.gicp_pair, fused_math._gicp_pair_plain, p_gicp),
    ]


def _both(ptsT, table, rows, megaT, scovT, p_ndt, p_aniso, p_gicp):
    """(kernel, plain) sums of the three kernels."""
    return [(fn(p, ptsT, table, rows), plain(p, ptsT, table, rows))
            for _, fn, plain, p in _kernels(scovT, p_ndt, p_aniso, p_gicp)]


@pytest.mark.parametrize("n", [1, 31, 32, 100, 255, 257, 5000])
def test_kernels_match_plain_on_ragged_n(dev, n):
    for out, ref in _both(*_inputs(n, 4, dev)):
        assert out.shape == ref.shape == (4, 44)
        assert torch.isfinite(out).all()
        compare(out, ref)


def test_more_tiles_than_persistent_blocks(dev):
    """~3,100 tiles over the persistent blocks: each block walks several
    tiles through its ring (and the last tile is ragged)."""
    ptsT, table, rows, megaT, scovT, p_ndt, p_aniso, p_gicp = _inputs(100_003, 3, dev, seed=4)
    grid = fused_math._load().ndt_pair_grid(100_003, torch.cuda.current_device())
    assert 0 < grid < -(-100_003 // 32) // 4
    for out, ref in _both(ptsT, table, rows, megaT, scovT, p_ndt, p_aniso, p_gicp):
        compare(out, ref)


def test_batched_launch_equals_single_launches(dev):
    """Each pose's sums do not depend on K or on the other poses of the
    launch: K = 1..20 poses in one launch equal the single launches, bit
    for bit."""
    ptsT, table, rows, megaT, scovT, *params = _inputs(3000, 20, dev, seed=1)
    for name, fn, _, p in _kernels(scovT, *params):
        singles = [fn(p[k:k + 1], ptsT, table, rows) for k in range(20)]
        for K in range(1, 21):
            batch = fn(p[:K].contiguous(), ptsT, table, rows)
            for k in range(K):
                assert torch.equal(batch[k:k + 1], singles[k]), (name, K, k)


def test_gathered_in_kernel_equals_pregathered(dev):
    """The kernel on (table, rows) equals the same kernel on the rows
    pre-gathered as a table of their own with the identity index."""
    ptsT, table, rows, megaT, scovT, *params = _inputs(20000, 20, dev, seed=5)
    pre, ident = fused_math.pregathered_table(megaT)
    for name, fn, _, p in _kernels(scovT, *params):
        for K in (1, 20):
            assert torch.equal(fn(p[:K].contiguous(), ptsT, table, rows),
                               fn(p[:K].contiguous(), ptsT, pre, ident)), (name, K)


def test_points_sharing_rows(dev):
    """Points of a tile that share a row share its copy: rows drawn from a
    handful of table rows give the plain version's sums."""
    ptsT, table, rows, _, scovT, *params = _inputs(5000, 3, dev, seed=8)
    few = rows[torch.randint(0, 4, rows.shape, generator=torch.Generator().manual_seed(0)).to(dev) * 97]
    for _, fn, plain, p in _kernels(scovT, *params):
        compare(fn(p, ptsT, table, few), plain(p, ptsT, table, few))


def test_sentinel_and_out_of_range_rows(dev):
    """All-sentinel rows count nothing and give finite (zero) sums; an index
    outside the table reads the sentinel row."""
    ptsT, table, rows, _, scovT, *params = _inputs(5000, 3, dev, seed=6)
    R = table.shape[0]
    sentinel = torch.full_like(rows, R - 1)
    bad, fixed = rows.clone(), rows.clone()
    bad[::7], bad[3::7] = R + 11, -5
    fixed[::7], fixed[3::7] = R - 1, R - 1
    for name, fn, _, p in _kernels(scovT, *params):
        out = fn(p, ptsT, table, sentinel)
        assert torch.isfinite(out).all() and (out[:, 43] == 0).all() and (out == 0).all(), name
        assert torch.equal(fn(p, ptsT, table, bad), fn(p, ptsT, table, fixed)), name


def test_kernels_repeat_and_count_launches(dev):
    ptsT, table, rows, _, scovT, *params = _inputs(20000, 20, dev, seed=2)
    for name, fn, _, p in _kernels(scovT, *params):
        before = dict(fused_math.LAUNCHES)
        a = fn(p, ptsT, table, rows)
        b = fn(p[:1].contiguous(), ptsT, table, rows)
        assert torch.equal(a, fn(p, ptsT, table, rows)), name  # no atomics: bit for bit
        assert torch.equal(b, fn(p[:1].contiguous(), ptsT, table, rows)), name
        want = dict(before, **{name: before[name] + 4})  # one launch a call, this kernel's only
        assert fused_math.LAUNCHES == want, name


def test_wrapper_rejects_bad_inputs_on_the_card(dev):
    ptsT, table, rows, _, scovT, p_ndt, p_aniso, p_gicp = _inputs(300, 2, dev, seed=3)
    before = dict(fused_math.LAUNCHES)
    with pytest.raises(ValueError):  # inputs on two devices
        fused_math.ndt_pair(p_ndt.cpu(), ptsT, table, rows)
    with pytest.raises(ValueError):  # not contiguous
        fused_math.ndt_pair(p_ndt, ptsT.t().contiguous().t(), table, rows)
    with pytest.raises(ValueError):  # wrong dtype
        fused_math.aniso_pair(p_aniso, ptsT, table, rows, scovT.double())
    with pytest.raises(ValueError):  # wrong shape
        fused_math.aniso_pair(p_aniso, ptsT, table, rows, scovT[:8].contiguous())
    with pytest.raises(ValueError):  # one covariance too few
        fused_math.aniso_pair(p_aniso, ptsT, table, rows, scovT[:, 1:].contiguous())
    with pytest.raises(ValueError):  # covariances on another device
        fused_math.aniso_pair(p_aniso, ptsT, table, rows, scovT.cpu())
    with pytest.raises(ValueError):  # not contiguous
        fused_math.aniso_pair(p_aniso, ptsT, table, rows, scovT.t().contiguous().t())
    with pytest.raises(ValueError):  # inputs on two devices
        fused_math.gicp_pair(p_gicp, ptsT.cpu(), table, rows)
    with pytest.raises(ValueError):  # wrong params shape
        fused_math.gicp_pair(p_gicp[:, :15].contiguous(), ptsT, table, rows)
    assert fused_math.LAUNCHES == before


@pytest.mark.parametrize("fn", ["ndt_pair", "gicp_pair", "aniso_pair"])
def test_wrapper_rejects_bad_table_and_rows(dev, fn):
    """Wrong dtype, shape or device of the table or the row index raises
    before any launch."""
    ptsT, table, rows, _, scovT, p_ndt, _, _ = _inputs(300, 2, dev, seed=7)
    kern = getattr(fused_math, fn)
    if fn == "aniso_pair":
        kern = lambda p, ptsT, table, rows: fused_math.aniso_pair(p, ptsT, table, rows, scovT)  # noqa: E731
    before = dict(fused_math.LAUNCHES)
    R = table.shape[0]
    misaligned = table.view(-1)[1:1 + 96 * (R - 1)].view(R - 1, 96)  # 4 bytes off
    bad = [
        (table.double(), rows), (table[:, :92].contiguous(), rows), (table.t().contiguous().t(), rows),
        (table.cpu(), rows), (misaligned, rows),
        (table, rows.long()), (table, rows[:-1]), (table, rows.cpu()), (table, rows[None]),
        (table, rows.float()),
    ]
    for tab, idx in bad:
        with pytest.raises(ValueError):
            kern(p_ndt, ptsT, tab, idx)
    assert fused_math.LAUNCHES == before


def _gate(dev, r, seed=0):
    """The gate block at a gather pose near the identity."""
    xi = np.random.default_rng(seed).normal(scale=[0.01, 0.01, 0.02, 0.05, 0.05, 0.05])
    return fused_math.gate_params(se3.expmap(torch.tensor(xi, dtype=torch.float32, device=dev)), r)


def _gated(p_ndt, p_gicp):
    return [("ndt_pair", fused_math.ndt_pair, fused_math._ndt_pair_plain, p_ndt),
            ("gicp_pair", fused_math.gicp_pair, fused_math._gicp_pair_plain, p_gicp)]


@pytest.mark.parametrize("n", [1, 31, 100, 257, 5000])
def test_gated_kernels_match_plain(dev, n):
    ptsT, table, rows, _, _, p_ndt, _, p_gicp = _inputs(n, 20, dev, seed=9)
    gate = _gate(dev, 1.0)
    for name, fn, plain, p in _gated(p_ndt, p_gicp):
        out, ref = fn(p, ptsT, table, rows, gate), plain(p, ptsT, table, rows, gate)
        assert torch.isfinite(out).all(), name
        compare(out, ref)
        if n >= 100:  # the radius cuts slots
            ungated = plain(p, ptsT, table, rows)
            assert float(ref[:, 43].sum()) < float(ungated[:, 43].sum()), name


def test_gate_is_the_gather_poses(dev):
    """K = 20 poses around the gather pose in one launch: each pose's sums
    are those of the gate at the gather pose, not at the pose's own."""
    ptsT, table, rows, _, _, p_ndt, _, p_gicp = _inputs(20000, 20, dev, seed=10)
    gate = _gate(dev, 1.0, seed=3)
    for name, fn, plain, p in _gated(p_ndt, p_gicp):
        out = fn(p, ptsT, table, rows, gate)
        compare(out, plain(p, ptsT, table, rows, gate))
        own = torch.cat([plain(p[k:k + 1], ptsT, table, rows,
                               fused_math.gate_params(se3.Pose3(p[k, :9].view(3, 3), p[k, 9:12]), 1.0))
                         for k in range(20)])
        assert (out[:, 43] - own[:, 43]).abs().max() > 20, name  # another set of slots


def test_gated_sentinel_rows_and_infinite_radius(dev):
    ptsT, table, rows, _, _, p_ndt, _, p_gicp = _inputs(5000, 3, dev, seed=11)
    sentinel = torch.full_like(rows, table.shape[0] - 1)
    wide = _gate(dev, 1.0)
    wide[12] = float("inf")
    for name, fn, _, p in _gated(p_ndt, p_gicp):
        assert (fn(p, ptsT, table, sentinel, _gate(dev, 1.0)) == 0).all(), name
        # a gate that cuts nothing leaves the ungated kernel's arithmetic
        assert torch.equal(fn(p, ptsT, table, rows, wide), fn(p, ptsT, table, rows)), name


def test_gated_kernels_count_launches_and_check_the_gate(dev):
    ptsT, table, rows, _, _, p_ndt, _, p_gicp = _inputs(3000, 2, dev, seed=12)
    gate = _gate(dev, 1.0)
    for name, fn, _, p in _gated(p_ndt, p_gicp):
        before = dict(fused_math.LAUNCHES)
        a = fn(p, ptsT, table, rows, gate)
        assert torch.equal(a, fn(p, ptsT, table, rows, gate))
        assert fused_math.LAUNCHES == dict(before, **{f"{name}_gated": before[f"{name}_gated"] + 2})
        for bad in (gate.cpu(), gate.double(), gate[:15].contiguous(),
                    torch.zeros(17, device=dev)[1:]):  # the last is 4 bytes off alignment
            with pytest.raises(ValueError):
                fn(p, ptsT, table, rows, bad)
        assert fused_math.LAUNCHES == dict(before, **{f"{name}_gated": before[f"{name}_gated"] + 2})


def _imu_inputs(seed, n=11):
    """A 64-sample IMU window (n real samples at ~50 Hz, one zero dt), a
    bias and the noise densities, as numpy."""
    rng = np.random.default_rng(seed)
    accel = rng.normal(scale=0.5, size=(64, 3)) + [0.0, 0.0, -9.81]
    gyro = rng.normal(scale=0.2, size=(64, 3))
    dts = np.zeros(64)
    dts[:n] = 0.02 + rng.uniform(-2e-3, 2e-3, n)
    dts[n // 2] = 0.0
    return accel, gyro, dts, rng.normal(scale=[0.05] * 3 + [0.01] * 3)


def _integrate(dev, accel, gyro, dts, bias):
    noise = preintegration.ImuNoise(*(torch.full((3,), s, dtype=torch.float64, device=dev)
                                      for s in (1e-3, 1e-4, 1e-5, 1e-6)))
    b = torch.as_tensor(bias, device=dev)
    return preintegration.integrate(torch.as_tensor(accel, device=dev), torch.as_tensor(gyro, device=dev),
                                    dts, preintegration.ImuBias(b[:3], b[3:]), noise)


def test_preintegration_on_the_card_matches_the_cpu(dev):
    for seed in range(3):
        inputs = _imu_inputs(seed)
        out, ref = _integrate(dev, *inputs), _integrate("cpu", *inputs)
        for name in ("dR", "dv", "dp", "dt", "dR_dbg", "dv_dba", "dv_dbg", "dp_dba", "dp_dbg", "cov"):
            a, b = getattr(out, name), getattr(ref, name)
            assert a.device.type == dev.type and a.dtype == torch.float64, name
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-10, atol=1e-12, err_msg=name)


def _ligo_window(dev):
    """A ligo-like W = 6 window with 4 states filled (INS pose priors,
    between factors and IMU factors on the chain, velocity priors, one bias
    prior), states perturbed from the path; built on the CPU."""
    rng = np.random.default_rng(11)
    W, n = 6, 4
    xi = np.concatenate([rng.normal(scale=0.05, size=(W, 3)), rng.normal(scale=0.2, size=(W, 3))], 1)
    pose = se3.expmap(torch.as_tensor(xi))
    rot, trans = pose.rot, pose.trans + torch.arange(W, dtype=torch.float64)[:, None] * torch.tensor([1.0, 0.1, 0.0])
    vel = torch.tensor([10.0, 1.0, 0.0], dtype=torch.float64).repeat(W, 1)
    active = torch.arange(W) < n
    b_active = torch.arange(W - 1) < n - 1
    pims = [_integrate("cpu", *_imu_inputs(10 + k, 6)) for k in range(W - 1)]
    f = graph.empty_factors(W, W - 1, W, 1, W - 1, 0)
    ks = torch.arange(W, dtype=torch.int32)
    rel = se3.between(se3.Pose3(rot[:-1], trans[:-1]), se3.Pose3(rot[1:], trans[1:]))

    def stack(key):
        return torch.stack([getattr(p, key) for p in pims])

    f = f._replace(
        prior_pose=graph.PriorPoseFactors(ks, rot, trans + 0.01, graph.sqrt_info_from_sigmas(
            torch.as_tensor(rng.uniform(0.01, 0.1, (W, 6)))), active),
        between=graph.BetweenFactors(ks[:-1], ks[1:], rel.rot, rel.trans,
                                     torch.eye(6, dtype=torch.float64).repeat(W - 1, 1, 1) * 100.0, b_active),
        prior_vel=f.prior_vel._replace(idx=ks, value=vel, sqrt_info=f.prior_vel.sqrt_info / 0.5, active=active),
        prior_bias=f.prior_bias._replace(idx=ks[:1], sqrt_info=f.prior_bias.sqrt_info / 0.05,
                                         active=torch.ones(1, dtype=torch.bool)),
        imu=graph.ImuFactors(ks[:-1], ks[1:], *(stack(k) for k in ("dR", "dv", "dp", "dt", "dR_dbg", "dv_dba",
                                                                     "dv_dbg", "dp_dba", "dp_dbg")),
                             torch.stack([p.bias_hat.vec() for p in pims]),
                             graph.sqrt_info_from_cov(stack("cov")), b_active),
    )
    xr = se3.expmap(torch.as_tensor(rng.normal(scale=[0.01] * 3 + [0.1] * 3, size=(W, 6))))
    state = graph.WindowState(rot @ xr.rot, trans + xr.trans, vel + 0.2, torch.zeros((W, 6), dtype=torch.float64),
                              active)
    def to(nt):
        return type(nt)(*(to(x) if isinstance(x, tuple) else x.to(dev) for x in nt))

    return to(state), to(f)


@pytest.mark.parametrize("solver", ["qr", "chol"])
def test_window_smoother_on_the_card_matches_the_cpu(dev, solver):
    cfg = smoother.SmootherConfig(iterations=6, solver=solver)
    ref = smoother.optimize(*_ligo_window("cpu"), cfg)
    out = smoother.optimize(*_ligo_window(dev), cfg)
    for name in ("rot", "trans", "vel", "bias"):
        np.testing.assert_allclose(getattr(out.state, name).cpu().numpy(), getattr(ref.state, name).numpy(),
                                   rtol=0, atol=1e-10, err_msg=name)
    H, H_ref = out.hessian.cpu().numpy(), ref.hessian.numpy()
    np.testing.assert_allclose(H, H_ref, rtol=1e-10, atol=1e-10 * np.abs(H_ref).max())
    np.testing.assert_allclose(float(out.error), float(ref.error), rtol=1e-10)
    # the marginal covariance inverts H (cond ~1e12 here): within 1e-8 of the
    # largest entry of H^-1, as two LU inversions of one H agree on the CPU
    inv_max = np.abs(np.linalg.inv(H_ref + 1e-12 * np.eye(H_ref.shape[0]))).max()
    for idx in range(4):
        cov = smoother.marginal_covariance(out.hessian, idx).cpu().numpy()
        cov_ref = smoother.marginal_covariance(ref.hessian, idx).numpy()
        np.testing.assert_allclose(cov, cov_ref, rtol=1e-8, atol=1e-8 * inv_max)


def test_segment_sums_repeat_bit_for_bit(dev):
    """Many points a segment, in one float32 sum each: two runs on the card
    are equal, and they agree with float64 sums on the CPU."""
    g = torch.Generator().manual_seed(3)
    vals = torch.randn((200_000, 9), generator=g)
    seg = torch.sort(torch.randint(0, 300, (200_000,), generator=g)).values  # sorted, as the callers'
    a = gaussian_map.segment_sum(vals.to(dev), seg.to(dev), 301)
    assert torch.equal(a, gaussian_map.segment_sum(vals.to(dev), seg.to(dev), 301))
    ref = torch.zeros((301, 9), dtype=torch.float64).index_add_(0, seg, vals.double())
    np.testing.assert_allclose(a.cpu().double().numpy(), ref.numpy(), rtol=0, atol=1e-3)


def test_generator_state_round_trip_on_the_card(dev, tmp_path):
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    torch.randn(7, generator=gen, device=dev)
    path = str(tmp_path / "gen.npz")
    np.savez(path, **checkpoint._generator_arrays(gen))
    want = torch.randn(20, 6, generator=gen, device=dev)
    other = torch.Generator(device=dev)
    checkpoint._restore_generator(dict(np.load(path)), other, "test")
    assert torch.equal(torch.randn(20, 6, generator=other, device=dev), want)
    with pytest.raises(ValueError):
        checkpoint._restore_generator(dict(np.load(path)), torch.Generator(), "test")


def _box_scene(device):
    """Three noisy perpendicular planes as the target, a sparser copy as the
    source, and a start pose offset from the truth (identity)."""
    rng = np.random.default_rng(21)

    def box(pitch, sigma):
        ax = np.arange(0.0, 6.0, pitch)
        g1, g2 = [a.ravel() for a in np.meshgrid(ax, ax, indexing="ij")]
        z = np.zeros_like(g1)
        pts = np.concatenate([np.stack(p, 1) for p in ((g1, g2, z), (g1, z, g2), (z, g1, g2))])
        return (pts + rng.normal(scale=sigma, size=pts.shape)).astype(np.float32)

    target, src = box(0.15, 0.02), box(0.25, 0.01)
    T = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    init = se3.expmap(torch.tensor([0.01, -0.02, 0.03, 0.15, -0.1, 0.08], device=device))
    return T(target), T(src), torch.ones(len(src), dtype=torch.bool, device=device), init


def _to(regmap, device):
    return type(regmap)(*(a if a is None or k == "resolution" else a.to(device)
                          for k, a in zip(regmap._fields, regmap)))


def _odom_engine(engine, device, grid, max_iterations, trans_eps):
    """(result, launches) of one registration of the box scene on
    ``device``. The maps and the source covariances are built on the CPU
    and moved: at the box's edges a voxel's two minor eigenvalues tie, so
    its plane normal is set by rounding, which another device's sums
    change."""
    target, src, mask, init = _box_scene("cpu")
    origin = torch.floor(target.amin(0)) - 8.0
    tmask = torch.ones(len(target), dtype=torch.bool)
    if engine == "gicp_aniso":
        gmap = gaussian_map.build_map(target, tmask, origin, 1.0, capacity=2048, min_points_per_voxel=4)
        regmap = _to(build_regmap(gicp.gicp_map_aniso(gmap), grid_shape=grid), device)
        scov = gicp.source_point_covariances(src, mask, 1.0, capacity=1024).to(device)
    else:
        levels = [lv._replace(regmap=_to(lv.regmap, device)) for lv in multires.build_pyramid(
            target, tmask, origin, [2.0, 1.0], 2048, grid, 4, [max_iterations // 3, max_iterations])]
    src, mask, init = src.to(device), mask.to(device), se3.Pose3(init.rot.to(device), init.trans.to(device))
    before = dict(fused_math.LAUNCHES)
    if engine == "gicp_aniso":
        cfg = NewtonConfig(resolution=1.0, max_iterations=max_iterations, trans_eps=trans_eps)
        res = fused_math.gicp_align_aniso(src, mask, scov, regmap, init, cfg, grid)
    else:
        res = multires.multires_align(src, mask, levels, init)
    return res, {k: v - before[k] for k, v in fused_math.LAUNCHES.items()}


@pytest.mark.parametrize("engine", ["gicp_aniso", "multires"])
def test_odom_engines_on_the_card_match_the_cpu(dev, engine):
    """The engine on the card against the same calls on the CPU, from the
    same maps. The plane-to-plane engine is held over its first three
    steps: its trimmed cost gains and loses pairs as the pose moves, so on
    this toy scene float32 sums in another order may take another path
    through its last steps; the whole run then converges on the card."""
    grid = (64, 64, 32)
    kernel = "aniso_pair" if engine == "gicp_aniso" else "ndt_pair"
    steps = (3, 0.0) if engine == "gicp_aniso" else (30, 1e-4)
    out, launches = _odom_engine(engine, dev, grid, *steps)
    ref, cpu_launches = _odom_engine(engine, "cpu", grid, *steps)
    assert cpu_launches[kernel] == 0 and launches[kernel] >= int(out.iterations) > 0
    assert abs(int(out.iterations) - int(ref.iterations)) <= 1 and bool(out.converged) == bool(ref.converged)
    np.testing.assert_allclose(out.pose.trans.cpu().numpy(), ref.pose.trans.numpy(), rtol=0, atol=1e-4)
    dR = ref.pose.rot.double().numpy().T @ out.pose.rot.cpu().double().numpy()
    assert np.linalg.norm([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]]) / 2 < 1e-4
    full, _ = _odom_engine(engine, dev, grid, 30, 1e-4)
    assert bool(full.converged) and float(torch.linalg.vector_norm(full.pose.trans)) < 0.02


def _box_regmap(device, grid):
    target, src, mask, init = _box_scene("cpu")
    gmap = gaussian_map.build_map(target, torch.ones(len(target), dtype=torch.bool), torch.floor(target.amin(0)) - 8.0,
                                  1.0, capacity=2048, min_points_per_voxel=4)
    return _to(build_regmap(gmap, grid_shape=grid), device), src.to(device), mask.to(device), \
        se3.Pose3(init.rot.to(device), init.trans.to(device))


def test_newton_batch_on_the_card_equals_its_scans(dev):
    """``newton_align_fused_batch`` on the card: each scan equals its own
    ``newton_align_fused`` bit for bit, one B1 launch a running scan a step,
    one host read an outer iteration for the batch."""
    grid = (64, 64, 32)
    regmap, src, mask, init = _box_regmap(dev, grid)
    B = 4
    xi = torch.linspace(0.3, 1.2, B, device=dev)[:, None] * torch.tensor(
        [0.01, -0.02, 0.03, 0.15, -0.1, 0.08], device=dev)
    inits = se3.retract(se3.Pose3(init.rot.expand(B, 3, 3), init.trans.expand(B, 3)), xi)
    cfg = NewtonConfig(resolution=1.0, max_iterations=20)
    before, reads = dict(fused_math.LAUNCHES), fused_math.HOST_READS["newton"]
    res = fused_math.newton_align_fused_batch(src.expand(B, -1, -1).contiguous(), mask.expand(B, -1).contiguous(),
                                              regmap, inits, cfg, grid, inner_iters=2)
    batch_launches = fused_math.LAUNCHES["ndt_pair"] - before["ndt_pair"]
    batch_reads = fused_math.HOST_READS["newton"] - reads
    single_launches, outer = 0, []
    for b in range(B):
        before, reads = fused_math.LAUNCHES["ndt_pair"], fused_math.HOST_READS["newton"]
        one = fused_math.newton_align_fused(src, mask, regmap, se3.Pose3(inits.rot[b], inits.trans[b]), cfg, grid,
                                            inner_iters=2)
        single_launches += fused_math.LAUNCHES["ndt_pair"] - before
        outer.append(fused_math.HOST_READS["newton"] - reads)
        assert torch.equal(res.pose.rot[b], one.pose.rot) and torch.equal(res.pose.trans[b], one.pose.trans)
        assert torch.equal(res.iterations[b], one.iterations) and torch.equal(res.hessian[b], one.hessian)
    assert batch_launches == single_launches > 0 and batch_reads == max(outer)


def test_per_particle_svn_on_the_card_matches_the_cpu(dev):
    """``svn_align_reg(shared_gather=False)``: K launches of B1 at K = 1 an
    iteration on the card, and the CPU's result within 1e-4 m / 1e-4 rad."""
    from slamtpu_torch.ndt.svn import SvnConfig, svn_align_reg

    grid = (64, 64, 32)
    K, T = 6, 5
    cfg = SvnConfig(resolution=1.0, num_particles=K, max_iterations=T, kernel_h=1.0, step_size=1.0,
                    shared_gather=False)
    noise = torch.as_tensor(np.random.default_rng(3).normal(size=(K, 6)), dtype=torch.float32)
    out = {}
    for d in (dev, torch.device("cpu")):
        regmap, src, mask, init = _box_regmap(d, grid)
        before = fused_math.LAUNCHES["ndt_pair"]
        out[d.type] = svn_align_reg(src, mask, regmap, init, cfg, grid, init_noise=noise.to(d))
        launches = fused_math.LAUNCHES["ndt_pair"] - before
        assert launches == (K * T + 1 if d.type == "cuda" else 0), launches
    a, b = out["cuda"], out["cpu"]
    assert int(a.iterations) == int(b.iterations)
    np.testing.assert_allclose(a.pose.trans.cpu().numpy(), b.pose.trans.numpy(), rtol=0, atol=1e-4)
    dR = b.pose.rot.double().numpy().T @ a.pose.rot.cpu().double().numpy()
    assert np.linalg.norm([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]]) / 2 < 1e-4
