"""The CUDA pair kernels on the card, against their plain versions.

These tests need an NVIDIA card and ``nvcc`` (marker ``cuda``) and skip
without them. tests/conftest.py imports JAX, which the card's machine need
not have, so run them there from the repository root without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

chip_smoke.py checks the three kernels (NDT, VGICP, plane-to-plane) at the
main paths' shapes (N = 65,536, a whole number of blocks). These add a ragged N, K poses in one launch
against K launches, repeatability, the launch counter and the wrapper's
input checks. Tolerances are chip_smoke.py's (``compare``): float32 sums of
the same pair terms in another order.
"""
import numpy as np
import pytest
import torch

from chip_smoke import compare
from slamtpu_torch.core import se3
from slamtpu_torch.ndt import fused_math
from slamtpu_torch.ndt.constants import gauss_constants

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernels)")
    return torch.device("cuda")


def _inputs(n, k, dev, seed=0):
    """Random points, mega rows and source covariances (N points) and the
    (K, 16) parameters of K poses near identity for the three kernels."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-20.0, 20.0, (n, 3))
    mega = np.zeros((n, 96))
    for s in range(7):
        a = rng.normal(scale=0.3, size=(n, 3, 3))
        mega[:, 12 * s:12 * s + 3] = pts + rng.normal(scale=0.5, size=(n, 3))
        # SPD: the icov of the NDT mode, the target covariance of the plane-to-plane mode
        mega[:, 12 * s + 3:12 * s + 12] = (a @ a.transpose(0, 2, 1) + 0.01 * np.eye(3)).reshape(n, 9)
        mega[:, 84 + s] = rng.random(n) < 0.7
    mega[rng.random(n) < 0.1] = 0.0  # sentinel rows: no valid slot
    c = rng.normal(scale=0.1, size=(n, 3, 3))
    scov = (c @ c.transpose(0, 2, 1) + 1e-3 * np.eye(3)).reshape(n, 9)
    xi = rng.normal(scale=[0.01, 0.01, 0.02, 0.05, 0.05, 0.05], size=(k, 6))

    def t(a):
        return torch.tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)

    poses = se3.expmap(t(xi))
    d1, d2, _ = gauss_constants(1.0, 0.55)
    return (t(pts.T), t(mega.T), t(scov.T), fused_math.pose_params(poses, d1, d2),
            fused_math.pose_params(poses, 0.0, 25.0),
            fused_math.pose_params(poses, 0.0, 2.0, 9.0, gicp=True))  # the VGICP distance gate bites


def _both(ptsT, megaT, scovT, p_ndt, p_aniso, p_gicp):
    """(kernel, plain) sums of the three kernels."""
    return [
        (fused_math.ndt_pair(p_ndt, ptsT, megaT), fused_math._ndt_pair_plain(p_ndt, ptsT, megaT)),
        (fused_math.aniso_pair(p_aniso, ptsT, megaT, scovT),
         fused_math._aniso_pair_plain(p_aniso, ptsT, megaT, scovT)),
        (fused_math.gicp_pair(p_gicp, ptsT, megaT), fused_math._gicp_pair_plain(p_gicp, ptsT, megaT)),
    ]


@pytest.mark.parametrize("n", [1, 255, 257, 5000])
def test_kernels_match_plain_on_ragged_n(dev, n):
    for out, ref in _both(*_inputs(n, 4, dev)):
        assert out.shape == ref.shape == (4, 44)
        assert torch.isfinite(out).all()
        compare(out, ref)


def test_batched_launch_equals_single_launches(dev):
    """Each pose's sums do not depend on the other poses of the launch."""
    ptsT, megaT, scovT, *params = _inputs(3000, 5, dev, seed=1)
    batch = _both(ptsT, megaT, scovT, *params)
    for k in range(5):
        single = _both(ptsT, megaT, scovT, *(p[k:k + 1] for p in params))
        for (b, _), (s, _) in zip(batch, single):
            assert torch.equal(b[k:k + 1], s)


def test_kernels_repeat_and_count_launches(dev):
    ptsT, megaT, scovT, p_ndt, p_aniso, p_gicp = _inputs(20000, 20, dev, seed=2)
    before = dict(fused_math.LAUNCHES)
    a = fused_math.ndt_pair(p_ndt, ptsT, megaT)
    b = fused_math.ndt_pair(p_ndt, ptsT, megaT)
    c = fused_math.aniso_pair(p_aniso[:1], ptsT, megaT, scovT)
    d = fused_math.aniso_pair(p_aniso[:1], ptsT, megaT, scovT)
    e = fused_math.gicp_pair(p_gicp[:1], ptsT, megaT)
    f = fused_math.gicp_pair(p_gicp[:1], ptsT, megaT)
    assert torch.equal(a, b) and torch.equal(c, d) and torch.equal(e, f)  # no atomics: bit for bit
    assert fused_math.LAUNCHES["ndt_pair"] == before["ndt_pair"] + 2
    assert fused_math.LAUNCHES["aniso_pair"] == before["aniso_pair"] + 2
    assert fused_math.LAUNCHES["gicp_pair"] == before["gicp_pair"] + 2


def test_wrapper_rejects_bad_inputs_on_the_card(dev):
    ptsT, megaT, scovT, p_ndt, _, p_gicp = _inputs(300, 2, dev, seed=3)
    before = dict(fused_math.LAUNCHES)
    with pytest.raises(ValueError):  # inputs on two devices
        fused_math.ndt_pair(p_ndt.cpu(), ptsT, megaT)
    with pytest.raises(ValueError):  # not contiguous
        fused_math.ndt_pair(p_ndt, ptsT.t().contiguous().t(), megaT)
    with pytest.raises(ValueError):  # wrong dtype
        fused_math.aniso_pair(p_ndt, ptsT, megaT, scovT.double())
    with pytest.raises(ValueError):  # wrong shape
        fused_math.aniso_pair(p_ndt, ptsT, megaT[:90], scovT)
    with pytest.raises(ValueError):  # inputs on two devices
        fused_math.gicp_pair(p_gicp, ptsT.cpu(), megaT)
    with pytest.raises(ValueError):  # wrong params shape
        fused_math.gicp_pair(p_gicp[:, :15].contiguous(), ptsT, megaT)
    assert fused_math.LAUNCHES == before
