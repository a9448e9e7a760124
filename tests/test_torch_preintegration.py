"""Parity of slamtpu_torch's IMU preintegration and WGS-84 gravity with
slamtpu on the CPU.

Inputs are made with numpy from a seed and fed to both packages in
float64 (x64 is on in the tests). The windows are 64 samples at ~50 Hz
with padding at the end and zero-dt samples inside, integrated at a
nonzero bias. The reference scans all 64 samples (padding and zero-dt
steps are exact no-ops there); the port loops over the real samples only.
Tolerance: rtol 1e-10 / atol 1e-12 on every field (the same float64
formulas, some sums in another order); gravity rtol 1e-12.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamtpu.core.se3 import Pose3 as JPose3
from slamtpu.fusion import preintegration as jpre
from slamtpu.ins import gravity as jgravity
from slamtpu.ins.imu_config import ImuConfig as JImu
from slamtpu_torch import interop
from slamtpu_torch.core.se3 import Pose3
from slamtpu_torch.fusion import preintegration as pre
from slamtpu_torch.ins import gravity
from slamtpu_torch.ins.imu_config import ImuConfig as TImu

torch.set_num_threads(1)
TOL = dict(rtol=1e-10, atol=1e-12)
CAPACITY = 64
FIELDS = ("dR", "dv", "dp", "dt", "dR_dbg", "dv_dba", "dv_dbg", "dp_dba", "dp_dbg", "cov")


def imu_window(seed, n_real):
    """(accel, gyro, dts) padded to 64 samples: n_real samples at ~50 Hz,
    two of them with dt 0, the padding with large garbage values."""
    rng = np.random.default_rng(seed)
    accel = rng.normal(scale=0.5, size=(CAPACITY, 3)) + [0.0, 0.0, -9.81]
    gyro = rng.normal(scale=0.2, size=(CAPACITY, 3))
    dts = np.zeros(CAPACITY)
    dts[:n_real] = 0.02 + rng.uniform(-2e-3, 2e-3, n_real)
    dts[rng.choice(n_real, 2, replace=False)] = 0.0
    accel[n_real:], gyro[n_real:] = 1e9, 1.0
    return accel, gyro, dts


def noise_pair(seed):
    rng = np.random.default_rng(seed + 100)
    kw = dict(accel_noise_sigma=rng.uniform(1e-3, 1e-2, 3), gyro_noise_sigma=rng.uniform(1e-4, 1e-3, 3),
              accel_bias_rw_sigma=rng.uniform(1e-5, 1e-4, 3), gyro_bias_rw_sigma=rng.uniform(1e-6, 1e-5, 3))
    jnoise = jpre.ImuNoise(**{k: jnp.asarray(v) for k, v in kw.items()})
    return jnoise, interop.imu_noise_from_reference(jnoise)


def bias_pair(vec):
    return (jpre.ImuBias(jnp.asarray(vec[:3]), jnp.asarray(vec[3:])),
            pre.ImuBias(torch.as_tensor(vec[:3]), torch.as_tensor(vec[3:])))


def integrate_both(seed, n_real):
    accel, gyro, dts = imu_window(seed, n_real)
    jnoise, tnoise = noise_pair(seed)
    rng = np.random.default_rng(seed + 200)
    jbias, tbias = bias_pair(rng.normal(scale=[0.05] * 3 + [0.01] * 3))
    ref = jpre.integrate(jnp.asarray(accel), jnp.asarray(gyro), jnp.asarray(dts), jbias, jnoise)
    out = pre.integrate(torch.as_tensor(accel), torch.as_tensor(gyro), dts, tbias, tnoise)
    return ref, out


def assert_pim_close(out, ref, **tol):
    for name in FIELDS:
        a, b = getattr(out, name), np.asarray(getattr(ref, name))
        assert a.dtype == torch.float64, name
        np.testing.assert_allclose(a.numpy(), b, err_msg=name, **tol)
    np.testing.assert_array_equal(out.bias_hat.vec().numpy(), np.asarray(ref.bias_hat.vec()))


@pytest.mark.parametrize("seed,n_real", [(0, 11), (1, 6), (2, 40), (3, 64)])
def test_integrate_matches_reference(seed, n_real):
    ref, out = integrate_both(seed, n_real)
    assert_pim_close(out, ref, **TOL)
    # the covariance is symmetric and positive semi-definite
    cov = out.cov.numpy()
    np.testing.assert_allclose(cov, cov.T, atol=1e-20)
    assert np.linalg.eigvalsh(cov).min() > -1e-18


def test_integrate_of_padding_only_is_the_identity():
    accel, gyro, dts = imu_window(4, 8)
    jnoise, tnoise = noise_pair(4)
    jbias, tbias = bias_pair(np.zeros(6))
    ref = jpre.integrate(jnp.asarray(accel), jnp.asarray(gyro), jnp.zeros(CAPACITY), jbias, jnoise)
    out = pre.integrate(torch.as_tensor(accel), torch.as_tensor(gyro), np.zeros(CAPACITY), tbias, tnoise)
    assert_pim_close(out, ref, rtol=0.0, atol=0.0)


def _nav_pair(rng):
    xi = rng.normal(scale=[0.3] * 3 + [5.0] * 3)
    jp = jpre.NavState(JPose3(*_pose(xi)), jnp.asarray(rng.normal(scale=3.0, size=3)))
    tp = pre.NavState(Pose3(*(torch.as_tensor(np.array(a)) for a in jp.pose)),
                      torch.as_tensor(np.array(jp.vel)))
    return jp, tp


def _pose(xi):
    from slamtpu.core import se3 as jse3

    p = jse3.expmap(jnp.asarray(xi))
    return p.rot, p.trans


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_predict_and_residual_match_reference(seed):
    """At a bias away from the linearization point (the first-order
    correction), from random states."""
    ref, out = integrate_both(seed, 12)
    rng = np.random.default_rng(seed + 300)
    jbias, tbias = bias_pair(np.concatenate([np.asarray(ref.bias_hat.vec())])
                             + rng.normal(scale=[2e-3] * 3 + [5e-4] * 3))
    g = np.array([0.0, 0.0, 9.80665])
    jgrav, tgrav = jnp.asarray(g), torch.as_tensor(g)
    ji, ti = _nav_pair(rng)
    jpred = jpre.predict(ji, jbias, ref, jgrav)
    tpred = pre.predict(ti, tbias, out, tgrav)
    np.testing.assert_allclose(tpred.pose.rot.numpy(), np.asarray(jpred.pose.rot), **TOL)
    np.testing.assert_allclose(tpred.pose.trans.numpy(), np.asarray(jpred.pose.trans), **TOL)
    np.testing.assert_allclose(tpred.vel.numpy(), np.asarray(jpred.vel), **TOL)
    for jd, td in zip(jpre.bias_corrected_deltas(ref, jbias), pre.bias_corrected_deltas(out, tbias)):
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    # the residual at the prediction is zero; at another state it matches
    np.testing.assert_allclose(pre.residual(ti, tbias, tpred, out, tgrav).numpy(), 0.0, atol=1e-9)
    jj, tj = _nav_pair(rng)
    np.testing.assert_allclose(pre.residual(ti, tbias, tj, out, tgrav).numpy(),
                               np.asarray(jpre.residual(ji, jbias, jj, ref, jgrav)), **TOL)


def test_imu_noise_from_config():
    cfg = dict(velocity_random_walk=np.array([1e-3, 2e-3, 3e-3]),
               bias_random_walk_gyro=np.array([4e-6, 5e-6, 6e-6]))
    ref = jpre.ImuNoise.from_imu_config(JImu(**cfg))
    out = pre.ImuNoise.from_imu_config(TImu(**cfg))
    for name in pre.ImuNoise._fields:
        np.testing.assert_array_equal(np.asarray(getattr(out, name)), np.asarray(getattr(ref, name)))


def test_gravity_wgs84():
    lla = np.array([[0.0, 0.0, 0.0], [np.deg2rad(52.52), np.deg2rad(13.40), 34.0],
                    [np.deg2rad(-33.9), np.deg2rad(151.2), 58.0], [np.deg2rad(89.9), 0.3, 2500.0],
                    [np.deg2rad(-45.0), np.deg2rad(-120.0), -30.0]])
    ref = [float(jgravity.gravity_wgs84(*[jnp.asarray(v) for v in p])) for p in lla]
    out = [float(gravity.gravity_wgs84(*p)) for p in lla]
    np.testing.assert_allclose(out, ref, rtol=1e-12)
    # batched
    np.testing.assert_allclose(gravity.gravity_wgs84(*lla.T), ref, rtol=1e-12)
    assert 9.77 < min(out) < max(out) < 9.84
