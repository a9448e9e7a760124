"""IMU preintegration, GTSAM CombinedImuFactor semantics (port of
slamtpu/fusion/preintegration.py).

It replaces the reference's ``gtsam::PreintegratedCombinedMeasurements``
(run/pipeline_ligo_tc.cpp:323-324, 404, 429-463): a window of IMU samples
is integrated into the deltas (dR, dv, dp), their first-order bias
Jacobians and the 15x15 noise covariance of the IMU factor. Everything runs
in float64 on the caller's device.

The reference scans a padded 64-sample window in which a sample with
``dt <= 0`` is an exact no-op. The host knows every dt, so ``integrate``
takes them as a host array and loops over the real samples only (about 5
per sweep at 50 Hz and 10 sweeps/s): the same result with about 12x fewer
launches. Each step's Exp(w dt) and right Jacobian are computed for all
real samples at once before the loop; the covariance update is one dense
15x15 product A P A^T + Q.

Error-state ordering throughout: [dtheta(3), dv(3), dp(3), dba(3), dbg(3)].
Functions of single states broadcast over leading batch dimensions.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import so3
from ..core.se3 import Pose3


class ImuNoise(NamedTuple):
    """Continuous-time noise densities (from ``ins.ImuConfig``)."""

    accel_noise_sigma: torch.Tensor  # (3,) VRW, m/s^2/sqrt(Hz)
    gyro_noise_sigma: torch.Tensor  # (3,) ARW, rad/s/sqrt(Hz)
    accel_bias_rw_sigma: torch.Tensor  # (3,)
    gyro_bias_rw_sigma: torch.Tensor  # (3,)
    integration_sigma: float = 1e-8  # integration position noise

    @classmethod
    def from_imu_config(cls, cfg, device="cpu") -> "ImuNoise":
        def vec(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=device)

        return cls(
            accel_noise_sigma=vec(cfg.velocity_random_walk),
            gyro_noise_sigma=vec(cfg.angular_random_walk),
            accel_bias_rw_sigma=vec(cfg.bias_random_walk_accel),
            gyro_bias_rw_sigma=vec(cfg.bias_random_walk_gyro),
        )


class ImuBias(NamedTuple):
    accel: torch.Tensor  # (..., 3)
    gyro: torch.Tensor  # (..., 3)

    def vec(self) -> torch.Tensor:
        return torch.cat([self.accel, self.gyro], dim=-1)


class PreintegratedImu(NamedTuple):
    """Preintegrated measurements between two keyframes, at linearization
    bias ``bias_hat``."""

    dR: torch.Tensor  # (3, 3)
    dv: torch.Tensor  # (3,)
    dp: torch.Tensor  # (3,)
    dt: torch.Tensor  # () total integration time
    # bias Jacobians (first-order correction, Forster eq. 44)
    dR_dbg: torch.Tensor  # (3, 3)
    dv_dba: torch.Tensor  # (3, 3)
    dv_dbg: torch.Tensor  # (3, 3)
    dp_dba: torch.Tensor  # (3, 3)
    dp_dbg: torch.Tensor  # (3, 3)
    cov: torch.Tensor  # (15, 15) in [dtheta, dv, dp, dba, dbg]
    bias_hat: ImuBias


class NavState(NamedTuple):
    """Pose + velocity (gtsam::NavState)."""

    pose: Pose3
    vel: torch.Tensor  # (..., 3) world frame


def _mv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (A @ v[..., None])[..., 0]


def integrate(
    accel: torch.Tensor,  # (N, 3) measured specific force, body frame
    gyro: torch.Tensor,  # (N, 3) measured angular rate, body frame
    dts,  # (N,) host per-sample dt; entries <= 0 are padding no-ops
    bias: ImuBias,
    noise: ImuNoise,
) -> PreintegratedImu:
    """Integrate a window of IMU samples with bias correction, propagating
    the bias Jacobians and the full 15x15 covariance."""
    dtype, dev = accel.dtype, accel.device
    dts = np.asarray(dts, np.float64)
    steps = [k for k in range(dts.shape[0]) if dts[k] > 0.0]
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    z3 = torch.zeros((3, 3), dtype=dtype, device=dev)
    dR, dv, dp = eye3, torch.zeros(3, dtype=dtype, device=dev), torch.zeros(3, dtype=dtype, device=dev)
    dR_dbg = dv_dba = dv_dbg = dp_dba = dp_dbg = z3
    cov = torch.zeros((15, 15), dtype=dtype, device=dev)
    if steps:
        a_all = accel - bias.accel.to(dtype)
        w_all = gyro - bias.gyro.to(dtype)
        # every step's rotation increment and right Jacobian at once
        wdt = torch.stack([w_all[k] * dts[k] for k in steps])
        dRk_all = so3.exp(wdt)
        Jr_all = so3.left_jacobian(-wdt)  # right Jacobian of Exp at (w dt)
        a_hat_all = so3.hat(a_all)
        g2, a2 = noise.gyro_noise_sigma.to(dtype) ** 2, noise.accel_noise_sigma.to(dtype) ** 2
        ba2, bg2 = noise.accel_bias_rw_sigma.to(dtype) ** 2, noise.gyro_bias_rw_sigma.to(dtype) ** 2
    for s, k in enumerate(steps):
        dt = float(dts[k])
        dt2 = dt * dt
        a, dRk, Jr = a_all[k], dRk_all[s], Jr_all[s]
        dRa = dR @ a_hat_all[k]  # dR * hat(a)
        Ra = dR @ a

        # bias Jacobians (Forster supplementary equations), then the state
        dp_dba = dp_dba + dv_dba * dt - 0.5 * dR * dt2
        dp_dbg = dp_dbg + dv_dbg * dt - 0.5 * dRa @ dR_dbg * dt2
        dv_dba = dv_dba - dR * dt
        dv_dbg = dv_dbg - dRa @ dR_dbg * dt
        dR_dbg = dRk.t() @ dR_dbg - Jr * dt

        # covariance: x = [dtheta, dv, dp, dba, dbg]
        A = torch.cat([
            torch.cat([dRk.t(), z3, z3, z3, -Jr * dt], dim=1),
            torch.cat([-dRa * dt, eye3, z3, -dR * dt, z3], dim=1),
            torch.cat([-0.5 * dRa * dt2, eye3 * dt, eye3, -0.5 * dR * dt2, z3], dim=1),
            torch.cat([z3, z3, z3, eye3, z3], dim=1),
            torch.cat([z3, z3, z3, z3, eye3], dim=1),
        ], dim=0)
        sa_R = (dR * (a2 / dt)) @ dR.t() * dt2  # dR diag(sa) dR^T dt^2
        Q = torch.block_diag(
            (Jr * (g2 / dt)) @ Jr.t() * dt2,
            sa_R,
            0.25 * sa_R * dt2 + eye3 * (noise.integration_sigma ** 2 * dt),
            torch.diag(ba2 * dt),
            torch.diag(bg2 * dt),
        )
        cov = A @ cov @ A.t() + Q

        dp = dp + dv * dt + 0.5 * Ra * dt2
        dv = dv + Ra * dt
        dR = dR @ dRk
    T = torch.full((), float(sum(dts[k] for k in steps)), dtype=dtype, device=dev)
    return PreintegratedImu(dR, dv, dp, T, dR_dbg, dv_dba, dv_dbg, dp_dba, dp_dbg, cov, bias)


def bias_corrected_deltas(pim: PreintegratedImu, bias: ImuBias):
    """First-order bias correction of the preintegrated deltas."""
    dba = bias.accel - pim.bias_hat.accel
    dbg = bias.gyro - pim.bias_hat.gyro
    dR = pim.dR @ so3.exp(_mv(pim.dR_dbg, dbg))
    dv = pim.dv + _mv(pim.dv_dba, dba) + _mv(pim.dv_dbg, dbg)
    dp = pim.dp + _mv(pim.dp_dba, dba) + _mv(pim.dp_dbg, dbg)
    return dR, dv, dp


def predict(state: NavState, bias: ImuBias, pim: PreintegratedImu, gravity) -> NavState:
    """Propagate a NavState through the preintegrated window
    (gtsam PreintegratedCombinedMeasurements::predict,
    run/pipeline_ligo_tc.cpp:453)."""
    dR, dv, dp = bias_corrected_deltas(pim, bias)
    Ri = state.pose.rot
    t = pim.dt[..., None]
    p_j = state.pose.trans + state.vel * t + 0.5 * gravity * t * t + _mv(Ri, dp)
    v_j = state.vel + gravity * t + _mv(Ri, dv)
    return NavState(Pose3(Ri @ dR, p_j), v_j)


def residual(state_i: NavState, bias_i: ImuBias, state_j: NavState, pim: PreintegratedImu,
             gravity) -> torch.Tensor:
    """9-dof preintegration residual [r_R, r_v, r_p] (Forster eq. 45)."""
    dR, dv, dp = bias_corrected_deltas(pim, bias_i)
    Ri_T = state_i.pose.rot.transpose(-1, -2)
    t = pim.dt[..., None]
    r_R = so3.log(dR.transpose(-1, -2) @ (Ri_T @ state_j.pose.rot))
    r_v = _mv(Ri_T, state_j.vel - state_i.vel - gravity * t) - dv
    r_p = _mv(Ri_T, state_j.pose.trans - state_i.pose.trans - state_i.vel * t
              - 0.5 * gravity * t * t) - dp
    return torch.cat([r_R, r_v, r_p], dim=-1)
