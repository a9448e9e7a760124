"""Fixed-capacity factor graph over a sliding window of nav states (port of
slamtpu/fusion/graph.py).

The window is re-solved every keyframe by dense Gauss-Newton
(``fusion.smoother``) in place of the reference's incremental iSAM2
(run/pipeline.cpp:486-489, 738-741). State per node: pose (SE(3)),
velocity (3) and IMU bias (6), 15 tangent dofs ordered [pose xi (omega, v),
dvel, dbias (accel, gyro)]. Factors live in fixed-capacity arrays with
active masks; the residuals of inactive slots are zero.

Factor types (the reference graphs'):
- prior_pose: INS pose prior with trust-gain scheduling (pipeline.cpp:637-665)
- between:    LiDAR registration between factor (pipeline.cpp:594-604)
- prior_vel / prior_bias: initial priors (pipeline_ligo_tc.cpp:365-404)
- imu:        CombinedImuFactor equivalent, 15-dof residual with the bias
              walk (pipeline_ligo_tc.cpp:459-463)
- position:   GPS/position factor (pipeline_ligo_tc.cpp:544-576)

The NamedTuples hold tensors and keep the reference's field names, so
``interop`` maps them field for field.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import se3
from ..core.se3 import Pose3
from .preintegration import ImuBias, NavState, PreintegratedImu, residual as imu_residual


class WindowState(NamedTuple):
    """W nav states (padded; ``active`` marks real ones)."""

    rot: torch.Tensor  # (W, 3, 3)
    trans: torch.Tensor  # (W, 3)
    vel: torch.Tensor  # (W, 3)
    bias: torch.Tensor  # (W, 6) [accel(3), gyro(3)]
    active: torch.Tensor  # (W,) bool

    @property
    def window(self) -> int:
        return self.trans.shape[0]

    def retract(self, delta: torch.Tensor) -> "WindowState":
        """delta: (W, 15) = [pose xi(6), dvel(3), dbias(6)]."""
        new_pose = se3.retract(Pose3(self.rot, self.trans), delta[:, :6])
        return WindowState(new_pose.rot, new_pose.trans, self.vel + delta[:, 6:9],
                           self.bias + delta[:, 9:15], self.active)

    @staticmethod
    def identity(window: int, dtype=torch.float64, device="cpu") -> "WindowState":
        return WindowState(
            torch.eye(3, dtype=dtype, device=device).expand(window, 3, 3).clone(),
            torch.zeros((window, 3), dtype=dtype, device=device),
            torch.zeros((window, 3), dtype=dtype, device=device),
            torch.zeros((window, 6), dtype=dtype, device=device),
            torch.zeros((window,), dtype=torch.bool, device=device),
        )


class PriorPoseFactors(NamedTuple):
    idx: torch.Tensor  # (F,) int32
    rot: torch.Tensor  # (F, 3, 3)
    trans: torch.Tensor  # (F, 3)
    sqrt_info: torch.Tensor  # (F, 6, 6)
    active: torch.Tensor  # (F,) bool


class BetweenFactors(NamedTuple):
    i: torch.Tensor  # (F,) int32
    j: torch.Tensor  # (F,)
    rot: torch.Tensor  # (F, 3, 3) measured relative pose i -> j
    trans: torch.Tensor  # (F, 3)
    sqrt_info: torch.Tensor  # (F, 6, 6)
    active: torch.Tensor


class VecPriorFactors(NamedTuple):
    """Prior on velocity (dim 3) or bias (dim 6)."""

    idx: torch.Tensor
    value: torch.Tensor  # (F, d)
    sqrt_info: torch.Tensor  # (F, d, d)
    active: torch.Tensor


class ImuFactors(NamedTuple):
    """Preintegrated IMU factors between window states (i, j), the
    preintegration fields stacked over F. 15-dof residual [rR, rv, rp,
    rba, rbg]; sqrt_info from the preintegration covariance."""

    i: torch.Tensor  # (F,)
    j: torch.Tensor
    dR: torch.Tensor  # (F, 3, 3)
    dv: torch.Tensor  # (F, 3)
    dp: torch.Tensor  # (F, 3)
    dt: torch.Tensor  # (F,)
    dR_dbg: torch.Tensor  # (F, 3, 3)
    dv_dba: torch.Tensor
    dv_dbg: torch.Tensor
    dp_dba: torch.Tensor
    dp_dbg: torch.Tensor
    bias_hat: torch.Tensor  # (F, 6)
    sqrt_info: torch.Tensor  # (F, 15, 15)
    active: torch.Tensor


class PositionFactors(NamedTuple):
    idx: torch.Tensor
    value: torch.Tensor  # (F, 3) measured position
    sqrt_info: torch.Tensor  # (F, 3, 3)
    active: torch.Tensor


class Factors(NamedTuple):
    prior_pose: PriorPoseFactors
    between: BetweenFactors
    prior_vel: VecPriorFactors
    prior_bias: VecPriorFactors
    imu: ImuFactors
    position: PositionFactors
    gravity: torch.Tensor  # (3,) world gravity vector for IMU factors


def empty_factors(n_prior: int, n_between: int, n_vel: int, n_bias: int, n_imu: int, n_pos: int,
                  dtype=torch.float64, device="cpu") -> Factors:
    def zeros(*s):
        return torch.zeros(s, dtype=dtype, device=device)

    def eye(n, d):
        return torch.eye(d, dtype=dtype, device=device).expand(n, d, d).clone()

    def idx(n):
        return torch.zeros((n,), dtype=torch.int32, device=device)

    def off(n):
        return torch.zeros((n,), dtype=torch.bool, device=device)

    return Factors(
        prior_pose=PriorPoseFactors(idx(n_prior), eye(n_prior, 3), zeros(n_prior, 3),
                                    eye(n_prior, 6), off(n_prior)),
        between=BetweenFactors(idx(n_between), idx(n_between), eye(n_between, 3),
                               zeros(n_between, 3), eye(n_between, 6), off(n_between)),
        prior_vel=VecPriorFactors(idx(n_vel), zeros(n_vel, 3), eye(n_vel, 3), off(n_vel)),
        prior_bias=VecPriorFactors(idx(n_bias), zeros(n_bias, 6), eye(n_bias, 6), off(n_bias)),
        imu=ImuFactors(idx(n_imu), idx(n_imu), eye(n_imu, 3), zeros(n_imu, 3), zeros(n_imu, 3),
                       zeros(n_imu), eye(n_imu, 3), eye(n_imu, 3), eye(n_imu, 3), eye(n_imu, 3),
                       eye(n_imu, 3), zeros(n_imu, 6), eye(n_imu, 15), off(n_imu)),
        position=PositionFactors(idx(n_pos), zeros(n_pos, 3), eye(n_pos, 3), off(n_pos)),
        gravity=torch.tensor([0.0, 0.0, 9.81], dtype=dtype, device=device),
    )


def _pose_at(state: WindowState, idx) -> Pose3:
    return Pose3(state.rot.index_select(0, idx), state.trans.index_select(0, idx))


def imu_pim(fi: ImuFactors) -> PreintegratedImu:
    """The factors' preintegration fields as one batched PreintegratedImu
    (no covariance: the factor carries its whitening instead)."""
    return PreintegratedImu(fi.dR, fi.dv, fi.dp, fi.dt, fi.dR_dbg, fi.dv_dba, fi.dv_dbg,
                            fi.dp_dba, fi.dp_dbg, None,
                            ImuBias(fi.bias_hat[:, :3], fi.bias_hat[:, 3:]))


def factor_errors(state: WindowState, factors: Factors) -> dict:
    """Unwhitened errors of every factor type, in residual order, each
    (F, d); keyed by the ``Factors`` field name."""
    fp = factors.prior_pose
    out = {"prior_pose": se3.local(Pose3(fp.rot, fp.trans), _pose_at(state, fp.idx))}
    fb = factors.between
    between = se3.between(_pose_at(state, fb.i), _pose_at(state, fb.j))
    out["between"] = se3.local(Pose3(fb.rot, fb.trans), between)
    fv = factors.prior_vel
    out["prior_vel"] = state.vel.index_select(0, fv.idx) - fv.value
    fbias = factors.prior_bias
    out["prior_bias"] = state.bias.index_select(0, fbias.idx) - fbias.value
    fi = factors.imu
    if fi.i.shape[0] > 0:
        bias_i, bias_j = state.bias.index_select(0, fi.i), state.bias.index_select(0, fi.j)
        r9 = imu_residual(NavState(_pose_at(state, fi.i), state.vel.index_select(0, fi.i)),
                          ImuBias(bias_i[:, :3], bias_i[:, 3:]),
                          NavState(_pose_at(state, fi.j), state.vel.index_select(0, fi.j)),
                          imu_pim(fi), factors.gravity)
        out["imu"] = torch.cat([r9, bias_j - bias_i], dim=1)
    fpos = factors.position
    out["position"] = state.trans.index_select(0, fpos.idx) - fpos.value
    return out


def whiten(factors: Factors, name: str, e: torch.Tensor) -> torch.Tensor:
    """sqrt_info @ e of factor type ``name``, zero on inactive slots."""
    f = getattr(factors, name)
    w = torch.einsum("fij,fj->fi", f.sqrt_info, e)
    return torch.where(f.active[:, None], w, 0.0)


def residuals(state: WindowState, factors: Factors) -> torch.Tensor:
    """Stacked weighted residual vector (fixed length)."""
    errors = factor_errors(state, factors)
    return torch.cat([whiten(factors, k, e).reshape(-1) for k, e in errors.items()])


def sqrt_info_from_cov(cov: torch.Tensor, jitter: float = 1e-12) -> torch.Tensor:
    """Whitening matrix S = L^-1 (lower triangular) of cov + jitter I =
    L L^T, so that S^T S = cov^-1 (batched). The factorization and the
    solve do not check for failure, so they never wait for the device; a
    matrix that is not positive definite gives non-finite entries, as in
    the reference."""
    d = cov.shape[-1]
    eye = torch.eye(d, dtype=cov.dtype, device=cov.device)
    L = torch.linalg.cholesky_ex(cov + jitter * eye)[0]
    return torch.linalg.solve_triangular(L, eye.expand(cov.shape), upper=False)


def sqrt_info_from_sigmas(sigmas: torch.Tensor) -> torch.Tensor:
    """Diagonal whitening from per-dof standard deviations (..., d)."""
    return torch.diag_embed(1.0 / sigmas)


def reorder_covariance_trans_rot(cov: torch.Tensor) -> torch.Tensor:
    """Swap a 6x6 covariance between [trans, rot] and [rot, trans] block
    order: P C P^T with P = [[0, I], [I, 0]] (diagonal AND off-diagonal
    blocks swap; the reference's reorderCovarianceForGTSAM swaps only the
    diagonal ones, registercallback.cpp:170-186). Involutory."""
    tt, tr = cov[..., :3, :3], cov[..., :3, 3:]
    rt, rr = cov[..., 3:, :3], cov[..., 3:, 3:]
    return torch.cat([torch.cat([rr, rt], dim=-1), torch.cat([tr, tt], dim=-1)], dim=-2)
