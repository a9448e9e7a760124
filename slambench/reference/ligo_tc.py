"""Plain reference of the ligo_tc keyframe, and the comparison that decides
``correct`` for a configuration with ``"app": "ligo_tc"``.

The keyframe (run/pipeline_ligo_tc.cpp:339-622) preintegrates the sweep's
raw IMU samples (ANPP packet 28) from the previous state's bias, predicts
the new state, registers the sweep by Newton NDT against the last K
keyframes' clouds fused at their solved poses, from the prediction and
pulled toward it, prices the LiDAR between factor from the registration's
Hessian, and solves a window of the newest W states (pose, velocity,
bias) under the INS pose priors, the velocity priors, a bias prior on the
oldest state, the between factors and the IMU factors. A keyframe
therefore depends on the window's velocities and biases and on the poses
its target was fused at, which the port keeps on the host and does not
publish. The app's host record (``LigoTcApp.record``: after each
keyframe's re-solve, the window's solved states, the poses the keyframe's
target was fused at and the registration's pose) holds them; the
adapter's ``state`` hands it over, and the harness passes it to
``point_gaps``. So the comparison is made there: ``published`` and
``gaps`` compare nothing in a run of the port (``published`` sees only the
published poses), and serve the control, which puts this reference's own
chain in the record's place (below).

For a keyframe j this reference works out again, from the generated
inputs alone (the decoded channels' ranges, the column timestamps, the
INS samples as encoded) and the configuration, each from the record of
the state before it:

- for each keyframe k of j's window after its first: the sweep, projected
  and deskewed between the INS poses at its first and last column; the
  IMU samples the synchroniser hands over (interpolated at the previous
  sweep's end, the samples inside, interpolated at this sweep's end) and
  their preintegration at the held bias of state k - 1 (deltas, bias
  Jacobians, the 15 x 15 noise covariance; Forster et al., GTSAM's
  CombinedImuFactor); the prediction from state k - 1; the Gaussian map of
  the ring's clouds placed at the poses the record says the target was
  fused at (one voxel map, the port's origin rule); Newton NDT from the
  prediction with the pull 0.5 w |Local(prediction, pose)|^2, w the
  configured factor times the contributing pairs, on the DIRECT7
  neighbours (looked up once every ``fused_inner_iters`` steps, with the
  port's re-lookup after a resolution of motion), until a step is shorter
  than ``ndt_transform_epsilon`` or ``ndt_max_iterations`` steps; the
  LiDAR covariance -(H + 1e-6 I)^-1 of the last step's NDT Hessian, its
  eigenvalues floored at 1e-12 and the configured sigma floors added; the
  relative pose from state k - 1's held pose to the registration;
- the INS priors of the window's states with their reported sigmas scaled
  by the GPS-denial trust gain, replayed from the first keyframe;
- the window's Gauss-Newton solve to convergence (Jacobians by forward
  differentiation, the IMU residual [r_R, r_v, r_p, b_j - b_i] with the
  first-order bias correction) and the newest state's 15 x 15 marginal
  covariance.

It compares that with what the port published for j (the translation gap
in mm, the rotation gap in urad, the covariance's relative Frobenius gap)
and with the record's newest velocity (mm/s) and registration pose (mm);
the bias gaps are printed. Whatever keyframes the harness samples, it
also redoes every keyframe at which the INS heading passes +-pi, under
the same limits (``cross_*``). Since each keyframe is redone from the
record, the record is held to itself at each of them
(``target_pose_gap_mm``): the poses the target was fused at must be the
solved poses of the record before, and its newest state the published
pose. It also compares the points: the count the port kept of each
sampled sweep, and the ring's clouds at the end of the run, point by
point. The port's RegMap, its row lookup and its CUDA kernels have no
counterpart here: the reference searches the voxel map itself.

The control (``control.py --control``) has no record: ``published`` then
runs this reference's own chain from the first keyframe in float64 and
redoes each sampled keyframe from that chain's record at the precision
asked for (its marginal from a float64 window over those steps, see
``published``), which ``gaps`` compares with the chain's own; the
crossings up to the window's end are redone likewise (``point_gaps``).
"""
from __future__ import annotations

import math
import struct
import sys
from typing import Dict, NamedTuple

import numpy as np
import torch

from . import common as c
from .common import F64, Pose, Prec

# limits of the compared numbers, each between the sound runs' largest
# reading and the TF32 control's smallest, 3x or more from both (see
# PERF.md, "Correctness", for the readings they were set from)
LIMITS = {"pose_gap_mm": 1.0, "rot_gap_urad": 60.0, "cov_gap": 1e-4, "vel_gap_mm_s": 4.0, "newton_gap_mm": 0.3,
          "points_gap": 0, "target_gap_mm": 2.0, "target_pose_gap_mm": 0.1, "cross_pose_gap_mm": 1.0,
          "cross_rot_gap_urad": 60.0, "cross_cov_gap": 1e-4}
HESS_LAMBDA = 1e-6  # added to the NDT Hessian (NewtonConfig.hess_lambda)
MAX_STEP_NORM = 1.0  # NewtonConfig.max_step_norm
COV_EPS = 1e-6  # -(H + eps I)^-1
SMOOTHER_ITERS, SMOOTHER_TOL = 50, 1e-13
STATE = 15  # a window state's tangent: pose [omega, v], velocity, bias [accel, gyro]


def gravity_wgs84(lat: float, lon: float, alt: float) -> float:
    """Normal gravity magnitude (m/s^2) of the WGS-84 ellipsoid at a geodetic
    position, in ellipsoidal-harmonic coordinates (the source's
    compcallback.cpp:405-433, with its constants)."""
    GM, a, b_over_a, omega = 3986004.418e8, 6378137.0, 0.996647189335, 7.292115e-5
    e2_first = 6.69437999014e-3
    b = a * b_over_a
    E2 = a * a - b * b
    E = math.sqrt(E2)
    sphi, cphi = math.sin(lat), math.cos(lat)
    N = a / math.sqrt(1.0 - e2_first * sphi * sphi)
    x = (N + alt) * cphi * math.cos(lon)
    y = (N + alt) * cphi * math.sin(lon)
    z = (b_over_a * b_over_a * N + alt) * sphi
    D = x * x + y * y + z * z - E2
    u2 = 0.5 * D * (1.0 + math.sqrt(1.0 + 4.0 * E2 * z * z / (D * D)))
    u, uE = math.sqrt(u2), u2 + E2
    beta = math.atan2(z * math.sqrt(uE), u * math.sqrt(x * x + y * y))
    sb, cb = math.sin(beta), math.cos(beta)
    w = math.sqrt((u2 + E2 * sb * sb) / uE)
    q = 0.5 * ((1.0 + 3.0 * u2 / E2) * math.atan(E / u) - 3.0 * u / E)
    q0 = 0.5 * ((1.0 + 3.0 * b * b / E2) * math.atan(E / b) - 3.0 * b / E)
    q1 = 3.0 * ((1.0 + u2 / E2) * (1.0 - (u / E) * math.atan(E / u))) - 1.0
    g_u = (-(GM / uE + omega * omega * a * a * E * q1 * (0.5 * sb * sb - 1.0 / 6.0) / (uE * q0)) / w
           + u * cb * cb * omega * omega / w)
    g_b = (omega * omega * a * a * q * sb * cb / (math.sqrt(uE) * w * q0)
           - math.sqrt(uE) * cb * sb * omega * omega / w)
    return math.sqrt(g_u * g_u + g_b * g_b)


def _yaw(R) -> float:
    return math.atan2(float(R[1, 0]), float(R[0, 0]))


def _crosses_pi(ya: float, yb: float) -> bool:
    """Whether the heading passes +-pi between ya and yb (the short way)."""
    return abs(ya) > 0.5 * math.pi and abs(yb) > 0.5 * math.pi and (ya > 0) != (yb > 0)


class Held(NamedTuple):
    """One keyframe's record, as ``LigoTcApp.record`` keeps it."""

    states: np.ndarray  # (n, 21) the window's solved states, oldest first: rot(9), trans(3), vel(3), bias(6)
    target_poses: object  # (K, 12) the ring slots' poses its target was fused at (None for the first)
    newton: object  # (12,) the registration's pose (None for the first)


class Step(NamedTuple):
    pim: dict  # the preintegration: dR, dv, dp, dt, its bias Jacobians, cov (15, 15), bias_hat (6,)
    vel: torch.Tensor  # the predicted velocity
    newton: Pose
    cov: torch.Tensor  # the LiDAR covariance (6, 6)
    rel: Pose  # from state k - 1's held pose to the registration


class Solved(NamedTuple):
    pose: Pose
    vel: torch.Tensor
    bias: torch.Tensor
    cov: torch.Tensor  # the newest state's (15, 15) marginal
    states: np.ndarray  # (n, 21) float64, as ``Held.states``
    step: Step


class Reference(c.Inputs):
    def __init__(self, rec, prec: Prec = F64, record: dict = None):
        reg = rec.cfg["register"]
        super().__init__(rec, prec, False, reg["ndt_resolution"])
        if reg["method"] != "NDT_OMP" or reg["search_method"] != "DIRECT7":
            raise ValueError("this reference registers by NDT_OMP in DIRECT7")
        self.fu, self.imu = rec.cfg["fusion"], rec.cfg["imu"]
        self.W, self.K = int(self.fu["window"]), int(reg["keyframe_window"])
        self.d1, self.d2 = c.gauss_constants(self.res, float(reg["svn_outlier_ratio"]))
        self.gravity = np.array([0.0, 0.0, gravity_wgs84(*(float(v) for v in self.ref_lla))])  # NED: +down
        # {k: Held}: the port's record, or (None) this reference's own chain
        self.record = {k: Held(*v) for k, v in record.items()} if record is not None else None
        self._own: Dict[int, Held] = {}
        self._origins = [np.asarray(self.ins_pose_end(0).trans, np.float64) - 512.0 * self.res]
        self._trust = [(False, 1.0)]  # (was_denied, trust) after each keyframe
        self._steps: Dict[int, Step] = {}
        self.evaluations: Dict[int, list] = {}  # k -> [(points active, pairs, rows)] of each Newton step

    # --- the INS stream as the synchroniser hands it over ---

    def _sample(self, m: int) -> dict:
        """Nav sample m as decoded: time, packet 28's accel and gyro and
        packet 20's velocity (float32 on the wire)."""
        lap = self.rec.lap
        k = lap._phase(m)
        f32 = lambda v: np.asarray(v, np.float32).astype(np.float64)  # noqa: E731
        return dict(t=self.ins.sample(m)[0], accel=f32(lap.nav_fbody[k]), gyro=f32(lap.nav_gyro[k]),
                    vel=f32(lap.nav_vel[k]))

    def _at(self, t: float) -> dict:
        """The nav frame interpolated at time t (linear, as the decoder's)."""
        m = math.floor((t - self.rec.lap.t0) * self.rec.lap.nav_hz)
        for m0 in (m - 1, m, m + 1):
            a, b = self._sample(m0), self._sample(m0 + 1)
            if a["t"] <= t <= b["t"]:
                u = float(np.clip((t - a["t"]) / (b["t"] - a["t"]) if b["t"] - a["t"] > 1e-9 else 0.0, 0.0, 1.0))
                return {key: a[key] + u * (b[key] - a[key]) for key in a}
        raise ValueError(f"no nav samples around t = {t}")

    def imu_samples(self, k: int) -> list:
        """Keyframe k's nav frames: interpolated at the previous sweep's end,
        those inside, interpolated at this sweep's end."""
        lap, g = self.rec.lap, self.rec.kf_sweeps[k]
        start, end = c.sweep_times(lap, g - 1)[2], c.sweep_times(lap, g)[2]
        m0 = math.floor((start - lap.t0) * lap.nav_hz) - 1
        inner = [self._sample(m) for m in range(m0, m0 + 4 * lap.nav_per_sweep)]
        return [self._at(start)] + [f for f in inner if start < f["t"] < end] + [self._at(end)]

    def ins_vel(self, k: int) -> np.ndarray:
        return self._at(c.sweep_times(self.rec.lap, self.rec.kf_sweeps[k])[2])["vel"]

    def ins_sigma(self, k: int) -> np.ndarray:
        """[rpy(3), pos(3)] sigmas the decoder reports at keyframe k's last
        column: packets 26 and 20 of the samples around it, interpolated."""
        lap = self.rec.lap
        t = c.sweep_times(lap, self.rec.kf_sweeps[k])[2]

        def of(m):
            pk = lap.nav_packets(m)
            p20 = next(p for p in pk if p[1] == 20)
            p26 = next(p for p in pk if p[1] == 26)
            return np.array(struct.unpack_from("<3f", p26, 5) + struct.unpack_from("<3f", p20, 5 + 12 + 24 + 52),
                            np.float64)

        m = math.floor((t - lap.t0) * lap.nav_hz)
        for m0 in (m - 1, m, m + 1):
            ta, tb = self.ins.sample(m0)[0], self.ins.sample(m0 + 1)[0]
            if ta <= t <= tb:
                u = float(np.clip((t - ta) / (tb - ta) if tb - ta > 1e-9 else 0.0, 0.0, 1.0))
                a, b = of(m0), of(m0 + 1)
                return a + u * (b - a)
        raise ValueError(f"no nav samples around t = {t}")

    def prior_sigma(self, k: int) -> np.ndarray:
        """Keyframe k's INS prior sigmas: the first keyframe's as reported,
        later ones scaled by the trust gain (pipeline_ligo_tc.cpp:465-506)."""
        fu = self.fu
        while len(self._trust) <= k:
            was_denied, trust = self._trust[-1]
            available = float(np.linalg.norm(self.ins_sigma(len(self._trust))[3:])) < float(fu["denial_threshold"])
            if available and was_denied:
                trust = 0.0
            if available:
                trust = min(1.0, trust + float(fu["recovery_rate"]))
            self._trust.append((not available, trust))
        sig = self.ins_sigma(k)
        if k == 0:
            return np.maximum(sig, 1e-6)
        scale = float(fu["denied_scale"])
        if not self._trust[k][0]:
            scale = scale + self._trust[k][1] * (1.0 - scale)
        return np.maximum(sig * scale, 1e-6)

    def map_origin(self, k: int) -> np.ndarray:
        """The map origin at keyframe k (float64; the port recentres it when
        the vehicle strays past half of the key range's half width)."""
        while len(self._origins) <= k:
            o = self._origins[-1]
            pos = np.asarray(self.ins_pose_end(len(self._origins)).trans, np.float64)
            half = 0.5 * c.GRID_DIM * self.res
            if np.max(np.abs(pos - (o + half))) > 0.5 * half:
                o = np.floor((pos - half) / self.res) * self.res
            self._origins.append(o)
        return self._origins[k]

    # --- the record: the port's, or this reference's own chain ---

    def held(self, k: int) -> Held:
        if self.record is not None:
            return self.record[k]
        if k not in self._own:
            for i in range(len(self._own), k + 1):
                if i not in self._own:
                    self._own[i] = self._first() if i == 0 else self._held_of(i, self.solve(i))
        return self._own[k]

    def _first(self) -> Held:
        p = self.ins_pose_end(0)
        return Held(np.concatenate([np.ravel(p.rot), p.trans, self.ins_vel(0), np.zeros(6)])[None], None, None)

    def _held_of(self, k: int, s: Solved) -> Held:
        newton = np.concatenate([s.step.newton.rot.double().cpu().numpy().ravel(),
                                 s.step.newton.trans.double().cpu().numpy()])
        return Held(s.states, self.target_poses(k), newton)

    def state_of(self, k: int, s: int):
        """State s as the record after keyframe k holds it: (Pose, vel, bias)
        on the device at this reference's precision."""
        rows = self.held(k).states
        row = rows[s - (k - rows.shape[0] + 1)]
        dt = self.prec.dtype
        t = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dt, device=self.dev)  # noqa: E731
        return Pose(t(row[0:9].reshape(3, 3)), t(row[9:12])), t(row[12:15]), t(row[15:21])

    def target_poses(self, k: int) -> np.ndarray:
        """(K, 12) the poses keyframe k's ring slots were fused at: the
        record's where it keeps them, else the solved poses after k - 1."""
        if self.record is not None:
            return np.asarray(self.record[k].target_poses, np.float64)
        out = np.zeros((self.K, 12))
        out[:, 0:9] = np.eye(3).ravel()
        for kk in range(max(0, k - self.K), k):
            p, _, _ = self.state_of(k - 1, kk)
            out[kk % self.K] = np.concatenate([p.rot.double().cpu().numpy().ravel(), p.trans.double().cpu().numpy()])
        return out

    # --- preintegration and prediction ---

    def preintegrate(self, k: int, bias: torch.Tensor) -> dict:
        """Keyframe k's IMU window integrated at ``bias`` [accel, gyro]."""
        prec, dt_, dev = self.prec, self.prec.dtype, self.dev
        T = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dt_, device=dev)  # noqa: E731
        eye3, z3 = torch.eye(3, dtype=dt_, device=dev), torch.zeros((3, 3), dtype=dt_, device=dev)
        dR, dv, dp = eye3, torch.zeros(3, dtype=dt_, device=dev), torch.zeros(3, dtype=dt_, device=dev)
        dR_dbg = dv_dba = dv_dbg = dp_dba = dp_dbg = z3
        cov = torch.zeros((15, 15), dtype=dt_, device=dev)
        im = self.imu
        g2, a2 = float(im["angular_random_walk"]) ** 2, float(im["velocity_random_walk"]) ** 2
        ba2, bg2 = float(im["bias_random_walk_accel"]) ** 2, float(im["bias_random_walk_gyro"]) ** 2
        s_int2 = float(im["integration_sigma"]) ** 2
        frames = self.imu_samples(k)
        total = 0.0
        mm = prec.mm
        for fa, fb in zip(frames, frames[1:]):
            dt = max(fb["t"] - fa["t"], 0.0)
            if dt <= 0.0:
                continue
            total += dt
            a = T(fa["accel"]) - bias[:3]
            w = T(fa["gyro"]) - bias[3:]
            dRk = c.so3_exp(w * dt)
            Jr = c.left_jacobian(-w * dt)
            dRa = mm(dR, c.hat(a))
            dp_dba = dp_dba + dv_dba * dt - 0.5 * dR * dt * dt
            dp_dbg = dp_dbg + dv_dbg * dt - 0.5 * mm(dRa, dR_dbg) * dt * dt
            dv_dba = dv_dba - dR * dt
            dv_dbg = dv_dbg - mm(dRa, dR_dbg) * dt
            dR_dbg = mm(dRk.t(), dR_dbg) - Jr * dt
            A = torch.cat([
                torch.cat([dRk.t(), z3, z3, z3, -Jr * dt], 1),
                torch.cat([-dRa * dt, eye3, z3, -dR * dt, z3], 1),
                torch.cat([-0.5 * dRa * dt * dt, eye3 * dt, eye3, -0.5 * dR * dt * dt, z3], 1),
                torch.cat([z3, z3, z3, eye3, z3], 1),
                torch.cat([z3, z3, z3, z3, eye3], 1)], 0)
            sa = mm(dR * (a2 / dt), dR.t()) * dt * dt
            Q = torch.block_diag(mm(Jr * (g2 / dt), Jr.t()) * dt * dt, sa,
                                 0.25 * sa * dt * dt + eye3 * (s_int2 * dt),
                                 eye3 * (ba2 * dt), eye3 * (bg2 * dt))
            cov = mm(mm(A, cov), A.t()) + Q
            dp = dp + dv * dt + 0.5 * mm(dR, a[:, None])[:, 0] * dt * dt
            dv = dv + mm(dR, a[:, None])[:, 0] * dt
            dR = mm(dR, dRk)
        return dict(dR=dR, dv=dv, dp=dp, dt=total, dR_dbg=dR_dbg, dv_dba=dv_dba, dv_dbg=dv_dbg, dp_dba=dp_dba,
                    dp_dbg=dp_dbg, cov=cov, bias_hat=bias)

    def _corrected(self, pim: dict, bias):
        """The deltas corrected to first order for ``bias``."""
        dba, dbg = bias[:3] - pim["bias_hat"][:3], bias[3:] - pim["bias_hat"][3:]
        mv = lambda A, v: self.prec.mm(A, v[:, None])[:, 0]  # noqa: E731
        dR = self.prec.mm(pim["dR"], c.so3_exp(mv(pim["dR_dbg"], dbg)))
        dv = pim["dv"] + mv(pim["dv_dba"], dba) + mv(pim["dv_dbg"], dbg)
        dp = pim["dp"] + mv(pim["dp_dba"], dba) + mv(pim["dp_dbg"], dbg)
        return dR, dv, dp

    # --- one keyframe's registration ---

    def _step(self, vm, pts, pose: Pose, idx, valid, reg_pose: Pose):
        one = Pose(pose.rot[None], pose.trans[None])
        obj = c.ndt_objective(pts, vm.mean[idx], vm.icov[idx], valid, one, self.d1, self.d2, self.prec,
                              HESS_LAMBDA)
        grad, hess = obj.grad[0], obj.hess[0]
        w = float(self.reg["regularization_scale_factor"]) * max(float(obj.count[0]), 1.0)
        eye = torch.eye(6, dtype=hess.dtype, device=hess.device)
        st = torch.linalg.solve(hess - w * eye, -(grad - w * c.local(reg_pose, pose)))
        st = torch.where(torch.isfinite(st).all(), st, 0.0)
        norm = torch.linalg.vector_norm(st)
        if float(norm) > MAX_STEP_NORM:
            st = st * (MAX_STEP_NORM / float(norm))
            norm = torch.linalg.vector_norm(st)
        return c.retract(pose, st), float(norm), hess

    def newton(self, k: int, vm, pts, mask, guess: Pose):
        """Newton NDT from ``guess`` pulled toward it: (pose, NDT Hessian of
        the last applied step at the pose it was taken from)."""
        reg = self.reg
        max_it, inner = int(reg["ndt_max_iterations"]), int(reg["fused_inner_iters"])
        eps, budget = float(reg["ndt_transform_epsilon"]), self.res
        pose, it, conv, hess = guess, 0, False, None
        self.evaluations[k] = evals = []
        while it < max_it and not conv:
            wp = c.transform(pose, pts, self.prec)
            idx, valid = c.neighbors(vm, wp, mask)
            active = valid.any(1)
            cells = c.pack(c.voxel_coords(wp[active], vm.origin, vm.resolution))
            evals += [(int(active.sum()), int(valid.sum()), int(torch.unique(cells).numel()))] * inner
            pose, norm, hess = self._step(vm, pts, pose, idx, valid, guess)
            moved, applied = norm, 1
            for _ in range(inner - 1):
                p2, n2, h2 = self._step(vm, pts, pose, idx, valid, guess)
                if moved + n2 <= budget:
                    pose, norm, hess, moved, applied = p2, n2, h2, moved + n2, applied + 1
                else:
                    moved = moved + budget
            it += applied
            conv = norm < eps
        return pose, hess

    def target(self, k: int):
        """Keyframe k's voxel map: the ring's clouds (keyframes k - K .. k - 1)
        at the poses its target was fused at."""
        poses = self.target_poses(k)
        dt = self.prec.dtype
        pts, masks = [], []
        for kk in range(max(0, k - self.K), k):
            p, m, _ = self.sweep(kk)
            row = poses[kk % self.K]
            at = Pose(torch.as_tensor(row[0:9].reshape(3, 3), dtype=dt, device=self.dev),
                      torch.as_tensor(row[9:12], dtype=dt, device=self.dev))
            pts.append(c.transform(at, p, self.prec))
            masks.append(m)
        origin = torch.as_tensor(np.asarray(self.map_origin(k), np.float32), device=self.dev)
        return c.build_map(torch.cat(pts), torch.cat(masks), origin, self.res, int(self.reg["map_capacity"]),
                           int(self.reg["min_points_per_voxel"]), self.prec)

    def step(self, k: int) -> Step:
        """Keyframe k's preintegration, prediction and registration (k >= 1),
        from the record after k - 1."""
        if k in self._steps:
            return self._steps[k]
        prec, reg = self.prec, self.reg
        prev, vel, bias = self.state_of(k - 1, k - 1)
        pim = self.preintegrate(k, bias)
        g = torch.as_tensor(self.gravity, dtype=prec.dtype, device=self.dev)
        t = pim["dt"]
        mv = lambda A, v: prec.mm(A, v[:, None])[:, 0]  # noqa: E731
        pred = Pose(prec.mm(prev.rot, pim["dR"]), prev.trans + vel * t + 0.5 * g * t * t + mv(prev.rot, pim["dp"]))
        pred_vel = vel + g * t + mv(prev.rot, pim["dv"])
        pts, mask, _ = self.sweep(k)
        res, hess = self.newton(k, self.target(k), pts, mask, pred)
        eye = torch.eye(6, dtype=prec.dtype, device=self.dev)
        cov = -torch.linalg.inv(hess + COV_EPS * eye)
        cov = 0.5 * (cov + cov.t())
        ev, evec = torch.linalg.eigh(cov)
        cov = (evec * torch.clamp(ev, min=1e-12)[None, :]) @ evec.t()
        floor = torch.tensor([reg["lidar_rot_sigma_floor"]] * 3 + [reg["lidar_trans_sigma_floor"]] * 3,
                             dtype=prec.dtype, device=self.dev)
        cov = cov + torch.diag(floor * floor)
        out = Step(pim, pred_vel, res, cov, c.compose(c.inverse(prev), res))
        self._steps[k] = out
        while len(self._steps) > 4 * self.W:
            self._steps.pop(next(iter(self._steps)))
        return out

    # --- the window ---

    def solve(self, j: int) -> Solved:
        """Keyframe j's window solved to convergence from the record after
        j - 1, and the newest state's marginal covariance (j >= 1)."""
        prec, dt, dev = self.prec, self.prec.dtype, self.dev
        fu = self.fu
        states = list(range(max(0, j - self.W + 1), j + 1))
        n = len(states)
        new = self.step(j)
        init = [self.state_of(j - 1, s) for s in states[:-1]] + [(new.newton, new.vel, self.state_of(j - 1, j - 1)[2])]
        T = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dt, device=dev)  # noqa: E731
        priors = [c.pose_to(self.ins_pose_end(s), dt, dev) for s in states]
        p_si = torch.stack([torch.diag(T(1.0 / self.prior_sigma(s))) for s in states])
        prior = Pose(torch.stack([p.rot for p in priors]), torch.stack([p.trans for p in priors]))
        v_prior = torch.stack([T(self.ins_vel(s)) for s in states])
        v_si = 1.0 / float(fu["prior_vel_sigma"])
        b_prior, b_si = init[0][2], 1.0 / float(fu["bias_prior_sigma"])
        steps = [self.step(s) for s in states[1:]]
        b_rel = Pose(torch.stack([s.rel.rot for s in steps]), torch.stack([s.rel.trans for s in steps]))
        b_whiten = torch.stack([torch.linalg.inv(torch.linalg.cholesky(s.cov)) for s in steps])
        i_whiten = torch.stack([torch.linalg.inv(torch.linalg.cholesky(s.pim["cov"])) for s in steps])
        g = T(self.gravity)
        mv = lambda A, v: prec.mm(A, v[..., None])[..., 0]  # noqa: E731

        def residual(x0, delta):
            rot0, trans0, vel0, bias0 = x0
            d = delta.reshape(n, STATE)
            y = c.retract(Pose(rot0, trans0), d[:, :6])
            vel, bias = vel0 + d[:, 6:9], bias0 + d[:, 9:]
            r_p = torch.einsum("sij,sj->si", p_si, c.local(prior, y))
            rel = c.compose(c.inverse(Pose(y.rot[:-1], y.trans[:-1])), Pose(y.rot[1:], y.trans[1:]))
            r_b = torch.einsum("sij,sj->si", b_whiten, c.local(b_rel, rel))
            r_v = (vel - v_prior) * v_si
            r_bias = (bias[0] - b_prior) * b_si
            r_i = []
            for e, s in enumerate(steps):
                dR, dv, dp = self._corrected(s.pim, bias[e])
                Ri, Rj, t = y.rot[e], y.rot[e + 1], s.pim["dt"]
                r_R = c.so3_log(prec.mm(prec.mm(dR.t(), Ri.t()), Rj))
                r_vi = mv(Ri.t(), vel[e + 1] - vel[e] - g * t) - dv
                r_pi = mv(Ri.t(), y.trans[e + 1] - y.trans[e] - vel[e] * t - 0.5 * g * t * t) - dp
                r_i.append(mv(i_whiten[e], torch.cat([r_R, r_vi, r_pi, bias[e + 1] - bias[e]])))
            return torch.cat([r_p.reshape(-1), r_b.reshape(-1), r_v.reshape(-1), r_bias] + r_i)

        x = (torch.stack([p.rot for p, _, _ in init]), torch.stack([p.trans for p, _, _ in init]),
             torch.stack([v for _, v, _ in init]), torch.stack([b for _, _, b in init]))
        zero = torch.zeros(STATE * n, dtype=dt, device=dev)

        def retract(x0, delta):
            d = delta.reshape(n, STATE)
            y = c.retract(Pose(x0[0], x0[1]), d[:, :6])
            return (y.rot, y.trans, x0[2] + d[:, 6:9], x0[3] + d[:, 9:])

        def equilibrated(J):
            """(D, D J^T J D) with D the inverse square root of the normal
            matrix's diagonal: the system's scales span ~1e12 (bias walks
            against velocity priors), which float32 cannot hold unscaled."""
            H = prec.mm(J.t(), J)
            d = torch.rsqrt(torch.clamp(torch.diagonal(H), min=1e-30))
            return d, H * d[:, None] * d[None, :]

        r = residual(x, zero)
        cost = float(r @ r)
        for _ in range(SMOOTHER_ITERS):
            J = torch.func.jacfwd(lambda d: residual(x, d))(zero)
            d, Hs = equilibrated(J)
            delta = d * torch.linalg.solve_ex(Hs, -d * prec.mm(J.t(), r[:, None])[:, 0])[0]
            delta = torch.where(torch.isfinite(delta), delta, 0.0)
            x_new = retract(x, delta)
            r_new = residual(x_new, zero)
            if float(r_new @ r_new) > cost:
                break
            x, r, cost = x_new, r_new, float(r_new @ r_new)
            if float(torch.linalg.vector_norm(delta)) < SMOOTHER_TOL:
                break
        J = torch.func.jacfwd(lambda d: residual(x, d))(zero)
        d, Hs = equilibrated(J)
        cov = (d[:, None] * torch.linalg.inv_ex(Hs)[0] * d[None, :])[-STATE:, -STATE:]
        rows = torch.cat([x[0].reshape(n, 9), x[1], x[2], x[3]], 1).double().cpu().numpy()
        return Solved(Pose(x[0][-1], x[1][-1]), x[2][-1], x[3][-1], cov, rows, new)


def _cast(st: Step, dtype) -> Step:
    """A keyframe's step with every tensor in ``dtype``."""
    f = lambda v: v.to(dtype) if torch.is_tensor(v) else v  # noqa: E731
    pose = lambda p: Pose(f(p.rot), f(p.trans))  # noqa: E731
    return Step({k: f(v) for k, v in st.pim.items()}, f(st.vel), pose(st.newton), f(st.cov), pose(st.rel))


def _numpy(s: Solved) -> tuple:
    """(rot, trans, cov, vel, newton trans) host float64 of a solved keyframe."""
    f = lambda t: t.detach().double().cpu().numpy()  # noqa: E731
    return f(s.pose.rot), f(s.pose.trans), f(s.cov), f(s.vel), f(s.step.newton.trans)


def published(rec, js, prec: Prec = F64):
    """{j: (rot, trans, cov, vel, registration trans)} host float64 of the
    reference at ``prec``, each keyframe redone from this reference's own
    float64 chain (the control); nothing ({}) where the port published
    poses, whose keyframes depend on states the port does not publish:
    ``point_gaps`` judges them from its host record.

    Below float64 a sixth value follows: the marginal of the window
    re-solved in float64 over the steps (registration, LiDAR covariance,
    preintegration) taken at ``prec``. The window's own marginal is NaN
    there: the newest bias's information is the bias prior's ~400 under the
    walks' ~1e10, below float32's resolution, so its block of the
    equilibrated matrix is singular. ``gaps`` prints the sixth's gap as
    ``cov_gap_f64_window``, not compared. ``prec`` is kept on ``rec`` for
    ``point_gaps``, which redoes the crossings at it."""
    if rec.published:
        return {}
    chain = getattr(rec, "ligo_chain", None)
    if chain is None:
        chain = Reference(rec)
        rec.ligo_chain = chain
    if prec == F64:
        return {j: _numpy(chain.solve(j)) for j in js}
    rec.ligo_control_prec = prec
    ref = Reference(rec, prec)
    ref.record = {k: chain.held(k) for k in range(max(js) + 1)}
    mixed = Reference(rec)  # the float64 window over ref's steps
    mixed.record = ref.record
    out = {}
    for j in js:
        s = ref.solve(j)
        mixed._steps = {k: _cast(st, F64.dtype) for k, st in ref._steps.items()}
        out[j] = _numpy(s) + (mixed.solve(j).cov.detach().cpu().numpy(),)
    return out


def _worst(a: float, b: float) -> float:
    """The larger of two readings, a non-finite one winning."""
    return b if not np.isfinite(b) or b > a else a


def gaps(mine, theirs):
    """The compared numbers of two sets of keyframes, each the worst over
    them: translation (mm), rotation (urad), the covariance's gap relative
    to the second's (Frobenius), and where both carry them the velocity
    (mm/s) and the registration's translation (mm), and where the first
    carries one (the control, see ``published``) ``cov_gap_f64_window``.
    Nothing where the second is empty."""
    if not theirs:
        return {}
    worst = {"pose_gap_mm": 0.0, "rot_gap_urad": 0.0, "cov_gap": 0.0}
    for j, v in mine.items():
        w = theirs[j]
        worst["pose_gap_mm"] = _worst(worst["pose_gap_mm"], 1e3 * float(np.linalg.norm(v[1] - w[1])))
        dR = torch.as_tensor(w[0].T @ v[0])
        worst["rot_gap_urad"] = _worst(worst["rot_gap_urad"], 1e6 * float(torch.linalg.vector_norm(c.so3_log(dR))))
        worst["cov_gap"] = _worst(worst["cov_gap"], float(np.linalg.norm(v[2] - w[2]) / np.linalg.norm(w[2])))
        if len(v) > 3 and len(w) > 3:
            worst["vel_gap_mm_s"] = _worst(worst.get("vel_gap_mm_s", 0.0), 1e3 * float(np.linalg.norm(v[3] - w[3])))
            worst["newton_gap_mm"] = _worst(worst.get("newton_gap_mm", 0.0),
                                            1e3 * float(np.linalg.norm(v[4] - w[4])))
        if len(v) > 5:
            worst["cov_gap_f64_window"] = _worst(worst.get("cov_gap_f64_window", 0.0),
                                                 float(np.linalg.norm(v[5] - w[2]) / np.linalg.norm(w[2])))
    return worst


def crossing_keyframes(ref: Reference, last: int):
    """Keyframes from the end of the warm-up to ``last`` at which the INS
    heading passes +-pi."""
    out = []
    w0 = int(ref.rec.cfg["warmup_keyframes"])
    y_prev = _yaw(ref.ins_pose_end(w0 - 1).rot)
    for j in range(w0, last + 1):
        y = _yaw(ref.ins_pose_end(j).rot)
        if _crosses_pi(y_prev, y):
            out.append(j)
        y_prev = y
    return out


def _moved_mm(ref: Reference, k: int, a, b) -> float:
    """The widest displacement, in mm, of keyframe k's kept points between
    the poses ``a`` and ``b`` (rot(9), trans(3) each)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    pts, mask, _ = ref.sweep(k)
    p = pts[mask].double().cpu().numpy()
    d = p @ (a[0:9] - b[0:9]).reshape(3, 3).T + (a[9:12] - b[9:12])
    return 1e3 * float(np.linalg.norm(d, axis=1).max(initial=np.linalg.norm(a[9:12] - b[9:12])))


def record_gap(ref: Reference, record: dict, rec, j: int) -> float:
    """How far keyframe j's record strays from the poses it must hold, as
    the widest displacement of a kept point (mm): each target slot's
    fused-at pose against its keyframe's solved pose in the record after
    j - 1 (float32 rounding: the port ships them so), and the record's
    newest state against the pose the port published for j."""
    held, prev = Held(*record[j]), Held(*record[j - 1])
    R, t, _ = rec.published[j]
    gap = _moved_mm(ref, j, held.states[-1, 0:12], np.concatenate([np.ravel(R), t]))
    first = j - prev.states.shape[0]  # the keyframe of prev's first row
    for kk in range(max(0, j - ref.K, first), j):
        gap = max(gap, _moved_mm(ref, kk, held.target_poses[kk % ref.K], prev.states[kk - first, 0:12]))
    return gap


def _compare(ref: Reference, record: dict, rec, js) -> dict:
    """The port's keyframes ``js`` (published pose and covariance, the
    record's newest velocity, bias and registration) against the
    reference's, each redone from the record before it, and
    ``target_pose_gap_mm``: the widest ``record_gap`` over them."""
    mine, theirs, bias = {}, {}, {"bias_accel_gap": 0.0, "bias_gyro_gap": 0.0}
    record_gaps = [record_gap(ref, record, rec, j) for j in js]
    for j in js:
        R, t, C = rec.published[j]
        held = Held(*record[j])
        mine[j] = (R, t, C, held.states[-1, 12:15], np.asarray(held.newton)[9:12])
        s = ref.solve(j)
        theirs[j] = _numpy(s)
        one = gaps({j: mine[j]}, {j: theirs[j]})
        b = s.bias.detach().double().cpu().numpy()
        bias["bias_accel_gap"] = max(bias["bias_accel_gap"], float(np.linalg.norm(held.states[-1, 15:18] - b[:3])))
        bias["bias_gyro_gap"] = max(bias["bias_gyro_gap"], float(np.linalg.norm(held.states[-1, 18:21] - b[3:])))
        print(f"keyframe {j} (sweep {rec.kf_sweeps[j]}): " + ", ".join(f"{k} {v:.6g}" for k, v in one.items())
              + f", bias gaps {np.linalg.norm(held.states[-1, 15:18] - b[:3]):.3g} m/s^2 "
              f"{np.linalg.norm(held.states[-1, 18:21] - b[3:]):.3g} rad/s", file=sys.stderr)
    numbers = gaps(mine, theirs) if js else {}
    numbers["target_pose_gap_mm"] = max(record_gaps, default=0.0)
    return numbers, bias


def point_gaps(rec, kept, held, js, prec: Prec = F64):
    """With the port's ``held`` ({"record", "ring"} from the adapter's
    ``state``): its keyframes ``js`` and, redone at every keyframe where
    the INS heading passes +-pi, ``cross_pose_gap_mm``,
    ``cross_rot_gap_urad``, ``cross_cov_gap`` (``cross_keyframes``: how
    many, printed); ``target_pose_gap_mm`` over both (``record_gap``);
    ``points_gap``: the most points by which the port's count of kept
    points differs from the reference's, over ``js``, or that are kept on
    one side only, over the ring's clouds; ``target_gap_mm``: the widest
    gap of a ring point kept on both sides (the reference's sweep placed at
    the pose the port published, or at the INS prior where none is
    recorded). The control hands a ring alone ({keyframe: (points, mask)},
    no record): then the points are compared here, and the crossings up to
    the last of ``js`` redone at the precision ``published`` was asked for
    against the float64 chain."""
    record = held.get("record") if "ring" in held else None
    ring = held["ring"] if record is not None else held
    ref = Reference(rec, prec, record=record)
    worst = {"points_gap": 0, "target_gap_mm": 0.0}
    for j in js:
        worst["points_gap"] = max(worst["points_gap"], abs(int(kept[j]) - int(ref.sweep(j)[1].sum())))
    for j, (pts, mask) in ring.items():
        p, m, prior = ref.sweep(j)
        m = m.cpu().numpy()
        worst["points_gap"] = max(worst["points_gap"], int((m != mask).sum()))
        both = m & mask
        if both.any():
            if j in rec.published:
                R, t, _ = rec.published[j]
                at = c.pose_to(Pose(R, t), prec.dtype, ref.dev)
            else:
                at = prior
            world = c.transform(at, p, prec).double().cpu().numpy()
            d = np.linalg.norm(world[both] - pts[both], axis=1)
            worst["target_gap_mm"] = max(worst["target_gap_mm"], 1e3 * float(d.max()))
    cross = []
    worst.update({"cross_" + k: v for k, v in c.gaps({}, {}).items()})
    if record is not None:
        rec.ligo_record = record  # for ``kernel_work``, which the harness calls after this
        numbers, bias = _compare(ref, record, rec, js)
        worst.update(numbers)
        worst.update(bias)
        cross = [j for j in crossing_keyframes(ref, max(js)) if j - 1 in record] if js else []
        numbers, _ = _compare(ref, record, rec, cross)
        worst["target_pose_gap_mm"] = max(worst["target_pose_gap_mm"], numbers.pop("target_pose_gap_mm"))
    else:
        # the control: its chain fuses at its own solved states, so its
        # record strays nowhere; its crossings are redone at its precision
        worst["target_pose_gap_mm"] = 0.0
        prec_c = getattr(rec, "ligo_control_prec", None)
        cross = crossing_keyframes(ref, max(js)) if js and prec_c is not None else []
        numbers = gaps(published(rec, cross, prec_c), published(rec, cross)) if cross else {}
    worst.update({"cross_" + k: v for k, v in numbers.items() if k.startswith(("pose", "rot", "cov"))}
                 if cross else {})
    worst["cross_keyframes"] = len(cross)
    return worst


def kernel_work(rec, js, costs):
    """(operations, bytes) of the NDT pair-kernel calls (K = 1) of the
    keyframes ``js``: one a Newton step this reference takes, inner steps
    that are dropped included, each over the rows of its lookup; each
    keyframe redone from the port's record (``point_gaps`` keeps it on the
    run's record)."""
    record = getattr(rec, "ligo_record", None)
    if record is None:
        return None
    ref = Reference(rec, record=record)
    ops = nbytes = 0
    for j in js:
        if j < 1 or j - 1 not in record or j not in record:
            continue
        ref.step(j)
        N = ref.sweep(j)[0].shape[0]
        for n_active, pairs, rows in ref.evaluations[j]:
            ops += n_active * costs.FLOPS_POINT["ndt_pair"] + pairs * costs.FLOPS_PAIR["ndt_pair"]
            nbytes += costs.call_bytes(rows, N, 1)
    return ops, nbytes
