"""Plain reference of the odom_ndt keyframe, and the comparison that decides
``correct`` for a configuration with ``"app": "odom_ndt"``.

The keyframe (run/pipeline.cpp:432-824) registers the sweep against the
previous keyframe's cloud placed at that keyframe's published pose, blends
the registration toward the INS-relative seed, prices the LiDAR between
factor from the registration's Hessian, and solves a window of the newest
W poses with an INS prior on each. The poses the port publishes are the
window's newest after each solve, so keyframe j depends on its own inputs
and on the published poses of the W - 1 keyframes before it. For a
keyframe j this reference starts from those published poses (or, where
the record has none, as for the control, from its own chain from the first
keyframe) and works out again, from the generated inputs alone (the
decoded channels' ranges, the column timestamps, the INS samples as
encoded) and the configuration:

- for each keyframe k of j's window after its first: the sweep, projected
  and deskewed between the INS poses at its first and last column; the
  Gaussian map of keyframe k - 1's cloud at its published pose (one
  voxel map, the port's origin rule); the seed, k - 1's published pose
  moved by the INS's motion from k - 1 to k; Newton NDT from the seed on
  the DIRECT7 neighbours (looked up once every ``fused_inner_iters`` steps,
  with the port's re-lookup after a resolution of motion), until a step is
  shorter than ``ndt_transform_epsilon`` or ``ndt_max_iterations`` steps;
  the deviation gate's weight w and the geodesic blend Retract(seed, w
  Local(seed, registration)); the LiDAR covariance -(H + 1e-6 I)^-1 of the
  Hessian of the last step, its eigenvalues floored at 1e-12 and the
  configured sigma floors added; the relative pose from k - 1's published
  pose to the blend;
- the INS priors of the window's keyframes with their reported sigmas
  scaled by the GPS-denial trust gain, replayed from the first keyframe;
- the window's Gauss-Newton solve to convergence (Jacobians by forward
  differentiation) and the newest pose's marginal covariance.

It compares that with what the port published for j: the gap of the
translations (mm), of the rotations (urad), and of the covariances
(relative Frobenius). Whatever keyframes the harness samples, it also
redoes every window keyframe at which the INS heading, or the heading the
port published, crosses +-pi, and compares them under the same limits
(``cross_*``): a closed lap meets +-pi once a lap, where a blend in global
Logmap coordinates lands metres off. It also compares the points: the
count the port kept of each sampled sweep, the blend weight it recorded,
and the target cloud(s) it holds at the end of the run (decoded,
projected, deskewed and placed at their published poses), point by point.
The port's RegMap, its row lookup and its CUDA kernels have no
counterpart here: the reference searches the voxel map itself.
"""
from __future__ import annotations

import math
import struct
from typing import Dict, NamedTuple

import numpy as np
import torch

from . import common as c
from .common import F64, Pose, Prec

# limits of the compared numbers, each between the sound runs' largest
# reading and the TF32 control's smallest, 3x or more from both (see
# PERF.md, "Correctness", for the readings they were set from)
LIMITS = {"pose_gap_mm": 1.0, "rot_gap_urad": 60.0, "cov_gap": 7e-5, "points_gap": 0, "target_gap_mm": 2.0,
          "w_gap": 2.5e-4, "cross_pose_gap_mm": 1.0, "cross_rot_gap_urad": 60.0, "cross_cov_gap": 7e-5}
HESS_LAMBDA = 1e-6  # added to the NDT Hessian (NewtonConfig.hess_lambda)
MAX_STEP_NORM = 1.0  # NewtonConfig.max_step_norm
COV_EPS = 1e-6  # -(H + eps I)^-1
SMOOTHER_ITERS, SMOOTHER_TOL = 50, 1e-13


def _yaw(R) -> float:
    return math.atan2(float(R[1, 0]), float(R[0, 0]))


def _crosses_pi(ya: float, yb: float) -> bool:
    """Whether the heading passes +-pi between ya and yb (the short way)."""
    return abs(ya) > 0.5 * math.pi and abs(yb) > 0.5 * math.pi and (ya > 0) != (yb > 0)


class Registration(NamedTuple):
    seed: Pose
    pose: Pose  # Newton's
    blend: Pose
    cov: torch.Tensor  # the LiDAR covariance (6, 6)
    w: float
    rel: Pose  # from the previous keyframe's published pose to the blend


class Reference(c.Inputs):
    def __init__(self, rec, prec: Prec = F64, half: bool = False):
        reg = rec.cfg["register"]
        super().__init__(rec, prec, half, reg["ndt_resolution"])
        if reg["method"] != "NDT_OMP" or int(reg["odom_target_window"]) != 1:
            raise ValueError("this reference registers by NDT_OMP against the previous keyframe")
        fu = rec.cfg["fusion"]
        self.fu = fu
        self.W = int(fu["window"])
        self.d1, self.d2 = c.gauss_constants(self.res, float(reg["svn_outlier_ratio"]))
        self._origins = [np.asarray(self.ins_pose_end(0).trans, np.float64) - 512.0 * self.res]
        self._trust = [(False, 1.0)]  # (was_denied, trust) after each keyframe
        self._reg: Dict[int, Registration] = {}
        self._own: Dict[int, Pose] = {}  # k -> pose of the reference's own chain
        self.evaluations: Dict[int, list] = {}  # k -> [(points active, pairs, rows)] of each Newton step

    # --- what the port holds on the host: INS sigmas, origin, trust gain ---

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

    def prior_sigma(self, k: int) -> np.ndarray:
        """Keyframe k's INS prior sigmas: the first keyframe's as reported,
        later ones scaled by the trust gain (pipeline.cpp:637-665)."""
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
        available = not self._trust[k][0]
        scale = float(fu["denied_scale"])
        if available:
            scale = scale + self._trust[k][1] * (1.0 - scale)
        return np.maximum(sig * scale, 1e-6)

    # --- published poses: the port's where the record has them ---

    def pose(self, k: int) -> Pose:
        if k in self.rec.published:
            R, t, _ = self.rec.published[k]
            return c.pose_to(Pose(R, t), self.prec.dtype, self.dev)
        if k == 0:
            return c.pose_to(self.ins_pose_end(0), self.prec.dtype, self.dev)
        if k not in self._own:
            for i in range(1, k + 1):
                if i not in self._own and i not in self.rec.published:
                    self._own[i] = self.keyframe(i)[0]
        return self._own[k]

    # --- one keyframe's registration, blend and LiDAR covariance ---

    def _objective(self, vm, pts, pose: Pose, idx, valid):
        one = Pose(pose.rot[None], pose.trans[None])
        obj = c.ndt_objective(pts, vm.mean[idx], vm.icov[idx], valid, one, self.d1, self.d2, self.prec,
                              HESS_LAMBDA)
        return obj.grad[0], obj.hess[0]

    def _step(self, vm, pts, pose: Pose, idx, valid):
        grad, hess = self._objective(vm, pts, pose, idx, valid)
        st = torch.linalg.solve(hess, -grad)
        st = torch.where(torch.isfinite(st).all(), st, 0.0)
        norm = torch.linalg.vector_norm(st)
        if float(norm) > MAX_STEP_NORM:
            st = st * (MAX_STEP_NORM / float(norm))
            norm = torch.linalg.vector_norm(st)
        return c.retract(pose, st), float(norm), hess

    def newton(self, k: int, vm, pts, mask, guess: Pose):
        """Newton NDT from ``guess``: (pose, Hessian of the last applied
        step at the pose it was taken from). Each outer iteration looks the
        DIRECT7 neighbours up at its pose and takes ``fused_inner_iters``
        steps on them; an inner step that would carry the summed motion
        since the lookup past one resolution is evaluated and dropped."""
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
            pose, norm, hess = self._step(vm, pts, pose, idx, valid)
            moved, applied = norm, 1
            for _ in range(inner - 1):
                p2, n2, h2 = self._step(vm, pts, pose, idx, valid)
                if moved + n2 <= budget:
                    pose, norm, hess, moved, applied = p2, n2, h2, moved + n2, applied + 1
                else:
                    moved = moved + budget
            it += applied
            conv = norm < eps
        return pose, hess

    def seed(self, k: int) -> Pose:
        """Keyframe k's seed: k - 1's published pose moved by the INS's
        motion from k - 1 to k."""
        dt = self.prec.dtype
        ins_rel = c.compose(c.inverse(c.pose_to(self.ins_pose_end(k - 1), dt, self.dev)),
                            c.pose_to(self.ins_pose_end(k), dt, self.dev))
        return c.compose(self.pose(k - 1), ins_rel)

    def register(self, k: int) -> Registration:
        """Keyframe k's registration (k >= 1)."""
        if k in self._reg:
            return self._reg[k]
        prec, reg, fu = self.prec, self.reg, self.fu
        dt = prec.dtype
        prev = self.pose(k - 1)
        p_prev, m_prev, _ = self.sweep(k - 1)
        guess = self.seed(k)
        pts, mask, _ = self.sweep(k)
        origin = torch.as_tensor(np.asarray(self.map_origin(k), np.float32), device=self.dev)
        vm = c.build_map(c.transform(prev, p_prev, prec), m_prev, origin, self.res, int(reg["map_capacity"]),
                         int(reg["min_points_per_voxel"]), prec)
        res, hess = self.newton(k, vm, pts, mask, guess)
        # the deviation gate (pipeline.cpp:570-592), blended on the geodesic
        dev = c.compose(c.inverse(guess), res)
        w_t = max(0.0, 1.0 - float(torch.linalg.vector_norm(dev.trans)) / float(fu["max_trans_deviation"]))
        w_r = max(0.0, 1.0 - float(torch.linalg.vector_norm(c.so3_log(dev.rot))) / float(fu["max_rot_deviation"]))
        w = min(w_t, w_r)
        blend = c.retract(guess, w * c.local(guess, res))
        # the LiDAR covariance (pipeline.cpp:594-603) and its floors
        eye = torch.eye(6, dtype=dt, device=self.dev)
        cov = -torch.linalg.inv(hess + COV_EPS * eye)
        cov = 0.5 * (cov + cov.t())
        ev, evec = torch.linalg.eigh(cov)
        cov = (evec * torch.clamp(ev, min=1e-12)[None, :]) @ evec.t()
        floor = torch.tensor([reg["lidar_rot_sigma_floor"]] * 3 + [reg["lidar_trans_sigma_floor"]] * 3,
                             dtype=dt, device=self.dev)
        cov = cov + torch.diag(floor * floor)
        out = Registration(guess, res, blend, cov, w, c.compose(c.inverse(prev), blend))
        self._reg[k] = out
        while len(self._reg) > 4 * self.W:
            self._reg.pop(next(iter(self._reg)))
        return out

    # --- the window ---

    def keyframe(self, j: int):
        """(published Pose, marginal covariance (6, 6), blend weight) of
        keyframe j >= 1."""
        dt, dev = self.prec.dtype, self.dev
        s0 = max(0, j - self.W + 1)
        states = list(range(s0, j + 1))
        newest = self.register(j)
        init = [self.pose(s) for s in states[:-1]] + [newest.blend]
        priors = [c.pose_to(self.ins_pose_end(s), dt, dev) for s in states]
        p_si = torch.stack([torch.diag(torch.as_tensor(1.0 / self.prior_sigma(s), dtype=dt, device=dev))
                            for s in states])
        betweens = [self.register(s) for s in states[1:]]
        b_rel = Pose(torch.stack([b.rel.rot for b in betweens]), torch.stack([b.rel.trans for b in betweens]))
        b_si = torch.stack([torch.linalg.inv(torch.linalg.cholesky(b.cov)) for b in betweens])
        prior = Pose(torch.stack([p.rot for p in priors]), torch.stack([p.trans for p in priors]))
        n = len(states)

        def residual(x: Pose, delta):
            y = c.retract(x, delta.reshape(n, 6))
            r_p = torch.einsum("sij,sj->si", p_si, c.local(prior, y))
            rel = c.compose(c.inverse(Pose(y.rot[:-1], y.trans[:-1])), Pose(y.rot[1:], y.trans[1:]))
            r_b = torch.einsum("sij,sj->si", b_si, c.local(b_rel, rel))
            return torch.cat([r_p.reshape(-1), r_b.reshape(-1)])

        x = Pose(torch.stack([p.rot for p in init]), torch.stack([p.trans for p in init]))
        zero = torch.zeros(6 * n, dtype=dt, device=dev)
        r = residual(x, zero)
        cost = float(r @ r)
        for _ in range(SMOOTHER_ITERS):
            J = torch.func.jacfwd(lambda d: residual(x, d))(zero)
            H = self.prec.mm(J.t(), J)
            delta = torch.linalg.solve(H, -self.prec.mm(J.t(), r[:, None])[:, 0])
            x_new = c.retract(x, delta.reshape(n, 6))
            r_new = residual(x_new, zero)
            if float(r_new @ r_new) > cost:
                break
            x, r, cost = x_new, r_new, float(r_new @ r_new)
            if float(torch.linalg.vector_norm(delta)) < SMOOTHER_TOL:
                break
        J = torch.func.jacfwd(lambda d: residual(x, d))(zero)
        H = self.prec.mm(J.t(), J)
        cov = torch.linalg.inv(H)[-6:, -6:]
        return Pose(x.rot[-1], x.trans[-1]), cov, newest.w

    # --- the work of the pair kernel, from this reference's Newton ---

    def kernel_work(self, j: int, costs) -> tuple:
        """(operations, bytes) of keyframe j's NDT pair-kernel calls (K = 1):
        one a Newton step this reference takes, inner steps that are
        dropped included, each over the rows of its lookup."""
        self.register(j)
        N = self.sweep(j)[0].shape[0]
        ops = nbytes = 0
        for n_active, pairs, rows in self.evaluations[j]:
            ops += n_active * costs.FLOPS_POINT["ndt_pair"] + pairs * costs.FLOPS_PAIR["ndt_pair"]
            nbytes += costs.call_bytes(rows, N, 1)
        return ops, nbytes


def published(rec, js, prec: Prec = F64, half: bool = False):
    """{j: (rot, trans, cov)} host float64 of the reference at ``prec``
    (``half``: with the fault of half of each sweep left out)."""
    ref = Reference(rec, prec, half)
    out = {}
    for j in js:
        pose, cov, _ = ref.keyframe(j)
        out[j] = tuple(x.detach().double().cpu().numpy() for x in (pose.rot, pose.trans, cov))
    return out


gaps = c.gaps


def _near_pi(a: Pose, b: Pose, margin: float) -> bool:
    """Whether the short arc between the headings of a and b comes within
    ``margin`` of +-pi."""
    ya, yb = _yaw(a.rot), _yaw(b.rot)
    return _crosses_pi(ya, yb) or min(math.pi - abs(ya), math.pi - abs(yb)) < margin


def crossing_keyframes(ref: "Reference", last: int):
    """Keyframes from the end of the warm-up to ``last`` at which the INS
    heading passes +-pi, or at which the seed and the registration that the
    deviation gate blends lie on an arc that passes within 1 mrad of +-pi
    (where a blend in global Logmap coordinates parts from the geodesic).
    The registration is worked out at every keyframe whose seed heads within
    ``max_rot_deviation`` of +-pi: a pair further apart is not blended."""
    out = []
    max_rd = float(ref.fu["max_rot_deviation"])
    y_prev = _yaw(ref.ins_pose_end(int(ref.rec.cfg["warmup_keyframes"]) - 1).rot)
    for j in range(int(ref.rec.cfg["warmup_keyframes"]), last + 1):
        y = _yaw(ref.ins_pose_end(j).rot)
        hit = _crosses_pi(y_prev, y)
        y_prev = y
        if not hit and j - 1 in ref.rec.published and math.pi - abs(_yaw(ref.seed(j).rot)) < max_rd:
            r = ref.register(j)
            hit = _near_pi(r.seed, r.pose, 1e-3)
        if hit:
            out.append(j)
    return out


def point_gaps(rec, kept, held, js, prec: Prec = F64):
    """``points_gap``: the most points by which the port's count of kept
    points differs from the reference's, over the keyframes ``js``, or that
    are kept on one side only, over the target clouds; ``target_gap_mm``:
    the widest gap of a target point kept on both sides (the reference's
    sweep placed at the pose the port published, or at the INS prior where
    none is recorded); ``w_gap``: the largest gap of the blend weight the
    port recorded; and, redone at every keyframe where the heading passes
    +-pi, ``cross_pose_gap_mm``, ``cross_rot_gap_urad``, ``cross_cov_gap``
    (``cross_keyframes``: how many, printed). ``kept`` maps a keyframe to
    its count, or to (count, blend weight)."""
    ref = Reference(rec, prec)
    worst = {"points_gap": 0, "target_gap_mm": 0.0, "w_gap": 0.0}
    for j in js:
        count, w = kept[j] if isinstance(kept[j], tuple) else (kept[j], None)
        worst["points_gap"] = max(worst["points_gap"], abs(int(count) - int(ref.sweep(j)[1].sum())))
        if w is not None:
            worst["w_gap"] = max(worst["w_gap"], abs(float(w) - ref.register(j).w))
    for j, (pts, mask) in held.items():
        p, m, prior = ref.sweep(j)
        m = m.cpu().numpy()
        worst["points_gap"] = max(worst["points_gap"], int((m != mask).sum()))
        both = m & mask
        if both.any():
            at = ref.pose(j) if j in rec.published else prior
            world = c.transform(at, p, prec).double().cpu().numpy()
            d = np.linalg.norm(world[both] - pts[both], axis=1)
            worst["target_gap_mm"] = max(worst["target_gap_mm"], 1e3 * float(d.max()))
    cross = crossing_keyframes(ref, max(js)) if js and rec.published else []
    mine = {j: rec.published[j] for j in cross}
    theirs = {}
    for j in cross:
        pose, cov, _ = ref.keyframe(j)
        theirs[j] = tuple(x.detach().double().cpu().numpy() for x in (pose.rot, pose.trans, cov))
    worst.update({"cross_" + k: v for k, v in c.gaps(mine, theirs).items()})
    worst["cross_keyframes"] = len(cross)
    return worst


def kernel_work(rec, js, costs):
    ref = Reference(rec)
    ops = nbytes = 0
    for j in js:
        o, b = ref.kernel_work(j, costs)
        ops, nbytes = ops + o, nbytes + b
    return ops, nbytes
