"""Plain reference of the lo_svn keyframe, and the comparison that decides
``correct`` for a configuration with ``"app": "lo_svn"``.

For a keyframe j it works out again, from the generated inputs alone (the
decoded channels' ranges, the column timestamps, the INS samples as
encoded) and the configuration:

- the sweep, projected and deskewed between the INS poses at its first and
  last column, and the INS prior at its end;
- the Gaussian map of the last rebuild keyframe r <= j (every
  ``map_rebuild_every`` keyframes), from the ring clouds that rebuild used
  (the ``keyframe_window`` keyframes before r, less the newest
  ``map_exclude_recent``), each at its INS pose;
- the SVN particle flow (DIRECT7 neighbours looked up at the particle mean,
  the NDT pair math for every particle, the Stein update) from the particle
  draws of keyframe j, which the configured seed determines;
- the plane-to-plane polish from the prior (each step's neighbours at its
  own pose, the plane-regularized target covariances and the stencil source
  covariances), which gives the published pose, and the particles'
  covariance at it, which is the published covariance.

It compares that with what the port published for j: the gap of the
translations (mm), of the rotations (urad), and of the covariances (relative
Frobenius). It also compares the points: the count the port kept of each
sampled sweep, and the ring of the newest keyframes' clouds that the port
holds at the end of the run (decoded, projected, deskewed and placed at
their INS poses, the clouds its next map is built from), point by point.
The port's RegMap, its row lookup and its CUDA kernels have no counterpart
here: the reference searches the voxel map itself.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import common as c
from .common import F64, Pose, Prec

INIT_SIGMAS = (0.01, 0.01, 0.02, 0.05, 0.05, 0.05)

# limits of the compared numbers (see PERF.md, "Correctness", for the
# readings they were set from); the rotation gap is printed, not compared:
# the control reads under three times what sound runs do
LIMITS = {"pose_gap_mm": 2.0, "cov_gap": 4.5e-4, "points_gap": 0, "ring_gap_mm": 2.0}


class Reference(c.Inputs):
    def __init__(self, rec, prec: Prec = F64, half: bool = False):
        super().__init__(rec, prec, half, rec.cfg["register"]["svn_resolution"])
        self.K = int(self.reg["svn_particles"])
        self.seed = int(rec.cfg.get("app_args", {}).get("seed", 1337))
        self._maps: Dict[int, tuple] = {}

    def rebuild_of(self, j: int) -> int:
        every = max(int(self.reg["map_rebuild_every"]), 1)
        return 1 + ((j - 1) // every) * every

    def ring_of(self, r: int) -> List[int]:
        """The keyframes whose clouds the rebuild at keyframe r uses."""
        W = int(self.reg["keyframe_window"])
        e = int(self.reg["map_exclude_recent"])
        if e > 0:
            e = min(e, max(min(r, W) - 1, 0))
        return [k for k in range(max(0, r - W), r) if r - 1 - k >= e]

    def vmap(self, j: int):
        """(voxel map, plane-regularized covariances) registered against at j."""
        r = self.rebuild_of(j)
        if r not in self._maps:
            clouds, masks = [], []
            for k in self.ring_of(r):
                pts, mask, prior = self.sweep(k)
                clouds.append(c.transform(prior, pts, self.prec))
                masks.append(mask)
            vm = self.map_of(torch.cat(clouds), torch.cat(masks))
            self._maps[r] = (vm, c.regularize_plane_covariance(vm.cov))
            while len(self._maps) > 3:
                self._maps.pop(next(iter(self._maps)))
        return self._maps[r]

    def draws(self, j: int) -> torch.Tensor:
        """Keyframe j's (K, 6) standard-normal particle draws: the j-th
        draw from a generator on the device seeded with the app's seed."""
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(self.seed)
        for _ in range(j - 1):
            torch.randn((self.K, 6), generator=gen, device=self.dev)
        return torch.randn((self.K, 6), generator=gen, device=self.dev)

    # --- the keyframe ---

    def keyframe(self, j: int):
        """(published Pose, posterior covariance (6, 6)) of keyframe j."""
        prec, reg = self.prec, self.reg
        dt = prec.dtype
        pts, mask, prior = self.sweep(j)
        vm, cov_r = self.vmap(j)
        d1, d2 = c.gauss_constants(self.res, float(reg["svn_outlier_ratio"]))
        K = self.K
        I6 = torch.eye(6, dtype=dt, device=self.dev)
        sigmas = torch.tensor(INIT_SIGMAS, dtype=dt, device=self.dev)
        prior_b = Pose(prior.rot.expand(K, 3, 3), prior.trans.expand(K, 3))
        parts = c.retract(prior_b, sigmas * self.draws(j).to(dt))
        mean = prior
        converged = False
        h, step, stop = float(reg["svn_kernel_h"]), float(reg["svn_step_size"]), float(reg["svn_stop_thresh"])
        for _ in range(int(reg["svn_max_iterations"])):
            if converged:
                break
            idx, valid = c.neighbors(vm, c.transform(mean, pts, prec), mask)
            obj = c.ndt_objective(pts, vm.mean[idx], vm.icov[idx], valid, parts, d1, d2, prec)
            fin = torch.isfinite(obj.grad).all(1)
            grads = torch.where(fin[:, None], obj.grad, 0.0)
            hess = torch.where(torch.isfinite(obj.hess).reshape(K, -1).all(1)[:, None, None], obj.hess, I6)
            inv = c.inverse(parts)
            rel = c.compose(Pose(inv.rot[:, None], inv.trans[:, None]), Pose(parts.rot[None], parts.trans[None]))
            diff = c.logmap(rel)
            kval = torch.exp(-torch.sum(diff * diff, -1) / h)
            kgrad = kval[..., None] * (-2.0 / h) * diff
            phi = (torch.einsum("lk,la->ka", prec.r(kval), prec.r(grads)) + kgrad.sum(0)) / K
            Ht = (torch.einsum("lk,lab->kab", prec.r(kval * kval), prec.r(hess))
                  + torch.einsum("lka,lkb->kab", prec.r(kgrad), prec.r(kgrad))) / K + 1e-6 * I6
            upd = torch.linalg.solve(Ht, -phi[..., None])[..., 0]
            upd = torch.where(torch.isfinite(upd).all(1)[:, None], upd, 0.0)
            parts = c.retract(parts, step * upd)
            mean_now = c.retract(prior, torch.sum(c.local(prior_b, parts), 0) / K)
            converged = bool(torch.linalg.vector_norm(c.local(mean, mean_now)) < stop)
            mean = mean_now
        # the polish from the prior, on the plane-to-plane cost
        if str(reg["svn_polish_from"]) != "prior" or str(reg["svn_polish_objective"]) != "gicp_aniso":
            raise ValueError("this reference polishes from the prior on the plane-to-plane cost")
        scov = c.stencil_covariances(pts, mask, self.grid)
        pose = prior
        for _ in range(int(reg["svn_polish_iters"])):
            idx, valid = c.neighbors(vm, c.transform(pose, pts, prec), mask)
            one = Pose(pose.rot[None], pose.trans[None])
            obj = c.aniso_objective(pts, scov, vm.mean[idx], cov_r[idx], valid, one, prec)
            st = torch.linalg.solve(obj.hess[0], -obj.grad[0])
            st = torch.where(torch.isfinite(st).all(), st, 0.0)
            st = st * torch.clamp(0.25 / torch.clamp(torch.linalg.vector_norm(st), min=1e-30), max=1.0)
            pose = c.retract(pose, st)
        mean_b = Pose(pose.rot.expand(K, 3, 3), pose.trans.expand(K, 3))
        tang = c.local(mean_b, parts)
        cen = tang - tang.mean(0, keepdim=True)
        cov = prec.mm(cen.t(), cen) / (K - 1)
        ev, evec = torch.linalg.eigh(0.5 * (cov + cov.t()))
        cov = (evec * torch.clamp(ev, min=1e-9)[None, :]) @ evec.t()
        return pose, cov

    # --- the work of the pair kernels, from this reference's map ---

    def kernel_work(self, j: int, pose: Pose, costs) -> tuple:
        """(operations, bytes) of keyframe j's pair-kernel calls at its
        published pose: ``svn_max_iterations`` NDT calls at K particles and
        ``svn_polish_iters`` plane-to-plane calls at K = 1."""
        pts, mask, _ = self.sweep(j)
        vm, _ = self.vmap(j)
        pose = c.pose_to(pose, self.prec.dtype, self.dev)
        wp = c.transform(pose, pts, self.prec)
        _, valid = c.neighbors(vm, wp, mask)
        active = valid.any(1)
        pairs, n_active = int(valid.sum()), int(active.sum())
        cells = c.pack(c.voxel_coords(wp[active], vm.origin, vm.resolution))
        rows = int(torch.unique(cells).numel())
        N = pts.shape[0]
        it, pol = int(self.reg["svn_max_iterations"]), int(self.reg["svn_polish_iters"])
        ops = (it * self.K * (n_active * costs.FLOPS_POINT["ndt_pair"] + pairs * costs.FLOPS_PAIR["ndt_pair"])
               + pol * (n_active * costs.FLOPS_POINT["aniso_pair"] + pairs * costs.FLOPS_PAIR["aniso_pair"]))
        nbytes = (it * costs.call_bytes(rows, N, self.K) + pol * costs.call_bytes(rows, N, 1, aniso=True))
        return ops, nbytes


def published(rec, js, prec: Prec = F64, half: bool = False):
    """{j: (rot, trans, cov)} host float64 of the reference at ``prec``
    (``half``: with the fault of half of each sweep left out)."""
    ref = Reference(rec, prec, half)
    out = {}
    for j in js:
        pose, cov = ref.keyframe(j)
        out[j] = tuple(x.detach().double().cpu().numpy() for x in (pose.rot, pose.trans, cov))
    return out


gaps = c.gaps


def point_gaps(rec, kept, ring, js, prec: Prec = F64):
    """``points_gap``: the most points by which the port's count of kept
    points differs from the reference's, over the keyframes ``js``, or that
    are kept on one side only, over the ring's keyframes; ``ring_gap_mm``:
    the widest gap of a ring point kept on both sides."""
    ref = Reference(rec, prec)
    worst = {"points_gap": 0, "ring_gap_mm": 0.0}
    for j in js:
        worst["points_gap"] = max(worst["points_gap"], abs(int(kept[j]) - int(ref.sweep(j)[1].sum())))
    for j, (pts, mask) in ring.items():
        p, m, prior = ref.sweep(j)
        m = m.cpu().numpy()
        worst["points_gap"] = max(worst["points_gap"], int((m != mask).sum()))
        both = m & mask
        if both.any():
            world = c.transform(prior, p, prec).double().cpu().numpy()
            d = np.linalg.norm(world[both] - pts[both], axis=1)
            worst["ring_gap_mm"] = max(worst["ring_gap_mm"], 1e3 * float(d.max()))
    return worst


def kernel_work(rec, js, costs):
    ref = Reference(rec)
    ops = nbytes = 0
    for j in js:
        R, t, _ = rec.published[j]
        o, b = ref.kernel_work(j, Pose(R, t), costs)
        ops, nbytes = ops + o, nbytes + b
    return ops, nbytes
