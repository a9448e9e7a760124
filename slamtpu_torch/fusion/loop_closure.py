"""Loop-closure detection and pose-graph refinement (port of
slamtpu/fusion/loop_closure.py).

Keyframes are bucketed by the voxel of their position (host numpy, the
reference's spatial archive); revisited buckets within a search radius,
outside the recent temporal window, give candidate pairs. Each candidate
is verified by NDT registration of the new keyframe's cloud against a map
of the candidate's: ``origin_for`` -> ``build_map`` (2^14 voxels, at least
4 points) -> the DIRECT7 ``build_regmap`` -> Newton with one step per row
lookup and the score and Hessian at the returned pose (the reference's XLA
loop, ``newton_align_reg``), which runs the NDT pair kernel on the card.
A verified pair becomes a between factor of the batch pose graph
(``fusion.pose_graph``) that ``refine_trajectory`` solves.

The detector keeps each keyframe's body-frame cloud and mask where they
were given (on the card in the apps), as the reference keeps them on its
device: at the Berlin shape (65,536 points) about 0.85 MB a keyframe.
A verification reads its result back in one device-to-host copy.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import se3
from ..core.se3 import Pose3
from ..mapping import gaussian_map
from ..ndt.fused_math import newton_align_fused
from ..ndt.newton import NewtonConfig
from ..ndt.regmap import build_regmap
from . import pose_graph as pg
from .graph import sqrt_info_from_cov

log = logging.getLogger("slamtpu_torch.loop")


@dataclasses.dataclass
class LoopClosure:
    i: int
    j: int
    relative: Pose3  # measured i -> j, float32 tensors on the clouds' device
    covariance: np.ndarray  # (6, 6) float64
    score: float


@dataclasses.dataclass
class LoopClosureConfig:
    bucket_size: float = 10.0  # m, spatial bucket edge
    search_radius: float = 15.0  # m, candidate distance threshold
    min_keyframe_gap: int = 20  # temporal exclusion window
    max_candidates_per_keyframe: int = 2
    resolution: float = 2.0  # NDT voxel size for verification
    reg_grid_shape: tuple = (128, 128, 32)  # dense lookup grid
    max_iterations: int = 30
    min_contrib_ratio: float = 0.3  # accepted pairs / (7 x source points)
    max_fitness_error: float = 0.5  # m, translation sanity vs odometry guess


def _np(a) -> np.ndarray:
    """A host numpy array of a tensor (on any device) or array."""
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _host_pose(pose: Pose3) -> Pose3:
    return Pose3(_np(pose.rot).astype(np.float64), _np(pose.trans).astype(np.float64))


class LoopDetector:
    """Host-side spatial index + NDT verification of loop candidates.
    ``verify_ms`` holds each verification's host-clock time (it ends in a
    read of its result, so it covers the device's work)."""

    def __init__(self, cfg: LoopClosureConfig = LoopClosureConfig()):
        self.cfg = cfg
        self.buckets: Dict[Tuple[int, int, int], List[int]] = defaultdict(list)
        self.positions: List[np.ndarray] = []
        self.clouds: List[Tuple[torch.Tensor, torch.Tensor]] = []  # body-frame points, mask
        self.poses: List[Pose3] = []  # host float64
        self.verify_ms: List[float] = []

    def add_keyframe(self, pose: Pose3, points, mask) -> List[LoopClosure]:
        """Register a keyframe (pose: host arrays or tensors) and return the
        verified loop closures against it."""
        pose = _host_pose(pose)
        idx = len(self.poses)
        pos = pose.trans
        closures = []
        for cand in self._candidates(pos, idx):
            lc = self.verify_pair(cand, pose, points, mask)
            if lc is not None:
                closures.append(lc)
                if len(closures) >= self.cfg.max_candidates_per_keyframe:
                    break
        key = tuple(np.floor(pos / self.cfg.bucket_size).astype(int))
        self.buckets[key].append(idx)
        self.positions.append(pos)
        self.clouds.append((points, mask))
        self.poses.append(pose)
        return closures

    def _candidates(self, pos: np.ndarray, idx: int) -> List[int]:
        base = np.floor(pos / self.cfg.bucket_size).astype(int)
        found = []
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    for k in self.buckets.get(tuple(base + [dx, dy, dz]), ()):
                        if idx - k < self.cfg.min_keyframe_gap:
                            continue
                        if np.linalg.norm(self.positions[k] - pos) <= self.cfg.search_radius:
                            found.append(k)
        found.sort(key=lambda k: np.linalg.norm(self.positions[k] - pos))
        return found

    def verify_pair(self, k: int, pose_j: Pose3, pts_j, mask_j) -> Optional[LoopClosure]:
        """NDT-register the new keyframe's cloud (at ``pose_j``, host) against
        a map of candidate k's cloud."""
        t0 = time.perf_counter()
        cfg = self.cfg
        pts_k, mask_k = self.clouds[k]
        dev, dt = pts_k.device, pts_k.dtype
        pose_j = _host_pose(pose_j)
        # both poses in the clouds' dtype, in one copy to the device
        both = torch.as_tensor(np.stack([np.concatenate([p.rot, p.trans[:, None]], axis=1)
                                         for p in (self.poses[k], pose_j)]), dtype=dt, device=dev)
        pose_k = Pose3(both[0, :, :3], both[0, :, 3])
        world_k = se3.transform_points(pose_k, pts_k)
        origin = gaussian_map.origin_for(world_k, mask_k, cfg.resolution)
        gmap = gaussian_map.build_map(world_k, mask_k, origin, cfg.resolution, capacity=1 << 14,
                                      min_points_per_voxel=4)
        regmap = build_regmap(gmap, grid_shape=cfg.reg_grid_shape)
        res = newton_align_fused(
            pts_j, mask_j, regmap, Pose3(both[1, :, :3], both[1, :, 3]),
            NewtonConfig(resolution=cfg.resolution, max_iterations=cfg.max_iterations),
            cfg.reg_grid_shape, inner_iters=1, final_eval=True,
        )
        f64 = torch.float64
        out = _np(torch.cat([
            torch.sum(mask_j.to(torch.int32)).reshape(1).to(f64), res.n_contrib.reshape(1).to(f64),
            res.pose.trans.to(f64), res.hessian.reshape(-1).to(f64), res.score.reshape(1).to(f64),
        ]))
        self.verify_ms.append((time.perf_counter() - t0) * 1e3)
        n_src, n_contrib = int(out[0]), int(out[1])
        ratio = n_contrib / max(n_src * 7, 1)
        guess_delta = np.linalg.norm(out[2:5].astype(np.float32) - pose_j.trans.astype(np.float32))
        # the eps-convergence flag is not required: Newton can creep along
        # weakly constrained directions while the registration is good; the
        # contribution ratio and the odometry-consistency distance filter
        if ratio < cfg.min_contrib_ratio or guess_delta > cfg.max_fitness_error:
            log.info("loop %d rejected: ratio=%.2f delta=%.2f", k, ratio, guess_delta)
            return None
        H = out[5:41].reshape(6, 6)
        cov = -np.linalg.inv(H + 1e-6 * np.eye(6))
        cov = 0.5 * (cov + cov.T)
        ev, evec = np.linalg.eigh(cov)
        cov = evec @ np.diag(np.maximum(ev, 1e-9)) @ evec.T
        rel = se3.between(se3.cast(pose_k, torch.float32), res.pose)
        return LoopClosure(k, len(self.poses), rel, cov, float(out[41]))


def refine_trajectory(
    poses: List[Pose3],
    odometry_rels: List[Pose3],
    odometry_covs: List[np.ndarray],
    closures: List[LoopClosure],
    cfg: pg.PoseGraphConfig = pg.PoseGraphConfig(huber_delta=2.0),
    prior_poses: List[Pose3] = None,
    prior_sigmas: List[np.ndarray] = None,
    device="cuda",
):
    """Batch pose-graph optimization over odometry + loop-closure factors,
    on ``device`` in the dtype of ``poses`` (host arrays or tensors).

    ``prior_poses``/``prior_sigmas`` (optional, per node) add absolute pose
    priors, the INS priors of the reference's live iSAM2 graph
    (run/pipeline.cpp:637-665): without them the re-solve discards the INS
    information. The default config weights factors beyond 2 sigma by the
    Huber kernel, so an imperfect closure is downweighted. Returns the
    refined poses (tensors on ``device``) and the ``PoseGraphResult``."""
    N = len(poses)
    if len(odometry_rels) != N - 1 or len(odometry_covs) != N - 1:
        raise ValueError(f"{N} poses need {N - 1} odometry factors, got {len(odometry_rels)} "
                         f"relatives and {len(odometry_covs)} covariances")
    rot = np.stack([_np(p.rot) for p in poses])
    dtype = torch.from_numpy(rot[:1]).dtype

    def tensor(items):
        return torch.as_tensor(np.stack([_np(a) for a in items]), dtype=dtype, device=device)

    stack = Pose3(torch.as_tensor(rot, device=device), tensor([p.trans for p in poses]))
    i = torch.as_tensor(list(range(N - 1)) + [c.i for c in closures], dtype=torch.int32, device=device)
    j = torch.as_tensor(list(range(1, N)) + [c.j for c in closures], dtype=torch.int32, device=device)
    rels = list(odometry_rels) + [c.relative for c in closures]
    rel = Pose3(tensor([r.rot for r in rels]), tensor([r.trans for r in rels]))
    si = sqrt_info_from_cov(tensor(list(odometry_covs) + [c.covariance for c in closures]))
    prior = psi = None
    if prior_poses is not None:
        prior = Pose3(tensor([p.rot for p in prior_poses]), tensor([p.trans for p in prior_poses]))
        psi = torch.diag_embed(1.0 / tensor(prior_sigmas))
    graph = pg.make_graph(stack, i, j, rel, si, prior=prior, prior_sqrt_info=psi)
    result = pg.optimize(graph, cfg)
    return [Pose3(result.poses.rot[k], result.poses.trans[k]) for k in range(N)], result
