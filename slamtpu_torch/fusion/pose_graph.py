"""Batch pose-graph optimization: sparse Gauss-Newton by preconditioned
conjugate gradients, at 10k-pose scale (port of slamtpu/fusion/pose_graph.py).

The sparse normal matrix is never formed: the product H x is taken factor
by factor (gathers, batched 6x6 products, and scatters to the nodes), and
each Gauss-Newton step solves H delta = -b by a fixed number of
block-Jacobi-preconditioned CG iterations. The factor Jacobians are written
out, as in the pose-window smoother (``smoother.logmap_derivative``,
``smoother.adjoint``), where the reference takes ``jax.jacfwd``: the
between residual S Log(rel^-1 x_i^-1 x_j) moves by S D(e) under x_j's
right perturbation and by -S D(e) Ad(x_j^-1 x_i) under x_i's; a prior
S Log(prior^-1 x_k) by S D(e). Inactive factors get exact zeros.

The scatters to the nodes add in a fixed order on either device
(``gaussian_map.segment_sum`` over the factor endpoints sorted once per
``optimize``; on the card a float64 prefix scan, where ``index_add_``'s
atomics would add in no fixed order), so a float32 solve repeats bit for
bit. The loops run as Python loops of ``gn_iterations`` x ``cg_iterations``
steps with no early exit and no host read: a solve never waits for the
device. The block preconditioner factors with ``cholesky_ex`` and inverts
with ``solve_triangular``, neither of which checks for failure; a block
that does not factor (``info > 0``) is made NaN,
as the reference's Cholesky returns it, and the NaN then runs through the
CG recurrences into the reference's zero step.

Anchor: node 0 (or any set) is pinned with ``anchor_weight`` and gets a
zero step, the usual gauge fix. Everything runs in the dtype and on the
device of ``graph.poses``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import se3
from ..core.se3 import Pose3
from ..mapping.gaussian_map import segment_sum
from .smoother import adjoint, logmap_derivative


class PoseGraph(NamedTuple):
    poses: Pose3  # (N,) batched
    i: torch.Tensor  # (F,) int32 factor endpoints
    j: torch.Tensor  # (F,)
    rel_rot: torch.Tensor  # (F, 3, 3) measured i -> j
    rel_trans: torch.Tensor  # (F, 3)
    sqrt_info: torch.Tensor  # (F, 6, 6)
    active: torch.Tensor  # (F,) bool
    anchored: torch.Tensor  # (N,) bool: nodes pinned at their current value
    # per-node absolute pose priors (the INS priors of the reference's
    # iSAM2 graph, run/pipeline.cpp:637-665)
    prior_rot: torch.Tensor  # (N, 3, 3)
    prior_trans: torch.Tensor  # (N, 3)
    prior_sqrt_info: torch.Tensor  # (N, 6, 6)
    prior_active: torch.Tensor  # (N,) bool

    @property
    def num_nodes(self) -> int:
        return self.poses.trans.shape[0]


class PoseGraphConfig(NamedTuple):
    gn_iterations: int = 10
    cg_iterations: int = 50
    damping: float = 1e-6
    anchor_weight: float = 1e6
    # Huber kernel on the whitened between-factor residual norm (IRLS):
    # factors beyond ``huber_delta`` sigmas are weighted by delta/|r|.
    # <= 0 disables.
    huber_delta: float = 0.0


class PoseGraphResult(NamedTuple):
    poses: Pose3
    error: torch.Tensor
    iterations: torch.Tensor


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def _linearize(graph: PoseGraph):
    """Per-factor whitened residuals (F, 6) and Jacobians (F, 6, 6) with
    respect to the right perturbations of both endpoints."""
    i, j = graph.i.long(), graph.j.long()
    pi = Pose3(graph.poses.rot.index_select(0, i), graph.poses.trans.index_select(0, i))
    pj = Pose3(graph.poses.rot.index_select(0, j), graph.poses.trans.index_select(0, j))
    e = se3.local(Pose3(graph.rel_rot, graph.rel_trans), se3.between(pi, pj))
    J_j = graph.sqrt_info @ logmap_derivative(e)
    J_i = -J_j @ adjoint(se3.between(pj, pi))
    m = graph.active[:, None]
    return (torch.where(m, _mv(graph.sqrt_info, e), 0.0), torch.where(m[..., None], J_i, 0.0),
            torch.where(m[..., None], J_j, 0.0))


def _linearize_priors(graph: PoseGraph):
    """Per-node prior residuals (N, 6) and Jacobians (N, 6, 6)."""
    e = se3.local(Pose3(graph.prior_rot, graph.prior_trans), graph.poses)
    m = graph.prior_active[:, None]
    return (torch.where(m, _mv(graph.prior_sqrt_info, e), 0.0),
            torch.where(m[..., None], graph.prior_sqrt_info @ logmap_derivative(e), 0.0))


def optimize(graph: PoseGraph, cfg: PoseGraphConfig = PoseGraphConfig()) -> PoseGraphResult:
    """``cfg.gn_iterations`` Gauss-Newton steps, each solved by
    ``cfg.cg_iterations`` preconditioned CG iterations.

    ``error`` is the reference's: 0.5 sum r^2 over the between factors
    only, at the returned poses, without the Huber weights and without the
    priors."""
    N = graph.num_nodes
    dtype, dev = graph.poses.trans.dtype, graph.poses.trans.device
    anchor = graph.anchored.to(dtype)[:, None] * cfg.anchor_weight
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    # both endpoints of every factor, sorted once: every scatter to the
    # nodes is one fixed-order segment sum over (F, ...) values at i then j
    i, j = graph.i.long(), graph.j.long()
    ends = torch.cat([i, j])
    order = torch.argsort(ends, stable=True)
    seg = ends.index_select(0, order)

    def scatter(at_i, at_j):
        return segment_sum(torch.cat([at_i, at_j]).index_select(0, order), seg, N)

    def gn_step(poses: Pose3) -> Pose3:
        g = graph._replace(poses=poses)
        r, Ji, Jj = _linearize(g)
        if cfg.huber_delta > 0.0:
            # IRLS: scale residuals and Jacobians by sqrt(w), w the Huber weight
            rn = torch.linalg.vector_norm(r, dim=-1)
            w = torch.where(rn > cfg.huber_delta, cfg.huber_delta / torch.clamp(rn, min=1e-30), 1.0)
            sw = torch.sqrt(w)
            r, Ji, Jj = r * sw[:, None], Ji * sw[:, None, None], Jj * sw[:, None, None]
        rp, Jp = _linearize_priors(g)
        JiT, JjT, JpT = Ji.transpose(-1, -2), Jj.transpose(-1, -2), Jp.transpose(-1, -2)

        # gradient b = J^T r at the nodes, and the diagonal 6x6 blocks of H
        b = scatter(_mv(JiT, r), _mv(JjT, r)) + _mv(JpT, rp)
        D = scatter(JiT @ Ji, JjT @ Jj) + JpT @ Jp + (cfg.damping + anchor[..., None]) * eye6
        # each block inverted through Jacobi-equilibrated Cholesky (unit
        # diagonal first: the blocks span ~1e12 between anchored and barely
        # constrained nodes); P formed explicitly, one batched product a CG
        # iteration. A block that does not factor is NaN, as the reference's.
        d = torch.rsqrt(torch.clamp(torch.diagonal(D, dim1=-2, dim2=-1), min=1e-30))
        dd = d[:, :, None] * d[:, None, :]
        L, info = torch.linalg.cholesky_ex(D * dd)
        L = torch.where(info[:, None, None] > 0, float("nan"), L)
        Linv = torch.linalg.solve_triangular(L, eye6.expand(N, 6, 6), upper=False)
        P = (Linv.transpose(-1, -2) @ Linv) * dd

        def hx(x):  # H x, the normal-equations product
            u = _mv(Ji, x.index_select(0, i)) + _mv(Jj, x.index_select(0, j))
            y = scatter(_mv(JiT, u), _mv(JjT, u))
            return y + _mv(JpT, _mv(Jp, x)) + (cfg.damping + anchor) * x

        # PCG for H delta = -b; the guards are the reference's
        x = torch.zeros((N, 6), dtype=dtype, device=dev)
        res = -b
        z = _mv(P, res)
        p = z
        for _ in range(cfg.cg_iterations):
            Hp = hx(p)
            denom = torch.sum(p * Hp)
            rz = torch.sum(res * z)
            alpha = torch.where(denom > 0, rz / torch.clamp(denom, min=1e-30), 0.0)
            x = x + alpha * p
            res = res - alpha * Hp
            z = _mv(P, res)
            beta = torch.sum(res * z) / torch.clamp(rz, min=1e-30)
            p = z + beta * p
        delta = torch.where(torch.isfinite(x), x, 0.0)
        delta = torch.where(graph.anchored[:, None], 0.0, delta)
        return se3.retract(poses, delta)

    poses = graph.poses
    for _ in range(cfg.gn_iterations):
        poses = gn_step(poses)
    final_r, _, _ = _linearize(graph._replace(poses=poses))
    iterations = torch.full((), cfg.gn_iterations, dtype=torch.int32, device=dev)
    return PoseGraphResult(poses, 0.5 * torch.sum(final_r ** 2), iterations)


def make_graph(
    poses: Pose3,
    i: torch.Tensor,
    j: torch.Tensor,
    rel: Pose3,
    sqrt_info: torch.Tensor,
    active=None,
    anchored=None,
    prior: Pose3 = None,
    prior_sqrt_info: torch.Tensor = None,
    prior_active=None,
) -> PoseGraph:
    """A PoseGraph on the device of ``poses``: every factor active and node
    0 anchored unless given; no priors unless ``prior`` is given (then all
    active unless ``prior_active`` says otherwise)."""
    N, F = poses.trans.shape[0], i.shape[0]
    dtype, dev = poses.trans.dtype, poses.trans.device
    if active is None:
        active = torch.ones((F,), dtype=torch.bool, device=dev)
    if anchored is None:
        anchored = torch.arange(N, device=dev) == 0
    if prior is None:
        prior = Pose3(torch.eye(3, dtype=dtype, device=dev).expand(N, 3, 3),
                      torch.zeros((N, 3), dtype=dtype, device=dev))
        prior_sqrt_info = torch.zeros((N, 6, 6), dtype=dtype, device=dev)
        prior_active = torch.zeros((N,), dtype=torch.bool, device=dev)
    elif prior_active is None:
        prior_active = torch.ones((N,), dtype=torch.bool, device=dev)
    return PoseGraph(poses, i.to(torch.int32), j.to(torch.int32), rel.rot, rel.trans, sqrt_info,
                     active, anchored, prior.rot, prior.trans, prior_sqrt_info, prior_active)
