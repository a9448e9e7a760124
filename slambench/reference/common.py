"""Plain PyTorch/NumPy pieces shared by the apps' references: the sensor
stream worked out again from the generated inputs (decoded ranges and
timestamps, the INS poses, projection, deskew), the Gaussian voxel map
with its DIRECT7 lookup, SE(3) algebra and the pair math of the NDT and
plane-to-plane costs.

Each is a frozen copy of the semantics the port states (copied from
slamtpu_torch/core/{se3,so3}.py, ins/anpp.py's interpolation,
lidar/{project,deskew}.py, mapping/gaussian_map.py, ndt/gicp.py's plane
model and stencil covariances, ndt/fused_math.py's plain pair math and
ndt/constants.py), written for any dtype and without the port's layout
tricks (no RegMap, no fixed-order scans). Nothing here imports the port.

``Prec`` is the precision a computation runs in: float64 for the
reference, float32 with every matrix product's inputs rounded to TF32
(10 mantissa bits) for the control.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import sensor as sn

GRID_DIM = 1024
DIRECT7 = ((0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1))
MAX_EXPONENT_ARG = 50.0
MIN_FACTOR = 1e-15
SECONDS_PER_DAY = 86400.0


class Prec(NamedTuple):
    dtype: torch.dtype = torch.float64
    tf32: bool = False

    def r(self, x: torch.Tensor) -> torch.Tensor:
        """A matrix product's input as the precision feeds it."""
        if not self.tf32:
            return x
        i = x.to(torch.float32).contiguous().view(torch.int32)
        return ((i + 0x1000) & ~0x1FFF).view(torch.float32)

    def mm(self, a, b):
        return self.r(a) @ self.r(b)


F64 = Prec()
TF32 = Prec(torch.float32, True)


# --- SO(3) / SE(3), GTSAM conventions: tangent [omega, v], right retraction ---


class Pose(NamedTuple):
    rot: torch.Tensor
    trans: torch.Tensor


def hat(w):
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([torch.stack([z, -wz, wy], -1), torch.stack([wz, z, -wx], -1),
                        torch.stack([-wy, wx, z], -1)], -2)


def _small(theta_sq):
    small = theta_sq < 1e-8
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    return small, safe_sq, torch.sqrt(safe_sq)


def so3_exp(w):
    th2 = torch.sum(w * w, -1)
    small, sq, t = _small(th2)
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(t)) / sq)
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * (W @ W)


def left_jacobian(w):
    th2 = torch.sum(w * w, -1)
    small, sq, t = _small(th2)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(t)) / sq)
    c = torch.where(small, 1.0 / 6.0 - th2 / 120.0, (t - torch.sin(t)) / (sq * t))
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + b[..., None, None] * W + c[..., None, None] * (W @ W)


def left_jacobian_inv(w):
    th2 = torch.sum(w * w, -1)
    small, sq, t = _small(th2)
    cot = torch.where(small, 1.0 / 12.0 + th2 / 720.0,
                      1.0 / sq - (1.0 + torch.cos(t)) / (2.0 * t * torch.sin(t)))
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye - 0.5 * W + cot[..., None, None] * (W @ W)


def so3_log(R):
    """Rotation vector of R (through the quaternion, stable up to pi)."""
    r00, r01, r02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    r10, r11, r12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    cands = torch.stack([
        torch.stack([1.0 + r00 + r11 + r22, r21 - r12, r02 - r20, r10 - r01], -1),
        torch.stack([r21 - r12, 1.0 + r00 - r11 - r22, r01 + r10, r02 + r20], -1),
        torch.stack([r02 - r20, r01 + r10, 1.0 - r00 + r11 - r22, r12 + r21], -1),
        torch.stack([r10 - r01, r02 + r20, r12 + r21, 1.0 - r00 - r11 + r22], -1),
    ], -2)
    piv = torch.stack([cands[..., i, i] for i in range(4)], -1)
    idx = torch.argmax(piv, -1)[..., None, None].expand(piv.shape[:-1] + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    q = q * torch.where(q[..., 0:1] < 0, -1.0, 1.0)
    qw, qv = q[..., 0], q[..., 1:]
    vn = torch.linalg.vector_norm(qv, dim=-1)
    small = vn < 1e-8
    scale = torch.where(small, 2.0 / torch.clamp(qw, min=0.5),
                        2.0 * torch.atan2(vn, qw) / torch.where(small, torch.ones_like(vn), vn))
    return qv * scale[..., None]


def _mv(A, v):
    return (A @ v[..., None])[..., 0]


def expmap(xi) -> Pose:
    w, v = xi[..., :3], xi[..., 3:]
    return Pose(so3_exp(w), _mv(left_jacobian(w), v))


def logmap(p: Pose):
    w = so3_log(p.rot)
    return torch.cat([w, _mv(left_jacobian_inv(w), p.trans)], -1)


def compose(a: Pose, b: Pose) -> Pose:
    return Pose(a.rot @ b.rot, _mv(a.rot, b.trans) + a.trans)


def inverse(p: Pose) -> Pose:
    rt = p.rot.transpose(-1, -2)
    return Pose(rt, -_mv(rt, p.trans))


def retract(p: Pose, xi) -> Pose:
    return compose(p, expmap(xi))


def local(a: Pose, b: Pose):
    return logmap(compose(inverse(a), b))


def transform(p: Pose, pts, prec: Prec = F64):
    return prec.mm(pts, p.rot.transpose(-1, -2)) + p.trans[..., None, :]


def pose_to(p: Pose, dtype, device) -> Pose:
    return Pose(torch.as_tensor(np.asarray(p.rot), dtype=dtype, device=device),
                torch.as_tensor(np.asarray(p.trans), dtype=dtype, device=device))


# --- the INS stream as decoded ---


def _slerp(q0, q1, t):
    q0, q1 = np.asarray(q0, np.float64), np.asarray(q1, np.float64)
    dot = float(q0 @ q1)
    if dot < 0.0:
        q1, dot = -q1, -dot
    dot = min(dot, 1.0)
    theta = float(np.arccos(dot))
    s = float(np.sin(theta))
    if s < 1e-6:
        w0, w1 = 1.0 - t, t
    else:
        w0, w1 = float(np.sin((1.0 - t) * theta)) / s, float(np.sin(t * theta)) / s
    q = w0 * q0 + w1 * q1
    return q / np.linalg.norm(q)


class InsStream:
    """The INS samples of a Lap as a decoder reads them, and the body pose
    at any time in the NED frame of a reference position."""

    def __init__(self, lap):
        self.lap = lap

    def sample(self, m: int):
        """(t as decoded, lla, quaternion) of nav sample m."""
        lap = self.lap
        t = lap.nav_time(m)
        secs = int(t)
        usecs = int(round((t - secs) * 1e6))
        k = lap._phase(m)
        r, p, y = (np.float32(v) for v in lap.nav_rpy[k])
        return (secs + usecs * 1e-6) % SECONDS_PER_DAY, lap.nav_lla[k], sn.euler_zyx_to_quat(r, p, y)

    def at(self, t: float):
        """(lla, quaternion) interpolated at time t."""
        lap = self.lap
        m = math.floor((t - lap.t0) * lap.nav_hz)
        for m0 in (m - 1, m, m + 1):
            ta, la, qa = self.sample(m0)
            tb, lb, qb = self.sample(m0 + 1)
            if ta <= t <= tb:
                u = (t - ta) / (tb - ta) if (tb - ta) > 1e-9 else 0.0
                u = float(np.clip(u, 0.0, 1.0))
                return la + u * (lb - la), _slerp(qa, qb, u)
        raise ValueError(f"no nav samples around t = {t}")

    def pose(self, t: float, ref_lla) -> Pose:
        """Host float64 body pose (numpy) in NED around ``ref_lla``."""
        lla, q = self.at(t)
        return Pose(sn.quat_to_rot(q), sn.lla2ned(np.asarray(lla, np.float64), np.asarray(ref_lla)))


# --- one sweep: decoded, projected, deskewed ---


class Sweep(NamedTuple):
    points: torch.Tensor  # (cols*sub, 3) body frame at the sweep's end, deskewed
    mask: torch.Tensor  # (cols*sub,)
    t_first: float
    t_end: float


def sweep_times(lap, g: int):
    ts = np.fmod(lap.col_ts_ns(g).astype(np.float64) * 1e-9, SECONDS_PER_DAY)
    return ts, float(ts.min()), float(ts.max())


def project(lap, g: int, luts, rng, prec: Prec, device):
    """(points (cols*sub, 3), mask, alpha (cols*sub,)) of sweep g."""
    dirs, offs = luts
    r = lap.ranges_of(g).to(device=device, dtype=prec.dtype) * 1e-3  # (cols, sub)
    pts = r[..., None] * dirs.to(prec.dtype) + offs.to(prec.dtype)[:, None, :]
    keep = (r >= rng[0]) & (r <= rng[1]) & (r > 0.0)
    ts, t0, t1 = sweep_times(lap, g)
    alpha = torch.as_tensor(np.clip((ts - t0) / max(t1 - t0, 1e-12), 0.0, 1.0), dtype=prec.dtype,
                            device=device)
    alpha = alpha[:, None].expand(r.shape)
    n = r.shape[0] * r.shape[1]
    return pts.reshape(n, 3), keep.reshape(n), alpha.reshape(n)


def deskew(points, alpha, pose_s: Pose, pose_e: Pose, prec: Prec):
    """Points re-expressed in the end-of-sweep frame: Exp(-(1 - a) xi) p."""
    xi = local(pose_s, pose_e)
    T = expmap(-(1.0 - alpha)[:, None] * xi[None, :])
    return (prec.r(T.rot) @ prec.r(points)[..., None])[..., 0] + T.trans


# --- Gaussian voxel map ---


class VoxelMap(NamedTuple):
    keys: torch.Tensor  # (V,) int64 sorted
    mean: torch.Tensor  # (V, 3)
    cov: torch.Tensor  # (V, 3, 3) inflated covariance
    icov: torch.Tensor  # (V, 3, 3)
    valid: torch.Tensor  # (V,)
    origin: torch.Tensor  # (3,)
    resolution: float


def voxel_coords(points, origin, resolution):
    return torch.floor((points - origin) / resolution).to(torch.int64)


def pack(c):
    ok = ((c >= 0) & (c < GRID_DIM)).all(-1)
    return torch.where(ok, (c[..., 0] * GRID_DIM + c[..., 1]) * GRID_DIM + c[..., 2], -1)


def build_map(points, mask, origin, resolution: float, capacity: int, min_points: int,
              prec: Prec, eig_mult: float = 0.01) -> VoxelMap:
    """Per-voxel mean and Bessel-corrected covariance from corner-relative
    sums, eigenvalues inflated to ``eig_mult`` of the largest, the validity
    gates of the port's map; at most ``capacity`` voxels, the smallest keys."""
    dt = prec.dtype
    points = points.to(dt)
    origin = origin.to(dt)
    finite = torch.isfinite(points).all(-1)
    c = voxel_coords(points, origin, resolution)
    key = pack(c)
    use = mask & finite & (key >= 0)
    key, c, p = key[use], c[use], points[use]
    rel = p - (c.to(dt) * resolution + origin)
    keys, inv = torch.unique(key, sorted=True, return_inverse=True)
    V = keys.shape[0]
    n = torch.zeros(V, dtype=dt, device=p.device).index_add_(0, inv, torch.ones_like(rel[:, 0]))
    sx = torch.zeros((V, 3), dtype=dt, device=p.device).index_add_(0, inv, rel)
    outer = (rel[:, :, None] * rel[:, None, :]).reshape(-1, 9)
    sxx = torch.zeros((V, 9), dtype=dt, device=p.device).index_add_(0, inv, outer).view(V, 3, 3)
    keys, n, sx, sxx = keys[:capacity], n[:capacity], sx[:capacity], sxx[:capacity]
    corner = torch.stack([keys // (GRID_DIM * GRID_DIM), (keys // GRID_DIM) % GRID_DIM,
                          keys % GRID_DIM], -1).to(dt) * resolution + origin
    rm = sx / n[:, None]
    mean = rm + corner
    cov = sxx / n[:, None, None] - rm[:, :, None] * rm[:, None, :]
    cov = cov * (n / torch.clamp(n - 1.0, min=1.0))[:, None, None]
    cov = 0.5 * (cov + cov.transpose(1, 2))
    evals, evecs = torch.linalg.eigh(cov)
    psd_ok = (evals[:, 0] >= 0.0) & (evals[:, 1] >= 0.0) & (evals[:, 2] >= 1e-12)
    floor = torch.clamp(evals[:, 2] * eig_mult, min=1e-12)
    evals = torch.maximum(evals, floor[:, None])
    cov = (evecs * evals[:, None, :]) @ evecs.transpose(1, 2)
    icov = (evecs / evals[:, None, :]) @ evecs.transpose(1, 2)
    icov_ok = torch.isfinite(icov).reshape(-1, 9).all(1) & (icov.abs().amax((1, 2)) <= 1e12)
    valid = (n >= max(min_points, 3)) & psd_ok & icov_ok
    return VoxelMap(keys, mean, cov, icov, valid, origin, float(resolution))


def neighbors(vmap: VoxelMap, world_points, mask):
    """Each point's DIRECT7 voxels: (index (N, 7) into the map, valid (N, 7))."""
    c = voxel_coords(world_points, vmap.origin, vmap.resolution)
    offs = torch.as_tensor(DIRECT7, dtype=torch.int64, device=c.device)
    key = pack(c[:, None, :] + offs[None])  # (N, 7)
    V = vmap.keys.shape[0]
    idx = torch.clamp(torch.searchsorted(vmap.keys, key), max=max(V - 1, 0))
    found = (key >= 0) & (vmap.keys[idx] == key) & mask[:, None] if V else torch.zeros_like(key, dtype=torch.bool)
    valid = found & vmap.valid[idx]
    return idx, valid


# --- the plane model and source covariances (ndt/gicp.py) ---


def regularize_plane_covariance(cov, eps: float = 1e-3):
    """Eigenvalues replaced by (eps, 1, 1): I - (1 - eps) n n^T, with n from
    the closed-form smallest eigenvalue and the longest cross product of two
    rows of (C - lambda_min I)."""
    c00, c11, c22 = cov[..., 0, 0], cov[..., 1, 1], cov[..., 2, 2]
    c01 = 0.5 * (cov[..., 0, 1] + cov[..., 1, 0])
    c02 = 0.5 * (cov[..., 0, 2] + cov[..., 2, 0])
    c12 = 0.5 * (cov[..., 1, 2] + cov[..., 2, 1])
    q = (c00 + c11 + c22) / 3.0
    p1 = c01 * c01 + c02 * c02 + c12 * c12
    p2 = (c00 - q) ** 2 + (c11 - q) ** 2 + (c22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=0.0))
    ps = torch.where(p > 1e-30, p, 1.0)
    b00, b11, b22 = (c00 - q) / ps, (c11 - q) / ps, (c22 - q) / ps
    b01, b02, b12 = c01 / ps, c02 / ps, c12 / ps
    det = b00 * (b11 * b22 - b12 * b12) - b01 * (b01 * b22 - b12 * b02) + b02 * (b01 * b12 - b11 * b02)
    phi = torch.arccos(torch.clamp(0.5 * det, -1.0, 1.0)) / 3.0
    lmin = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    rows = ((c00 - lmin, c01, c02), (c01, c11 - lmin, c12), (c02, c12, c22 - lmin))

    def cross(u, v):
        return (u[1] * v[2] - u[2] * v[1], u[2] * v[0] - u[0] * v[2], u[0] * v[1] - u[1] * v[0])

    cands = [cross(rows[0], rows[1]), cross(rows[0], rows[2]), cross(rows[1], rows[2])]
    norms = [u[0] * u[0] + u[1] * u[1] + u[2] * u[2] for u in cands]
    best01 = norms[0] >= norms[1]
    n = [torch.where(best01, cands[0][i], cands[1][i]) for i in range(3)]
    use2 = norms[2] > torch.maximum(norms[0], norms[1])
    n = [torch.where(use2, cands[2][i], n[i]) for i in range(3)]
    nn = torch.sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2])
    degenerate = nn < 1e-20
    inv = torch.where(degenerate, 0.0, 1.0 / torch.where(degenerate, 1.0, nn))
    nv = torch.stack([n[0] * inv, n[1] * inv, torch.where(degenerate, 1.0, n[2] * inv)], -1)
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
    return eye - (1.0 - eps) * nv[..., :, None] * nv[..., None, :]


def stencil_covariances(points, mask, grid, col_window=2, chan_window=1, gate_rel=0.08,
                        gate_abs=0.3, fallback_sigma=0.05, min_neighbors=5, eps=1e-3):
    """(N, 3, 3) plane-regularized covariances from each point's range-image
    neighbourhood (+-2 columns wrapping, +-1 channel clamped), gated by a
    range-proportional distance; sigma^2 I below ``min_neighbors``."""
    dt = points.dtype
    cols, sub = grid
    N = points.shape[0]
    P = torch.where(mask[:, None], points, 0.0).reshape(cols, sub, 3)
    Vm = mask.reshape(cols, sub)
    r = torch.sqrt(torch.sum(P * P, -1))
    gate2 = (gate_rel * r + gate_abs) ** 2
    n = torch.zeros((cols, sub), dtype=dt, device=points.device)
    sx = torch.zeros((cols, sub, 3), dtype=dt, device=points.device)
    sxx = torch.zeros((cols, sub, 3, 3), dtype=dt, device=points.device)
    for dc in range(-col_window, col_window + 1):
        for ds in range(-chan_window, chan_window + 1):
            Q = torch.roll(P, shifts=(-dc, -ds), dims=(0, 1))
            VQ = torch.roll(Vm, shifts=(-dc, -ds), dims=(0, 1))
            if ds > 0:
                VQ[:, -ds:] = False
            elif ds < 0:
                VQ[:, :-ds] = False
            Qr = Q - P
            w = (Vm & VQ & (torch.sum(Qr * Qr, -1) <= gate2)).to(dt)
            n = n + w
            sx = sx + w[..., None] * Qr
            sxx = sxx + w[..., None, None] * (Qr[..., :, None] * Qr[..., None, :])
    nf = torch.clamp(n, min=1.0)
    mu = sx / nf[..., None]
    cov = sxx / nf[..., None, None] - mu[..., :, None] * mu[..., None, :]
    cov = cov * (nf / torch.clamp(nf - 1.0, min=1.0))[..., None, None]
    cov = regularize_plane_covariance(cov, eps)
    good = (n >= min_neighbors) & Vm
    iso = (fallback_sigma ** 2) * torch.eye(3, dtype=dt, device=points.device)
    return torch.where(good[..., None, None], cov, iso).reshape(N, 3, 3)


# --- pair math (ndt/fused_math.py's plain versions) ---


def gauss_constants(resolution: float, outlier_ratio: float):
    eps = 1e-9
    c1 = max(10.0 * (1.0 - outlier_ratio), eps)
    c2 = max(outlier_ratio / resolution ** 3, eps)
    d3 = -math.log(c2)
    d1 = -math.log(c1 + c2) - d3
    inner = c1 * math.exp(-0.5) + c2
    outer = (-math.log(inner) - d3) / d1
    d2 = -2.0 * math.log(outer)
    return d1, d2


class Objective(NamedTuple):
    score: torch.Tensor  # (K,)
    grad: torch.Tensor  # (K, 6) [omega, v]
    hess: torch.Tensor  # (K, 6, 6)
    count: torch.Tensor  # (K,)


def _finish(R, x, b, M, score, count, prec: Prec, hess_lambda: float):
    Rt = R.transpose(1, 2)[:, None]
    q = prec.mm(Rt, b[..., None])[..., 0]
    gw = torch.linalg.cross(x[None].expand_as(q), q, dim=-1).sum(1)
    gv = q.sum(1)
    P = prec.mm(prec.mm(Rt, M), R[:, None])
    hx = hat(x)
    Q = prec.mm(hx[None], P)
    W = prec.mm(Q, hx.transpose(1, 2)[None])
    Qs = Q.sum(1)
    H = torch.cat([torch.cat([W.sum(1), Qs], 2), torch.cat([Qs.transpose(1, 2), P.sum(1)], 2)], 1)
    H = H + hess_lambda * torch.eye(6, dtype=H.dtype, device=H.device)
    return Objective(score, torch.cat([gw, gv], 1), H, count)


def ndt_objective(x, mu, icov, valid, poses: Pose, d1, d2, prec: Prec, hess_lambda=1e-6):
    """NDT sums for K poses (rot (K, 3, 3)) of points x (N, 3) against
    their neighbours mu (N, 7, 3), icov (N, 7, 3, 3), valid (N, 7)."""
    tp = transform(poses, x[None], prec)  # (K, N, 3)
    xr = tp[:, :, None, :] - mu[None]
    icx = prec.mm(icov[None], xr[..., None])[..., 0]
    mahal = torch.clamp((xr * icx).sum(-1), min=0.0)
    expo = 0.5 * d2 * mahal
    ok = valid[None] & (expo <= MAX_EXPONENT_ARG)
    e = torch.exp(-torch.where(ok, expo, 0.0))
    f = d1 * d2 * e
    f = torch.where(ok & (torch.abs(f) >= MIN_FACTOR), f, 0.0)
    score = torch.where(ok, -d1 * e, 0.0).sum((1, 2))
    b = (f[..., None] * icx).sum(2)
    M = (f[..., None, None] * icov[None]).sum(2)
    return _finish(poses.rot, x, b, M, score, ok.sum((1, 2)), prec, hess_lambda)


def aniso_objective(x, scov, mu, ct, valid, pose: Pose, prec: Prec, corr2=25.0, max_mahal=9.0,
                    hess_lambda=1e-6):
    """Plane-to-plane sums at one pose (rot (1, 3, 3)): per pair
    S = C_t + R C_src R^T, a pair counting if mahal <= max_mahal and
    |xr|^2 <= corr2."""
    R = pose.rot
    tp = transform(pose, x[None], prec)
    rc = prec.mm(prec.mm(R[:, None], scov[None]), R.transpose(1, 2)[:, None])  # (1, N, 3, 3)
    Si = torch.linalg.inv(ct[None] + rc[:, :, None])
    xr = tp[:, :, None, :] - mu[None]
    icx = prec.mm(Si, xr[..., None])[..., 0]
    mahal = torch.clamp((xr * icx).sum(-1), min=0.0)
    ok = valid[None] & (mahal <= max_mahal) & ((xr * xr).sum(-1) <= corr2)
    f = torch.where(ok, -2.0, 0.0)
    score = torch.where(ok, -mahal, 0.0).sum((1, 2))
    b = (f[..., None] * icx).sum(2)
    M = (f[..., None, None] * Si).sum(2)
    return _finish(R, x, b, M, score, ok.sum((1, 2)), prec, hess_lambda)


# --- the inputs of a run's keyframes, worked out again ---


class Inputs:
    """Keyframe j's sweep (projected, deskewed), its INS poses, the NDT
    constants' resolution and the map origin, from a run's record: the
    generated lap, the configuration and the global sweep of each keyframe.
    ``half`` plants a fault: every other column of each sweep left out."""

    def __init__(self, rec, prec: Prec, half: bool, resolution: float):
        self.rec, self.prec, self.half = rec, prec, half
        cfg = rec.cfg
        self.reg = cfg["register"]
        self.dev = rec.device
        sens = sn.Sensor.from_config(cfg["sensor"])
        self.grid = (sens.columns_per_frame, len(range(0, sens.pixels_per_column, sens.channel_stride)))
        d, o = sn.build_luts(sens, sens.channel_stride)
        self.luts = (torch.as_tensor(d, device=self.dev), torch.as_tensor(o, device=self.dev))
        self.range = tuple(cfg["sensor"]["range_filter"])
        self.ins = InsStream(rec.lap)
        self.res = float(resolution)
        self.ref_lla = self.ins.at(sweep_times(rec.lap, rec.kf_sweeps[0])[2])[0]
        # the apps' map origin: 512 voxels below the first keyframe's INS position
        self.origin = np.asarray(self.ins_pose_end(0).trans - 512.0 * self.res, np.float32)
        self._sweeps = {}

    def ins_pose_end(self, j: int) -> Pose:
        """Host float64 INS pose at keyframe j's last column."""
        return self.ins.pose(sweep_times(self.rec.lap, self.rec.kf_sweeps[j])[2], self.ref_lla)

    def sweep(self, j: int):
        """(deskewed body points, mask, INS prior Pose on the device) of keyframe j."""
        if j not in self._sweeps:
            lap, g = self.rec.lap, self.rec.kf_sweeps[j]
            pts, mask, alpha = project(lap, g, self.luts, self.range, self.prec, self.dev)
            if self.half:
                mask = mask & (torch.arange(mask.shape[0], device=self.dev) // self.grid[1] % 2 == 0)
            _, t0, t1 = sweep_times(lap, g)
            dt = self.prec.dtype
            prior = pose_to(self.ins.pose(t1, self.ref_lla), dt, self.dev)
            if self.rec.cfg["deskew"]:
                ps = pose_to(self.ins.pose(t0, self.ref_lla), dt, self.dev)
                pts = deskew(pts, alpha, ps, prior, self.prec)
            self._sweeps[j] = (pts, mask, prior)
            while len(self._sweeps) > 16:
                self._sweeps.pop(next(iter(self._sweeps)))
        return self._sweeps[j]

    def map_of(self, points, mask):
        return build_map(points, mask, torch.as_tensor(self.origin, device=self.dev), self.res,
                         int(self.reg["map_capacity"]), int(self.reg["min_points_per_voxel"]), self.prec)


def gaps(mine, theirs, with_cov: bool = True):
    """The compared numbers, each the worst over the keyframes: translation
    gap (mm), rotation gap (urad), and the covariance's gap relative to the
    reference's (Frobenius)."""
    worst = {"pose_gap_mm": 0.0, "rot_gap_urad": 0.0, "cov_gap": 0.0}
    for j, (R, t, C) in mine.items():
        Rr, tr, Cr = theirs[j]
        worst["pose_gap_mm"] = max(worst["pose_gap_mm"], 1e3 * float(np.linalg.norm(t - tr)))
        dR = torch.as_tensor(Rr.T @ R)
        worst["rot_gap_urad"] = max(worst["rot_gap_urad"], 1e6 * float(torch.linalg.vector_norm(so3_log(dR))))
        worst["cov_gap"] = max(worst["cov_gap"], float(np.linalg.norm(C - Cr) / np.linalg.norm(Cr)))
    return worst
