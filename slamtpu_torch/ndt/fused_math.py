"""The registration objective on pre-gathered mega rows (port of
slamtpu/ndt/pallas_math.py: ``gather_megaT`` and ``fused_objective``).

Two pair kernels carry it, each beside its plain PyTorch version:

- ``ndt_pair``   (CUDA ``ndt_pair_kernel``,   plain ``_ndt_pair_plain``):
  the NDT pair math, K poses in one launch (SVN stage 1);
- ``aniso_pair`` (CUDA ``aniso_pair_kernel``, plain ``_aniso_pair_plain``):
  plane-to-plane GICP against the aux payload (the SVN polish).

Each takes params (K, 16) = R(9), t(3), d1, d2, mode (0), max_mahal and
returns (K, 44) sums: score, grad [omega, v] (6), Hessian (36), count. A
wrapper runs the plain version only for CPU tensors; for CUDA tensors it
launches the kernel (``csrc/ndt_pair.cu``, built at first launch) or
raises. ``LAUNCHES`` counts kernel launches, and only those.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..core.se3 import Pose3
from .objective import MAX_EXPONENT_ARG, MIN_FACTOR, NdtObjective
from .regmap import RegMap, point_rows

LAUNCHES = {"ndt_pair": 0, "aniso_pair": 0}

_lock = threading.Lock()
_lib = None


def _load():
    """Build (first use) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            from ..cuda_build import build_library

            lib = ctypes.CDLL(build_library(("ndt_pair.cu",), "ndt_pair"))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.ndt_pair_launch.argtypes = [vp, vp, vp, ci, ci, vp, vp, vp]
            lib.ndt_pair_launch.restype = ci
            lib.aniso_pair_launch.argtypes = [vp, vp, vp, vp, ci, ci, vp, vp, vp]
            lib.aniso_pair_launch.restype = ci
            lib.ndt_pair_threads.argtypes = []
            lib.ndt_pair_threads.restype = ci
            lib.ndt_pair_error_string.argtypes = [ci]
            lib.ndt_pair_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _device_of(*tensors) -> torch.device:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"pair kernel inputs on several devices: {[str(t.device) for t in tensors]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"pair kernels run on cpu (plain) or cuda, not {dev}")
    return dev


def _check_inputs(params, ptsT, megaT, scovT=None):
    N = ptsT.shape[1]
    shapes = [(params, (params.shape[0], 16)), (ptsT, (3, N)), (megaT, (96, N))]
    if scovT is not None:
        shapes.append((scovT, (9, N)))
    for t, shape in shapes:
        if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"pair kernel input must be contiguous float32 {shape}, got "
                f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
            )


def _launch(name, params, ptsT, megaT, scovT=None):
    lib = _load()
    K, N = params.shape[0], ptsT.shape[1]
    threads = lib.ndt_pair_threads()
    n_blocks = -(-N // threads)
    with torch.cuda.device(ptsT.device):
        # the caching allocator reuses ``partials`` only for work queued
        # later on this stream, so it may go out of scope before the kernel runs
        partials = torch.empty((K, max(n_blocks, 1), 44), dtype=torch.float32, device=ptsT.device)
        out = torch.empty((K, 44), dtype=torch.float32, device=ptsT.device)
        stream = ctypes.c_void_p(torch.cuda.current_stream(ptsT.device).cuda_stream)
        ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (params, ptsT, megaT)]
        if scovT is None:
            rc = lib.ndt_pair_launch(*ptrs, N, K, ctypes.c_void_p(partials.data_ptr()),
                                     ctypes.c_void_p(out.data_ptr()), stream)
        else:
            rc = lib.aniso_pair_launch(*ptrs, ctypes.c_void_p(scovT.data_ptr()), N, K,
                                       ctypes.c_void_p(partials.data_ptr()),
                                       ctypes.c_void_p(out.data_ptr()), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({lib.ndt_pair_error_string(rc).decode()})")
    LAUNCHES[name] += 1
    return out


def ndt_pair(params, ptsT, megaT) -> torch.Tensor:
    """NDT pair sums (K, 44) for K poses over pre-gathered rows (B1)."""
    dev = _device_of(params, ptsT, megaT)
    _check_inputs(params, ptsT, megaT)
    if dev.type == "cpu":
        return _ndt_pair_plain(params, ptsT, megaT)
    return _launch("ndt_pair", params, ptsT, megaT)


def aniso_pair(params, ptsT, megaT, scovT) -> torch.Tensor:
    """Plane-to-plane GICP pair sums (K, 44) over aux rows (B3)."""
    dev = _device_of(params, ptsT, megaT, scovT)
    _check_inputs(params, ptsT, megaT, scovT)
    if dev.type == "cpu":
        return _aniso_pair_plain(params, ptsT, megaT, scovT)
    return _launch("aniso_pair", params, ptsT, megaT, scovT)


# --- plain PyTorch versions (the CPU path, and the reference on the card) ---


def _unpack_rows(megaT):
    N = megaT.shape[1]
    mega = megaT.t()
    fields = mega[:, :84].reshape(N, 7, 12)
    return fields[..., 0:3], fields[..., 3:12].reshape(N, 7, 3, 3), mega[:, 84:91] > 0.5


def _pose_terms(params, ptsT):
    K = params.shape[0]
    R = params[:, :9].reshape(K, 3, 3)
    x = ptsT.t()  # (N, 3)
    tp = x[None] @ R.transpose(1, 2) + params[:, None, 9:12]  # (K, N, 3)
    return R, x, tp


def _finish(R, x, b, M, score, count):
    """(K, 44) sums from the per-point moments b (K, N, 3) and M (K, N, 3, 3):
    grad = [sum x cross q; sum q] with q = R^T b, and the Gauss-Newton
    Hessian from P = R^T M R and the cross-product terms (the kernel's
    tail, written with matrices)."""
    K = R.shape[0]
    Rt = R.transpose(1, 2)[:, None]  # (K, 1, 3, 3)
    q = (Rt @ b[..., None])[..., 0]  # (K, N, 3)
    gw = torch.linalg.cross(x[None].expand_as(q), q, dim=-1).sum(1)
    gv = q.sum(1)
    P = Rt @ M @ R[:, None]  # (K, N, 3, 3)
    zero = torch.zeros_like(x[:, 0])
    hx = torch.stack([  # hat(x): hx @ u == x cross u
        torch.stack([zero, -x[:, 2], x[:, 1]], -1),
        torch.stack([x[:, 2], zero, -x[:, 0]], -1),
        torch.stack([-x[:, 1], x[:, 0], zero], -1),
    ], -2)
    Q = hx[None] @ P  # H_wv terms
    W = Q @ hx.transpose(1, 2)[None]  # H_ww terms
    Qs = Q.sum(1)
    H = torch.cat([
        torch.cat([W.sum(1), Qs], dim=2),
        torch.cat([Qs.transpose(1, 2), P.sum(1)], dim=2),
    ], dim=1)
    return torch.cat([score[:, None], gw, gv, H.reshape(K, 36), count[:, None]], dim=1)


def _ndt_pair_plain(params, ptsT, megaT) -> torch.Tensor:
    mu, icov, valid = _unpack_rows(megaT)
    R, x, tp = _pose_terms(params, ptsT)
    d1 = params[:, 12].view(-1, 1, 1)
    d2 = params[:, 13].view(-1, 1, 1)
    xr = tp[:, :, None, :] - mu[None]  # (K, N, 7, 3)
    icx = (icov[None] @ xr[..., None])[..., 0]
    mahal = torch.clamp((xr * icx).sum(-1), min=0.0)
    exponent = 0.5 * d2 * mahal
    ok = valid[None] & (exponent <= MAX_EXPONENT_ARG)
    e = torch.exp(-torch.where(ok, exponent, 0.0))
    f = d1 * d2 * e
    f = torch.where(ok & (torch.abs(f) >= MIN_FACTOR), f, 0.0)
    score = torch.where(ok, -d1 * e, 0.0).sum((1, 2))
    count = ok.sum((1, 2)).to(torch.float32)
    b = (f[..., None] * icx).sum(2)
    M = (f[..., None, None] * icov[None]).sum(2)
    return _finish(R, x, b, M, score, count)


def _aniso_pair_plain(params, ptsT, megaT, scovT) -> torch.Tensor:
    mu, ct, valid = _unpack_rows(megaT)
    R, x, tp = _pose_terms(params, ptsT)
    corr2 = params[:, 13].view(-1, 1, 1)
    max_mahal = params[:, 15].view(-1, 1, 1)
    N = ptsT.shape[1]
    csrc = scovT.t().reshape(N, 3, 3)
    rc = R[:, None] @ csrc[None] @ R.transpose(1, 2)[:, None]  # (K, N, 3, 3)
    S = ct[None] + rc[:, :, None]  # (K, N, 7, 3, 3)
    s00, s01, s02 = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    s11, s12, s22 = S[..., 1, 1], S[..., 1, 2], S[..., 2, 2]
    c00 = s11 * s22 - s12 * s12
    c01 = s02 * s12 - s01 * s22
    c02 = s01 * s12 - s02 * s11
    c11 = s00 * s22 - s02 * s02
    c12 = s01 * s02 - s00 * s12
    c22 = s00 * s11 - s01 * s01
    det = s00 * c00 + s01 * c01 + s02 * c02
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-30, det, 1.0)
    Si = torch.stack([
        torch.stack([c00, c01, c02], -1),
        torch.stack([c01, c11, c12], -1),
        torch.stack([c02, c12, c22], -1),
    ], -2) * inv_det[..., None, None]  # symmetric adjugate inverse
    xr = tp[:, :, None, :] - mu[None]
    icx = (Si @ xr[..., None])[..., 0]
    mahal = torch.clamp((xr * icx).sum(-1), min=0.0)
    dist2 = (xr * xr).sum(-1)
    ok = valid[None] & (mahal <= max_mahal) & (dist2 <= corr2)
    f = torch.where(ok, -2.0, 0.0)
    score = torch.where(ok, -mahal, 0.0).sum((1, 2))
    count = ok.sum((1, 2)).to(torch.float32)
    b = (f[..., None] * icx).sum(2)
    M = (f[..., None, None] * Si).sum(2)
    return _finish(R, x, b, M, score, count)


# --- host side around the kernels ---


def gather_megaT(points, mask, pose: Pose3, regmap: RegMap, grid_shape,
                 table: str = "packed") -> torch.Tensor:
    """Voxel assignment + mega-row gather -> (96, N) float32, from
    ``regmap.packed`` or (``table="aux"``) ``regmap.packed_aux``."""
    _tp, drow = point_rows(points, mask, pose, regmap, grid_shape)
    src = regmap.packed if table == "packed" else regmap.packed_aux
    return src[drow].t().contiguous().to(torch.float32)


def pose_params(pose: Pose3, d1: float, d2: float, max_mahal: float = 9.0) -> torch.Tensor:
    """(K, 16) kernel parameters for a (K,)-batched or single pose. The
    scalars are written by fills, not copied from the host."""
    rot = pose.rot.reshape(-1, 9)
    params = torch.empty((rot.shape[0], 16), dtype=torch.float32, device=rot.device)
    params[:, :9] = rot
    params[:, 9:12] = pose.trans.reshape(-1, 3)
    params[:, 12] = d1
    params[:, 13] = d2
    params[:, 14] = 0.0
    params[:, 15] = max_mahal
    return params


def fused_objective(ptsT, megaT, pose: Pose3, d1, d2, hess_lambda=1e-6,
                    max_mahal: float = 9.0, src_covT=None) -> NdtObjective:
    """The pair math on pre-gathered rows for one pose or K poses.

    With ``src_covT`` ((9, N) body-frame source covariances) it runs the
    plane-to-plane mode: megaT carries the aux payload and ``d2`` carries
    max_corr_dist^2. Fields come back batched like ``pose``."""
    batched = pose.rot.dim() == 3
    params = pose_params(pose, d1, d2, max_mahal)
    if src_covT is None:
        out = ndt_pair(params, ptsT, megaT)
    else:
        out = aniso_pair(params, ptsT, megaT, src_covT)
    K = out.shape[0]
    hess = out[:, 7:43].reshape(K, 6, 6) + hess_lambda * torch.eye(
        6, dtype=out.dtype, device=out.device
    )
    obj = NdtObjective(out[:, 0], out[:, 1:7], hess, out[:, 43].to(torch.int32))
    return obj if batched else NdtObjective(*(f[0] for f in obj))
