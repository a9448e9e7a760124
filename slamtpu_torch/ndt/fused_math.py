"""The registration objective on RegMap rows and the Newton driver on top
of it (port of slamtpu/ndt/pallas_math.py: ``gather_megaT``,
``fused_objective``, ``score_grad_hess_fused``, ``newton_align_fused`` and
``gicp_align_fused``; and of slamtpu/ndt/gicp.py's ``gicp_align`` and
``gicp_align_aniso``).

Three pair kernels carry it, the three costs of one CUDA kernel template,
each beside its plain PyTorch version:

- ``ndt_pair``   (CUDA ``ndt_pair_kernel<kNdt>``,   plain ``_ndt_pair_plain``):
  the NDT pair math, K poses in one launch (SVN stage 1, Newton);
- ``gicp_pair``  (CUDA ``ndt_pair_kernel<kGicp>``,  plain ``_gicp_pair_plain``):
  the trimmed isotropic VGICP cost against a ``gicp_map`` RegMap (the
  odom_ndt GICP engine's Newton);
- ``aniso_pair`` (CUDA ``ndt_pair_kernel<kAniso>``, plain ``_aniso_pair_plain``):
  plane-to-plane GICP against a table of means and plane-regularized
  covariances and each point's body-frame source covariance scovT (9, N):
  the aux table ``regmap.packed_aux`` (the SVN polish) or the table of a
  ``gicp_map_aniso`` RegMap (odom_ndt's anisotropic GICP engine).

B1 and B2 also run gated, for the KDTREE search mode (CUDA
``ndt_pair_kernel<kNdt, true>`` and ``<kGicp, true>``, counted as
``ndt_pair_gated`` and ``gicp_pair_gated``): given ``gate`` (16,) = R_g(9),
t_g(3), r^2, pad (``gate_params``), a slot counts only if its centroid lies
within r of the point at the gather pose (R_g, t_g), the pose at which
``grid_rows`` looked the rows up.

Each takes a RegMap table (R, 96), whose last row is the all-zero
sentinel, and each point's row index (N,) int32 (``regmap.grid_rows``),
and gathers the rows inside the kernel; each takes params (K, 16) = R(9),
t(3), d1, d2, mode, max_mahal and returns (K, 44) sums: score, grad
[omega, v] (6), Hessian (36), count. A wrapper runs the plain version only
for CPU tensors; for CUDA tensors it launches the kernel
(``csrc/ndt_pair.cu``, built at first launch) or raises. ``LAUNCHES``
counts kernel launches, and only those.

The Newton loop (``newton.drive``) is a Python loop over outer iterations,
one row lookup each. Its exit test reads the iteration count and the
convergence flag on the host: one device sync per outer iteration, counted
in ``HOST_READS`` (``newton.HOST_READS``).
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..core import se3
from ..core.se3 import Pose3
from .constants import gauss_constants
from .newton import HOST_READS, NewtonConfig, NewtonResult, _NewtonRun, drive
from .objective import MAX_EXPONENT_ARG, MIN_FACTOR, NdtObjective, sanitize_points
from .regmap import RegMap, grid_rows, radius_gate

LAUNCHES = {"ndt_pair": 0, "gicp_pair": 0, "aniso_pair": 0, "ndt_pair_gated": 0,
            "gicp_pair_gated": 0}

_lock = threading.Lock()
_lib = None
# per (device, stream): the zeroed counters with which the pair kernel finds
# its finishing blocks (the kernel resets them); launches on one stream run
# in turn
_tickets: dict = {}


def _load():
    """Build (first use) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            from ..cuda_build import build_library

            lib = ctypes.CDLL(build_library(("ndt_pair.cu",), "ndt_pair"))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            tail = [ci, ci, ci, ci, vp, vp, vp, vp, vp]  # N, K, R, grid, scratch, out, stream
            for fn in (lib.ndt_pair_launch, lib.gicp_pair_launch):
                fn.argtypes = [vp] * 4 + tail
                fn.restype = ci
            # + scovT, or + the gate block
            for fn in (lib.aniso_pair_launch, lib.ndt_pair_gated_launch, lib.gicp_pair_gated_launch):
                fn.argtypes = [vp] * 5 + tail
                fn.restype = ci
            for fn in (lib.ndt_pair_max_poses, lib.ndt_pair_acc, lib.ndt_pair_group):
                fn.argtypes = []
                fn.restype = ci
            for fn in (lib.ndt_pair_grid, lib.ndt_pair_blocks_per_sm):
                fn.argtypes = [ci, ci]
                fn.restype = ci
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


def _check(t, shape, dtype=torch.float32):
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"pair kernel input must be contiguous {dtype} {shape}, got "
            f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
        )


def _check_rows_inputs(params, ptsT, table, rows):
    N = ptsT.shape[1] if ptsT.dim() == 2 else -1
    _check(params, (params.shape[0], 16))
    _check(ptsT, (3, N))
    _check(table, (table.shape[0], 96))
    _check(rows, (N,), torch.int32)
    if table.shape[0] < 1:
        raise ValueError("the row table needs at least its sentinel row")


def _check_gate(gate, dev):
    _check(gate, (16,))
    if gate.device != dev:
        raise ValueError(f"the gate block is on {gate.device}, the points on {dev}")


def _raise_on(rc, name, lib):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({lib.ndt_pair_error_string(rc).decode()})")


def _launch_rows(name, params, ptsT, table, rows, extra=None):
    """One launch of kernel ``name`` (B1, B2, or B3 with ``extra`` = scovT,
    or gated B1 or B2 with ``extra`` = the gate block), the rows gathered in
    the kernel."""
    lib = _load()
    K, N, R = params.shape[0], ptsT.shape[1], table.shape[0]
    if K > lib.ndt_pair_max_poses():
        raise ValueError(f"{name}: at most {lib.ndt_pair_max_poses()} poses a launch, got {K}")
    if table.data_ptr() % 16 or (name.endswith("_gated") and extra.data_ptr() % 16):
        raise ValueError(f"{name}: the row table and the gate block must be 16-byte aligned")
    dev = ptsT.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        grid = lib.ndt_pair_grid(N, dev.index if dev.index is not None else torch.cuda.current_device())
        if N > 0 and grid <= 0:
            raise RuntimeError(f"{name}: no grid for {N} points on {dev}")
        groups = -(-max(grid, 1) // lib.ndt_pair_group())
        key = (str(dev), stream.cuda_stream)
        tickets = _tickets.get(key)
        if tickets is None or tickets.numel() < 1 + groups:
            tickets = _tickets[key] = torch.zeros(1 + groups, dtype=torch.int32, device=dev)
        # the caching allocator reuses the scratch only for work queued
        # later on this stream, so it may go out of scope before the kernel runs
        acc = lib.ndt_pair_acc()
        partials = torch.empty((max(grid, 1), K, acc), dtype=torch.float32, device=dev)
        gsums = torch.empty((groups, K, acc), dtype=torch.float64, device=dev)
        out = torch.empty((K, 44), dtype=torch.float32, device=dev)
        ins = (params, ptsT, table, rows) + (() if extra is None else (extra,))
        ptrs = [ctypes.c_void_p(t.data_ptr()) for t in ins]
        scratch = [ctypes.c_void_p(t.data_ptr()) for t in (partials, gsums, tickets, out)]
        rc = getattr(lib, f"{name}_launch")(*ptrs, N, K, R, grid, *scratch,
                                             ctypes.c_void_p(stream.cuda_stream))
    _raise_on(rc, name, lib)
    if N > 0 and K > 0:  # else no kernel ran (out is zeros, or empty)
        LAUNCHES[name] += 1
    return out


def _gated_launch(name, params, ptsT, table, rows, gate, plain):
    dev = _device_of(params, ptsT, table, rows)
    _check_rows_inputs(params, ptsT, table, rows)
    if gate is not None:
        _check_gate(gate, dev)
    if dev.type == "cpu":
        return plain(params, ptsT, table, rows, gate)
    if gate is None:
        return _launch_rows(name, params, ptsT, table, rows)
    return _launch_rows(f"{name}_gated", params, ptsT, table, rows, gate)


def ndt_pair(params, ptsT, table, rows, gate=None) -> torch.Tensor:
    """NDT pair sums (K, 44) for K poses; point i's mega row is
    ``table[rows[i]]`` (B1); with ``gate`` (``gate_params``) only the slots
    within its radius at its pose count."""
    return _gated_launch("ndt_pair", params, ptsT, table, rows, gate, _ndt_pair_plain)


def gicp_pair(params, ptsT, table, rows, gate=None) -> torch.Tensor:
    """Trimmed isotropic VGICP pair sums (K, 44) over ``gicp_map`` rows (B2):
    params[:, 13] carries max_corr_dist^2, params[:, 15] max_mahal; ``gate``
    as in ``ndt_pair``."""
    return _gated_launch("gicp_pair", params, ptsT, table, rows, gate, _gicp_pair_plain)


def aniso_pair(params, ptsT, table, rows, scovT) -> torch.Tensor:
    """Plane-to-plane GICP pair sums (K, 44) (B3): point i's aux row is
    ``table[rows[i]]`` (``regmap.packed_aux``), its body-frame source
    covariance scovT[:, i] (row-major); params[:, 13] carries
    max_corr_dist^2, params[:, 15] max_mahal."""
    dev = _device_of(params, ptsT, table, rows, scovT)
    _check_rows_inputs(params, ptsT, table, rows)
    _check(scovT, (9, ptsT.shape[1]))
    if dev.type == "cpu":
        return _aniso_pair_plain(params, ptsT, table, rows, scovT)
    return _launch_rows("aniso_pair", params, ptsT, table, rows, scovT)


# --- plain PyTorch versions (the CPU path, and the reference on the card) ---


def _unpack_rows(mega):
    """(mean (N, 7, 3), icov or covariance (N, 7, 3, 3), valid (N, 7)) of
    mega rows (N, 96)."""
    N = mega.shape[0]
    fields = mega[:, :84].reshape(N, 7, 12)
    return fields[..., 0:3], fields[..., 3:12].reshape(N, 7, 3, 3), mega[:, 84:91] > 0.5


def _table_rows(table, rows):
    """Point i's mega row ``table[rows[i]]`` -> (N, 96). As in the kernel,
    the last row R - 1 is the sentinel, which no point reads (zeros), and
    an index outside the table reads it."""
    R = table.shape[0]
    idx = rows.long()
    idx = torch.where((idx >= 0) & (idx < R), idx, R - 1)
    return torch.where((idx == R - 1)[:, None], 0.0, table[idx])


def _gate_valid(valid, gate, x, mu):
    """``valid`` (N, 7) less the slots whose centroid mu (N, 7, 3) lies
    farther than r from the point x (N, 3) at the gate's pose (the kernel's
    ``gate_slots``); no gate keeps them all."""
    if gate is None:
        return valid
    q = x @ gate[:9].reshape(3, 3).t() + gate[9:12]
    return valid & (torch.sum((q[:, None, :] - mu) ** 2, dim=-1) <= gate[12])


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


def _ndt_pair_plain(params, ptsT, table, rows, gate=None) -> torch.Tensor:
    mu, icov, valid = _unpack_rows(_table_rows(table, rows))
    R, x, tp = _pose_terms(params, ptsT)
    valid = _gate_valid(valid, gate, x, mu)
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


def _trimmed_quadratic(R, x, tp, mu, icov, valid, params) -> torch.Tensor:
    """The trimmed quadratic GICP cost of B2 and B3 for pairs with inverse
    covariance ``icov`` ((1 or K, N, 7, 3, 3)): a pair
    counts if valid, mahal <= params[:, 15] and |xr|^2 <= params[:, 13];
    score -mahal, f = -2."""
    corr2 = params[:, 13].view(-1, 1, 1)
    max_mahal = params[:, 15].view(-1, 1, 1)
    xr = tp[:, :, None, :] - mu[None]  # (K, N, 7, 3)
    icx = (icov @ xr[..., None])[..., 0]
    mahal = torch.clamp((xr * icx).sum(-1), min=0.0)
    dist2 = (xr * xr).sum(-1)
    ok = valid[None] & (mahal <= max_mahal) & (dist2 <= corr2)
    f = torch.where(ok, -2.0, 0.0)
    score = torch.where(ok, -mahal, 0.0).sum((1, 2))
    count = ok.sum((1, 2)).to(torch.float32)
    b = (f[..., None] * icx).sum(2)
    M = (f[..., None, None] * icov).sum(2)
    return _finish(R, x, b, M, score, count)


def _gicp_pair_plain(params, ptsT, table, rows, gate=None) -> torch.Tensor:
    mu, icov, valid = _unpack_rows(_table_rows(table, rows))
    R, x, tp = _pose_terms(params, ptsT)
    valid = _gate_valid(valid, gate, x, mu)
    return _trimmed_quadratic(R, x, tp, mu, icov[None], valid, params)


def _aniso_pair_plain(params, ptsT, table, rows, scovT) -> torch.Tensor:
    mu, ct, valid = _unpack_rows(_table_rows(table, rows))
    R, x, tp = _pose_terms(params, ptsT)
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
    return _trimmed_quadratic(R, x, tp, mu, Si, valid, params)


# --- host side around the kernels ---


def gather_megaT(points, mask, pose: Pose3, regmap: RegMap, grid_shape, kd_radius=None,
                 table: str = "packed") -> torch.Tensor:
    """Voxel assignment + mega-row gather -> (96, N) float32, from
    ``regmap.packed`` or (``table="aux"``) ``regmap.packed_aux``: the
    reference's input to its kernels. ``kd_radius`` clears the validity
    flags of the slots outside the radius at ``pose`` (``radius_gate``). No
    path of the port calls it: the kernels gather the rows themselves from
    (table, ``grid_rows``) and gate them; the tests and the kernels' timing
    scripts use it as the reference's counterpart."""
    points, mask = sanitize_points(points, mask)
    drow = grid_rows(points, mask, pose, regmap, grid_shape)
    src = regmap.packed if table == "packed" else regmap.packed_aux
    mega = src[drow]
    if kd_radius is not None and kd_radius > 0.0:
        mu, _, valid = _unpack_rows(mega)
        tp = se3.transform_points(pose, points)
        act = radius_gate(tp, mu, valid, kd_radius)
        mega = torch.cat([mega[:, :84], act.to(mega.dtype), mega[:, 91:]], dim=1)
    return mega.t().contiguous().to(torch.float32)


def gate_params(pose: Pose3, kd_radius: float):
    """The KDTREE gate block (16,) float32 for rows looked up at ``pose``:
    R(9), t(3), kd_radius^2, pad; None when kd_radius is not positive
    (DIRECT7, no gate). Built by fills and copies on the device: writing a
    Python number through an index would wait for the device."""
    if kd_radius is None or kd_radius <= 0.0:
        return None
    tail = torch.zeros(4, dtype=torch.float32, device=pose.rot.device)
    tail[:1].fill_(float(kd_radius) * float(kd_radius))
    return torch.cat([pose.rot.reshape(9).to(torch.float32), pose.trans.reshape(3).to(torch.float32),
                      tail])


def pregathered_table(megaT):
    """Pre-gathered rows megaT (96, N) as the pair kernels' inputs: the
    table (N + 1, 96), the rows with the zero sentinel row appended, and
    the row index 0..N-1."""
    N = megaT.shape[1]
    table = torch.cat([megaT.t(), megaT.new_zeros((1, 96))]).to(torch.float32)
    return table, torch.arange(N, dtype=torch.int32, device=megaT.device)


def pose_params(pose: Pose3, d1: float, d2: float, max_mahal: float = 9.0,
                gicp: bool = False) -> torch.Tensor:
    """(K, 16) kernel parameters for a (K,)-batched or single pose; the mode
    slot is 1 for the VGICP cost, as the reference writes it. The scalars
    are written by fills, not copied from the host."""
    rot = pose.rot.reshape(-1, 9)
    params = torch.empty((rot.shape[0], 16), dtype=torch.float32, device=rot.device)
    params[:, :9] = rot
    params[:, 9:12] = pose.trans.reshape(-1, 3)
    params[:, 12] = d1
    params[:, 13] = d2
    params[:, 14] = 1.0 if gicp else 0.0
    params[:, 15] = max_mahal
    return params


def _objective(out, batched: bool, hess_lambda) -> NdtObjective:
    K = out.shape[0]
    hess = out[:, 7:43].reshape(K, 6, 6) + hess_lambda * torch.eye(
        6, dtype=out.dtype, device=out.device
    )
    obj = NdtObjective(out[:, 0], out[:, 1:7], hess, out[:, 43].to(torch.int32))
    return obj if batched else NdtObjective(*(f[0] for f in obj))


def rows_objective(ptsT, table, rows, pose: Pose3, d1, d2, hess_lambda=1e-6, gicp: bool = False,
                   gicp_max_mahal: float = 9.0, src_covT=None, gate=None, reduce=None) -> NdtObjective:
    """The NDT (or, with ``gicp=True``, the trimmed VGICP) pair math for one
    pose or K poses, point i against mega row ``table[rows[i]]``. In the
    VGICP cost the table is a ``gicp_map`` RegMap's, ``d2`` carries
    max_corr_dist^2 and d1 is unused. With ``src_covT`` ((9, N) body-frame
    source covariances) it runs the plane-to-plane cost: the table holds
    means and plane-regularized covariances (``regmap.packed_aux``, or
    ``packed`` of a ``gicp_map_aniso`` RegMap) and ``d2`` carries
    max_corr_dist^2. ``gate`` (``gate_params``, NDT and VGICP costs) applies
    the KDTREE radius gate at the pose the rows were looked up at.
    ``reduce`` maps the kernel's raw (K, 44) sums before ``hess_lambda`` is
    added (the multi-device layer sums them over the ranks).
    Fields come back batched like ``pose``."""
    params = pose_params(pose, d1, d2, gicp_max_mahal, gicp)
    if src_covT is not None:
        if gate is not None:
            raise ValueError("the plane-to-plane cost takes no KDTREE gate")
        out = aniso_pair(params, ptsT, table, rows, src_covT)
    else:
        out = (gicp_pair if gicp else ndt_pair)(params, ptsT, table, rows, gate)
    if reduce is not None:
        out = reduce(out)
    return _objective(out, pose.rot.dim() == 3, hess_lambda)


def fused_objective(ptsT, megaT, pose: Pose3, d1, d2, hess_lambda=1e-6, gicp: bool = False,
                    gicp_max_mahal: float = 9.0, src_covT=None) -> NdtObjective:
    """The pair math on pre-gathered rows megaT (96, N) for one pose or K
    poses (the reference's signature): ``rows_objective`` with megaT's
    columns as the table and the identity as the row index (with
    ``src_covT``, megaT carries the aux payload)."""
    table, rows = pregathered_table(megaT)
    return rows_objective(ptsT, table, rows, pose, d1, d2, hess_lambda, gicp, gicp_max_mahal,
                          src_covT)


def score_grad_hess_fused(points, mask, pose: Pose3, regmap: RegMap, d1: float, d2: float,
                          grid_shape: tuple, hess_lambda: float = 1e-6) -> NdtObjective:
    """Row lookup + the NDT pair kernel at one pose (float32)."""
    points, mask = sanitize_points(points, mask)
    rows = grid_rows(points, mask, pose, regmap, grid_shape)
    return rows_objective(points.to(torch.float32).t().contiguous(), regmap.packed, rows, pose,
                          d1, d2, hess_lambda)


def gicp_align_fused(points, mask, regmap: RegMap, init_pose: Pose3, cfg: NewtonConfig,
                     grid_shape: tuple, inner_iters: int = 1,
                     max_mahal: float = 9.0) -> NewtonResult:
    """VGICP registration on the fused kernel (regmap from ``gicp_map`` +
    ``build_regmap``); ``cfg.kd_radius`` > 0 gates its slots, as the
    reference's fused path does."""
    return newton_align_fused(points, mask, regmap, init_pose, cfg, grid_shape, inner_iters,
                              _gicp=True, _gicp_max_mahal=max_mahal)


def gicp_align(points, mask, regmap: RegMap, init_pose: Pose3, cfg: NewtonConfig,
               grid_shape: tuple = (256, 256, 64)) -> NewtonResult:
    """VGICP registration with the contract of the reference's ``gicp_align``
    (its XLA Newton loop, which the sorted-key apps take): one Newton step a
    lookup whatever ``fused_inner_iters`` says, no KDTREE gate, score and
    Hessian at the returned pose; over the VGICP pair kernel (regmap from
    ``gicp_map`` + ``build_regmap``)."""
    return newton_align_fused(points, mask, regmap, init_pose, cfg._replace(kd_radius=0.0), grid_shape,
                              inner_iters=1, final_eval=True, _gicp=True)


def gicp_align_aniso(points, mask, src_cov, regmap: RegMap, init_pose: Pose3, cfg: NewtonConfig,
                     grid_shape: tuple) -> NewtonResult:
    """Plane-to-plane GICP registration on the plane-to-plane pair kernel
    (regmap from ``gicp_map_aniso`` + ``build_regmap``, src_cov (N, 3, 3)
    body-frame source covariances), with the contract of the reference's
    Newton loop: each step evaluated at its own pose, score and Hessian at
    the returned pose."""
    return newton_align_fused(points, mask, regmap, init_pose, cfg, grid_shape, inner_iters=1,
                              final_eval=True, src_cov=src_cov)


def newton_align_fused(points, mask, regmap: RegMap, init_pose: Pose3, cfg: NewtonConfig,
                       grid_shape: tuple, inner_iters: int = 1, reg_pose: Pose3 = None,
                       final_eval: bool = False, src_cov=None, reduce=None, _gicp: bool = False,
                       _gicp_max_mahal: float = 9.0) -> NewtonResult:
    """Newton registration on the fused kernel: NDT; VGICP with _gicp; or,
    with ``src_cov`` ((N, 3, 3) body-frame source covariances), plane-to-plane
    GICP on the table of a ``gicp_map_aniso`` RegMap.

    Each outer iteration looks up the points' rows once and takes up to
    ``inner_iters`` Newton steps on them. A staleness budget guards the
    reuse: once the summed step length since the gather would pass
    ``cfg.gather_stale_frac * cfg.resolution``, further inner steps freeze
    (their evaluations are discarded and they do not count toward
    ``cfg.max_iterations``) and the next outer iteration looks up again. The
    loop ends when an outer iteration's last applied step is shorter than
    ``cfg.trans_eps`` or the applied steps reach ``cfg.max_iterations``.

    By default the returned (score, hessian, n_contrib) are those of the
    last applied step, evaluated at the pose before its retract;
    ``final_eval=True`` evaluates them at the returned pose.

    ``cfg.kd_radius`` > 0 (the KDTREE search mode) gates the NDT and VGICP
    costs' slots at the pose of each lookup, which the outer iteration's
    inner steps share; the plane-to-plane cost takes no gate (the
    reference's ``gicp_align_aniso`` applies none). ``reduce`` maps each
    evaluation's raw kernel sums (``rows_objective``): the multi-device
    layer passes a sum over the ranks, whose equal results give every rank
    the same loop decisions."""
    return drive(_fused_run(points, mask, regmap, init_pose, cfg, grid_shape, inner_iters, reg_pose,
                            src_cov, reduce, _gicp, _gicp_max_mahal), final_eval)


def newton_align_fused_batch(points, mask, regmap: RegMap, init_pose: Pose3, cfg: NewtonConfig,
                             grid_shape: tuple, inner_iters: int = 1,
                             final_eval: bool = False) -> NewtonResult:
    """B scans (points (B, N, 3), mask (B, N), init_pose (B,)-batched)
    against one RegMap, each equal to its own ``newton_align_fused``: the
    outer iterations run in lockstep, a scan that has converged or spent
    its iterations freezes (the reference's vmapped while loop), and one
    host read per outer iteration covers the whole batch. Each step
    launches the NDT pair kernel at K = 1 once per running scan, with that
    scan's rows (a launch takes one point set). Fields come back batched."""
    runs = [_fused_run(points[b], mask[b], regmap, Pose3(init_pose.rot[b], init_pose.trans[b]), cfg,
                       grid_shape, inner_iters)
            for b in range(points.shape[0])]
    running = runs if cfg.max_iterations > 0 else []
    while running:
        for run in running:
            run.outer_iteration()
        HOST_READS["newton"] += 1
        state = torch.stack([torch.stack([r.it, r.conv.to(torch.int32)]) for r in runs]).tolist()
        running = [r for r, (it, conv) in zip(runs, state) if it < cfg.max_iterations and not conv]
    res = [r.result(final_eval) for r in runs]
    return NewtonResult(Pose3(torch.stack([r.pose.rot for r in res]), torch.stack([r.pose.trans for r in res])),
                        *(torch.stack(f) for f in list(zip(*res))[1:]))


def _fused_run(points, mask, regmap: RegMap, init_pose: Pose3, cfg: NewtonConfig, grid_shape: tuple,
               inner_iters: int, reg_pose: Pose3 = None, src_cov=None, reduce=None, gicp: bool = False,
               gicp_max_mahal: float = 9.0) -> _NewtonRun:
    """One registration of ``newton_align_fused`` in float32: each lookup is
    the points' RegMap rows (and the KDTREE gate block) at the lookup pose,
    each evaluation one launch of a pair kernel on those rows."""
    d1, d2, _ = gauss_constants(cfg.resolution, cfg.outlier_ratio)
    if gicp or src_cov is not None:
        d2 = float(cfg.gicp_max_corr_dist) ** 2  # the d2 slot carries the distance gate
    f32 = torch.float32
    points, mask = sanitize_points(points, mask)
    ptsT = points.to(f32).t().contiguous()
    scovT = None if src_cov is None else src_cov.reshape(-1, 9).t().contiguous().to(f32)
    kd_radius = cfg.kd_radius if src_cov is None else 0.0

    def lookup(pose):
        """(rows, gate) at ``pose``."""
        return grid_rows(points, mask, pose, regmap, grid_shape), gate_params(pose, kd_radius)

    def evaluate(pose, rows):
        return rows_objective(ptsT, regmap.packed, rows[0], pose, d1, d2, cfg.hess_lambda, gicp=gicp,
                              gicp_max_mahal=gicp_max_mahal, src_covT=scovT, gate=rows[1], reduce=reduce)

    return _NewtonRun(lookup, evaluate, init_pose, cfg, inner_iters, reg_pose, f32)
