"""Checkpoint and resume of the apps' state as numpy ``.npz`` files (port of
slamtpu/runtime/checkpoint.py).

Files cross between the packages in both directions: the port writes the
reference's keys, names, shapes and dtypes, and adds only

- ``layout``: the file layout, ``LAYOUT``. In this layout the map
  statistics are voxel-corner-relative sums
  (``mapping.gaussian_map.stats_from_points``). A file without the marker
  is read as this layout, the one this repo's reference package writes.
  The reference's map statistics from before corner-relative sums were
  origin-relative, in files with the same keys: such a file cannot be told
  apart from a current one, and is misread.
- ``torch_generator_state`` and ``torch_generator_device`` in lo_svn files
  and in odom_ndt files of the SVNNDT engine: the state of the app's
  particle generator. It is restored only on a generator of the same
  device type.

No added key starts with ``carry_``: the reference's odom loader takes
every ``carry_*`` key as part of the window carry.

The reference's files carry a JAX PRNG key (``key``), which cannot drive
torch draws: resuming such a file, the port keeps its own seeded
generator, and says so once in the log. In ``key`` the port writes the
reference's key of the seed of the app's generator (``PRNGKey(seed)``,
that is ``[0, seed]``), so that the reference can resume the file; its
draws then start from that key.

Resuming puts the device state on ``app.device``: the keyframe rings, the
odom window carry (float64) and the ligo clouds. The ligo window comes
back as the host's numpy dicts with ``Pose3`` poses. Resumed apps rebuild
the RegMap on their first keyframe: no file carries it.
"""
from __future__ import annotations

import logging
from typing import List

import numpy as np
import torch

from .. import interop
from ..core import so3
from ..core.se3 import Pose3
from ..mapping.gaussian_map import VoxelStats

log = logging.getLogger("slamtpu_torch.checkpoint")

LAYOUT = 1
GEN_STATE, GEN_DEVICE = "torch_generator_state", "torch_generator_device"
_PIM_KEYS = ("dR", "dv", "dp", "dR_dbg", "dv_dba", "dv_dbg", "dp_dba", "dp_dbg", "bias_hat", "cov")
_logged_jax_key = False


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _save(path: str, **arrays):
    np.savez_compressed(path, layout=np.asarray(LAYOUT, np.int32), **arrays)


def _load(path: str) -> dict:
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    layout = int(data.get("layout", LAYOUT))
    if layout != LAYOUT:
        raise ValueError(f"{path}: checkpoint layout {layout}, this package reads {LAYOUT}")
    return data


def _tensor(a, device, dtype) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def _seed_key(seed: int) -> np.ndarray:
    """The reference's PRNGKey(seed) (threefry: [high word, low word])."""
    return np.asarray([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def _generator_arrays(gen: torch.Generator) -> dict:
    return {GEN_STATE: gen.get_state().numpy(), GEN_DEVICE: np.asarray(gen.device.type)}


def _restore_generator(data: dict, gen: torch.Generator, app: str):
    global _logged_jax_key
    if GEN_STATE not in data:
        if not _logged_jax_key:
            _logged_jax_key = True
            log.info("%s checkpoint without a torch generator state (a JAX key cannot drive torch "
                     "draws): the particle draws go on from the app's own seeded generator", app)
        return
    kind = str(data[GEN_DEVICE])
    if kind != gen.device.type:
        raise ValueError(f"{app} checkpoint: a {kind} generator state cannot be restored on a "
                         f"{gen.device.type} generator")
    gen.set_state(torch.from_numpy(data[GEN_STATE].copy()))


def _trust_array(trust) -> np.ndarray:
    was_denied, gain = trust
    return np.asarray([1.0 if was_denied else 0.0, gain], np.float64)


def _trust_of(a) -> tuple:
    return bool(a[0] > 0.5), float(a[1])


# --- map statistics ---


def save_map_stats(path: str, stats: VoxelStats):
    _save(path, **{k: _np(getattr(stats, k)) for k in VoxelStats._fields})


def _stats_of(z: dict, device) -> VoxelStats:
    out = {k: torch.tensor(z[k], device=device) for k in VoxelStats._fields if k != "resolution"}
    out["resolution"] = torch.tensor(z["resolution"], dtype=out["sx"].dtype)
    return VoxelStats(**out)


def load_map_stats(path: str, device) -> VoxelStats:
    """Map statistics on ``device`` (the resolution stays a CPU scalar
    tensor, as the port keeps it)."""
    return _stats_of(_load(path), device)


# --- ins_map ---


def save_ins_map(path: str, stats: VoxelStats, ref_lla):
    """The ins_map state: the mergeable map statistics and the geodetic
    reference (the reference's keys, and ``layout``)."""
    _save(path, **{k: _np(getattr(stats, k)) for k in VoxelStats._fields},
          ref_lla=np.asarray(ref_lla, np.float64))


def load_ins_map(path: str, device):
    """(map statistics on ``device``, ref_lla (3,) numpy float64) from a file
    of either package."""
    z = _load(path)
    return _stats_of(z, device), np.asarray(z["ref_lla"], np.float64)


# --- lo_svn ---


def save_lo_svn(path: str, app):
    """The lo_svn state: the keyframe ring (world-frame clouds, masks,
    head), map origin, geodetic reference, rebuild-cadence index and the
    particle generator. In-flight keyframes are read back first."""
    app.flush()
    if app._kf_points is None:
        raise ValueError("nothing to checkpoint before the first keyframe")
    _save(
        path,
        kf_points=_np(app._kf_points),
        kf_mask=_np(app._kf_mask),
        kf_head=np.asarray(app._kf_head),
        origin=np.asarray(app._origin),
        ref_lla=np.asarray(app._ref_lla, np.float64),
        key=_seed_key(app.seed),
        cadence_idx=np.asarray(app._cadence._idx),
        n_keyframes=np.asarray(app._n_keyframes),
        **_generator_arrays(app.generator),
    )


def load_lo_svn(path: str, app):
    """Restore a lo_svn checkpoint (either package's) into a new app."""
    z = _load(path)
    app._kf_points = _tensor(z["kf_points"], app.device, torch.float32)
    app._kf_mask = _tensor(z["kf_mask"], app.device, torch.bool)
    app._kf_head = int(z["kf_head"])
    app._origin = np.asarray(z["origin"], np.float32)
    app._ref_lla = np.asarray(z["ref_lla"], np.float64)
    _restore_generator(z, app.generator, "lo_svn")
    app._cadence._idx = int(z["cadence_idx"])
    app._cadence.force_next = True
    app._n_keyframes = int(z["n_keyframes"])
    return app


# --- odom_ndt ---


def save_odom_ndt(path: str, app):
    """The odom_ndt state: the window carry, trust gain, origin, geodetic
    reference, the previous keyframe's INS pose and, for the SVNNDT
    engine, the particle generator. In-flight keyframes are read back
    first."""
    app.flush()
    if app._carry is None:
        raise ValueError("nothing to checkpoint before the first keyframe")
    carry = {f"carry_{k}": np.asarray(v, np.int32) if k == "n" else _np(v)
             for k, v in app._carry.items()}
    gen = app.generator
    _save(
        path,
        origin=np.asarray(app._origin, np.float64),
        ref_lla=np.asarray(app._ref_lla, np.float64),
        trust=_trust_array(app._trust),
        n_keyframes=np.asarray(app._n_keyframes),
        key=_seed_key(gen.initial_seed()) if gen is not None else np.zeros(0, np.uint32),
        # (rot | trans column); empty when unknown
        prev_ins=np.concatenate([app._prev_ins[0], app._prev_ins[1][:, None]], axis=1)
        if app._prev_ins is not None else np.zeros((0, 4)),
        **carry,
        **(_generator_arrays(gen) if gen is not None else {}),
    )


def load_odom_ndt(path: str, app):
    """Restore an odom_ndt checkpoint (either package's) into a new app. A
    file without the previous keyframe's INS pose (the reference's older
    files) leaves it unset: the first resumed keyframe then takes the
    constant-velocity seed."""
    z = _load(path)
    carry = {k[len("carry_"):]: v for k, v in z.items() if k.startswith("carry_")}
    if carry["win_rot"].shape[0] != app.window:
        raise ValueError(f"checkpoint window {carry['win_rot'].shape[0]}, app window {app.window}")
    app._carry = interop.odom_carry_from_numpy(carry, app.device)
    app._origin = np.asarray(z["origin"], np.float64)
    app._ref_lla = np.asarray(z["ref_lla"], np.float64)
    app._trust = _trust_of(z["trust"])
    app._n_keyframes = int(z["n_keyframes"])
    prev = z.get("prev_ins")
    app._prev_ins = None if prev is None or not prev.size else (prev[:, :3].copy(), prev[:, 3].copy())
    if app.generator is not None:
        _restore_generator(z, app.generator, "odom_ndt")
    return app


# --- ligo_tc ---


def save_ligo_tc(path: str, app):
    """The ligo_tc state: the 15-dof window (poses, velocities, biases, INS
    priors, LiDAR betweens, preintegrated IMU), the keyframe ring with each
    slot's window entry or frozen pose, trust gain, origin, gravity,
    geodetic reference and rebuild-cadence index."""
    if app._kf_clouds is None:
        raise ValueError("nothing to checkpoint before the first keyframe")
    win = app._win
    zeros33 = np.zeros((3, 3))
    pim_defaults = dict(dR=zeros33, dv=np.zeros(3), dp=np.zeros(3), dR_dbg=zeros33, dv_dba=zeros33,
                        dv_dbg=zeros33, dp_dba=zeros33, dp_dbg=zeros33, bias_hat=np.zeros(6),
                        cov=np.zeros((15, 15)))

    def stk(get, default):
        return np.stack([np.asarray(get(w), np.float64) if get(w) is not None else default
                         for w in win])

    arrays = dict(
        win_rot=stk(lambda w: w["pose"].rot, zeros33),
        win_trans=stk(lambda w: w["pose"].trans, np.zeros(3)),
        win_vel=stk(lambda w: w["vel"], np.zeros(3)),
        win_bias=stk(lambda w: w["bias"], np.zeros(6)),
        win_ins_rot=stk(lambda w: w["ins"][0].rot, zeros33),
        win_ins_trans=stk(lambda w: w["ins"][0].trans, np.zeros(3)),
        win_ins_sigma=stk(lambda w: w["ins"][1], np.zeros(6)),
        win_ins_vel=stk(lambda w: w["ins_vel"], np.zeros(3)),
        win_has_pim=np.asarray([w["pim"] is not None for w in win]),
        win_pim_dt=np.asarray([w["pim"]["dt"] if w["pim"] is not None else 0.0 for w in win]),
        win_has_rel=np.asarray([w["rel"] is not None for w in win]),
        win_rel_rot=stk(lambda w: None if w["rel"] is None else w["rel"].rot, zeros33),
        win_rel_trans=stk(lambda w: None if w["rel"] is None else w["rel"].trans, np.zeros(3)),
        win_rel_cov=stk(lambda w: w["rel_cov"], np.zeros((6, 6))),
    )
    for k in _PIM_KEYS:
        arrays[f"win_pim_{k}"] = stk(lambda w: None if w["pim"] is None else w["pim"][k],
                                     pim_defaults[k])
    # ring slots: an index into the window while aliased, else a frozen pose
    S = len(app._kf_slots)
    slot_win_idx = np.full(S, -1, np.int64)
    slot_used = np.zeros(S, bool)
    slot_rot = np.stack([np.eye(3)] * S)
    slot_trans = np.zeros((S, 3))
    win_ids = {id(w): k for k, w in enumerate(win)}
    for s, entry in enumerate(app._kf_slots):
        if entry is None:
            continue
        slot_used[s] = True
        if id(entry) in win_ids:
            slot_win_idx[s] = win_ids[id(entry)]
        else:
            slot_rot[s] = np.asarray(entry["pose"].rot, np.float64)
            slot_trans[s] = np.asarray(entry["pose"].trans, np.float64)
    _save(
        path,
        n_win=np.asarray(len(win)),
        kf_clouds=_np(app._kf_clouds),
        kf_masks=_np(app._kf_masks),
        kf_head=np.asarray(app._kf_head),
        slot_win_idx=slot_win_idx,
        slot_used=slot_used,
        slot_rot=slot_rot,
        slot_trans=slot_trans,
        origin=np.asarray(app._origin, np.float64),
        ref_lla=np.asarray(app._ref_lla, np.float64),
        gravity=np.asarray(app._gravity, np.float64),
        trust=_trust_array(app._trust),
        cadence_idx=np.asarray(app._cadence._idx),
        **arrays,
    )


def load_ligo_tc(path: str, app):
    """Restore a ligo_tc checkpoint (either package's) into a new app."""
    z = _load(path)
    win = []
    for k in range(int(z["n_win"])):
        pim = None
        if bool(z["win_has_pim"][k]):
            pim = {key: z[f"win_pim_{key}"][k] for key in _PIM_KEYS}
            pim["dt"] = float(z["win_pim_dt"][k])
        rel = Pose3(z["win_rel_rot"][k], z["win_rel_trans"][k]) if bool(z["win_has_rel"][k]) else None
        win.append(dict(
            pose=Pose3(z["win_rot"][k], z["win_trans"][k]), vel=z["win_vel"][k],
            bias=z["win_bias"][k],
            ins=(Pose3(z["win_ins_rot"][k], z["win_ins_trans"][k]), z["win_ins_sigma"][k]),
            ins_vel=z["win_ins_vel"][k], pim=pim, rel=rel,
            rel_cov=z["win_rel_cov"][k] if rel is not None else None,
        ))
    app._win = win
    app._kf_clouds = _tensor(z["kf_clouds"], app.device, torch.float32)
    app._kf_masks = _tensor(z["kf_masks"], app.device, torch.bool)
    app._kf_head = int(z["kf_head"])
    app._kf_slots = []
    for s in range(z["slot_used"].shape[0]):
        idx = int(z["slot_win_idx"][s])
        if not bool(z["slot_used"][s]):
            app._kf_slots.append(None)
        elif idx >= 0:
            app._kf_slots.append(win[idx])
        else:
            app._kf_slots.append(dict(pose=Pose3(z["slot_rot"][s], z["slot_trans"][s])))
    app._origin = np.asarray(z["origin"], np.float64)
    app._ref_lla = np.asarray(z["ref_lla"], np.float64)
    app._gravity = np.asarray(z["gravity"], np.float64)
    app._factor_template = app._factor_template._replace(
        gravity=_tensor(app._gravity, app.device, torch.float64))
    app._trust = _trust_of(z["trust"])
    app._cadence._idx = int(z["cadence_idx"])
    app._cadence.force_next = True
    return app


# --- trajectories ---


def save_trajectory(path: str, timestamps, poses: List[Pose3], frame_ids=None):
    rots = torch.as_tensor(np.stack([_np(p.rot) for p in poses]))
    _save(
        path,
        timestamps=np.asarray(timestamps, np.float64),
        quats=so3.rot_to_quat(rots).numpy(),
        trans=np.stack([_np(p.trans) for p in poses]),
        frame_ids=np.asarray(frame_ids if frame_ids is not None else range(len(poses))),
    )


def load_trajectory(path: str):
    """(timestamps, host poses, frame ids)."""
    z = _load(path)
    rots = so3.quat_to_rot(torch.as_tensor(z["quats"])).numpy()
    return z["timestamps"], [Pose3(R, t) for R, t in zip(rots, z["trans"])], z["frame_ids"]
