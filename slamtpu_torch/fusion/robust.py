"""Failure-softening logic: GPS-denial trust-gain scheduling and the
deviation-gated pose blend (port of slamtpu/fusion/robust.py; the blend
is geodesic where the original's is chordal, see deviation_gated_blend).

The ``_np`` twins are host numpy, copied unchanged; the rest are tensor
functions that keep the dtype and device of their inputs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import se3, so3
from ..core.se3 import Pose3


class TrustGainState(NamedTuple):
    was_denied: torch.Tensor  # () bool
    trust: torch.Tensor  # () in [0, 1]


def trust_gain_init(dtype=torch.float64, device="cpu") -> TrustGainState:
    return TrustGainState(torch.zeros((), dtype=torch.bool, device=device),
                          torch.ones((), dtype=dtype, device=device))


def trust_gain_update(
    state: TrustGainState,
    ins_sigma_norm: torch.Tensor,
    denial_threshold: float = 0.1,  # meters of INS sigma-norm (pipeline.cpp:637)
    recovery_rate: float = 0.005,  # trust regained per keyframe
    denied_scale: float = 1e2,  # sigma scaling while denied
):
    """Returns (new_state, sigma_scale in [1, denied_scale]): while GPS is
    denied the INS prior sigmas are inflated by ``denied_scale``; on
    recovery trust restarts at 0 and ramps back linearly."""
    available = ins_sigma_norm < denial_threshold
    trust = torch.where(available & state.was_denied, 0.0, state.trust)
    trust = torch.where(available, torch.clamp(trust + recovery_rate, max=1.0), trust)
    scale = torch.where(available, denied_scale + trust * (1.0 - denied_scale), denied_scale)
    return TrustGainState(~available, trust), scale


def trust_gain_init_np():
    return (False, 1.0)


def trust_gain_update_np(
    state,
    ins_sigma_norm: float,
    denial_threshold: float = 0.1,
    recovery_rate: float = 0.005,
    denied_scale: float = 1e2,
):
    """Host-scalar twin of trust_gain_update (state = (was_denied, trust));
    the per-keyframe apps run it on the host to avoid eager device dispatch."""
    was_denied, trust = state
    available = float(ins_sigma_norm) < denial_threshold
    if available and was_denied:
        trust = 0.0
    if available:
        trust = min(1.0, trust + recovery_rate)
        scale = denied_scale + trust * (1.0 - denied_scale)
    else:
        scale = denied_scale
    return (not available, trust), scale


def deviation_gated_blend(
    pose_pred: Pose3,
    pose_meas: Pose3,
    max_trans_deviation: float = 1.0,  # m (pipeline.cpp:454)
    max_rot_deviation: float = 0.1,  # rad (":455")
):
    """Blend a registration result toward a prediction when it deviates too
    much (pipeline.cpp:570-592): trust weight w = min(max(0, 1 - |dt|/maxT),
    max(0, 1 - |dr|/maxR)), and the blend moves from the prediction a share
    w of the way to the measurement along the geodesic between them,
    Retract(pred, w Local(pred, meas)). Returns (blended_pose, w).

    This departs from slamtpu/fusion/robust.py, which blends linearly in
    the global Logmap coordinates (a chordal blend): there the rotation
    vector flips sign where the heading crosses +-pi, and a pair that
    straddles it blends toward the far side of the circle (metres off on a
    closed lap). The two agree at w = 0 and w = 1, and to second order in
    the pair's gap elsewhere. SURVEY.md describes the source's blend both
    as "on the SE(3) manifold" and as an "SE(3) log-lerp" and quotes no
    call, so the source may blend chordally too; the geodesic blend is
    kept either way, since the chordal one fails on every closed lap."""
    dev = se3.between(pose_pred, pose_meas)
    trans_err = torch.linalg.vector_norm(dev.trans, dim=-1)
    rot_err = torch.linalg.vector_norm(so3.log(dev.rot), dim=-1)
    w_trans = torch.clamp(1.0 - trans_err / max_trans_deviation, min=0.0)
    w_rot = torch.clamp(1.0 - rot_err / max_rot_deviation, min=0.0)
    w = torch.minimum(w_trans, w_rot)
    return se3.interpolate(pose_pred, pose_meas, w), w


def constant_velocity_predict(prev: Pose3, curr: Pose3) -> Pose3:
    """Next-pose prediction curr * (prev^-1 curr) (pipeline.cpp:763-770)."""
    return se3.compose(curr, se3.between(prev, curr))
