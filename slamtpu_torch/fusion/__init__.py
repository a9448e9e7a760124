"""Factor graphs and their pieces: IMU preintegration, the 15-dof window
graph and smoother of ligo_tc, the pose-window smoother of odom_ndt, the
deviation-gated blend and trust-gain scheduling, sqrt-information, the
batch pose graph and loop closure. The exports are the reference's
(slamtpu/fusion/__init__.py)."""
from . import graph, loop_closure, pose_graph, preintegration, robust, smoother
from .graph import (
    BetweenFactors,
    Factors,
    ImuFactors,
    PositionFactors,
    PriorPoseFactors,
    VecPriorFactors,
    WindowState,
    empty_factors,
    residuals,
    sqrt_info_from_cov,
    sqrt_info_from_sigmas,
)
from .loop_closure import LoopClosure, LoopClosureConfig, LoopDetector, refine_trajectory
from .pose_graph import PoseGraph, PoseGraphConfig, make_graph
from .preintegration import (
    ImuBias,
    ImuNoise,
    NavState,
    PreintegratedImu,
    bias_corrected_deltas,
    integrate,
    predict,
)
from .robust import (
    TrustGainState,
    constant_velocity_predict,
    deviation_gated_blend,
    trust_gain_init,
    trust_gain_update,
)
from .smoother import (
    PoseWindowResult,
    SmootherConfig,
    SmootherResult,
    marginal_covariance,
    optimize,
    optimize_pose_window,
    pose_marginal_covariance,
)

__all__ = [
    "graph",
    "loop_closure",
    "LoopClosure",
    "LoopClosureConfig",
    "LoopDetector",
    "refine_trajectory",
    "smoother",
    "pose_graph",
    "preintegration",
    "robust",
    "WindowState",
    "Factors",
    "empty_factors",
    "residuals",
    "sqrt_info_from_cov",
    "sqrt_info_from_sigmas",
    "PriorPoseFactors",
    "BetweenFactors",
    "VecPriorFactors",
    "ImuFactors",
    "PositionFactors",
    "ImuBias",
    "ImuNoise",
    "NavState",
    "PreintegratedImu",
    "integrate",
    "predict",
    "bias_corrected_deltas",
    "SmootherConfig",
    "SmootherResult",
    "PoseWindowResult",
    "optimize",
    "optimize_pose_window",
    "marginal_covariance",
    "pose_marginal_covariance",
    "PoseGraph",
    "PoseGraphConfig",
    "make_graph",
    "TrustGainState",
    "trust_gain_init",
    "trust_gain_update",
    "deviation_gated_blend",
    "constant_velocity_predict",
]
