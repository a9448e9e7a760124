"""Operations and bytes of one call of the port's pair kernels, the
benchmark's frozen copy of chip_smoke.py:489-503's per-point and per-pair
operation counts.

Operations per pose: each point with a valid DIRECT7 slot pays the pose
transform and the gradient/Hessian tail (``FLOPS_POINT``), each valid
slot the pair math (``FLOPS_PAIR``). Bytes: each input read once, 91
floats of each distinct table row that a point reads (7 slots of 12 floats
and 7 flags), the points (3 floats) and their row indices (one int32), the
plane-to-plane cost's source covariances (9 floats), and each pose's 16
parameters.
"""

FLOPS_POINT = {"ndt_pair": 101, "gicp_pair": 101, "aniso_pair": 191}
FLOPS_PAIR = {"ndt_pair": 56, "gicp_pair": 55, "aniso_pair": 91}


def call_bytes(rows: int, n_points: int, k_poses: int, aniso: bool = False) -> int:
    return 4 * (91 * rows + 4 * n_points + (9 * n_points if aniso else 0) + 16 * k_poses)
