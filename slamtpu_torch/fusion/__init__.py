"""Factor-graph pieces of odom_ndt: the pose-window smoother, the
deviation-gated blend and trust-gain scheduling, sqrt-information."""
