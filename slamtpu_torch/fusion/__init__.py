"""Factor graphs and their pieces: IMU preintegration, the 15-dof window
graph and smoother of ligo_tc, the pose-window smoother of odom_ndt, the
deviation-gated blend and trust-gain scheduling, sqrt-information."""
