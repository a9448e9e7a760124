"""Keyframes the port published per second of the whole --trace 0 window
(host clock), from the first timed sweep to the return of the app's closing
flush(), so that every keyframe counted has its pose on the host: the
closed-loop capacity at the cell's stated input size (lo_svn_berlin: 65,536
points a sweep, K = 20 particles)."""


def read(run):
    return run.n_keyframes / run.window_s if run.n_keyframes else None
