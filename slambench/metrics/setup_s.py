"""Set-up: from the process's start to the first timed sweep (host clock):
imports, the kernels' load (their build on a checkout's first run), the
traffic's generation and the warm-up keyframes."""


def read(run):
    return run.setup_s
