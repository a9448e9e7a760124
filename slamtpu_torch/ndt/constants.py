"""NDT mixture constants (Magnusson 2009, Eq. 6.8); a copy of
slamtpu/ndt/constants.py (plain Python, no array library).

Host-side (config-time) computation matching the reference's
``updateNdtConstants`` (reference extern/svn_ndt/include/
svn_ndt_impl.hpp:79-131) including its epsilon guards, so score parity holds
bit-for-bit at config level. Returns plain Python floats which are baked into
the kernels' parameters.
"""
from __future__ import annotations

import math


def gauss_constants(resolution: float, outlier_ratio: float):
    """Return (d1, d2, d3) for the NDT score  s = -d1 * exp(-d2/2 * mahal^2).

    Note d1 < 0 for typical configs, so the per-pair score increment -d1*e is
    positive and registration *maximizes* the total score.
    """
    if resolution <= 1e-6:
        return 1.0, 1.0, 0.0
    eps = 1e-9
    c1 = max(10.0 * (1.0 - outlier_ratio), eps)
    c2 = max(outlier_ratio / resolution**3, eps)
    d3 = -math.log(c2)
    d1 = -math.log(c1 + c2) - d3
    if abs(d1) < eps:
        d2 = 1.0
    else:
        inner = c1 * math.exp(-0.5) + c2
        if inner <= eps:
            d2 = 1.0
        else:
            outer = (-math.log(inner) - d3) / d1
            d2 = -2.0 * math.log(outer) if outer > eps else 1.0
    if not (math.isfinite(d1) and math.isfinite(d2) and math.isfinite(d3)):
        return 1.0, 1.0, 0.0
    return d1, d2, d3
