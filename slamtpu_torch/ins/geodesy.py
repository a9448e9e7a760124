"""WGS-84 geodesy: LLA <-> local NED conversions, host numpy float64.

A numpy-only copy of slamtpu/ins/geodesy.py: the port cannot import
``slamtpu`` (its ``__init__`` imports JAX), and the port keeps geodesy on
the host, so the jnp branch of the original's ``_xp_of`` is dropped.

Re-implementation of the reference's small-angle expansion lla2ned and
iterative ned2lla (reference src/registercallback.cpp:93-168), batched.

Angles in radians, NED in meters. PRECISION MATTERS: latitude in float32 has
~1e-7 resolution, i.e. ~0.6 m of position quantization, so everything here
runs in float64.
"""
from __future__ import annotations

import numpy as _np


def _xp_of(*args):
    return _np

WGS84_A = 6378137.0
WGS84_E2 = 0.00669437999014132
WGS84_F = 1.0 / 298.257223563


def symmetrical_angle(x):
    """Wrap to [-pi, pi) (reference SymmetricalAngle,
    registercallback.cpp:162-168)."""
    xp = _xp_of(x)
    two_pi = 2.0 * xp.pi
    y = x - two_pi * xp.round(x / two_pi)
    return xp.where(y == xp.pi, -xp.pi, y)


def lla2ned(lla, ref_lla):
    """Small-angle series expansion of geodetic -> local NED
    (registercallback.cpp:93-116). lla, ref_lla: (..., 3) [lat, lon, alt]."""
    xp = _xp_of(lla, ref_lla)
    lat, lon, alt = lla[..., 0], lla[..., 1], lla[..., 2]
    rlat, rlon, ralt = ref_lla[..., 0], ref_lla[..., 1], ref_lla[..., 2]
    dphi = lat - rlat
    dlam = symmetrical_angle(lon - rlon)
    dh = alt - ralt
    cp = xp.cos(rlat)
    sp = xp.sin(rlat)
    tmp1 = xp.sqrt(1.0 - WGS84_E2 * sp * sp)
    tmp3 = tmp1**3
    dlam2 = dlam * dlam
    dphi2 = dphi * dphi
    a = WGS84_A
    e2 = WGS84_E2
    E = (
        (a / tmp1 + ralt) * cp * dlam
        - (a * (1 - e2) / tmp3 + ralt) * sp * dphi * dlam
        + cp * dlam * dh
    )
    N = (
        (a * (1 - e2) / tmp3 + ralt) * dphi
        + 1.5 * cp * sp * a * e2 * dphi2
        + sp * sp * dh * dphi
        + 0.5 * sp * cp * (a / tmp1 + ralt) * dlam2
    )
    D = -(
        dh
        - 0.5 * (a - 1.5 * a * e2 * cp * cp + 0.5 * a * e2 + ralt) * dphi2
        - 0.5 * cp * cp * (a / tmp1 - ralt) * dlam2
    )
    return xp.stack([N, E, D], axis=-1)


def ned2lla(ned, ref_lla, iterations: int = 5):
    """Exact NED -> geodetic via ECEF with a fixed-iteration Bowring solve
    (registercallback.cpp:118-160; the while-loop becomes a fixed 5-step
    unrolled iteration matching its maxIterations)."""
    xp = _xp_of(ned, ref_lla)
    n, e, d = ned[..., 0], ned[..., 1], ned[..., 2]
    rlat, rlon, ralt = ref_lla[..., 0], ref_lla[..., 1], ref_lla[..., 2]
    a = WGS84_A
    f = WGS84_F
    b = (1.0 - f) * a
    e2 = f * (2.0 - f)
    ep2 = e2 / (1.0 - e2)
    slat, clat = xp.sin(rlat), xp.cos(rlat)
    slon, clon = xp.sin(rlon), xp.cos(rlon)
    Nval = a / xp.sqrt(1.0 - e2 * slat * slat)
    rho0 = (Nval + ralt) * clat
    z0 = (Nval * (1.0 - e2) + ralt) * slat
    x0 = rho0 * clon
    y0 = rho0 * slon
    t = clat * (-d) - slat * n
    dz = slat * (-d) + clat * n
    dx = clon * t - slon * e
    dy = slon * t + clon * e
    x, y, z = x0 + dx, y0 + dy, z0 + dz
    lon = xp.arctan2(y, x)
    rho = xp.hypot(x, y)
    beta = xp.arctan2(z, (1.0 - f) * rho)
    lat = xp.arctan2(
        z + b * ep2 * xp.sin(beta) ** 3, rho - a * e2 * xp.cos(beta) ** 3
    )
    for _ in range(iterations):
        beta = xp.arctan2((1.0 - f) * xp.sin(lat), xp.cos(lat))
        lat = xp.arctan2(
            z + b * ep2 * xp.sin(beta) ** 3, rho - a * e2 * xp.cos(beta) ** 3
        )
    slat = xp.sin(lat)
    Nval = a / xp.sqrt(1.0 - e2 * slat * slat)
    alt = rho * xp.cos(lat) + (z + e2 * Nval * slat) * slat - Nval
    return xp.stack([lat, lon, alt], axis=-1)
