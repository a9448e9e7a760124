"""WGS-84 ellipsoidal-harmonic gravity, host numpy float64.

A numpy copy of slamtpu/ins/gravity.py: the port cannot import ``slamtpu``
(its ``__init__`` imports JAX), and the only caller, ligo_tc, evaluates it
once on the host scalars of its first nav frame, so it stays on the host
like ``ins/geodesy.py``.

Port of the reference's Somigliana/ellipsoidal-harmonic gravity
(reference src/compcallback.cpp:405-433) with its exact constants
(compcallback.hpp:35-42), used to prime the IMU preintegration gravity
vector (run/pipeline_ligo_tc.cpp:365-404). Batched over numpy arrays.
"""
from __future__ import annotations

import math

import numpy as np

GM = 3986004.418e8
A = 6378137.0
E2_FIRST = 6.69437999014e-3
B_OVER_A = 0.996647189335
OMEGA = 7.292115e-5
B = A * B_OVER_A
E_LIN = math.sqrt(A * A - B * B)  # linear eccentricity
E2_LIN = A * A - B * B


def gravity_wgs84(lat, lon, alt):
    """Gravity magnitude (m/s^2) at geodetic (lat, lon, alt) [rad, rad, m]."""
    lat, lon, alt = (np.asarray(v, np.float64) for v in (lat, lon, alt))
    sinphi = np.sin(lat)
    cosphi = np.cos(lat)
    sinlam = np.sin(lon)
    coslam = np.cos(lon)
    sin2phi = sinphi * sinphi
    N = A / np.sqrt(1.0 - E2_FIRST * sin2phi)
    x = (N + alt) * cosphi * coslam
    y = (N + alt) * cosphi * sinlam
    z = (B_OVER_A * B_OVER_A * N + alt) * sinphi
    D = x * x + y * y + z * z - E2_LIN
    u2 = 0.5 * D * (1.0 + np.sqrt(1.0 + 4.0 * E2_LIN * z * z / (D * D)))
    u2E2 = u2 + E2_LIN
    u = np.sqrt(u2)
    beta = np.arctan2(z * np.sqrt(u2E2), u * np.sqrt(x * x + y * y))
    sinbeta = np.sin(beta)
    cosbeta = np.cos(beta)
    sin2beta = sinbeta * sinbeta
    cos2beta = cosbeta * cosbeta
    w = np.sqrt((u2 + E2_LIN * sin2beta) / u2E2)
    q = 0.5 * ((1.0 + 3.0 * u2 / E2_LIN) * np.arctan(E_LIN / u) - 3.0 * u / E_LIN)
    qo = 0.5 * ((1.0 + 3.0 * B * B / E2_LIN) * np.arctan(E_LIN / B) - 3.0 * B / E_LIN)
    q_prime = 3.0 * ((1.0 + u2 / E2_LIN) * (1.0 - (u / E_LIN) * np.arctan(E_LIN / u))) - 1.0
    cf_u = u * cos2beta * OMEGA * OMEGA / w
    cf_beta = np.sqrt(u2E2) * cosbeta * sinbeta * OMEGA * OMEGA / w
    gamma_u = (
        -(GM / u2E2 + OMEGA * OMEGA * A * A * E_LIN * q_prime * (0.5 * sin2beta - 1.0 / 6.0) / (u2E2 * qo))
        / w
        + cf_u
    )
    gamma_beta = (
        OMEGA * OMEGA * A * A * q * sinbeta * cosbeta / (np.sqrt(u2E2) * w * qo) - cf_beta
    )
    return np.sqrt(gamma_u * gamma_u + gamma_beta * gamma_beta)
