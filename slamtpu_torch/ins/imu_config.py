"""Host copy of ``slamtpu/ins/imu_config.py`` (numpy only, code unchanged).

The port cannot import it from ``slamtpu``: ``slamtpu/__init__.py``
imports JAX, so any ``import slamtpu.<module>`` pulls JAX in, and the
GPU port runs where JAX is absent. The docstring below is the
original's.

IMU noise-model configuration (cf. CompCallback::ParseMetadata,
reference src/compcallback.cpp:28-157 and
reference config/imu_config_berlin.json)."""
from __future__ import annotations

import dataclasses
import json

import numpy as np


@dataclasses.dataclass(frozen=True)
class ImuConfig:
    update_rate_hz: float = 50.0
    static_bias_accel: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    static_bias_gyro: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    velocity_random_walk: np.ndarray = dataclasses.field(
        default_factory=lambda: np.full(3, 1e-3)
    )  # accel white noise density
    angular_random_walk: np.ndarray = dataclasses.field(
        default_factory=lambda: np.full(3, 1e-4)
    )  # gyro white noise density
    bias_instability_accel: np.ndarray = dataclasses.field(
        default_factory=lambda: np.full(3, 1e-4)
    )
    bias_instability_gyro: np.ndarray = dataclasses.field(
        default_factory=lambda: np.full(3, 1e-5)
    )
    bias_random_walk_accel: np.ndarray = dataclasses.field(
        default_factory=lambda: np.full(3, 1e-5)
    )
    bias_random_walk_gyro: np.ndarray = dataclasses.field(
        default_factory=lambda: np.full(3, 1e-6)
    )
    body_to_imu_rotation: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(3))
    body_to_imu_translation: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3)
    )

    @property
    def dt(self) -> float:
        return 1.0 / self.update_rate_hz

    @classmethod
    def from_json(cls, obj: dict) -> "ImuConfig":
        p = obj["imu_parameter"]

        def vec(key, default):
            return np.asarray(p[key], np.float64) if key in p else default

        kw = dict(
            update_rate_hz=float(p.get("updateRateHz", 50.0)),
            static_bias_accel=vec("staticBiasAccelerometer", np.zeros(3)),
            static_bias_gyro=vec("staticBiasGyroscope", np.zeros(3)),
            velocity_random_walk=vec("velocityRandomWalk", np.full(3, 1e-3)),
            angular_random_walk=vec("angularRandomWalk", np.full(3, 1e-4)),
            bias_instability_accel=vec("biasInstabilityAccelerometer", np.full(3, 1e-4)),
            bias_instability_gyro=vec("biasInstabilityGyroscope", np.full(3, 1e-5)),
            bias_random_walk_accel=vec("biasRandomWalkAccelerometer", np.full(3, 1e-5)),
            bias_random_walk_gyro=vec("biasRandomWalkGyroscope", np.full(3, 1e-6)),
        )
        if "Cb2m" in p:
            kw["body_to_imu_rotation"] = np.asarray(p["Cb2m"], np.float64).reshape(3, 3)
        if "tb2m" in p:
            kw["body_to_imu_translation"] = np.asarray(p["tb2m"], np.float64)
        return cls(**kw)

    @classmethod
    def from_file(cls, path: str) -> "ImuConfig":
        with open(path) as f:
            return cls.from_json(json.load(f))
