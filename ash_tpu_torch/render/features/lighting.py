"""Lighting feature: light types + config (copied from
ash_tpu/render/features/lighting.py; reference
src/renderer/features/lighting.rs:5-58).

The lights collected here feed the Forward+ light-culling pass and the
shading pass's light loop (render/frame.py).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from .feature_trait import RenderFeature


@dataclasses.dataclass
class DirectionalLight:
    direction: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([-0.5, -1.0, -0.3], np.float32)
    )
    color: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3, np.float32)
    )
    intensity: float = 1.0


@dataclasses.dataclass
class PointLight:
    position: np.ndarray
    color: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3, np.float32)
    )
    intensity: float = 1.0
    radius: float = 10.0


@dataclasses.dataclass
class SpotLight:
    position: np.ndarray
    direction: np.ndarray
    color: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3, np.float32)
    )
    intensity: float = 1.0
    radius: float = 10.0
    inner_cone_angle: float = 0.3  # radians
    outer_cone_angle: float = 0.5


@dataclasses.dataclass
class LightingConfig:
    max_point_lights: int = 1024


class LightingFeature(RenderFeature):
    def __init__(self, config: LightingConfig | None = None):
        self.config = config or LightingConfig()
        self.point_lights: List[PointLight] = []
        self.spot_lights: List[SpotLight] = []
        # Bumped on every add/clear so the renderer can cache the packed
        # GPU light array across frames (host-side packing of a large
        # light set costs real per-frame milliseconds otherwise).
        self.version = 0

    def add_point_light(self, light: PointLight) -> int:
        if len(self.point_lights) >= self.config.max_point_lights:
            raise ValueError(
                f"max {self.config.max_point_lights} point lights"
            )
        self.point_lights.append(light)
        self.version += 1
        return len(self.point_lights) - 1

    def add_spot_light(self, light: SpotLight) -> int:
        self.spot_lights.append(light)
        self.version += 1
        return len(self.spot_lights) - 1

    def clear_point_lights(self) -> None:
        self.point_lights.clear()
        self.version += 1

    def clear_spot_lights(self) -> None:
        self.spot_lights.clear()
        self.version += 1

    def clear_lights(self) -> None:
        """Remove every point AND spot light."""
        self.point_lights.clear()
        self.spot_lights.clear()
        self.version += 1
