"""Forward+ light culling: the light packing (copied from
ash_tpu/render/features/light_culling.py; reference
src/renderer/features/light_culling.rs).

The GpuLight packing mirrors light_culling.rs:28-63. The culling itself is
ops/light_cull.py, a vectorized test of every (tile, light) pair.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .lighting import DirectionalLight, PointLight


@dataclasses.dataclass
class GpuLight:
    """Packed light record, 4 x vec4 (light_culling.rs:28-37)."""

    position: np.ndarray  # xyz + radius
    color: np.ndarray  # rgb + intensity
    direction: np.ndarray  # xyz + type (0 point, 1 spot, 2 directional)
    params: np.ndarray  # inner cone, outer cone, falloff, enabled

    @staticmethod
    def from_point_light(light: PointLight) -> "GpuLight":
        return GpuLight(
            position=np.array([*light.position, light.radius], np.float32),
            color=np.array([*light.color, light.intensity], np.float32),
            direction=np.zeros(4, np.float32),
            params=np.array([0.0, 0.0, 1.0, 1.0], np.float32),
        )

    @staticmethod
    def from_spot_light(light) -> "GpuLight":
        """Spot light: type 1, cone angles in params.xy."""
        d = np.asarray(light.direction, np.float32)
        d = d / max(float(np.linalg.norm(d)), 1e-8)
        return GpuLight(
            position=np.array([*light.position, light.radius], np.float32),
            color=np.array([*light.color, light.intensity], np.float32),
            direction=np.array([*d, 1.0], np.float32),
            params=np.array(
                [light.inner_cone_angle, light.outer_cone_angle, 1.0, 1.0],
                np.float32,
            ),
        )

    @staticmethod
    def from_directional_light(light: DirectionalLight) -> "GpuLight":
        return GpuLight(
            position=np.array([0, 0, 0, np.finfo(np.float32).max], np.float32),
            color=np.array([*light.color, light.intensity], np.float32),
            direction=np.array([*light.direction, 2.0], np.float32),
            params=np.array([0.0, 0.0, 1.0, 1.0], np.float32),
        )

    def flat(self) -> np.ndarray:
        return np.concatenate(
            [self.position, self.color, self.direction, self.params]
        ).astype(np.float32)
