"""Shadow map state: light-space matrix fitting + config.

Copied from ash_tpu/render/shadow_map.py (host numpy only), itself the
counterpart of the reference's shadow implementation
(src/renderer/shadow_map.rs). The Vulkan plumbing (depth image, render pass,
border sampler) disappears: the shadow "map" is simply a (S, S) depth array
produced by running the shared rasterizer depth-only with the light matrix
(see render/frame.py); the sampler semantics live in ops/shadow.py.

What remains host-side is the math: an orthographic light frustum fitted to
the scene bounding sphere (shadow_map.rs:224-247) and the quality knobs
(ShadowConfig, shadow_map.rs:25-35).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core import maths


@dataclasses.dataclass
class ShadowConfig:
    """Reference shadow_map.rs:25-35 defaults."""

    resolution: int = 2048
    depth_bias: float = 0.005
    slope_bias: float = 0.05
    pcf_size: int = 3
    enabled: bool = True


def directional_light_matrix(
    light_dir, scene_center, scene_radius: float
) -> np.ndarray:
    """Ortho light-space matrix fitted to the scene sphere
    (shadow_map.rs:224-247): eye = center - dir * 2r, look_at_rh toward the
    center, ortho [-r, r]^2 with depth range [0.1, 4r]."""
    light_dir = np.asarray(light_dir, np.float32)
    scene_center = np.asarray(scene_center, np.float32)
    n = light_dir / max(float(np.linalg.norm(light_dir)), 1e-8)
    light_pos = scene_center - n * (scene_radius * 2.0)
    light_view = maths.look_at_rh(light_pos, scene_center, maths.stable_up(n))
    light_proj = maths.orthographic_rh(
        -scene_radius,
        scene_radius,
        -scene_radius,
        scene_radius,
        0.1,
        scene_radius * 4.0,
    )
    return (light_proj @ light_view).astype(np.float32)


class ShadowMapState:
    """Holds the current light matrix (device work happens in the frame fn)."""

    def __init__(self, config: ShadowConfig | None = None):
        self.config = config or ShadowConfig()
        self.light_space_matrix = maths.mat4_identity()
        self._update_key = None  # last (dir, center, radius) fitted

    @property
    def resolution(self) -> int:
        return self.config.resolution

    def update_light_matrix(self, light_dir, scene_center, scene_radius):
        # Value-cached: runs every frame on the host, and the inputs only
        # change when the light or scene bounds move.
        key = (
            np.asarray(light_dir, np.float32).tobytes(),
            np.asarray(scene_center, np.float32).tobytes(),
            float(scene_radius),
        )
        if key != self._update_key:
            self._update_key = key
            self.light_space_matrix = directional_light_matrix(
                light_dir, scene_center, scene_radius
            )
        return self.light_space_matrix
