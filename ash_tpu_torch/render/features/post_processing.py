"""Post-processing feature config (copied from
ash_tpu/render/features/post_processing.py; reference
src/renderer/features/post_processing.rs:4-22).

Defaults: bloom on, fxaa on, tonemapping on, exposure 1.0, gamma 2.2. The
renderer consumes these through initialize_hdr + the setter API; FXAA runs
after tonemapping when enabled (ops/fxaa.py).
"""

from __future__ import annotations

import dataclasses

from .feature_trait import RenderFeature


@dataclasses.dataclass
class PostProcessingConfig:
    enable_bloom: bool = True
    enable_fxaa: bool = True
    enable_tonemapping: bool = True
    exposure: float = 1.0
    gamma: float = 2.2


class PostProcessingFeature(RenderFeature):
    def __init__(self, config: PostProcessingConfig | None = None):
        self.config = config or PostProcessingConfig()

    def apply_to(self, renderer) -> None:
        """Push this config into a Renderer's post state."""
        renderer.initialize_hdr()
        renderer.set_bloom_enabled(self.config.enable_bloom)
        renderer.set_tonemapping_enabled(self.config.enable_tonemapping)
        renderer.set_tonemapping_exposure(self.config.exposure)
        renderer.set_tonemapping_gamma(self.config.gamma)
        renderer.set_fxaa_enabled(self.config.enable_fxaa)
