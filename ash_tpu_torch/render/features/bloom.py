"""Bloom feature config (copied from ash_tpu/render/features/bloom.py;
reference src/renderer/features/bloom.rs:10-33).

Defaults: threshold 0.8, intensity 0.5, 5 mips, soft knee 0.5, enabled.
The image pipeline is ops/bloom_cuda.py (csrc/bloom.cu on the card, the
plain chain of ops/bloom.py on the CPU), run by render/frame.py.
"""

from __future__ import annotations

import dataclasses

from .feature_trait import RenderFeature


@dataclasses.dataclass
class BloomConfig:
    threshold: float = 0.8
    intensity: float = 0.5
    mip_count: int = 5
    soft_knee: float = 0.5
    enabled: bool = True


class BloomFeature(RenderFeature):
    def __init__(self, config: BloomConfig | None = None):
        self.config = config or BloomConfig()

    def set_enabled(self, enabled: bool) -> None:
        self.config.enabled = enabled
