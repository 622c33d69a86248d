"""Tonemapping feature config (copied from
ash_tpu/render/features/tonemapping.py; reference
src/renderer/features/tonemapping.rs:9-44).

Operators: ACES (default), Reinhard, Uncharted2, None. Defaults: exposure 1.0,
gamma 2.2. Curves implemented in ops/tonemap.py.
"""

from __future__ import annotations

import dataclasses
import enum

from .feature_trait import RenderFeature


class TonemapOperator(enum.Enum):
    ACES = "aces"
    REINHARD = "reinhard"
    UNCHARTED2 = "uncharted2"
    NONE = "none"


@dataclasses.dataclass
class TonemappingConfig:
    operator: TonemapOperator = TonemapOperator.ACES
    exposure: float = 1.0
    gamma: float = 2.2
    enabled: bool = True


class TonemappingFeature(RenderFeature):
    def __init__(self, config: TonemappingConfig | None = None):
        self.config = config or TonemappingConfig()
