"""Auto-rotate feature (copy of ash_tpu/render/features/auto_rotate.py;
reference src/renderer/features/auto_rotate.rs).

Spins the single-mesh transform by euler increments when ctx.auto_rotate is
set; the renderer disables it by default (reference renderer.rs:1635).
"""

from __future__ import annotations

import numpy as np

from .feature_trait import FeatureFrameContext, RenderFeature


class AutoRotateFeature(RenderFeature):
    def __init__(self, speed=(0.0, 1.0, 0.0)):
        self.speed = np.asarray(speed, np.float32)  # radians/second per axis

    def before_frame(self, ctx: FeatureFrameContext) -> None:
        if ctx.auto_rotate and ctx.transform is not None:
            ctx.transform.rotate(self.speed * ctx.delta_time)
