"""TemporalAA manager: Halton jitter sequence + jittered projection (copied
from ash_tpu/render/temporal_aa.py; reference src/renderer/temporal_aa.rs).

Host-side numpy. Defaults match
TaaConfig (temporal_aa.rs:29-39): blend 0.9, color clamp on, velocity
rejection on, jitter scale 1.0. The resolve is ops/taa.py; the history is
explicit state carried by the renderer.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.maths import halton


@dataclasses.dataclass
class TaaConfig:
    """temporal_aa.rs:16-39."""

    enabled: bool = True
    blend_factor: float = 0.9
    color_clamp: bool = True
    velocity_rejection: bool = True
    jitter_scale: float = 1.0


class HaltonSequence:
    """Halton(2,3) jitter in [-0.5, 0.5], index mod 16 (temporal_aa.rs:42-77)."""

    def __init__(self):
        self.index = 0

    def next_jitter(self) -> np.ndarray:
        j = np.array(
            [halton(self.index + 1, 2) - 0.5, halton(self.index + 1, 3) - 0.5],
            np.float32,
        )
        self.index = (self.index + 1) % 16
        return j

    def reset(self) -> None:
        self.index = 0


class TemporalAA:
    """Jitter bookkeeping (temporal_aa.rs:110-208)."""

    def __init__(self, config: TaaConfig | None = None):
        self.config = config or TaaConfig()
        self.halton = HaltonSequence()
        self.current_jitter = np.zeros(2, np.float32)
        self.previous_jitter = np.zeros(2, np.float32)
        self.frame_index = 0

    def begin_frame(self) -> None:
        """temporal_aa.rs:137-141."""
        self.previous_jitter = self.current_jitter
        self.current_jitter = (
            self.halton.next_jitter() * self.config.jitter_scale
        )
        self.frame_index += 1

    def jitter_projection(
        self, projection: np.ndarray, width: int, height: int
    ) -> np.ndarray:
        """Perturb the projection so NDC shifts by a CONSTANT 2*jitter/screen.

        Deviation from the reference (temporal_aa.rs:144-156, which adds
        the offset to w_axis.xy — the translation column): under a
        perspective matrix w_clip = ±z_view, so a translation-column
        offset lands jitter/|z| PIXELS on screen — depth-dependent, while
        the TAA resolve compensates with the full constant jitter
        (taa_resolve's unjitter + reprojection fallback). Distant
        geometry would receive almost no jitter yet be "corrected" by the
        full amount. The reference never wired TAA into its frame loop,
        so the quirk was latent there; we perturb the Z COLUMN scaled by
        proj[3,2] (x_clip += j*w_clip => ndc_x += j exactly, any w = ±z
        convention, Y-flip-safe). Orthographic projections (w_clip = 1)
        keep the reference's translation-column form, which is exact
        there."""
        if not self.config.enabled:
            return projection
        j = np.array(projection, np.float32, copy=True)
        jx = self.current_jitter[0] * 2.0 / width
        jy = self.current_jitter[1] * 2.0 / height
        wz = float(projection[3, 2])  # w_clip = wz * z_view (perspective)
        if wz != 0.0:
            j[0, 2] += jx * wz
            j[1, 2] += jy * wz
        else:  # orthographic: w_clip == 1, translation column is exact
            j[0, 3] += jx
            j[1, 3] += jy
        return j

    def params(self):
        """Resolve-kernel parameters (temporal_aa.rs:159-180)."""
        return dict(
            blend_factor=np.float32(self.config.blend_factor),
            color_clamp=np.float32(1.0 if self.config.color_clamp else 0.0),
            velocity_rejection=np.float32(
                1.0 if self.config.velocity_rejection else 0.0
            ),
            jitter=self.current_jitter,
            prev_jitter=self.previous_jitter,
        )

    def is_enabled(self) -> bool:
        return self.config.enabled

    def reset_history(self) -> None:
        """temporal_aa.rs:203-207."""
        self.halton.reset()
        self.current_jitter = np.zeros(2, np.float32)
        self.previous_jitter = np.zeros(2, np.float32)
