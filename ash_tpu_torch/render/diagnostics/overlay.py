"""Diagnostics text overlay (port of ash_tpu/render/diagnostics/overlay.py).

The stats lines are drawn on the host with the embedded 8x8 font into a
small RGBA patch (numpy, as in the reference); `composite` alpha-blends it
onto the presented frame on the frame's device, before the frame's one copy
to the host. The patch moves to the device once per change of its text.

Defaults are the reference's OverlayConfig: scale 2, green text on a
translucent black background, an 8-pixel margin.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from .font_data import GLYPH_SIZE, glyph


class TextVertex(NamedTuple):
    """Overlay vertex (pos, uv, colour), as the reference's TextVertex."""

    pos: Tuple[float, float]
    uv: Tuple[float, float]
    color: Tuple[float, float, float, float]


@dataclasses.dataclass
class OverlayConfig:
    scale: int = 2
    text_color: Tuple[float, float, float, float] = (0.0, 1.0, 0.0, 1.0)
    background_color: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.6)
    margin: int = 8
    line_spacing: int = 2


def pixel_to_ndc(x: float, y: float, width: int, height: int):
    """Pixel -> NDC (y down)."""
    return (x / width * 2.0 - 1.0, y / height * 2.0 - 1.0)


def generate_quad_ndc(x: float, y: float, w: float, h: float,
                      width: int, height: int, color, uv=(0, 0, 1, 1)):
    """A two-triangle quad as TextVertex tuples in NDC, for consumers that
    build their own overlay geometry."""
    x0, y0 = pixel_to_ndc(x, y, width, height)
    x1, y1 = pixel_to_ndc(x + w, y + h, width, height)
    u0, v0, u1, v1 = uv
    c = tuple(color)
    return [
        TextVertex((x0, y0), (u0, v0), c),
        TextVertex((x1, y0), (u1, v0), c),
        TextVertex((x1, y1), (u1, v1), c),
        TextVertex((x0, y0), (u0, v0), c),
        TextVertex((x1, y1), (u1, v1), c),
        TextVertex((x0, y1), (u0, v1), c),
    ]


def render_text_patch(lines: List[str], config: OverlayConfig) -> np.ndarray:
    """Rasterize text lines to an RGBA float patch (H, W, 4)."""
    if not lines:
        return np.zeros((1, 1, 4), np.float32)
    s = config.scale
    g = GLYPH_SIZE * s
    line_h = g + config.line_spacing * s
    width = max(len(ln) for ln in lines) * g + 2 * config.margin
    height = len(lines) * line_h + 2 * config.margin

    patch = np.zeros((height, width, 4), np.float32)
    patch[:] = np.asarray(config.background_color, np.float32)

    text = np.asarray(config.text_color, np.float32)
    for li, line in enumerate(lines):
        y0 = config.margin + li * line_h
        for ci, ch in enumerate(line):
            mask = glyph(ch)
            if s != 1:
                mask = np.repeat(np.repeat(mask, s, 0), s, 1)
            x0 = config.margin + ci * g
            region = patch[y0 : y0 + g, x0 : x0 + g]
            m = mask[..., None].astype(np.float32)
            region[:] = region * (1 - m) + text * m
    return patch


class DiagnosticsOverlay:
    """Builds the overlay patch and composites it."""

    def __init__(self, config: OverlayConfig | None = None):
        self.config = config or OverlayConfig()
        self._cache_key = None
        self._cache_patch = None
        self._device_patch = None  # (device, patch, 255.0) on the device

    def patch(self, lines: List[str]) -> np.ndarray:
        key = tuple(lines)
        if key != self._cache_key:
            self._cache_patch = render_text_patch(lines, self.config)
            self._cache_key = key
            self._device_patch = None
        return self._cache_patch

    def composite(self, image_u8: torch.Tensor, lines: List[str]) -> torch.Tensor:
        """Alpha-blend the overlay onto an (H, W, 4) u8 frame tensor, on its
        device, in place; returns the frame."""
        patch = self.patch(lines)
        h, w = image_u8.shape[:2]
        ph, pw = min(patch.shape[0], h), min(patch.shape[1], w)
        dev = image_u8.device
        if self._device_patch is None or self._device_patch[0] != dev:
            # The divisor rides on the device too: CUDA divides by a host
            # scalar as a product with its reciprocal, which can round
            # otherwise than the reference's division.
            self._device_patch = (dev, torch.from_numpy(patch).to(dev),
                                  torch.full((), 255.0, device=dev))
        _, p, full = self._device_patch
        p = p[:ph, :pw]
        region = image_u8[:ph, :pw, :3].to(torch.float32) / full
        a = p[..., 3:4]
        blended = region * (1 - a) + p[..., :3] * a
        image_u8[:ph, :pw, :3] = (blended * 255.0 + 0.5).clamp(0, 255).to(
            torch.uint8)
        return image_u8
