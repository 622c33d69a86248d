"""CPU texture data + mip-chain generation.

TPU-native re-design of reference src/renderer/resources/texture.rs. The
reference uploads RGBA8 data to a Vulkan image and builds a full mip chain with
a `cmd_blit_image` LINEAR loop (texture.rs:163-270); sampling uses a REPEAT
sampler with LINEAR min/mag/mip filtering (texture.rs:313-327).

Here a texture is a numpy RGBA array plus a precomputed mip pyramid. Textures
are flattened into a single "bindless" pool by the renderer (the reference's
render/bindless.py, ROADMAP A10 in the port); sampling happens inside the
shading pass (ops/texture_sample.py) with the same REPEAT + trilinear
semantics. sRGB textures (albedo, emissive — texture.rs upload formats, see
mesh.rs:745-799) are converted to linear at build time, since the Vulkan sRGB
image formats decode on fetch.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


def srgb_to_linear(c: np.ndarray) -> np.ndarray:
    """Exact sRGB EOTF (what VK_FORMAT_*_SRGB hardware decode applies)."""
    c = c.astype(np.float32)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4).astype(
        np.float32
    )


def linear_to_srgb(c: np.ndarray) -> np.ndarray:
    c = np.clip(c.astype(np.float32), 0.0, 1.0)
    return np.where(
        c <= 0.0031308, c * 12.92, 1.055 * np.power(c, 1.0 / 2.4) - 0.055
    ).astype(np.float32)


def mip_chain(levels_needed: Optional[int], base: np.ndarray) -> List[np.ndarray]:
    """Full mip chain by 2x2 box reduction (matches the reference's LINEAR
    blit mipgen, texture.rs:163-270, to within filtering differences).

    ``base`` is (H, W, C) float32. Returns [base, mip1, ...] down to 1x1 (or
    ``levels_needed`` levels if given).
    """
    mips = [base]
    h, w = base.shape[:2]
    while (h > 1 or w > 1) and (levels_needed is None or len(mips) < levels_needed):
        nh, nw = max(h // 2, 1), max(w // 2, 1)
        src = mips[-1]
        # Match Vulkan mip sizing (floor): crop odd trailing rows/cols, pad
        # 1-wide dims by edge-replication, then 2x2 average.
        ph, pw = nh * 2, nw * 2
        if src.shape[0] < ph or src.shape[1] < pw:
            src = np.pad(
                src,
                (
                    (0, max(0, ph - src.shape[0])),
                    (0, max(0, pw - src.shape[1])),
                    (0, 0),
                ),
                mode="edge",
            )
        src = src[:ph, :pw]
        down = src.reshape(nh, 2, nw, 2, -1).mean(axis=(1, 3))
        mips.append(down.astype(np.float32))
        h, w = nh, nw
    return mips


def max_mip_levels(width: int, height: int) -> int:
    """floor(log2(max(w,h))) + 1 — same formula as the reference
    (texture.rs mip_levels calculation)."""
    return int(np.floor(np.log2(max(width, height)))) + 1


@dataclasses.dataclass
class TextureData:
    """CPU-side RGBA8 texture payload (reference: texture.rs `TextureData`)."""

    width: int
    height: int
    pixels: np.ndarray  # (H, W, 4) uint8
    srgb: bool = True

    def __post_init__(self):
        self.pixels = np.asarray(self.pixels, dtype=np.uint8).reshape(
            self.height, self.width, 4
        )

    @staticmethod
    def solid_color(rgba, width: int = 1, height: int = 1, srgb: bool = True) -> "TextureData":
        """1x1 default texture (reference: texture.rs:31-37)."""
        px = np.broadcast_to(
            np.asarray(rgba, dtype=np.uint8).reshape(1, 1, 4), (height, width, 4)
        ).copy()
        return TextureData(width=width, height=height, pixels=px, srgb=srgb)

    @staticmethod
    def white() -> "TextureData":
        """The renderer's default 1x1 white texture
        (reference: renderer.rs:468-477)."""
        return TextureData.solid_color([255, 255, 255, 255])

    @staticmethod
    def checkerboard(size: int = 64, cell: int = 8) -> "TextureData":
        yy, xx = np.mgrid[0:size, 0:size]
        mask = ((yy // cell + xx // cell) % 2).astype(np.uint8)
        px = np.empty((size, size, 4), np.uint8)
        px[..., :3] = np.where(mask[..., None] > 0, 230, 40)
        px[..., 3] = 255
        return TextureData(size, size, px)

    def to_linear_f32(self) -> np.ndarray:
        """Decode to linear float32 (H, W, 4); alpha stays linear."""
        f = self.pixels.astype(np.float32) / 255.0
        if self.srgb:
            rgb = srgb_to_linear(f[..., :3])
            return np.concatenate([rgb, f[..., 3:4]], axis=-1)
        return f
