"""Hi-Z depth pyramid (port of ash_tpu/ops/hiz.py).

Each level is the 2x2 max of the one below (max depth is the farthest, the
conservative bound for occlusion). Levels are floor-sized: on an odd axis
the trailing row or column is max-folded into the last kept pair, so no
depth is dropped and the uv -> texel mapping of `sample_level` stays exact.
At 1080p the rows go 1080, 540, ..., 4, 2 and the columns 1920, ..., 7, 3.

The pyramid is stored flat, level after level, with a host table of each
level's offset, width and height, so the occlusion pass reads a level
chosen per object with one gather.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

HIZ_LEVELS = 10


class HizPyramid(NamedTuple):
    texels: torch.Tensor  # (TOTAL,) flat depths, level-major
    table: np.ndarray  # (L, 3) host int64: offset, width, height
    levels: int

    def level(self, i: int) -> torch.Tensor:
        off, w, h = (int(x) for x in self.table[i])
        return self.texels[off:off + w * h].reshape(h, w)


def _fold_odd_max(d: torch.Tensor, axis: int) -> torch.Tensor:
    """Max-fold the trailing element of an odd-length axis (longer than 1)
    into the one before it, which drops the axis to an even length."""
    n = d.shape[axis]
    if n <= 1 or n % 2 == 0:
        return d
    merged = torch.maximum(d.narrow(axis, n - 2, 1), d.narrow(axis, n - 1, 1))
    return torch.cat([d.narrow(axis, 0, n - 2), merged], dim=axis)


def _downsample_max(d: torch.Tensor) -> torch.Tensor:
    """One level up: 2x2 max after the odd folds. An axis of length 1 is
    edge-padded to 2, so it stays 1."""
    d = _fold_odd_max(_fold_odd_max(d, 0), 1)
    h, w = d.shape
    if h == 1:
        d = torch.cat([d, d], dim=0)
    if w == 1:
        d = torch.cat([d, d], dim=1)
    nh, nw = d.shape[0] // 2, d.shape[1] // 2
    return d.reshape(nh, 2, nw, 2).amax(dim=(1, 3))


def build_hiz(depth: torch.Tensor, max_levels: int = HIZ_LEVELS) -> HizPyramid:
    """The pyramid of an (H, W) depth buffer; level 0 is the buffer."""
    mips: List[torch.Tensor] = [depth]
    while len(mips) < max_levels and max(mips[-1].shape) > 1:
        mips.append(_downsample_max(mips[-1]))
    table = np.zeros((len(mips), 3), np.int64)
    off = 0
    for i, m in enumerate(mips):
        h, w = m.shape
        table[i] = (off, w, h)
        off += h * w
    texels = torch.cat([m.reshape(-1) for m in mips])
    return HizPyramid(texels=texels, table=table, levels=len(mips))


def sample_level(pyr: HizPyramid, level: torch.Tensor, u: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    """Nearest sample of each (u, v) at a per-element level (textureLod).
    The texel index truncates u * width toward zero, then clamps."""
    table = torch.from_numpy(pyr.table.astype(np.int32)).to(u.device)
    entry = table[level.clamp(0, pyr.levels - 1).long()]
    off, w, h = entry[..., 0], entry[..., 1], entry[..., 2]
    x = torch.minimum((u * w.to(torch.float32)).to(torch.int32).clamp_min(0),
                      w - 1)
    y = torch.minimum((v * h.to(torch.float32)).to(torch.int32).clamp_min(0),
                      h - 1)
    return pyr.texels[(off + y * w + x).long()]
