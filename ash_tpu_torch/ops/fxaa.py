"""FXAA: fast approximate antialiasing on the tonemapped LDR image (port of
ash_tpu/ops/fxaa.py).

A console-style single pass: luma edge detection with an absolute and a
relative contrast threshold, then a blend toward the 3x3 tent-filtered
neighbourhood in proportion to the sub-pixel contrast. It runs after tonemap
and gamma. Inside, the image is planar and every neighbour fetch is a shift
of an edge-padded plane.
"""

from __future__ import annotations

import torch

from .bloom import shift_planar, to_planar

EDGE_THRESHOLD = 1.0 / 8.0  # relative contrast threshold
EDGE_THRESHOLD_MIN = 1.0 / 24.0  # absolute floor
SUBPIX_STRENGTH = 0.75


def fxaa(color: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) LDR in, antialiased (H, W, 3) out."""
    planes = to_planar(color)
    r, g, b = planes[0], planes[1], planes[2]
    luma = (0.299 * r + 0.587 * g + 0.114 * b)[None]

    l_n = shift_planar(luma, -1, 0)
    l_s = shift_planar(luma, 1, 0)
    l_e = shift_planar(luma, 0, 1)
    l_w = shift_planar(luma, 0, -1)

    l_min = torch.minimum(luma, torch.minimum(torch.minimum(l_n, l_s),
                                              torch.minimum(l_e, l_w)))
    l_max = torch.maximum(luma, torch.maximum(torch.maximum(l_n, l_s),
                                              torch.maximum(l_e, l_w)))
    contrast = l_max - l_min
    threshold = (l_max * EDGE_THRESHOLD).clamp_min(EDGE_THRESHOLD_MIN)
    is_edge = contrast >= threshold

    # Sub-pixel blend amount: how far the centre lies from the local
    # lowpass, normalized by the contrast.
    lowpass = (l_n + l_s + l_e + l_w) * 0.25
    blend = ((lowpass - luma).abs() / contrast.clamp_min(1e-6)).clamp(0.0, 1.0)
    blend = (blend * blend) * SUBPIX_STRENGTH

    # The 3x3 tent-filtered colour, all three planes at once.
    def sh(dy, dx):
        return shift_planar(planes, dy, dx)

    tent = planes * 4.0
    tent = tent + (sh(-1, 0) + sh(1, 0) + sh(0, 1) + sh(0, -1)) * 2.0
    tent = tent + (sh(-1, -1) + sh(-1, 1) + sh(1, -1) + sh(1, 1))
    tent = tent / 16.0

    amount = torch.where(is_edge, blend, 0.0)
    return (planes * (1.0 - amount) + tent * amount).permute(1, 2, 0).contiguous()
