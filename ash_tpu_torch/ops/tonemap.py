"""Tonemapping operators and gamma (port of ash_tpu/ops/tonemap.py).

The post pass composites bloom, applies exposure, tonemaps and
gamma-encodes. Operators: ACES (the Narkowicz fit, a=2.51 b=0.03 c=2.43
d=0.59 e=0.14), Reinhard, Uncharted2 filmic, and "none" (a clamp). Every
operation is per channel and elementwise, so the (H, W, 3) image is used as
it comes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def aces(x: torch.Tensor) -> torch.Tensor:
    """ACES filmic fit."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return ((x * (a * x + b)) / (x * (c * x + d) + e)).clamp(0.0, 1.0)


def reinhard(x: torch.Tensor) -> torch.Tensor:
    """c / (c + 1)."""
    return x / (x + 1.0)


def _uncharted2_curve(x):
    a, b, c, d, e, f = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return ((x * (a * x + c * b) + d * e) / (x * (a * x + b) + d * f)) - e / f


def uncharted2(x: torch.Tensor, white_point: float = 11.2) -> torch.Tensor:
    """Hable/Uncharted2 filmic, normalized at the white point."""
    return (_uncharted2_curve(x) / _uncharted2_curve(white_point)).clamp(0.0, 1.0)


OPERATORS = {
    "aces": aces,
    "reinhard": reinhard,
    "uncharted2": uncharted2,
    "none": lambda x: x.clamp(0.0, 1.0),
}


def tonemap_compose(
    hdr: torch.Tensor,  # (H, W, 3) linear HDR
    bloom: Optional[torch.Tensor],  # (H, W, 3) or None
    exposure: float,
    gamma: float,
    bloom_intensity: float,
    operator: str = "aces",
) -> torch.Tensor:
    """The post composite: hdr += bloom * intensity; *= exposure; tonemap;
    pow(1 / gamma). The three knobs are host numbers, taken as float32."""
    if operator not in OPERATORS:
        raise ValueError(f"unknown tonemap operator {operator!r}")
    x = hdr
    if bloom is not None:
        x = x + bloom * float(np.float32(bloom_intensity))
    x = x * float(np.float32(exposure))
    ldr = OPERATORS[operator](x)
    inv_gamma = float(np.float32(1.0) / np.float32(gamma))
    return torch.pow(ldr.clamp_min(0.0), inv_gamma)
