"""TAA resolve (port of ash_tpu/ops/taa.py).

Blends the current frame with the reprojected history:
- the history is fetched at uv - velocity (the jitter difference where the
  velocity is under 1e-4, or where there is no velocity buffer);
- a 3x3 neighbourhood AABB in tonemapped YCoCg, widened 1.25x, and a clip of
  the history toward its centre;
- a Reinhard tonemap and its inverse around the clamp;
- the blend weight falls with the velocity in pixels, and is 0 where the
  history lies off screen.

The resolve is a pure function: (current, history) -> resolved, and the
caller keeps `resolved` as the next history. The two switches of TaaParams
are host values, so the clamp and the rejection are Python branches; the
blend factor and the jitters are host values or tensors on the frame's
device (the renderer's, so a captured frame reads each frame's own), with
the same f32 arithmetic either way. Inside, the image is planar (3, H, W); the
neighbourhood taps are integer shifts of an edge-padded image and only the
history fetch gathers.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import constant
from .bloom import (
    bilinear_planar,
    shift_planar,
    target_uv,
    to_interleaved,
    to_planar,
)


class TaaParams(NamedTuple):
    """Resolve parameters. The switches are host floats; the blend factor
    and the jitters host values or f32 device tensors (0-d and (2,))."""

    blend_factor: float  # weight of the history, default 0.9
    color_clamp: float  # > 0.5: clamp the history to the neighbourhood
    velocity_rejection: float  # > 0.5: the blend falls with the velocity
    jitter: np.ndarray  # (2,) this frame's subpixel jitter, in pixels
    prev_jitter: np.ndarray  # (2,)


def _jitter_velocity(params: TaaParams, h: int, w: int, device) -> tuple:
    """((2,) jitter difference over the screen size, () blend factor) as
    f32 tensors: computed on the device from device values, else with
    numpy on the host (CPU tensors, which CUDA ops take as scalars). The
    same f32 subtraction and division either way."""
    if isinstance(params.jitter, torch.Tensor):
        screen = constant([w, h], torch.float32, device)
        jv = (params.jitter - params.prev_jitter) / screen
        return jv, params.blend_factor
    screen = np.array([w, h], np.float32)
    jv = (np.asarray(params.jitter, np.float32)
          - np.asarray(params.prev_jitter, np.float32)) / screen
    return (torch.from_numpy(jv),
            torch.tensor(np.float32(params.blend_factor)))


def rgb_to_ycocg(rgb: torch.Tensor) -> torch.Tensor:
    return torch.stack(_rgb_to_ycocg(rgb[..., 0], rgb[..., 1], rgb[..., 2]), -1)


def ycocg_to_rgb(c: torch.Tensor) -> torch.Tensor:
    return torch.stack(_ycocg_to_rgb(c[..., 0], c[..., 1], c[..., 2]), -1)


def _rgb_to_ycocg(r, g, b):
    return (0.25 * r + 0.5 * g + 0.25 * b, 0.5 * r - 0.5 * b,
            -0.25 * r + 0.5 * g - 0.25 * b)


def _ycocg_to_rgb(y, co, cg):
    return (y + co - cg, y + cg, y - co - cg)


def _tm(c):
    return c / (1.0 + c)


def _untm(c):
    return c / (1.0 - c + 1e-4)


def clip_aabb(aabb_min, aabb_max, history):
    """Clip the history toward the AABB's centre; channels on the last axis."""
    center = 0.5 * (aabb_max + aabb_min)
    half = 0.5 * (aabb_max - aabb_min) + 1e-3
    delta = history - center
    max_v = (delta / half).abs().amax(dim=-1, keepdim=True)
    return torch.where(max_v > 1.0, center + delta / max_v, history)


def _clamped_history(cur: torch.Tensor, hist: torch.Tensor) -> torch.Tensor:
    """The history (3, H, W) clipped to the current frame's 3x3
    neighbourhood AABB in tonemapped YCoCg."""
    mins = maxs = None
    for oy in (-1, 0, 1):
        for ox in (-1, 0, 1):
            s = shift_planar(cur, oy, ox)
            c = _rgb_to_ycocg(_tm(s[0]), _tm(s[1]), _tm(s[2]))
            if mins is None:
                mins, maxs = list(c), list(c)
            else:
                mins = [torch.minimum(a, x) for a, x in zip(mins, c)]
                maxs = [torch.maximum(a, x) for a, x in zip(maxs, c)]
    center = [(mn + mx) * 0.5 for mn, mx in zip(mins, maxs)]
    extent = [(mx - mn) * 0.5 for mn, mx in zip(mins, maxs)]
    mins = [c - e * 1.25 for c, e in zip(center, extent)]
    maxs = [c + e * 1.25 for c, e in zip(center, extent)]
    hist_c = _rgb_to_ycocg(_tm(hist[0]), _tm(hist[1]), _tm(hist[2]))
    # clip_aabb, plane by plane.
    ctr = [(mx + mn) * 0.5 for mn, mx in zip(mins, maxs)]
    half = [(mx - mn) * 0.5 + 1e-3 for mn, mx in zip(mins, maxs)]
    delta = [hc - c for hc, c in zip(hist_c, ctr)]
    ratios = [d.abs() / hf for d, hf in zip(delta, half)]
    max_v = torch.maximum(ratios[0], torch.maximum(ratios[1], ratios[2]))
    clipped = [torch.where(max_v > 1.0, c + d / max_v, hc)
               for hc, c, d in zip(hist_c, ctr, delta)]
    return torch.stack([_untm(p) for p in _ycocg_to_rgb(*clipped)])


def taa_resolve(
    current: torch.Tensor,  # (H, W, 3) current frame (HDR, before tonemap)
    history: torch.Tensor,  # (H, W, 3) previous resolved frame
    params: TaaParams,
    velocity: Optional[torch.Tensor] = None,  # (H, W, 2) uv motion or None
) -> torch.Tensor:
    h, w = current.shape[:2]
    cur = to_planar(current)
    u, v = target_uv(h, w, current.device)

    jitter_vel, blend_factor = _jitter_velocity(params, h, w, current.device)
    vel_u, vel_v = jitter_vel[0], jitter_vel[1]
    if velocity is not None:
        vx, vy = velocity[..., 0], velocity[..., 1]
        small = torch.sqrt(vx * vx + vy * vy) < 1e-4
        vel_u = torch.where(small, vel_u, vx)
        vel_v = torch.where(small, vel_v, vy)

    hist_u_raw = u - vel_u
    hist_v_raw = v - vel_v
    hist = bilinear_planar(to_planar(history), hist_u_raw.clamp(0.0, 1.0),
                           hist_v_raw.clamp(0.0, 1.0))
    if params.color_clamp > 0.5:
        hist = _clamped_history(cur, hist)

    blend = blend_factor
    if params.velocity_rejection > 0.5:
        pu, pv = vel_u * w, vel_v * h
        vel_len = torch.sqrt(pu * pu + pv * pv)
        blend = blend * (1.0 - vel_len * 0.1).clamp(0.0, 1.0)
    onscreen = ((hist_u_raw >= 0.0) & (hist_u_raw <= 1.0)
                & (hist_v_raw >= 0.0) & (hist_v_raw <= 1.0))
    blend = torch.where(onscreen, blend, 0.0)
    return to_interleaved(cur * (1.0 - blend) + hist * blend)
