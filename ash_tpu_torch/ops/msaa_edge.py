"""Edge-adaptive MSAA resolve (port of ash_tpu/ops/msaa_edge.py).

Hardware MSAA rasterizes at sample rate but shades once per pixel, paying
the multisample cost only at geometry edges. Plain SSAA shades every
sample. This module gives the hardware cost profile:

1. the visibility buffer is rasterized at sample rate;
2. each presentation pixel is `uniform` when all its samples see the same
   triangle (or all see the background);
3. uniform pixels shade once at the pixel centre, with uv derivatives that
   step one presentation pixel, so mip selection sees the 1x footprint;
4. edge pixels are compacted (an exclusive prefix sum) into a worklist of
   fixed capacity whose samples shade at sample rate and are box-averaged
   back.

Shading cost is about 1x + N x the edge share instead of Nx. Pixels past
the worklist's capacity keep their centre shading, and their count is
reported.

The reference lays the worklist out as (cap * S / 128, 128) so its shading
runs on full 128-lane TPU rows; that layout exists only for the TPU's
lanes. Here the worklist keeps (cap, S): one row per edge pixel, one column
per sample. `edge_capacity` keeps the reference's rounding all the same,
because the capacity decides the overflow count the frame reports.

Sample layout (render_band's SSAA grouping): render row r = y * sy + dy and
render column c = x * sx + dx for presentation pixel (y, x).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .compute_utils import exclusive_prefix_sum


def edge_capacity(n_pixels: int, fraction: float, samples: int) -> int:
    """Worklist capacity: `fraction` of the band's pixels, rounded up to a
    multiple of 128 / gcd(samples, 128) (the reference's lane rounding) and
    at most the pixel count rounded up the same way."""
    cap = max(int(n_pixels * fraction), 1)
    unit = 128 // math.gcd(max(samples, 1), 128)
    cap = -(-cap // unit) * unit
    return min(cap, n_pixels + (-n_pixels) % unit)


class EdgePlan(NamedTuple):
    """Per-presentation-pixel classification of a sample-rate vis buffer."""

    primary_tid: torch.Tensor  # (Hp, Wp) int32, the nearest sample's triangle
    uniform: torch.Tensor  # (Hp, Wp) bool, every sample sees primary_tid
    tid_samples: torch.Tensor  # (Hp, Wp, S) int32


def _by_pixel(x: torch.Tensor, sy: int, sx: int) -> torch.Tensor:
    """(Hp*sy, Wp*sx) -> (Hp, Wp, sy*sx), samples in row-major order."""
    hr, wr = x.shape
    hp, wp = hr // sy, wr // sx
    return x.reshape(hp, sy, wp, sx).permute(0, 2, 1, 3).reshape(hp, wp, sy * sx)


def classify(tri_id: torch.Tensor, depth: torch.Tensor, sy: int,
             sx: int) -> EdgePlan:
    """Group the sample buffers by presentation pixel and pick each pixel's
    primary triangle: the depth-nearest sample's (the first on ties, as
    argmin takes the first minimum), so a partly covered pixel falls back
    to its covered surface."""
    tid_s = _by_pixel(tri_id, sy, sx)
    near = torch.argmin(_by_pixel(depth, sy, sx), dim=-1)
    primary = torch.gather(tid_s, -1, near[..., None])[..., 0]
    uniform = (tid_s == primary[..., None]).all(dim=-1)
    return EdgePlan(primary_tid=primary, uniform=uniform, tid_samples=tid_s)


def center_pixel_xy(hp: int, wp: int, sy: int, sx: int, y0r, device) -> tuple:
    """Presentation-pixel centres in global render coordinates (those of
    triangle_setup's edge equations): pixel (y, x) spans render columns
    [x * sx, (x + 1) * sx), so its centre is at (x + 0.5) * sx."""
    xi = torch.arange(wp, dtype=torch.int32, device=device).to(torch.float32)
    yi = torch.arange(hp, dtype=torch.int32, device=device).to(torch.float32)
    px = ((xi + 0.5) * sx)[None, :].expand(hp, wp)
    py = ((yi + 0.5) * sy + y0r)[:, None].expand(hp, wp)
    return px, py


def center_tile_xy(hp: int, wp: int, sy: int, sx: int, device) -> tuple:
    """Band-local integer render coordinates of the pixel centres, for the
    Forward+ tile lookup (shade_pbr's pixel_xy): the light-culling grid is
    built at render resolution."""
    xi = torch.arange(wp, dtype=torch.int32, device=device)
    yi = torch.arange(hp, dtype=torch.int32, device=device)
    return ((xi * sx + sx // 2)[None, :].expand(hp, wp),
            (yi * sy + sy // 2)[:, None].expand(hp, wp))


class EdgeWorklist(NamedTuple):
    """The compacted edge-pixel worklist, one row per slot."""

    pixel_idx: torch.Tensor  # (cap,) int32 band-local flat pixel id, -1 pad
    tid: torch.Tensor  # (cap, S) int32 per-sample triangle ids
    px: torch.Tensor  # (cap, S) f32 global render x of the sample centre
    py: torch.Tensor  # (cap, S) f32 global render y
    tile_px: torch.Tensor  # (cap, S) int32 band-local render x
    tile_py: torch.Tensor  # (cap, S) int32 band-local render y
    n_edge: torch.Tensor  # () int32, every edge pixel (may exceed cap)


def build_worklist(
    tri_id: torch.Tensor,  # (Hr, Wr) sample-rate vis buffer
    plan: EdgePlan,
    capacity: int,
    sy: int,
    sx: int,
    y0r: int = 0,
) -> EdgeWorklist:
    """Compact the edge pixels in raster order into `capacity` slots. Slots
    past the count, and pixels past the capacity, write to a dump slot at
    index `capacity` that is sliced off, so every kept slot has one
    writer."""
    hr, wr = tri_id.shape
    wp = wr // sx
    s = sy * sx
    dev = tri_id.device
    mask = (~plan.uniform).reshape(-1)
    m = mask.to(torch.int32)
    slots = exclusive_prefix_sum(m)
    n_edge = m.sum(dtype=torch.int32)
    ids = torch.arange(mask.shape[0], dtype=torch.int32, device=dev)
    out = torch.full((capacity + 1,), -1, dtype=torch.int32, device=dev)
    write_to = torch.where(mask & (slots < capacity), slots, capacity)
    out[write_to.long()] = ids
    pixel_idx = out[:capacity]

    safe = pixel_idx.clamp_min(0)
    ey = safe // wp  # (cap,) band-local presentation row
    ex = safe % wp
    k = torch.arange(s, dtype=torch.int32, device=dev)
    ry = ey[:, None] * sy + (k // sx)[None, :]  # (cap, S) band-local rows
    rx = ex[:, None] * sx + (k % sx)[None, :]
    tid = tri_id.reshape(-1)[(ry * wr + rx).long()]
    return EdgeWorklist(
        pixel_idx=pixel_idx,
        tid=tid,
        px=rx.to(torch.float32) + 0.5,
        py=ry.to(torch.float32) + 0.5 + y0r,
        tile_px=rx,
        tile_py=ry,
        n_edge=n_edge,
    )


def resolve(
    color_center: torch.Tensor,  # (Hp, Wp, 3) centre-shaded frame
    edge_colors: torch.Tensor,  # (cap, S, 3) shaded worklist samples
    wl: EdgeWorklist,
    samples: int,
) -> torch.Tensor:
    """Box-average each edge pixel's samples and scatter them over the
    centre-shaded frame. Padded and overflowed slots scatter into a dump row
    past the end, so an overflow degrades to centre shading."""
    hp, wp, c = color_center.shape
    cap = wl.pixel_idx.shape[0]
    mean = edge_colors.reshape(cap, samples, c).mean(dim=1)
    tgt = torch.where(wl.pixel_idx >= 0, wl.pixel_idx, hp * wp).long()
    out = torch.cat([color_center.reshape(hp * wp, c),
                     color_center.new_zeros((1, c))])
    out[tgt] = mean
    return out[:hp * wp].reshape(hp, wp, c)
