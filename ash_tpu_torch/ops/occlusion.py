"""Per-draw GPU-driven culling (port of ash_tpu/ops/occlusion.py): the
frustum test, and the Hi-Z test against the previous frame's depth.

Per object: the world bounds (exact centre transform, extents scaled by the
length of each model row), the positive-vertex AABB frustum test, then the
Hi-Z test: the 8 corners are projected, the screen rectangle picks the
pyramid level mip = ceil(log2(largest side in pixels)), and the box's
nearest depth is held against the level's texel at the rectangle's centre.
A box with a corner at or behind the eye is kept. Survivors are compacted
into an ordered draw list by a prefix sum.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..device import constant
from .compute_utils import aabb_in_frustum, extract_frustum_planes, prefix_sum_compact
from .geometry import matvec3, transform_points
from .hiz import HizPyramid, sample_level


class CullResult(NamedTuple):
    visibility: torch.Tensor  # (N,) int32, 1 = visible
    draw_list: torch.Tensor  # (N,) int32 compacted visible ids, -1 padded
    visible_count: torch.Tensor  # () int32


def world_bounds(centers, extents, models):
    """World AABB per draw: exact centre transform, extents scaled by the
    length of each model row (rotation deliberately approximated)."""
    m = models[:, :3, :3]
    wc = matvec3(m, centers) + models[:, :3, 3]
    scale = torch.linalg.vector_norm(m, dim=2)  # |model[i].xyz| per row
    return wc, extents * scale


def occlusion_test(
    centers_w: torch.Tensor,  # (N, 3)
    extents_w: torch.Tensor,  # (N, 3)
    view_proj: torch.Tensor,  # (4, 4)
    pyr: HizPyramid,
    width: int,
    height: int,
) -> torch.Tensor:
    """(N,) bool, True = occluded."""
    signs = constant(
        [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
        torch.float32, centers_w.device,
    )  # (8, 3)
    corners = centers_w[:, None, :] + extents_w[:, None, :] * signs[None]
    clip = transform_points(view_proj, corners)  # (N, 8, 4)
    w = clip[..., 3]
    behind = (w <= 0.0).any(-1)  # conservatively visible
    safe_w = torch.where(w.abs() < 1e-8, 1e-8, w)
    ndc = clip[..., :3] / safe_w[..., None]
    screen = ndc[..., :2] * 0.5 + 0.5
    min_s = screen.amin(1).clamp(0.0, 1.0)
    max_s = screen.amax(1).clamp(0.0, 1.0)
    min_z = ndc[..., 2].amin(1)

    size_px = (max_s - min_s) * constant(
        [width, height], torch.float32, centers_w.device)
    mip = torch.ceil(torch.log2(size_px.amax(-1).clamp_min(1e-8)))
    mip = mip.clamp(0.0, pyr.levels - 1).to(torch.int32)

    center_uv = (min_s + max_s) * 0.5
    hiz_depth = sample_level(pyr, mip, center_uv[:, 0], center_uv[:, 1])
    return (min_z > hiz_depth) & ~behind


def cull_objects(
    centers: torch.Tensor,  # (N, 3) local centers
    extents: torch.Tensor,  # (N, 3) local half extents
    models: torch.Tensor,  # (N, 4, 4)
    enabled: torch.Tensor,  # (N,) bool
    view_proj: torch.Tensor,  # (4, 4)
    pyr: Optional[HizPyramid] = None,
    width: int = 0,
    height: int = 0,
) -> CullResult:
    """Frustum and Hi-Z cull -> visibility flags + compacted draw list.
    pyr=None runs the frustum test alone; with a pyramid, `width` and
    `height` are the size of the depth buffer it was built from."""
    wc, we = world_bounds(centers, extents, models)
    visible = enabled & aabb_in_frustum(wc, we, extract_frustum_planes(view_proj))
    if pyr is not None:
        if width <= 0 or height <= 0:
            raise ValueError("a Hi-Z pyramid needs the depth buffer's size")
        visible = visible & ~occlusion_test(wc, we, view_proj, pyr, width,
                                            height)
    draw_list, count = prefix_sum_compact(visible, visible.shape[0])
    return CullResult(
        visibility=visible.to(torch.int32), draw_list=draw_list,
        visible_count=count,
    )
