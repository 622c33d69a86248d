"""Forward+ tiled light culling (port of ash_tpu/ops/light_cull.py).

Per 16x16-pixel tile:
1. the min and max depth over the tile's pixels, a reshape and a reduction;
2. the tile frustum: 4 side planes through the view-space origin from the
   tile's corner rays (via the inverse projection) plus near and far planes
   from the tile's depth bounds. The reference's two deviations from the
   shader it ports are kept: side-plane normals are oriented inward by the
   tile's centre ray (the shader's winding pointed them outward), and the
   depth bounds are unprojected to view-space distances before they become
   plane offsets (the shader used raw [0, 1] depth);
3. every (tile, light) pair tested at once: sphere against the 6 planes in
   view space;
4. compaction to per-tile lists `[idx...]` in ascending light order, by
   top-k.

Matrix products are explicit per-component sums, as in ops/geometry.py.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .geometry import _cross, matvec3

TILE_SIZE = 16
MAX_LIGHTS_PER_TILE = 256


class TileLights(NamedTuple):
    mask: torch.Tensor  # (ty, tx, L) bool: the light reaches the tile
    indices: torch.Tensor  # (ty, tx, K) int32 compacted, -1 padded
    counts: torch.Tensor  # (ty, tx) int32


def tile_depth_bounds(depth: torch.Tensor, tile: int = TILE_SIZE):
    """(min, max) depth per tile; padding rows and columns use the (1.0,
    0.0) identities, the shader's initial values."""
    h, w = depth.shape
    ty, tx = -(-h // tile), -(-w // tile)
    pad = (0, tx * tile - w, 0, ty * tile - h)
    dmin = F.pad(depth, pad, value=1.0).reshape(ty, tile, tx, tile)
    dmax = F.pad(depth, pad, value=0.0).reshape(ty, tile, tx, tile)
    return dmin.amin(dim=(1, 3)), dmax.amax(dim=(1, 3))


def _mat4_apply(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(4, 4) @ (..., 4) as an explicit sum over j."""
    return ((v[..., 0:1] * m[:, 0] + v[..., 1:2] * m[:, 1])
            + v[..., 2:3] * m[:, 2]) + v[..., 3:4] * m[:, 3]


def _unproject(inv_projection, x, y, z):
    """inv_projection @ (x, y, z, 1) for (...,) coordinates -> (..., 4)."""
    return _mat4_apply(inv_projection, torch.stack(
        [x, y, z, torch.ones_like(x)], -1))


def tile_frustum_planes(
    inv_projection: torch.Tensor,  # (4, 4)
    width: int,
    height: int,
    dmin: torch.Tensor,  # (ty, tx)
    dmax: torch.Tensor,  # (ty, tx)
    tile: int = TILE_SIZE,
    tile_y0: int = 0,  # global tile row of the grid's first row
) -> torch.Tensor:
    """(ty, tx, 6, 4) view-space planes. `width` and `height` are the full
    framebuffer's (the NDC mapping); the grid may be a band of tile rows
    starting at global tile row `tile_y0`."""
    ty, tx = dmin.shape
    dev = dmin.device
    tix = torch.arange(tx, device=dev, dtype=torch.float32)[None, :].expand(ty, tx)
    tiy = (torch.arange(ty, device=dev, dtype=torch.float32)
           + float(tile_y0))[:, None].expand(ty, tx)
    min_ndc_x = (tix * tile) / width * 2.0 - 1.0
    min_ndc_y = (tiy * tile) / height * 2.0 - 1.0
    max_ndc_x = ((tix + 1) * tile) / width * 2.0 - 1.0
    max_ndc_y = ((tiy + 1) * tile) / height * 2.0 - 1.0
    zero = torch.zeros_like(dmin)

    def corner(x, y):
        # The shader maps NDC to [0, 1] and its unprojection maps it back:
        # corners are unprojected at the NDC coordinates, with the same
        # float operations as the reference.
        v = _unproject(inv_projection, (x * 0.5 + 0.5) * 2.0 - 1.0,
                       (y * 0.5 + 0.5) * 2.0 - 1.0, zero)
        return v[..., :3] / v[..., 3:4]

    c0 = corner(min_ndc_x, min_ndc_y)
    c1 = corner(max_ndc_x, min_ndc_y)
    c2 = corner(max_ndc_x, max_ndc_y)
    c3 = corner(min_ndc_x, max_ndc_y)
    # The tile's centre ray: side planes pass through the origin, so the
    # sign of n . interior turns every normal inward, whatever the
    # projection's handedness.
    interior = (c0 + c1 + c2 + c3) * 0.25

    def plane(a, b):
        v = _cross(a, b)
        ln = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        n = torch.where(ln > 1e-4, v / ln.clamp_min(1e-8), 0.0)
        s = torch.sign((n * interior).sum(-1, keepdim=True))
        n = n * torch.where(s == 0.0, 1.0, s)
        return torch.cat([n, torch.zeros_like(n[..., :1])], -1)

    left = plane(c3, c0)
    right = plane(c1, c2)
    bottom = plane(c0, c1)
    top = plane(c2, c3)

    def view_dist(d):
        vv = _unproject(inv_projection, torch.zeros_like(d),
                        torch.zeros_like(d), d)
        return -(vv[..., 2] / vv[..., 3])  # positive view-space distance

    min_d = view_dist(dmin)
    max_d = view_dist(dmax)
    near = torch.stack([zero, zero, zero - 1.0, -min_d], -1)
    far = torch.stack([zero, zero, zero + 1.0, max_d], -1)
    return torch.stack([left, right, bottom, top, near, far], -2)


def cull_lights(
    lights: torch.Tensor,  # (L, 16) packed GpuLight rows
    view: torch.Tensor,  # (4, 4)
    inv_projection: torch.Tensor,  # (4, 4)
    depth: torch.Tensor,  # (H, W), may be a band of the framebuffer
    width: int,
    height: int,
    max_per_tile: int = MAX_LIGHTS_PER_TILE,
    tile: int = TILE_SIZE,
    tile_y0: int = 0,  # global tile row of the band (0 = full frame)
) -> TileLights:
    """The Forward+ culling pass -> per-tile light lists."""
    dmin, dmax = tile_depth_bounds(depth, tile)
    planes = tile_frustum_planes(
        inv_projection, width, height, dmin, dmax, tile, tile_y0=tile_y0
    )
    radius = lights[:, 3]
    enabled = lights[:, 15] >= 0.5  # params.w
    pos_view = matvec3(view[:3, :3], lights[:, 0:3]) + view[:3, 3]  # (L, 3)

    # (ty, tx, 6, L) signed distances.
    dist = ((planes[..., 0:1] * pos_view[:, 0] + planes[..., 1:2] * pos_view[:, 1])
            + planes[..., 2:3] * pos_view[:, 2]) + planes[..., 3:4]
    hit = (dist >= -radius).all(dim=2) & enabled  # (ty, tx, L)

    # Compact to [idx...] per tile in ascending order: the top-k of
    # L - index over the hits.
    n = lights.shape[0]
    k = min(max_per_tile, n)
    iota = torch.arange(n, device=lights.device, dtype=torch.int32)
    score = torch.where(hit, n - iota, 0)
    top = torch.topk(score, k, dim=-1).values
    indices = torch.where(top > 0, n - top, -1).to(torch.int32)
    if k < max_per_tile:
        indices = F.pad(indices, (0, max_per_tile - k), value=-1)
    counts = hit.sum(-1, dtype=torch.int32).clamp_max(max_per_tile)
    return TileLights(mask=hit, indices=indices, counts=counts)


def pack_tile_buffer(tl: TileLights) -> torch.Tensor:
    """Flatten to the shader's buffer layout: (tiles, K + 1) with the count
    first, as int64 (the shader's u32 values, which torch cannot yet
    compute with on every device)."""
    ty, tx, k = tl.indices.shape
    counts = tl.counts.reshape(ty * tx, 1)
    idx = tl.indices.reshape(ty * tx, k).clamp_min(0)
    return torch.cat([counts, idx], -1).to(torch.int64)
