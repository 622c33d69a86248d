"""Tile rasterization into a visibility buffer: the plain PyTorch version.

Port of ash_tpu/ops/raster.py (`rasterize`, `tile_image`). For every screen
tile the candidate triangles of its bin list are tested in slot order: three
homogeneous edge functions at the pixel centres give coverage, their
z-weighted sum gives depth, and a LESS depth test keeps the nearest
(earlier id on ties, since slots are in ascending id order). The output is a
(depth, triangle id) pair per pixel; shading happens later, once per pixel.
With layers=K it keeps the K nearest surfaces per pixel instead (a K-layer
depth peel), optionally only those strictly behind a per-pixel floor.

This module is the reference for the hand-written CUDA kernels in
ops/raster_cuda.py + csrc/raster.cu, which compute the same values with the
same order of float operations. The CPU tests run this version; on the card
it serves only as the comparison for the kernels.

The kernels skip, per warp, the candidates whose conservative pixel
rectangle misses the warp's pixels. `candidate_rects` is the plain version
of those rectangles (the kernels compute them with the same f64 operations
in a pre-pass kernel, csrc/raster.cu:candidate_rect), and `warp_bins` is the
rejection in plain torch, which the tests and the kernels' pair counts use.
The plain raster itself tests every candidate at every pixel of its tile.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..device import constant
from .binning import TileBins, grid_shape
from .geometry import TriangleSetup

# The kernels' warp rectangle: 8 rows x 16 columns, 4 pixels per lane.
WARP_RECT = (8, 16)
# Upper bounds on the f32 rounding of `coverage_and_depth` (and of the
# kernels' `covers`), used by rect_bounds. With u = 2^-24: GAMMA3 >= 3u /
# (1 - 3u), the relative error of a rounded a*px + b*py + c, and of the
# tolerance's two sums and product; TOL1 >= 1e-6 * (1 + GAMMA3), the seam
# tolerance with that rounding.
GAMMA3 = 1.8e-7
TOL1 = 1.000001e-6
# rect_bounds' own f64 rounding (below 1e-12 of the values it touches) is
# covered by scaling the overshoot by RECT_SCALE and adding RECT_ULP times
# the largest coordinate: 2e-3 px at 1080p.
RECT_SCALE = 1.001
RECT_ULP = 1e-6


class VisibilityBuffer(NamedTuple):
    depth: torch.Tensor  # (H, W) float32, 1.0 = far/clear
    tri_id: torch.Tensor  # (H, W) int32, -1 = background
    # Second-nearest layer (layers >= 2 only).
    depth2: Optional[torch.Tensor] = None
    tri_id2: Optional[torch.Tensor] = None
    # Layers 3..K stacked (K-2, H, W), nearest first (layers >= 3 only).
    depth_rest: Optional[torch.Tensor] = None
    tri_id_rest: Optional[torch.Tensor] = None

    @property
    def num_layers(self) -> int:
        n = 1 + (self.depth2 is not None)
        if self.depth_rest is not None:
            n += self.depth_rest.shape[0]
        return n

    def layer(self, i: int):
        """(depth, tri_id) of peel layer i (0 = nearest)."""
        if i == 0:
            return self.depth, self.tri_id
        if i == 1:
            return self.depth2, self.tri_id2
        return self.depth_rest[i - 2], self.tri_id_rest[i - 2]

    @classmethod
    def from_layers(cls, depth: torch.Tensor, tri_id: torch.Tensor):
        """Views of (K, H, W) depth and id stacks, nearest layer first."""
        k = depth.shape[0]
        return cls(
            depth=depth[0], tri_id=tri_id[0],
            depth2=depth[1] if k > 1 else None,
            tri_id2=tri_id[1] if k > 1 else None,
            depth_rest=depth[2:] if k > 2 else None,
            tri_id_rest=tri_id[2:] if k > 2 else None,
        )


def _gather_tile_tris(setup: TriangleSetup, tri_ids: torch.Tensor):
    """(num_tiles, K, 12): each slot's 3x3 edge matrix (row-major) and its
    3 clip-space z values. Slot -1 gathers triangle 0 and is masked later."""
    ids = tri_ids.clamp_min(0).long()
    edge = setup.edge[ids]  # (num_tiles, K, 3, 3)
    zc = setup.z_clip[ids]  # (num_tiles, K, 3)
    return torch.cat([edge.reshape(*ids.shape, 9), zc], dim=-1)


def _pixel_centers(num_tiles, tx, tile_h, tile_w, y0, device):
    """Global framebuffer pixel centres per tile, (num_tiles, TH, TW) each.
    `y0` is the global row of the band's first row."""
    tile = torch.arange(num_tiles, dtype=torch.int32, device=device)
    base_x = ((tile % tx) * tile_w)[:, None, None]
    base_y = ((tile // tx) * tile_h + y0)[:, None, None]
    ix = torch.arange(tile_w, dtype=torch.int32, device=device)[None, None, :]
    iy = torch.arange(tile_h, dtype=torch.int32, device=device)[None, :, None]
    px = (base_x + ix).to(torch.float32) + 0.5
    py = (base_y + iy).to(torch.float32) + 0.5
    return px.expand(num_tiles, tile_h, tile_w), py.expand(
        num_tiles, tile_h, tile_w
    )


def coverage_and_depth(tri: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """One triangle per tile over the tile's pixels.

    tri: (num_tiles, 12) packed rows; px/py: (num_tiles, TH, TW).
    Returns (inside bool, z f32). The order of operations is the one the
    CUDA kernel uses, so the two agree bit for bit.
    """
    c = lambda i: tri[:, i][:, None, None]  # noqa: E731
    lam0 = c(0) * px + c(1) * py + c(2)
    lam1 = c(3) * px + c(4) * py + c(5)
    lam2 = c(6) * px + c(7) * py + c(8)
    s = lam0 + lam1 + lam2  # interpolated 1/w; > 0 on the eye side
    # Edge functions of neighbours are not exact negations in f32, so a
    # strict >= 0 can drop a shared-edge pixel from both triangles; the
    # tolerance admits it to either and the depth test picks one.
    thr = -1e-6 * (lam0.abs() + lam1.abs() + lam2.abs())
    inside = (lam0 >= thr) & (lam1 >= thr) & (lam2 >= thr) & (s > 0.0)
    z = lam0 * c(9) + lam1 * c(10) + lam2 * c(11)
    return inside, z


def untile(buf: torch.Tensor, height: int, width: int, tile_h: int, tile_w: int):
    """(num_tiles, TH, TW) tiled layout -> (H, W), cropping the pad."""
    ty, tx = grid_shape(height, width, tile_h, tile_w)
    img = buf.reshape(ty, tx, tile_h, tile_w).permute(0, 2, 1, 3)
    img = img.reshape(ty * tile_h, tx * tile_w)
    return img[:height, :width].contiguous()


def tile_image(img: torch.Tensor, tile_h: int, tile_w: int) -> torch.Tensor:
    """(H, W) -> (num_tiles, TH, TW), zero padded."""
    h, w = img.shape
    ty, tx = grid_shape(h, w, tile_h, tile_w)
    img = torch.nn.functional.pad(img, (0, tx * tile_w - w, 0, ty * tile_h - h))
    return (
        img.reshape(ty, tile_h, tx, tile_w)
        .permute(0, 2, 1, 3)
        .reshape(ty * tx, tile_h, tile_w)
    )


def rasterize(
    setup: TriangleSetup,
    bins: TileBins,
    height: int,
    width: int,
    tile_h: int,
    tile_w: int,
    y0: int = 0,
    layers: int = 1,
    depth_floor: Optional[torch.Tensor] = None,
) -> VisibilityBuffer:
    """Plain rasterizer: a loop over the K bin slots, every tile at once.

    `y0`: global framebuffer row of this band's first row; `height` and
    `width` describe the band. Depth LESS keeps the lowest id on ties.

    `layers` > 1 keeps that many nearest surfaces per pixel: each hit
    bubbles down the pixel's sorted list, displacing a stored surface that
    is strictly farther (which then moves on as the candidate), so on equal
    depth the stored surface stays. `depth_floor` ((height, width) f32,
    layers >= 2 only) rejects candidates at z <= floor: the second and later
    passes of iterated peeling.
    """
    if depth_floor is not None and layers < 2:
        raise ValueError("depth_floor needs layers >= 2")
    ty, tx = grid_shape(height, width, tile_h, tile_w)
    num_tiles = ty * tx
    dev = setup.edge.device
    tile_data = _gather_tile_tris(setup, bins.tri_ids)  # (num_tiles, K, 12)
    px, py = _pixel_centers(num_tiles, tx, tile_h, tile_w, y0, dev)

    floor = (
        None if depth_floor is None else tile_image(depth_floor, tile_h, tile_w)
    )
    zs = [torch.ones((num_tiles, tile_h, tile_w), dtype=torch.float32,
                     device=dev)] * layers
    ts = [torch.full((num_tiles, tile_h, tile_w), -1, dtype=torch.int32,
                     device=dev)] * layers
    for k in range(bins.tri_ids.shape[1]):
        ids = bins.tri_ids[:, k][:, None, None]
        inside, z = coverage_and_depth(tile_data[:, k], px, py)
        hit = inside & (ids >= 0) & (z >= 0.0) & (z <= 1.0)
        if floor is not None:
            hit = hit & (z > floor)
        cz, ct = z, ids
        for i in range(layers):
            swap = hit & (cz < zs[i])
            kept_z = torch.where(swap, cz, zs[i])
            kept_t = torch.where(swap, ct, ts[i])
            if i + 1 < layers:  # the displaced surface moves on
                cz = torch.where(swap, zs[i], cz)
                ct = torch.where(swap, ts[i], ct)
            zs[i], ts[i] = kept_z, kept_t
    return VisibilityBuffer.from_layers(
        torch.stack([untile(z, height, width, tile_h, tile_w) for z in zs]),
        torch.stack([untile(t, height, width, tile_h, tile_w) for t in ts]),
    )


def rect_bounds(setup: TriangleSetup, height: int, width: int,
                y0: int = 0) -> torch.Tensor:
    """(T, 4) f64 [x0, y0, x1, y1] in framebuffer coordinates: a box that
    holds every pixel centre of the band at which the f32 coverage test
    (`coverage_and_depth`, the kernels' `covers`) can accept triangle t, or
    (-inf, -inf, inf, inf) where no box is proven. It is derived from the
    stored f32 edge rows e_i = (A_i, B_i, C_i) alone, so it holds for
    whatever triangle they describe:

    1. Let l_i = e_i . (px, py, 1) exactly. The rounded l_i is within
       GAMMA3 * E_i of it, E_i = |A_i| X + |B_i| Y + |C_i| with X = width,
       Y = y0 + height (pixel centres are in (0, X) x (0, Y)), and the
       tolerance is at most TOL1 * sum|rounded l|. So an accepted pixel has
       l_i >= -TOL1 * sum_j |l_j| - tau_i, tau_i = GAMMA3 * (E_i + TOL1 *
       sum_j E_j).
    2. Column i of the edge matrix's inverse, q_i = (e_j x e_k) / det, is
       the i-th vertex in homogeneous form, w_i * (X_i, Y_i, 1), so
       (px, py, 1) = sum_i l_i q_i. Where every w_i > 0, b_i = w_i l_i are
       screen barycentrics (sum 1), and with rho = max w / min w, their
       negative part N obeys N <= 2 TOL1 rho (1 + 2N) + S with
       S = sum_i w_i tau_i, so N <= (2 TOL1 rho + S) / (1 - 4 TOL1 rho).
    3. A point whose barycentrics sum to 1 with negative part N lies at
       most N * (the vertices' extent) outside their bbox.

    In f64 every e_j x e_k component is two exact products and one
    rounding. A vertex at or behind the eye (some w_i <= 0), a det not
    resolved to 1e-9 of its terms, rho >= 1 / (8 TOL1) or a non-finite
    value gives the whole band. For 8 cubes under a perspective camera at
    96x64 (the CPU tests) the box is the setup's bbox widened by under
    0.002 px.
    """
    e = setup.edge.double()
    a, b, c = e[..., 0], e[..., 1], e[..., 2]  # (T, 3): edge i's row
    aj, bj, cj = (x.roll(-1, 1) for x in (a, b, c))  # edge i + 1
    ak, bk, ck = (x.roll(-2, 1) for x in (a, b, c))  # edge i + 2
    # det * q_i = e_j x e_k.
    qx = bj * ck - cj * bk
    qy = cj * ak - aj * ck
    qz = aj * bk - bj * ak
    t0, t1, t2 = a[:, 0] * qx[:, 0], b[:, 0] * qy[:, 0], c[:, 0] * qz[:, 0]
    det = (t0 + t1) + t2
    mag = (t0.abs() + t1.abs()) + t2.abs()
    w = qz / det[:, None]
    vx, vy = qx / qz, qy / qz
    xmax, ymax = float(width), float(y0 + height)
    ebar = (a.abs() * xmax + b.abs() * ymax) + c.abs()
    esum = (ebar[:, 0] + ebar[:, 1]) + ebar[:, 2]
    wt = w * (GAMMA3 * (ebar + TOL1 * esum[:, None]))
    s = (wt[:, 0] + wt[:, 1]) + wt[:, 2]
    w_lo = w.amin(1)
    rho = w.amax(1) / w_lo
    den = 1.0 - (4.0 * TOL1) * rho
    n = ((2.0 * TOL1) * rho + s) / den
    lo_x, hi_x, lo_y, hi_y = vx.amin(1), vx.amax(1), vy.amin(1), vy.amax(1)
    ext = torch.maximum(hi_x - lo_x, hi_y - lo_y)
    reach = torch.maximum(torch.maximum(lo_x.abs(), hi_x.abs()),
                          torch.maximum(lo_y.abs(), hi_y.abs()))
    reach = reach + (xmax + ymax)
    d = (n * ext) * RECT_SCALE + RECT_ULP * reach
    box = torch.stack([lo_x - d, lo_y - d, hi_x + d, hi_y + d], -1)
    bounded = (torch.isfinite(setup.edge).all(-1).all(-1)
               & (det.abs() > 1e-9 * mag) & (w_lo > 0.0) & (den > 0.5)
               & torch.isfinite(box).all(-1))
    inf = constant([-math.inf, -math.inf, math.inf, math.inf],
                   torch.float64, box.device)
    return torch.where(bounded[:, None], box, inf)


def candidate_rects(
    setup: TriangleSetup, height: int, width: int, y0: int = 0
) -> torch.Tensor:
    """(T, 4) int32 [col0, row0, col1, row1]: the inclusive range of pixel
    columns and band-local rows whose centres lie in triangle t's
    rect_bounds box, clipped to the band; every pixel the triangle covers is
    in it. An empty range is (width, height, -1, -1), which overlaps no
    pixel rectangle.
    """
    box = rect_bounds(setup, height, width, y0)
    dev = box.device
    shift = constant([0.0, float(y0)], torch.float64, dev)
    lim = constant([width - 1.0, height - 1.0], torch.float64, dev)
    # Pixel c's centre c + 0.5 lies in [lo, hi] iff ceil(lo - 0.5) <= c
    # <= floor(hi - 0.5).
    first = torch.ceil(box[:, :2] - 0.5) - shift
    last = torch.floor(box[:, 2:] - 0.5) - shift
    first = torch.maximum(first, torch.zeros_like(first))
    last = torch.minimum(last, lim)
    empty = ~(first <= last).all(-1, keepdim=True)
    rect = torch.cat([first, last], dim=-1)
    none = constant([width, height, -1.0, -1.0], torch.float64, dev)
    return torch.where(empty, none, rect).to(torch.int32)


def warp_bins(
    bins: TileBins,
    rects: torch.Tensor,
    height: int,
    width: int,
    tile_h: int,
    tile_w: int,
) -> TileBins:
    """The kernels' per-warp rejection in plain torch: one bin list per
    WARP_RECT pixel rectangle (a grid of 8x16 "tiles" over the band), each
    its tile's list with the candidates whose rectangle misses the warp's
    pixels set to -1 in place, so slot order is kept. Rasterizing with
    these bins and 8x16 tiles gives what the kernels give. Tiles must be
    whole multiples of the warp rectangle."""
    rh, rw = WARP_RECT
    if tile_h % rh or tile_w % rw:
        raise ValueError(f"tiles {tile_h}x{tile_w} are not whole {rh}x{rw} "
                         "warp rectangles")
    _, tx = grid_shape(height, width, tile_h, tile_w)
    wh, ww = grid_shape(height, width, rh, rw)
    sy, sx = tile_h // rh, tile_w // rw
    dev = rects.device
    # Warp rectangle (row-major over the band) -> its tile and pixel range.
    wy = torch.arange(wh, device=dev)[:, None].expand(-1, ww).reshape(-1)
    wx = torch.arange(ww, device=dev)[None, :].expand(wh, -1).reshape(-1)
    tile = (wy // sy) * tx + wx // sx
    ids = bins.tri_ids.long()[tile]  # (warps, K)
    r = rects.long()[ids.clamp_min(0)]  # (warps, K, 4)
    c0, r0 = (wx * rw)[:, None], (wy * rh)[:, None]
    c1 = torch.clamp(c0 + rw, max=width) - 1
    r1 = torch.clamp(r0 + rh, max=height) - 1
    overlap = ((r[..., 0] <= c1) & (r[..., 2] >= c0)
               & (r[..., 1] <= r1) & (r[..., 3] >= r0))
    slot = torch.arange(ids.shape[1], device=dev)[None, :]
    live = overlap & (ids >= 0) & (slot < bins.counts.long()[tile][:, None])
    kept = torch.where(live, ids, -1).to(torch.int32)
    return TileBins(tri_ids=kept, counts=live.sum(-1, dtype=torch.int32),
                    overflow=bins.overflow)
