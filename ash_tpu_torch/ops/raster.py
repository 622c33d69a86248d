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
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .binning import TileBins, grid_shape
from .geometry import TriangleSetup


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
