"""Bindless texture pool and trilinear sampling (port of
ash_tpu/ops/texture_sample.py).

All registered textures live in one flat array of texels; a per-texture mip
table stores (offset, width, height) per level. A texture handle is an
int32 index into the table, and -1 means "no texture: white". Sampling is
the reference sampler's: REPEAT addressing, bilinear min/mag filtering and
linear filtering between mips (trilinear). `sample_footprint` builds
anisotropic filtering on it (the loop of ash_tpu/ops/shade.py:_sample_map)
over the footprints that `map_footprint` computes, and `sample_maps` does
both for shade_pbr's five maps. `sample_maps` and `sample_trilinear` are the
plain versions of csrc/texture.cu's two entries: ops/texture_cuda.py runs
them for CPU tensors, and the kernel is held to them bit for bit.

Texels are stored bfloat16: the sources are 8-bit images, so bf16's 8-bit
mantissa loses nothing they had, and it halves the gathers' bytes.
Filtering runs in float32. Each bilinear fetch is 4 gathers from the flat
texel array; trilinear is 8.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device


class TexturePool(NamedTuple):
    """Flat bindless texture storage, on one device.

    `min_level` is the mip residency of a streaming pool
    (render/bindless.py): levels below a texture's min_level are not
    stored, and sampling clamps its LOD up to the finest resident level. A
    restream rewrites texel and table values but never the shapes.
    """

    texels: torch.Tensor  # (TOTAL, 4) bfloat16 linear RGBA
    table: torch.Tensor  # (N, MAX_MIPS, 3) int32: offset, width, height
    levels: torch.Tensor  # (N,) int32 mip count
    min_level: Optional[torch.Tensor] = None  # (N,) int32 finest resident

    @property
    def num_textures(self) -> int:
        return int(self.table.shape[0])


def build_pool(
    mip_pyramids: list,
    min_levels: Optional[Sequence[int]] = None,
    arena_texels: Optional[int] = None,
    device="cuda",
) -> TexturePool:
    """Pack per-texture mip pyramids ((H, W, 4) float32 each) into a pool
    on `device` (the card unless the caller names another; without CUDA
    the default raises).

    `min_levels[i]` (streaming residency) skips the levels below it for
    texture i: only resident mips are stored. `arena_texels` fixes the texel
    array's length so restreams keep its shape; resident texels must fit or
    this raises.
    """
    device = resolve_device(device)
    if not mip_pyramids:
        # A single white 1x1 placeholder keeps the shapes valid.
        mip_pyramids = [[np.ones((1, 1, 4), np.float32)]]
    if min_levels is None:
        min_levels = [0] * len(mip_pyramids)
    max_mips = max(len(p) for p in mip_pyramids)
    texel_rows = []
    table = np.zeros((len(mip_pyramids), max_mips, 3), np.int64)
    levels = np.zeros(len(mip_pyramids), np.int32)
    mins = np.zeros(len(mip_pyramids), np.int32)
    offset = 0
    for ti, pyramid in enumerate(mip_pyramids):
        levels[ti] = len(pyramid)
        lo = int(min(min_levels[ti], len(pyramid) - 1))
        mins[ti] = lo
        for li, mip in enumerate(pyramid):
            if li < lo:
                continue  # not resident: sampling clamps past it
            h, w = mip.shape[:2]
            table[ti, li] = (offset, w, h)
            texel_rows.append(mip.reshape(-1, 4).astype(np.float32))
            offset += h * w
        # Levels that are not resident point at the finest resident mip
        # (never fetched, since sampling clamps the LOD to min_level) but
        # keep their true (w, h): `_sample_map` takes the footprint from
        # level 0's size.
        for li in range(lo):
            h, w = pyramid[li].shape[:2]
            table[ti, li] = (table[ti, lo][0], w, h)
    texels = np.concatenate(texel_rows, axis=0)
    if arena_texels is not None:
        if offset > arena_texels:
            raise ValueError(
                f"resident texels {offset} exceed arena {arena_texels}"
            )
        texels = np.concatenate(
            [texels, np.zeros((arena_texels - offset, 4), np.float32)]
        )
    # A streaming pool (arena mode) always carries min_level, so its
    # structure does not change on a restream.
    keep_min = arena_texels is not None or bool(np.any(mins > 0))
    # f32 -> bf16 rounds to nearest even, as the reference's conversion
    # does; it runs on the host so the copy moves half the bytes.
    return TexturePool(
        texels=torch.from_numpy(texels).to(torch.bfloat16).to(device),
        table=torch.from_numpy(table.astype(np.int32)).to(device),
        levels=torch.from_numpy(levels).to(device),
        min_level=torch.from_numpy(mins).to(device) if keep_min else None,
    )


def _bilinear_at_level(pool: TexturePool, idx, level, u, v):
    """Bilinear fetch at an integer mip level. idx, level, u, v: (...,)."""
    entry = pool.table[idx.long(), level.long()]  # (..., 3)
    off, w, h = entry[..., 0], entry[..., 1], entry[..., 2]
    px = u * w.to(torch.float32) - 0.5
    py = v * h.to(torch.float32) - 0.5
    x0 = torch.floor(px).to(torch.int32)
    y0 = torch.floor(py).to(torch.int32)
    fx = (px - x0.to(torch.float32))[..., None]
    fy = (py - y0.to(torch.float32))[..., None]
    last = pool.texels.shape[0] - 1
    w1, h1 = w.clamp_min(1), h.clamp_min(1)

    def fetch(xi, yi):
        # REPEAT addressing. torch.remainder is a floor modulo, like
        # jnp.mod, so negative coordinates wrap to the far side.
        xw = torch.where(w > 0, torch.remainder(xi, w1), 0)
        yw = torch.where(h > 0, torch.remainder(yi, h1), 0)
        flat = (off + yw * w + xw).clamp(0, last)
        return pool.texels[flat.long()].to(torch.float32)

    c00 = fetch(x0, y0)
    c10 = fetch(x0 + 1, y0)
    c01 = fetch(x0, y0 + 1)
    c11 = fetch(x0 + 1, y0 + 1)
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def sample_trilinear(
    pool: TexturePool,
    idx: torch.Tensor,  # (...,) int32 texture index, -1 => white
    uv: torch.Tensor,  # (..., 2)
    lod: Optional[torch.Tensor] = None,  # (...,) float32 mip level; None => 0
) -> torch.Tensor:
    """Sample with REPEAT addressing and trilinear filtering -> (..., 4)."""
    safe_idx = idx.clamp_min(0).long()
    u = uv[..., 0]
    v = uv[..., 1]
    levels = pool.levels[safe_idx]
    max_level = (levels - 1).to(torch.float32)
    if lod is None:
        lod = torch.zeros_like(u)
    # Mip residency: the LOD cannot be finer than the finest resident level.
    if pool.min_level is not None:
        floor_level = pool.min_level[safe_idx].to(torch.float32)
    else:
        floor_level = torch.zeros_like(max_level)
    lod = torch.minimum(torch.maximum(lod, floor_level), max_level)
    l0 = torch.floor(lod).to(torch.int32)
    l1 = torch.minimum(l0 + 1, levels - 1)
    f = (lod - l0.to(torch.float32))[..., None]
    c0 = _bilinear_at_level(pool, safe_idx, l0, u, v)
    c1 = _bilinear_at_level(pool, safe_idx, l1, u, v)
    color = c0 * (1 - f) + c1 * f
    return torch.where((idx >= 0)[..., None], color, torch.ones_like(color))


class Footprint(NamedTuple):
    """A map's screen footprint at each pixel: its LOD and, with
    anisotropic filtering, its tap count and major-axis step in uv."""

    lod: torch.Tensor  # (...,)
    n_taps: Optional[torch.Tensor] = None  # (...,) f32 in [1, max_aniso]
    major_uv: Optional[torch.Tensor] = None  # (..., 2)


def sample_footprint(pool, index, uv, fp: Footprint,
                     trips: Optional[int] = None) -> torch.Tensor:
    """Sample texture `index` over its footprint -> (..., 4).

    The anisotropic taps are spread along the major axis and averaged. The
    loop runs `trips` times, which must be at least the largest n_taps of
    every pixel whose value is used: a tap beyond a pixel's n_taps adds
    exactly 0, so any such trip count gives the same bits. None takes the
    largest n_taps of all pixels (one host sync)."""
    if fp.n_taps is None:
        return sample_trilinear(pool, index, uv, fp.lod)
    if trips is None:
        trips = int(fp.n_taps.max())
    acc = torch.zeros(uv.shape[:-1] + (4,), dtype=torch.float32,
                      device=uv.device)
    for i in range(trips):
        live = float(i) < fp.n_taps
        # Tap position along the major axis; taps beyond a pixel's n_taps
        # collapse onto the centre and weigh 0.
        frac = torch.where(live, (float(i) + 0.5) / fp.n_taps - 0.5, 0.0)
        tap = sample_trilinear(
            pool, index, uv + fp.major_uv * frac[..., None], fp.lod)
        acc = acc + tap * torch.where(live, 1.0, 0.0)[..., None]
    return acc / fp.n_taps[..., None]


def map_footprint(pool, index, ddx, ddy, max_aniso: int = 1) -> Footprint:
    """The footprint of texture `index` (level 0's size) under the uv
    derivatives. With max_aniso > 1 it is the footprint assembly of the
    reference sampler's anisotropic filtering: n_taps = ceil(major /
    minor) taps, at the mip where n_taps minor footprints cover the major
    axis."""
    base = pool.table[index.clamp_min(0).long(), 0]  # (..., 3): offset, w, h
    tw = base[..., 1].to(torch.float32)
    th = base[..., 2].to(torch.float32)
    lu = _norm(torch.stack([ddx[..., 0] * tw, ddx[..., 1] * th], -1))
    lv = _norm(torch.stack([ddy[..., 0] * tw, ddy[..., 1] * th], -1))
    rho_max = torch.maximum(lu, lv).clamp_min(1e-8)
    if max_aniso <= 1:
        return Footprint(lod=torch.log2(rho_max).clamp_min(0.0))
    rho_min = torch.minimum(lu, lv).clamp_min(1e-8)
    n_taps = torch.ceil(rho_max / rho_min).clamp(1.0, float(max_aniso))
    return Footprint(
        lod=torch.log2(rho_max / n_taps).clamp_min(0.0),
        n_taps=n_taps,
        major_uv=torch.where((lu >= lv)[..., None], ddx, ddy),
    )


def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1)


def sample_maps(pool, indices, uv, ddx, ddy, max_aniso: int, mask):
    """shade_pbr's five maps: for each texture index in the last dimension
    of `indices` (..., 5), its footprint under the uv derivatives
    (`map_footprint`) and its sample over it (`sample_footprint`), where
    `mask` holds, 0 elsewhere -> five (..., 4). Each map's tap loop takes
    its trip count from every element (one host sync a map)."""
    samples = []
    for m in range(indices.shape[-1]):
        index = indices[..., m]
        fp = map_footprint(pool, index, ddx, ddy, max_aniso)
        color = sample_footprint(pool, index, uv, fp)
        samples.append(torch.where(mask[..., None], color, 0.0))
    return tuple(samples)
