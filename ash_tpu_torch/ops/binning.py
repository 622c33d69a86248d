"""Triangle -> screen-tile binning (port of ash_tpu/ops/binning.py).

Each tile gets a bounded list of candidate triangles from a conservative
bbox/tile overlap test. The lists are built densely, as a (tiles, T) overlap
matrix compacted with `torch.topk`, so no atomics decide the order: ids in a
list are ascending, which gives the raster's depth test its first-wins tie
rule. Large scenes bin in two levels (`bin_triangles_two_level`): densely
into coarse tiles first, then each fine tile refines its coarse tile's list.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class TileBins(NamedTuple):
    tri_ids: torch.Tensor  # (num_tiles, K) int32, -1 padded, ascending ids
    counts: torch.Tensor  # (num_tiles,) int32 number of valid entries
    overflow: torch.Tensor  # () int32: worst tile's excess over K (0 = ok)


def grid_shape(height: int, width: int, tile_h: int, tile_w: int):
    return (-(-height // tile_h), -(-width // tile_w))


def _keep_rank(keep_score: torch.Tensor):
    """(rank, rank_to_id): a HIGHER rank is kept longer; equal scores give
    the lower triangle id the higher rank (the reference's lexsort on
    (score, -id), done as two stable sorts). As the reference's sort and
    the CPU's, -0.0 ranks equal to +0.0 and every NaN equal, above +inf:
    the scores are made so first, since the card's radix sort orders
    zeros and NaNs by their bits."""
    t = keep_score.shape[0]
    score = torch.where(keep_score == 0, 0.0, keep_score)
    score = torch.where(torch.isnan(score), float("nan"), score)
    ids = torch.arange(t, device=keep_score.device)
    by_id_desc = ids.flip(0)  # secondary key first: -id ascending
    order = by_id_desc[
        torch.argsort(score[by_id_desc], stable=True)
    ]  # tri id at each rank
    rank = torch.empty(t, dtype=torch.int32, device=keep_score.device)
    rank[order] = ids.to(torch.int32)
    return rank, order.to(torch.int32)


def _ascending_ids(tri_ids: torch.Tensor) -> torch.Tensor:
    """Sort each tile's kept ids ascending with -1 padding at the end."""
    big = torch.iinfo(torch.int32).max
    key = torch.where(tri_ids >= 0, tri_ids, big)
    key = torch.sort(key, dim=-1).values
    return torch.where(key == big, -1, key)


def bin_triangles(
    bbox: torch.Tensor,  # (T, 4) fb-space [x0, y0, x1, y1]
    valid: torch.Tensor,  # (T,) bool
    height: int,
    width: int,
    tile_h: int,
    tile_w: int,
    max_per_tile: int,
    y0: int = 0,
    keep_score: torch.Tensor | None = None,  # (T,) f32: keep HIGHEST
) -> TileBins:
    """Per-tile triangle lists (ascending ids, -1 padded) from bbox overlap.

    `overflow` is how far the worst tile exceeded `max_per_tile`; those
    triangles are dropped. `keep_score` picks which ones: None keeps the
    lowest ids (submission order), e.g. negated depth keeps the nearest.
    `y0` is the global row of the band's first tile row; bboxes stay in
    global coordinates and the grid covers rows [y0, y0 + height).
    """
    t = bbox.shape[0]
    ty, tx = grid_shape(height, width, tile_h, tile_w)
    num_tiles = ty * tx
    dev = bbox.device

    # Bboxes wholly outside the band cover nothing; without the horizontal
    # check the clamp below would fold them into the edge tile column.
    valid = (
        valid
        & (bbox[:, 3] >= y0) & (bbox[:, 1] < y0 + height)
        & (bbox[:, 2] >= 0.0) & (bbox[:, 0] < width)
    )

    def tile_index(coord, size, hi):
        return torch.floor(coord / size).clamp(0, hi).to(torch.int32)

    tx0 = tile_index(bbox[:, 0], tile_w, tx - 1)
    ty0 = tile_index(bbox[:, 1] - y0, tile_h, ty - 1)
    tx1 = tile_index(bbox[:, 2], tile_w, tx - 1)
    ty1 = tile_index(bbox[:, 3] - y0, tile_h, ty - 1)

    tile = torch.arange(num_tiles, dtype=torch.int32, device=dev)[:, None]
    tile_row, tile_col = tile // tx, tile % tx
    overlap = (
        valid[None, :]
        & (tile_col >= tx0[None, :]) & (tile_col <= tx1[None, :])
        & (tile_row >= ty0[None, :]) & (tile_row <= ty1[None, :])
    )  # (num_tiles, T)

    counts_full = overlap.sum(dim=1, dtype=torch.int32)
    overflow = (counts_full.max() - max_per_tile).clamp_min(0)

    k = min(max_per_tile, t)
    if keep_score is None:
        # Lower ids score higher, so top-k yields ascending ids. Scores of
        # overlapping triangles are distinct; ties only among zeros (-1).
        tri_iota = torch.arange(t, dtype=torch.int32, device=dev)[None, :]
        score = torch.where(overlap, t - tri_iota, 0)
        top = torch.topk(score, k, dim=1).values
        tri_ids = torch.where(top > 0, t - top, -1).to(torch.int32)
    else:
        rank, rank_to_id = _keep_rank(keep_score)
        score = torch.where(overlap, rank[None, :] + 1, 0)
        top = torch.topk(score, k, dim=1).values
        kept = rank_to_id[(top - 1).clamp_min(0).long()]
        tri_ids = _ascending_ids(torch.where(top > 0, kept, -1))
    if k < max_per_tile:
        tri_ids = torch.nn.functional.pad(
            tri_ids, (0, max_per_tile - k), value=-1
        )
    counts = counts_full.clamp_max(max_per_tile)
    return TileBins(
        tri_ids=tri_ids.contiguous(), counts=counts,
        overflow=overflow.to(torch.int32),
    )


def bin_triangles_two_level(
    bbox: torch.Tensor,  # (T, 4) fb-space [x0, y0, x1, y1]
    valid: torch.Tensor,  # (T,) bool
    height: int,
    width: int,
    tile_h: int,
    tile_w: int,
    max_per_tile: int,
    y0: int = 0,
    coarse_tiles: tuple = (4, 2),  # fine tiles per coarse tile (y, x)
    coarse_cap: int = 16384,
    keep_score: torch.Tensor | None = None,  # (T,) f32: keep HIGHEST
) -> TileBins:
    """Coarse -> fine binning for large triangle counts, with
    bin_triangles' output contract (ascending ids, -1 padded).

    The dense binner's (tiles, T) overlap matrix grows with tiles x T. Here
    the triangles first bin densely into coarse tiles of `coarse_tiles`
    fine tiles each, keeping at most `coarse_cap` per coarse tile under the
    same policy; then each fine tile tests only its coarse tile's list:
    work C x T + tiles x Kc in place of tiles x T. `overflow` is the worst
    of the coarse and the fine drops, so every lost triangle is reported.
    """
    t = bbox.shape[0]
    ty, tx = grid_shape(height, width, tile_h, tile_w)
    cy_f, cx_f = coarse_tiles
    # Pad the fine grid up to whole coarse tiles.
    ty_p = -(-ty // cy_f) * cy_f
    tx_p = -(-tx // cx_f) * cx_f
    cy, cx = ty_p // cy_f, tx_p // cx_f
    kc = min(coarse_cap, t)
    dev = bbox.device

    coarse = bin_triangles(
        bbox, valid, ty_p * tile_h, tx_p * tile_w, tile_h * cy_f,
        tile_w * cx_f, kc, y0=y0, keep_score=keep_score,
    )
    cand = coarse.tri_ids.reshape(cy, cx, kc)  # ascending ids, -1 pad
    cb = bbox[cand.clamp_min(0).long()]  # (cy, cx, kc, 4)

    # Each fine tile's first pixel row and column, band-global like
    # bin_triangles, broadcast over (cy, cx, cy_f, cx_f, 1).
    gy = (torch.arange(cy, device=dev)[:, None] * cy_f
          + torch.arange(cy_f, device=dev)[None, :])  # (cy, cy_f)
    gx = (torch.arange(cx, device=dev)[:, None] * cx_f
          + torch.arange(cx_f, device=dev)[None, :])  # (cx, cx_f)
    py0 = (gy * tile_h + y0).to(torch.float32)[:, None, :, None, None]
    px0 = (gx * tile_w).to(torch.float32)[None, :, None, :, None]

    def b(i):  # (cy, cx, 1, 1, kc)
        return cb[:, :, None, None, :, i]

    overlap = (
        (cand >= 0)[:, :, None, None, :]
        & (b(2) >= px0) & (b(0) < px0 + tile_w)
        & (b(3) >= py0) & (b(1) < py0 + tile_h)
    )  # (cy, cx, cy_f, cx_f, kc)

    counts_full = overlap.sum(dim=-1, dtype=torch.int32)
    k = min(max_per_tile, kc)
    if keep_score is None:
        # Keep each fine tile's first k candidates: the coarse list is in
        # ascending id order, so lower slots score higher.
        slot = torch.arange(kc, dtype=torch.int32, device=dev)
        score = torch.where(overlap, kc - slot, 0)
        top = torch.topk(score, k, dim=-1).values
        slots = (kc - top).clamp(0, kc - 1).long()
        fine_ids = torch.gather(
            cand[:, :, None, None, :].expand(overlap.shape), -1, slots)
        fine_ids = torch.where(top > 0, fine_ids, -1)
    else:
        # Keep the highest-score candidates.
        rank, rank_to_id = _keep_rank(keep_score)
        slot_rank = rank[cand.clamp_min(0).long()]  # (cy, cx, kc)
        score = torch.where(overlap, slot_rank[:, :, None, None, :] + 1, 0)
        top = torch.topk(score, k, dim=-1).values
        fine_ids = _ascending_ids(torch.where(
            top > 0, rank_to_id[(top - 1).clamp_min(0).long()], -1))
    del score, overlap
    if k < max_per_tile:
        fine_ids = torch.nn.functional.pad(
            fine_ids, (0, max_per_tile - k), value=-1)

    # (cy, cx, cy_f, cx_f, ...) -> row-major fine tiles, less the grid pad.
    def fine_grid(a):
        return a.permute(0, 2, 1, 3, *range(4, a.dim())).reshape(
            ty_p, tx_p, *a.shape[4:])[:ty, :tx]

    tri_ids = fine_grid(fine_ids).reshape(ty * tx, max_per_tile)
    counts_real = fine_grid(counts_full)
    # Overflow over the real fine grid only: unclamped bboxes land
    # candidates in the off-screen pad tiles, which would report phantom
    # drops. Coarse drops never reach the fine pass, so they count too.
    overflow = torch.maximum(
        (counts_real.max() - max_per_tile).clamp_min(0), coarse.overflow)
    return TileBins(
        tri_ids=tri_ids.to(torch.int32).contiguous(),
        counts=counts_real.clamp_max(max_per_tile).reshape(ty * tx),
        overflow=overflow.to(torch.int32),
    )
