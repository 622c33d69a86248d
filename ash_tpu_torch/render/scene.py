"""Packed scene buffers (port of ash_tpu/render/scene.py).

The draw list is packed with numpy exactly as the reference packs it (true
instancing: vertex attributes once per unique mesh, plus int32 expansion
maps `vert_uid` / `vert_draw`; LOD chains packed with a level per triangle;
everything padded to power-of-two buckets), then moved to the device as
torch tensors. `scene_from_numpy` is that last step, and also carries a
reference `SceneBuffers` across so both packages compute on identical
inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..core.mesh import Mesh, VertexArrays
from ..core.uniform import MaterialUniform

MAX_LOD_LEVELS = 8


@dataclasses.dataclass
class DrawItem:
    """One draw: mesh + model transform + packed material."""

    mesh_key: str
    model: np.ndarray  # (4, 4) float32
    material: MaterialUniform

    def packed_material(self) -> np.ndarray:
        return self.material.pack()


class SceneBuffers(NamedTuple):
    """Device-resident packed scene (shapes static per bucket)."""

    # Unique per-mesh attribute pool (length Vu).
    position: torch.Tensor  # (Vu, 3)
    normal: torch.Tensor  # (Vu, 3)
    uv: torch.Tensor  # (Vu, 2)
    color: torch.Tensor  # (Vu, 3)
    tangent: torch.Tensor  # (Vu, 4)
    # Instance expansion maps (length Ve).
    vert_uid: torch.Tensor  # (Ve,) int32 -> unique vertex
    vert_draw: torch.Tensor  # (Ve,) int32 -> draw id
    # Triangles index EXPANDED vertex ids.
    tri_v: torch.Tensor  # (Te, 3) int32
    tri_draw: torch.Tensor  # (Te,) int32
    tri_valid: torch.Tensor  # (Te,) bool
    tri_lod: torch.Tensor  # (Te,) int32
    materials: torch.Tensor  # (D, MATERIAL_RECORD_SIZE)
    draw_center: torch.Tensor  # (D, 3)
    draw_extents: torch.Tensor  # (D, 3)
    draw_enabled: torch.Tensor  # (D,) bool
    lod_thresholds: torch.Tensor  # (D, MAX_LOD_LEVELS)

    @property
    def num_triangles(self) -> int:
        return int(self.tri_v.shape[0])

    @property
    def num_draws(self) -> int:
        return int(self.materials.shape[0])

    @property
    def num_unique_vertices(self) -> int:
        return int(self.position.shape[0])


def scene_from_numpy(buffers, device) -> SceneBuffers:
    """Any SceneBuffers-shaped tuple (this package's numpy packing, or the
    reference's jax arrays) -> this package's SceneBuffers on `device`,
    field by field through `np.asarray`, dtypes unchanged."""
    return SceneBuffers(*(
        torch.from_numpy(np.array(getattr(buffers, f))).to(device)
        for f in SceneBuffers._fields
    ))


def _bucket(n: int, minimum: int = 16) -> int:
    """Round up to the next power of two (>= minimum)."""
    b = minimum
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class BuiltScene:
    buffers: SceneBuffers
    num_draws: int  # real (unpadded) draw count
    num_triangles: int
    num_vertices: int  # expanded
    scene_center: np.ndarray
    scene_radius: float
    has_lods: bool = False
    # The world AABB that scene_center and scene_radius fit (the chunked
    # frame unions its chunks' boxes).
    scene_lo: Optional[np.ndarray] = None  # (3,)
    scene_hi: Optional[np.ndarray] = None  # (3,)
    # Host LOD tables for Renderer.lod_stats (no device readback): per draw,
    # the triangle count of each level and the levels' coverage thresholds.
    lod_level_triangles: Optional[np.ndarray] = None  # (D, MAX_LOD_LEVELS)
    lod_thresholds_host: Optional[np.ndarray] = None  # (D, MAX_LOD_LEVELS)
    # Per-draw local bounds on the host, for the bounds refit after a
    # transform update and lod_stats (no device readback).
    draw_center_host: Optional[np.ndarray] = None  # (D, 3)
    draw_extents_host: Optional[np.ndarray] = None  # (D, 3)


def _pack_mesh(mesh: Mesh) -> tuple:
    """A mesh's LOD chain as one local vertex/triangle block."""
    levels = [mesh] + [m for m, _ in mesh.lods]
    if len(levels) > MAX_LOD_LEVELS:
        raise ValueError(f"more than {MAX_LOD_LEVELS} LOD levels")
    parts, tris, lods = [], [], []
    level_tris = np.zeros(MAX_LOD_LEVELS, np.int32)
    off = 0
    for li, lv in enumerate(levels):
        parts.append(lv.vertices)
        t = lv.triangle_indices + off
        tris.append(t)
        lods.append(np.full(t.shape[0], li, np.int32))
        level_tris[li] = t.shape[0]
        off += len(lv.vertices)
    thr = np.full(MAX_LOD_LEVELS, np.inf, np.float32)
    for j, (_, s) in enumerate(mesh.lods):
        thr[j] = s  # level j selected while coverage >= lods[j].threshold
    thr[len(levels) - 1] = -np.inf  # last level: always selectable
    c, e = mesh.bounds()
    lo, hi = c - e, c + e
    corners = np.array(
        [[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
         for z in (lo[2], hi[2])], np.float32,
    )
    return (parts, np.concatenate(tris).astype(np.int32),
            np.concatenate(lods), c, e, thr, level_tris, corners, off)


class _PackedMesh(NamedTuple):
    voff: int  # offset into the unique vertex pool
    nverts: int  # expanded verts per instance
    tris: np.ndarray  # (Tm, 3) int32 local indices
    tri_lod: np.ndarray  # (Tm,) int32
    center: np.ndarray
    extents: np.ndarray
    thresholds: np.ndarray  # (MAX_LOD_LEVELS,) f32
    level_tris: np.ndarray  # (MAX_LOD_LEVELS,) int32 triangles per level
    corners: np.ndarray  # (8, 3) local AABB corners


def pack_scene(draw_items: List[DrawItem], meshes: Dict[str, Mesh]):
    """Pack a draw list with numpy. Returns (buffers with numpy fields,
    BuiltScene metadata kwargs)."""
    if not draw_items:
        raise ValueError("empty draw list")

    packed: Dict[str, _PackedMesh] = {}
    pool_parts = []
    voff = 0
    for item in draw_items:
        if item.mesh_key in packed:
            continue
        parts, tris, tri_lod, c, e, thr, lt, corners, nv = _pack_mesh(
            meshes[item.mesh_key]
        )
        pool_parts.extend(parts)
        packed[item.mesh_key] = _PackedMesh(voff, nv, tris, tri_lod, c, e,
                                            thr, lt, corners)
        voff += nv
    pool = VertexArrays.concatenate(pool_parts)

    # Vectorized instance expansion.
    nd = len(draw_items)
    keys = [it.mesh_key for it in draw_items]
    pm = [packed[k] for k in keys]
    vcounts = np.array([p.nverts for p in pm], np.int64)
    tcounts = np.array([p.tris.shape[0] for p in pm], np.int64)
    mesh_voff = np.array([p.voff for p in pm], np.int64)

    ve = int(vcounts.sum())
    voffs_item = np.concatenate([[0], np.cumsum(vcounts)[:-1]])
    vert_item = np.repeat(np.arange(nd), vcounts)
    within_v = np.arange(ve) - voffs_item[vert_item]
    vert_uid = (mesh_voff[vert_item] + within_v).astype(np.int32)
    vert_draw = vert_item.astype(np.int32)

    te = int(tcounts.sum())
    toffs_item = np.concatenate([[0], np.cumsum(tcounts)[:-1]])
    tri_item = np.repeat(np.arange(nd), tcounts)
    within_t = np.arange(te) - toffs_item[tri_item]
    mesh_order = list(packed)
    mesh_index = {k: i for i, k in enumerate(mesh_order)}
    tris_cat = np.concatenate([packed[k].tris for k in mesh_order])
    lods_cat = np.concatenate([packed[k].tri_lod for k in mesh_order])
    mesh_toff = np.concatenate(
        [[0], np.cumsum([packed[k].tris.shape[0] for k in mesh_order])[:-1]]
    )
    item_midx = np.array([mesh_index[k] for k in keys], np.int64)
    global_tri = mesh_toff[item_midx[tri_item]] + within_t
    tri_v = (tris_cat[global_tri] + voffs_item[tri_item][:, None]).astype(np.int32)
    tri_lod = lods_cat[global_tri].astype(np.int32)
    tri_draw = tri_item.astype(np.int32)

    models = np.stack([np.asarray(it.model, np.float32) for it in draw_items])
    mats = np.stack([it.packed_material() for it in draw_items]).astype(np.float32)
    centers = np.stack([p.center for p in pm])
    extents = np.stack([p.extents for p in pm])
    thresholds = np.stack([p.thresholds for p in pm])
    level_tris = np.stack([p.level_tris for p in pm])
    has_lods = bool((level_tris[:, 1] > 0).any())

    # World AABB for shadow fitting: batched corner transform.
    corners = np.stack([p.corners for p in pm])  # (D, 8, 3)
    wc = (
        np.einsum("dij,dcj->dci", models[:, :3, :3], corners)
        + models[:, None, :3, 3]
    )
    lo = wc.reshape(-1, 3).min(axis=0)
    hi = wc.reshape(-1, 3).max(axis=0)

    pv_u = _bucket(len(pool))
    pv_e, pt, pd = _bucket(ve), _bucket(te), _bucket(nd, minimum=1)

    def padv(a, n, fill=0.0):
        a = np.asarray(a)
        out = np.full((n, *a.shape[1:]), fill, a.dtype)
        out[: a.shape[0]] = a
        return out

    buffers = SceneBuffers(
        position=padv(pool.position, pv_u),
        normal=padv(pool.normal, pv_u),
        uv=padv(pool.uv, pv_u),
        color=padv(pool.color, pv_u),
        tangent=padv(pool.tangent, pv_u),
        vert_uid=padv(vert_uid, pv_e),
        vert_draw=padv(vert_draw, pv_e),
        tri_v=padv(tri_v, pt),
        tri_draw=padv(tri_draw, pt),
        tri_valid=padv(np.ones(te, bool), pt, fill=False),
        tri_lod=padv(tri_lod, pt),
        materials=padv(mats, pd),
        draw_center=padv(centers, pd),
        draw_extents=padv(extents, pd),
        draw_enabled=padv(np.ones(nd, bool), pd, fill=False),
        lod_thresholds=padv(thresholds, pd, fill=np.float32(np.inf)),
    )
    center = ((lo + hi) * 0.5).astype(np.float32)
    meta = dict(
        num_draws=nd, num_triangles=te, num_vertices=ve,
        scene_center=center,
        scene_radius=max(float(np.linalg.norm(hi - center)), 1e-3),
        has_lods=has_lods,
        scene_lo=lo.astype(np.float32),
        scene_hi=hi.astype(np.float32),
        lod_level_triangles=level_tris,
        lod_thresholds_host=thresholds,
        draw_center_host=centers,
        draw_extents_host=extents,
    )
    return buffers, meta


def build_scene(
    draw_items: List[DrawItem], meshes: Dict[str, Mesh], device
) -> BuiltScene:
    """Pack a draw list and place it on `device`."""
    buffers, meta = pack_scene(draw_items, meshes)
    return BuiltScene(buffers=scene_from_numpy(buffers, device), **meta)


def build_models(draw_items: List[DrawItem], num_draws_padded: int) -> np.ndarray:
    """(D_pad, 4, 4) model matrices for the current frame (identity pad)."""
    out = np.tile(np.eye(4, dtype=np.float32), (num_draws_padded, 1, 1))
    if draw_items:
        out[: len(draw_items)] = np.stack(
            [np.asarray(it.model, np.float32) for it in draw_items]
        )
    return out
