"""Occlusion-culling host state (a copy of ash_tpu/render/occlusion_culling.py,
after the reference src/renderer/occlusion_culling.rs).

CPU-side structures and stats for the device pass in ops/occlusion.py:
CullBoundingBox (occlusion_culling.rs:24-66), CullObjectData (:70-109),
IndirectDrawCommand (VkDrawIndexedIndirectCommand layout, :111-120), push
constants (:122-148), OcclusionStats (:150-185). Limits:
MAX_CULLABLE_OBJECTS = 65536, HIZ_LEVELS = 10 (:17-21).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

MAX_CULLABLE_OBJECTS = 65536
HIZ_LEVELS = 10

FLAG_ENABLED = 1


@dataclasses.dataclass
class CullBoundingBox:
    """Center + half-extents AABB (occlusion_culling.rs:24-66)."""

    center: np.ndarray
    extents: np.ndarray

    @staticmethod
    def from_min_max(bmin, bmax) -> "CullBoundingBox":
        bmin = np.asarray(bmin, np.float32)
        bmax = np.asarray(bmax, np.float32)
        return CullBoundingBox(
            center=(bmin + bmax) * 0.5, extents=(bmax - bmin) * 0.5
        )

    def corners(self) -> np.ndarray:
        s = np.array(
            [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
            np.float32,
        )
        return self.center[None] + self.extents[None] * s


@dataclasses.dataclass
class CullObjectData:
    """Per-object record (occlusion_culling.rs:70-109)."""

    bounds: CullBoundingBox
    model: np.ndarray  # (4, 4)
    draw_index: int = 0
    lod_bias: float = 0.0
    flags: int = FLAG_ENABLED

    @property
    def enabled(self) -> bool:
        return bool(self.flags & FLAG_ENABLED)


@dataclasses.dataclass
class IndirectDrawCommand:
    """VkDrawIndexedIndirectCommand layout (occlusion_culling.rs:111-120)."""

    index_count: int = 0
    instance_count: int = 1
    first_index: int = 0
    vertex_offset: int = 0
    first_instance: int = 0


@dataclasses.dataclass
class OcclusionStats:
    """occlusion_culling.rs:150-185."""

    total_objects: int = 0
    frustum_culled: int = 0
    occlusion_culled: int = 0
    visible: int = 0

    @property
    def culled_fraction(self) -> float:
        if self.total_objects == 0:
            return 0.0
        return 1.0 - self.visible / self.total_objects


class OcclusionCullingSystem:
    """Host registry feeding ops/occlusion.cull_objects."""

    def __init__(self):
        self.objects: List[CullObjectData] = []
        self.stats = OcclusionStats()

    def register(self, obj: CullObjectData) -> int:
        if len(self.objects) >= MAX_CULLABLE_OBJECTS:
            raise ValueError(f"max {MAX_CULLABLE_OBJECTS} cullable objects")
        self.objects.append(obj)
        return len(self.objects) - 1

    def clear(self) -> None:
        self.objects.clear()

    def packed(self):
        """(centers (N,3), extents (N,3), models (N,4,4), enabled (N,))."""
        n = len(self.objects)
        centers = np.zeros((n, 3), np.float32)
        extents = np.zeros((n, 3), np.float32)
        models = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        enabled = np.zeros(n, bool)
        for i, o in enumerate(self.objects):
            centers[i] = o.bounds.center
            extents[i] = o.bounds.extents
            models[i] = o.model
            enabled[i] = o.enabled
        return centers, extents, models, enabled

    def record_result(self, visibility: np.ndarray) -> OcclusionStats:
        vis = np.asarray(visibility)
        self.stats = OcclusionStats(
            total_objects=len(self.objects),
            visible=int(vis.sum()),
            frustum_culled=0,  # combined in the fused pass
            occlusion_culled=int((vis == 0).sum()),
        )
        return self.stats
