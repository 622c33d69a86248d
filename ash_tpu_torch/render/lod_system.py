"""Level-of-detail system (a copy of ash_tpu/render/lod_system.py, after the
reference src/renderer/lod_system.rs).

Screen-coverage estimation from a projected bounding sphere
(lod_system.rs:207-235), selection by screen size with hysteresis blend or by
distance (lod_system.rs:300-346), per-object + global bias, cull threshold
0.1% (lod_system.rs:56), and triangle-reduction stats (lod_system.rs:148-185).

Host-side; the frame selects levels on the device (render/frame.py:
lod_tri_mask), and `screen_coverage_batch` offers the vectorized form for
large scenes.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

import numpy as np

MAX_LOD_LEVELS = 8


class LodSelectionMode(enum.Enum):
    SCREEN_SIZE = "screen_size"
    DISTANCE = "distance"


@dataclasses.dataclass
class LodConfig:
    """lod_system.rs:35-59."""

    mode: LodSelectionMode = LodSelectionMode.SCREEN_SIZE
    smooth_transitions: bool = True
    transition_width: float = 0.1
    global_bias: float = 0.0
    cull_threshold: float = 0.001  # cull below 0.1% screen coverage


@dataclasses.dataclass
class LodLevel:
    screen_threshold: float = 0.0
    distance_threshold: float = 0.0
    triangle_count: int = 0
    vertex_count: int = 0
    mesh_key: Optional[str] = None


@dataclasses.dataclass
class LodMesh:
    """A mesh with multiple detail levels (level 0 = full detail)."""

    name: str
    levels: List[LodLevel] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class LodSelection:
    level: int
    blend: float
    culled: bool
    screen_coverage: float


@dataclasses.dataclass
class LodStats:
    """lod_system.rs:148-185."""

    triangles_before: int = 0
    triangles_after: int = 0
    objects_culled: int = 0
    objects_per_lod: List[int] = dataclasses.field(
        default_factory=lambda: [0] * MAX_LOD_LEVELS
    )

    def reset(self) -> None:
        self.triangles_before = 0
        self.triangles_after = 0
        self.objects_culled = 0
        self.objects_per_lod = [0] * MAX_LOD_LEVELS

    @property
    def reduction_rate(self) -> float:
        if self.triangles_before == 0:
            return 0.0
        return 1.0 - self.triangles_after / self.triangles_before


def screen_coverage(
    position, radius: float, view_proj: np.ndarray,
    screen_width: float, screen_height: float,
) -> float:
    """Projected-sphere coverage as screen-area fraction
    (lod_system.rs:207-235)."""
    p = np.asarray(position, np.float32)
    clip = view_proj @ np.array([p[0], p[1], p[2], 1.0], np.float32)
    if clip[3] <= 0.0:
        return 0.0
    proj_radius = radius / clip[3]
    pixel_radius = proj_radius * max(screen_width, screen_height) * 0.5
    area = np.pi * pixel_radius * pixel_radius
    return float(min(area / (screen_width * screen_height), 1.0))


def screen_coverage_batch(
    positions: np.ndarray, radii: np.ndarray, view_proj: np.ndarray,
    screen_width: float, screen_height: float,
) -> np.ndarray:
    """Vectorized coverage for N objects."""
    p4 = np.concatenate(
        [positions, np.ones((len(positions), 1), np.float32)], axis=-1
    )
    clip = p4 @ view_proj.T
    w = clip[:, 3]
    pixel_radius = radii / np.maximum(w, 1e-8) * max(screen_width, screen_height) * 0.5
    cov = np.pi * pixel_radius**2 / (screen_width * screen_height)
    return np.where(w <= 0.0, 0.0, np.minimum(cov, 1.0)).astype(np.float32)


class LodManager:
    def __init__(self, config: LodConfig | None = None):
        self.config = config or LodConfig()
        self.stats = LodStats()
        self.object_bias: dict[str, float] = {}

    def begin_frame(self) -> None:
        self.stats.reset()

    def set_object_bias(self, name: str, bias: float) -> None:
        self.object_bias[name] = bias

    def _select_by_screen_size(self, mesh: LodMesh, coverage: float):
        """lod_system.rs:317-337: first level whose threshold is met, with a
        hysteresis blend toward the next level."""
        for i, level in enumerate(mesh.levels):
            if coverage >= level.screen_threshold:
                blend = 0.0
                if self.config.smooth_transitions and i + 1 < len(mesh.levels):
                    nxt = mesh.levels[i + 1].screen_threshold
                    rng = level.screen_threshold - nxt
                    if rng > 0.0:
                        pos = (level.screen_threshold - coverage) / rng
                        blend = float(
                            np.clip(pos / self.config.transition_width, 0.0, 1.0)
                        )
                return i, blend
        return max(len(mesh.levels) - 1, 0), 0.0

    def _select_by_distance(self, mesh: LodMesh, distance: float):
        for i, level in enumerate(mesh.levels):
            if distance <= level.distance_threshold:
                return i, 0.0
        return max(len(mesh.levels) - 1, 0), 0.0

    def select_lod(
        self, mesh: LodMesh, world_position, view_proj: np.ndarray,
        camera_position, screen_width: float, screen_height: float,
    ) -> LodSelection:
        if mesh.levels:
            self.stats.triangles_before += mesh.levels[0].triangle_count

        coverage = screen_coverage(
            world_position, 1.0, view_proj, screen_width, screen_height
        )
        if coverage < self.config.cull_threshold:
            self.stats.objects_culled += 1
            return LodSelection(0, 0.0, True, coverage)

        if self.config.mode is LodSelectionMode.SCREEN_SIZE:
            level, blend = self._select_by_screen_size(mesh, coverage)
        else:
            dist = float(
                np.linalg.norm(
                    np.asarray(world_position, np.float32)
                    - np.asarray(camera_position, np.float32)
                )
            )
            level, blend = self._select_by_distance(mesh, dist)

        bias = self.config.global_bias + self.object_bias.get(mesh.name, 0.0)
        biased = int(np.clip(level + round(bias), 0, max(len(mesh.levels) - 1, 0)))
        if biased < len(mesh.levels):
            self.stats.triangles_after += mesh.levels[biased].triangle_count
            if biased < MAX_LOD_LEVELS:
                self.stats.objects_per_lod[biased] += 1
        return LodSelection(biased, blend, False, coverage)
