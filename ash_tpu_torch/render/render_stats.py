"""Unified render statistics dashboard (copy of
ash_tpu/render/render_stats.py; reference src/renderer/render_stats.rs).

FrameTimings / DrawStats / MemoryStats / CullingStats (render_stats.rs:10-82)
and the efficiency_score heuristic (render_stats.rs:93-113), reproduced
exactly: 100 - min(draws/100, 30) + instancing_ratio*10 + cull_ratio*20,
clamped to [0, 100].
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class FrameTimings:
    frame_ms: float = 0.0
    shadow_ms: float = 0.0
    scene_ms: float = 0.0
    post_ms: float = 0.0
    overlay_ms: float = 0.0


@dataclasses.dataclass
class DrawStats:
    draw_calls: int = 0
    instanced_draws: int = 0
    triangles: int = 0
    vertices: int = 0


@dataclasses.dataclass
class MemoryStats:
    hbm_used_bytes: int = 0
    buffer_bytes: int = 0
    texture_bytes: int = 0
    allocation_count: int = 0


@dataclasses.dataclass
class CullingStats:
    objects_submitted: int = 0
    after_frustum: int = 0
    after_occlusion: int = 0
    triangles_submitted: int = 0
    triangles_rasterized: int = 0


@dataclasses.dataclass
class RenderStats:
    frame: int = 0
    timings: FrameTimings = dataclasses.field(default_factory=FrameTimings)
    draws: DrawStats = dataclasses.field(default_factory=DrawStats)
    memory: MemoryStats = dataclasses.field(default_factory=MemoryStats)
    culling: CullingStats = dataclasses.field(default_factory=CullingStats)
    fps: float = 0.0

    def calculate_fps(self) -> None:
        if self.timings.frame_ms > 0.0:
            self.fps = 1000.0 / self.timings.frame_ms

    def efficiency_score(self) -> float:
        """render_stats.rs:93-113."""
        score = 100.0
        score -= min(self.draws.draw_calls / 100.0, 30.0)
        if self.draws.draw_calls > 0:
            ratio = self.draws.instanced_draws / self.draws.draw_calls
            score += ratio * 10.0
        if self.culling.objects_submitted > 0:
            cull_ratio = 1.0 - (
                self.culling.after_occlusion / self.culling.objects_submitted
            )
            score += cull_ratio * 20.0
        return max(0.0, min(score, 100.0))

    def format_compact(self) -> str:
        return (
            f"#{self.frame} {self.fps:.0f}fps {self.timings.frame_ms:.2f}ms "
            f"draws:{self.draws.draw_calls} tris:{self.draws.triangles} "
            f"eff:{self.efficiency_score():.0f}"
        )


class StatsCollector:
    """Accumulates per-frame stats (reference StatsCollector)."""

    def __init__(self):
        self.current = RenderStats()
        self.history: list[RenderStats] = []
        self.history_limit = 240

    def begin_frame(self) -> None:
        frame = self.current.frame + 1
        self.current = RenderStats(frame=frame)

    def end_frame(self, frame_ms: float) -> RenderStats:
        self.current.timings.frame_ms = frame_ms
        self.current.calculate_fps()
        self.history.append(self.current)
        if len(self.history) > self.history_limit:
            self.history.pop(0)
        return self.current
