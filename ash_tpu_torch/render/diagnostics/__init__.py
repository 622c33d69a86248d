"""Diagnostics: modes, frame stats, device timings, memory stats, overlay
(port of ash_tpu/render/diagnostics/__init__.py).

The display-mode state machine (Off -> ConsoleOnly -> OverlayOnly ->
BothWithToggle, cycled by F6), FrameStats, GpuTimings, MemoryStats and the
every-60-frames console block are the reference's. The renderer fills the
memory stats from `torch.cuda.memory_allocated` and `mem_get_info` on a
CUDA device, and from the scene's buffers on the CPU.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict

from .frame_profiler import FrameProfiler
from .device_profiler import DeviceProfiler, ProfileScope

__all__ = [
    "DiagnosticsMode",
    "DiagnosticsState",
    "FrameStats",
    "GpuTimings",
    "MemoryStats",
    "FrameProfiler",
    "DeviceProfiler",
    "ProfileScope",
]


class DiagnosticsMode(enum.Enum):
    """mod.rs:31-64."""

    OFF = "off"
    CONSOLE_ONLY = "console_only"
    OVERLAY_ONLY = "overlay_only"
    BOTH_WITH_TOGGLE = "both_with_toggle"

    def next(self) -> "DiagnosticsMode":
        order = [
            DiagnosticsMode.OFF,
            DiagnosticsMode.CONSOLE_ONLY,
            DiagnosticsMode.OVERLAY_ONLY,
            DiagnosticsMode.BOTH_WITH_TOGGLE,
        ]
        return order[(order.index(self) + 1) % 4]

    @property
    def console_enabled(self) -> bool:
        return self in (
            DiagnosticsMode.CONSOLE_ONLY,
            DiagnosticsMode.BOTH_WITH_TOGGLE,
        )

    @property
    def overlay_enabled(self) -> bool:
        return self in (
            DiagnosticsMode.OVERLAY_ONLY,
            DiagnosticsMode.BOTH_WITH_TOGGLE,
        )


@dataclasses.dataclass
class FrameStats:
    """mod.rs:67-127."""

    fps: float = 0.0
    frame_time_ms: float = 0.0
    frame_time_min_ms: float = float("inf")
    frame_time_max_ms: float = 0.0
    draw_calls: int = 0
    triangles: int = 0
    total_frames: int = 0

    def format_line(self) -> str:
        return (
            f"FPS: {self.fps:.1f} | Frame: {self.frame_time_ms:.2f}ms "
            f"(min: {self.frame_time_min_ms:.2f}, max: {self.frame_time_max_ms:.2f}) "
            f"| Draws: {self.draw_calls} | Tris: {self.triangles}"
        )


@dataclasses.dataclass
class GpuTimings:
    """Named per-pass device timings in ms (reference gpu_profiler scopes)."""

    passes: Dict[str, float] = dataclasses.field(default_factory=dict)

    def total_ms(self) -> float:
        return sum(self.passes.values())

    def format_line(self) -> str:
        if not self.passes:
            return "Device: (no samples)"
        parts = " | ".join(f"{k}: {v:.2f}ms" for k, v in self.passes.items())
        return f"Device: {parts}"


@dataclasses.dataclass
class MemoryStats:
    """mod.rs:152-181."""

    gpu_used_bytes: int = 0
    gpu_budget_bytes: int = 0
    allocation_count: int = 0
    buffer_pool: tuple = (0, 0, 0)  # (available, in_use, total_bytes)

    def format_line(self) -> str:
        used = self.gpu_used_bytes / 2**20
        budget = self.gpu_budget_bytes / 2**20
        pool = self.buffer_pool[2] / 2**20
        return (
            f"HBM: {used:.1f}/{budget:.1f} MB | Allocs: {self.allocation_count}"
            f" | Pool: {pool:.1f} MB ({self.buffer_pool[0]} avail,"
            f" {self.buffer_pool[1]} used)"
        )


class DiagnosticsState:
    """mod.rs:183-254: combined state + periodic console print."""

    def __init__(
        self,
        mode: DiagnosticsMode = DiagnosticsMode.OFF,
        console_print_interval: int = 60,
    ):
        self.mode = mode
        self.frame_stats = FrameStats()
        self.gpu_timings = GpuTimings()
        self.memory_stats = MemoryStats()
        self._console_counter = 0
        self.console_print_interval = console_print_interval

    def toggle(self) -> None:
        """The F6 handler (mod.rs:44-53)."""
        self.mode = self.mode.next()

    def on_frame(self, log=print) -> None:
        """Advance the console cadence; prints every N frames when enabled."""
        if not self.mode.console_enabled:
            return
        self._console_counter += 1
        if self._console_counter >= self.console_print_interval:
            self._console_counter = 0
            log("── diagnostics ──────────────────────────")
            log(self.frame_stats.format_line())
            log(self.gpu_timings.format_line())
            log(self.memory_stats.format_line())

    def overlay_lines(self) -> list:
        """Text lines for the overlay (mod.rs:257-264)."""
        return [
            self.frame_stats.format_line(),
            self.gpu_timings.format_line(),
            self.memory_stats.format_line(),
        ]
