"""Host frame profiler: a rolling 60-frame window of frame times (copy of
ash_tpu/render/diagnostics/frame_profiler.py)."""

from __future__ import annotations

import time
from collections import deque

WINDOW = 60


class FrameProfiler:
    def __init__(self, window: int = WINDOW):
        self.window = window
        self.samples: deque = deque(maxlen=window)
        self._frame_start = None
        self.total_frames = 0

    def begin_frame(self) -> None:
        self._frame_start = time.perf_counter()

    def end_frame(self) -> float:
        """Record the frame; returns frame time in ms."""
        if self._frame_start is None:
            return 0.0
        dt = (time.perf_counter() - self._frame_start) * 1000.0
        self.samples.append(dt)
        self.total_frames += 1
        self._frame_start = None
        return dt

    def record(self, frame_time_ms: float) -> None:
        """Record an externally measured frame time."""
        self.samples.append(frame_time_ms)
        self.total_frames += 1

    @property
    def avg_ms(self) -> float:
        return sum(self.samples) / len(self.samples) if self.samples else 0.0

    @property
    def min_ms(self) -> float:
        return min(self.samples) if self.samples else 0.0

    @property
    def max_ms(self) -> float:
        return max(self.samples) if self.samples else 0.0

    @property
    def fps(self) -> float:
        avg = self.avg_ms
        return 1000.0 / avg if avg > 0 else 0.0
