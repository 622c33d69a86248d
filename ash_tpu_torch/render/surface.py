"""Output surfaces (port of ash_tpu/render/surface.py, headless only).

The renderer needs `physical_size()` and somewhere to put finished frames.
Here a surface receives each frame as a host numpy array: the renderer
copies the image off the device once per frame (`.cpu()`), which is also the
point where the frame's device work is known to be done.
"""

from __future__ import annotations

from typing import Optional, Protocol, Tuple

import numpy as np


class SurfaceProvider(Protocol):
    """Minimal surface contract."""

    def physical_size(self) -> Tuple[int, int]:
        """(width, height) in pixels."""
        ...

    def present(self, frame: np.ndarray) -> None:
        """Accept a finished (H, W, 4) uint8 frame on the host."""
        ...


class HeadlessSurface:
    """Offscreen surface that keeps the last presented frame."""

    def __init__(self, width: int, height: int):
        if width <= 0 or height <= 0:
            raise ValueError(f"bad surface extent {width}x{height}")
        self._size = (int(width), int(height))
        self._frame: Optional[np.ndarray] = None
        self.presented_frames = 0

    def physical_size(self) -> Tuple[int, int]:
        return self._size

    def resize(self, width: int, height: int) -> None:
        """A window resize event; the renderer notices on its next frame."""
        self._size = (int(width), int(height))

    def present(self, frame: np.ndarray) -> None:
        if not isinstance(frame, np.ndarray):
            raise TypeError("present takes a host numpy array")
        self._frame = frame
        self.presented_frames += 1

    def read_back(self) -> Optional[np.ndarray]:
        """The last presented frame (already on the host)."""
        return self._frame

    def save_png(self, path: str) -> None:
        from ..utils.image import write_png

        if self._frame is None:
            raise RuntimeError("no frame presented yet")
        write_png(path, self._frame)
