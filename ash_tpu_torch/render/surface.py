"""Output surfaces (port of ash_tpu/render/surface.py): the headless one
and `FileStreamSurface`; `LiveViewSurface` (live_view.py) and
`TerminalSurface` (terminal_surface.py) are the other display seams.

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


class FileStreamSurface:
    """Streams every presented frame out of the process: numbered PNGs
    (`pattern` holds an `{n}` placeholder) or one appended raw RGBA stream,
    playable with e.g. `ffplay -f rawvideo -pixel_format rgba -video_size
    WxH file.rgba`.

    Like a swapchain with `max_frames_in_flight` images, the frame
    presented at step N is written at step N + 1 (or at `flush`)."""

    def __init__(self, width: int, height: int, pattern: str,
                 max_frames_in_flight: int = 2):
        if width <= 0 or height <= 0:
            raise ValueError(f"bad surface extent {width}x{height}")
        if max_frames_in_flight < 1:
            raise ValueError("max_frames_in_flight must be >= 1")
        self._size = (int(width), int(height))
        self._pattern = pattern
        try:  # a PNG sequence iff the pattern has an {n...} placeholder
            self._png = pattern.format(n=0) != pattern
        except (KeyError, IndexError, ValueError):
            raise ValueError(
                f"bad pattern {pattern!r}: only {{n}} may appear"
            ) from None
        self._queue: list = []  # (frame index, frame) awaiting the write
        self._depth = int(max_frames_in_flight)
        self._raw = None if self._png else open(pattern, "wb")
        self._last: Optional[np.ndarray] = None
        self.presented_frames = 0
        self.written_frames = 0

    def physical_size(self) -> Tuple[int, int]:
        return self._size

    def resize(self, width: int, height: int) -> None:
        self.flush()
        self._size = (int(width), int(height))

    def present(self, frame: np.ndarray) -> None:
        if not isinstance(frame, np.ndarray):
            raise TypeError("present takes a host numpy array")
        self._last = frame
        self._queue.append((self.presented_frames, frame))
        self.presented_frames += 1
        while len(self._queue) >= self._depth:
            self._write_oldest()

    def _write_oldest(self) -> None:
        index, frame = self._queue.pop(0)
        if self._png:
            from ..utils.image import write_png

            write_png(self._pattern.format(n=index), frame)
        else:
            self._raw.write(frame.tobytes())
        self.written_frames += 1

    def flush(self) -> None:
        """Write every frame in flight (at exit, or before a resize)."""
        while self._queue:
            self._write_oldest()
        if self._raw is not None:
            self._raw.flush()

    def read_back(self) -> Optional[np.ndarray]:
        return self._last

    def close(self) -> None:
        self.flush()
        if self._raw is not None:
            self._raw.close()
            self._raw = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
