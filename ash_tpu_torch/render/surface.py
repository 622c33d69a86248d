"""Output surfaces (port of ash_tpu/render/surface.py): the headless one
and `FileStreamSurface`; `LiveViewSurface` (live_view.py) and
`TerminalSurface` (terminal_surface.py) are the other display seams.

The renderer needs `physical_size()` and somewhere to put finished frames.
As in the reference, a surface receives each frame as the renderer holds
it, an (H, W, 4) uint8 tensor on the renderer's device, and presenting
waits for nothing: the frame's device work may still be running. A surface
also takes a host numpy array, as the reference's `np.asarray` does.
`HeadlessSurface` keeps the tensor until `read_back`, a blocking copy to
the host: the fence, the port's `vkQueueWaitIdle`. The other surfaces
enqueue each frame's copy into a reused pinned host buffer at `present`
and wait on its CUDA event only where they read it (render/host_copy.py).
"""

from __future__ import annotations

from typing import Optional, Protocol, Tuple

import numpy as np
import torch

from .host_copy import HostFrames, Slot, as_frame


class SurfaceProvider(Protocol):
    """Minimal surface contract."""

    def physical_size(self) -> Tuple[int, int]:
        """(width, height) in pixels."""
        ...

    def present(self, frame) -> None:
        """Accept a finished (H, W, 4) uint8 frame: a tensor on the
        renderer's device, or a host numpy array."""
        ...


class HeadlessSurface:
    """Offscreen surface: the last presented frame stays on the device until
    read back."""

    def __init__(self, width: int, height: int):
        if width <= 0 or height <= 0:
            raise ValueError(f"bad surface extent {width}x{height}")
        self._size = (int(width), int(height))
        self._frame: Optional[torch.Tensor] = None
        self._host: Optional[np.ndarray] = None  # the frame's copy, once read
        self.presented_frames = 0

    def physical_size(self) -> Tuple[int, int]:
        return self._size

    def resize(self, width: int, height: int) -> None:
        """A window resize event; the renderer notices on its next frame."""
        self._size = (int(width), int(height))

    def present(self, frame) -> None:
        self._frame = as_frame(frame)
        self._host = None
        self.presented_frames += 1

    def read_back(self) -> Optional[np.ndarray]:
        """The last presented frame on the host: a blocking copy (it waits
        for the frame's device work), made at most once a frame."""
        if self._frame is None:
            return None
        if self._host is None:
            self._host = self._frame.cpu().numpy()
        return self._host

    def save_png(self, path: str) -> None:
        from ..utils.image import write_png

        frame = self.read_back()
        if frame is None:
            raise RuntimeError("no frame presented yet")
        write_png(path, frame)


class FileStreamSurface:
    """Streams every presented frame out of the process: numbered PNGs
    (`pattern` holds an `{n}` placeholder) or one appended raw RGBA stream,
    playable with e.g. `ffplay -f rawvideo -pixel_format rgba -video_size
    WxH file.rgba`.

    Like a swapchain with `max_frames_in_flight` images, the frame
    presented at step N is written at step N + 1 (or at `flush`), so its
    copy to the host overlaps the device's next frame. `present` enqueues
    the frame's device-to-host copy into a free buffer of a ring of
    `max_frames_in_flight + 1` pinned ones (render/host_copy.py; made at
    the first present and again after a resize) and records an event;
    writing a frame waits on its event, then frees its buffer. A CPU frame
    is copied at once."""

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
        self._queue: list = []  # (frame index, Slot) awaiting the write
        self._depth = int(max_frames_in_flight)
        # The queue holds at most `depth` slots, and the last frame's slot
        # is held for read_back once it is written.
        self._slots = HostFrames(self._depth + 1)
        self._raw = None if self._png else open(pattern, "wb")
        self._last: Optional[Slot] = None
        self.presented_frames = 0
        self.written_frames = 0

    def physical_size(self) -> Tuple[int, int]:
        return self._size

    def resize(self, width: int, height: int) -> None:
        self.flush()
        self._slots.reset()
        self._size = (int(width), int(height))

    def present(self, frame) -> None:
        slot = self._slots.copy(frame)
        if self._last is not None:
            self._slots.release(self._last)
        self._last = self._slots.retain(slot)
        self._queue.append((self.presented_frames, slot))
        self.presented_frames += 1
        while len(self._queue) >= self._depth:
            self._write_oldest()

    def _write_oldest(self) -> None:
        index, slot = self._queue.pop(0)
        slot.wait()
        if self._png:
            from ..utils.image import write_png

            write_png(self._pattern.format(n=index), slot.pixels())
        else:
            self._raw.write(slot.pixels())
        self._slots.release(slot)
        self.written_frames += 1

    def flush(self) -> None:
        """Write every frame in flight (at exit, or before a resize)."""
        while self._queue:
            self._write_oldest()
        if self._raw is not None:
            self._raw.flush()

    def read_back(self) -> Optional[np.ndarray]:
        """A host copy of the last presented frame (it waits for the
        frame's copy)."""
        if self._last is None:
            return None
        self._last.wait()
        return self._last.pixels().copy()

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
