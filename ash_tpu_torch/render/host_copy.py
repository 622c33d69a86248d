"""Copies between the device and reused host buffers that the render thread
does not wait for: the surfaces' readback of presented frames
(render/surface.py, live_view.py, terminal_surface.py) and the renderer's
upload of each frame's constants (renderer.py `_upload_frame`).

A CUDA copy is enqueued with `non_blocking=True` on the current stream of
the tensor's device, between a pinned host buffer and device memory, and a
CUDA event is recorded after it. Nothing reads a host buffer that a copy
filled before its event has completed, and nothing writes a host buffer
that a copy reads from before its event has completed: that is the whole
of the ordering. A pinned allocation, a copy or an event that fails raises;
no path falls back to a blocking copy. On the CPU the same calls copy at
once and record nothing.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch


def as_frame(frame) -> torch.Tensor:
    """A presented (H, W, C) frame as a tensor: a tensor itself (on the
    device or the host), or a host numpy array's tensor view."""
    if isinstance(frame, torch.Tensor):
        return frame
    if isinstance(frame, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(frame))
    raise TypeError("present takes an (H, W, C) uint8 tensor or a host "
                    f"numpy array, not {type(frame).__name__}")


class Slot:
    """One host buffer of a `HostFrames` ring, the event recorded after the
    last copy into it (None on the CPU) and its holders' count."""

    __slots__ = ("host", "event", "refs", "ring")

    def __init__(self, host: torch.Tensor, event, ring):
        self.host, self.event, self.refs, self.ring = host, event, 0, ring

    def wait(self) -> None:
        """Block until the copy into the buffer has completed."""
        if self.event is not None:
            self.event.synchronize()

    def pixels(self) -> np.ndarray:
        """The buffer as numpy (a view: read it only between wait() and the
        slot's release)."""
        return self.host.numpy()


class HostFrames:
    """`count` host buffers that presented frames are copied into, made at
    the first copy and again after `reset` or when a frame's shape, dtype
    or kind of device changes; pinned for CUDA frames. `copy` takes a free
    buffer, enqueues the frame's copy into it and returns its `Slot`, held
    once; `retain` and `release` count its holders, and a slot is free again
    when none is left. The caller sizes `count` to the most slots its
    frames in flight hold at once; where every one is held (a reader of an
    old frame may hold one a while), `copy` makes one more. Not
    thread-safe: a surface calls it under its own lock."""

    def __init__(self, count: int):
        if count < 1:
            raise ValueError("HostFrames needs at least one buffer")
        self.count = int(count)
        self._ring: Optional[tuple] = None  # (key, [free Slot])

    def reset(self) -> None:
        """Make the buffers anew at the next copy; held slots stay valid
        and are dropped at their release."""
        self._ring = None

    def copy(self, frame) -> Slot:
        t = as_frame(frame)
        key = (tuple(t.shape), t.dtype, t.is_cuda)
        if self._ring is None or self._ring[0] != key:
            self._ring = (key, [])
            for _ in range(self.count):
                self._ring[1].append(self._slot(t))
        free = self._ring[1]
        slot = free.pop(0) if free else self._slot(t)
        slot.refs = 1
        if t.is_cuda:
            slot.host.copy_(t, non_blocking=True)
            slot.event.record(torch.cuda.current_stream(t.device))
        else:
            slot.host.copy_(t)
        return slot

    def _slot(self, t: torch.Tensor) -> Slot:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
        return Slot(host, torch.cuda.Event() if t.is_cuda else None,
                    self._ring)

    @staticmethod
    def retain(slot: Slot) -> Slot:
        slot.refs += 1
        return slot

    @staticmethod
    def release(slot: Slot) -> None:
        slot.refs -= 1
        if slot.refs == 0:
            slot.ring[1].append(slot)


class Staging:
    """`count` pinned host buffers for host-to-device copies into one device
    buffer (the renderer's frame constants), used in turn. Reusing a buffer
    waits on the event recorded after its last copy, so that no frame's
    constants are overwritten before the device has read them; that alone
    bounds how many frames the host runs ahead of the device (count)."""

    def __init__(self, count: int):
        if count < 1:
            raise ValueError("Staging needs at least one buffer")
        self.count = int(count)
        self._bufs: List[torch.Tensor] = []
        self._events: List[torch.cuda.Event] = []
        self._next = 0

    def upload(self, dst: torch.Tensor, parts: Sequence[np.ndarray]) -> None:
        """dst[:n] = the f32 arrays `parts`, flattened and concatenated (n
        floats in all): a non-blocking copy from the next pinned buffer on
        the card, a plain copy on the CPU."""
        n = sum(p.size for p in parts)
        if not dst.is_cuda:
            dst[:n].copy_(torch.from_numpy(np.concatenate(parts)))
            return
        if not self._bufs or self._bufs[0].numel() < n:
            # The old buffers' pending copies keep their memory: PyTorch's
            # pinned allocator frees a block after the copies that read it.
            self._bufs = [torch.empty(n, dtype=torch.float32, pin_memory=True)
                          for _ in range(self.count)]
            self._events = [torch.cuda.Event() for _ in range(self.count)]
            self._next = 0
        i = self._next
        self._next = (i + 1) % self.count
        self._events[i].synchronize()
        buf = self._bufs[i][:n]
        np.concatenate(parts, out=buf.numpy())
        dst[:n].copy_(buf, non_blocking=True)
        self._events[i].record(torch.cuda.current_stream(dst.device))
