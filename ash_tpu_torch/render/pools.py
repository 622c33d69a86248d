"""Array/buffer pools (copy of ash_tpu/render/pools.py).

The reference's three pool designs, host-side allocators whose buffers are
preallocated arrays handed out to staging and readback paths:

- BufferPool: simple first-fit >= size reuse with (available, in_use,
  total_bytes) stats feeding diagnostics
  (src/renderer/resources/buffer_pool.rs:48-106, stats renderer.rs:2253).
- OptimizedBufferPool: power-of-two size classes 256B..64MB with per-class
  stats and a retention policy
  (src/renderer/resources/optimized_buffer_pool.rs:19-37, 62-110).
- ThreadSafeResourcePool: lock-free-spirit pool with auto-return guards and
  hit/miss stats (src/renderer/resources/thread_safe_pool.rs:26-110).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from collections import deque
from typing import Callable, Deque, Dict, Generic, List, Optional, TypeVar

import numpy as np

T = TypeVar("T")


@dataclasses.dataclass
class PooledBuffer:
    size: int
    array: np.ndarray  # pinned host staging storage


class BufferPool:
    """First-fit reuse pool (buffer_pool.rs:48-106)."""

    def __init__(self, allocate: Optional[Callable[[int], object]] = None):
        self._allocate = allocate or (lambda n: np.empty(n, np.uint8))
        self._available: Deque = deque()
        self._in_use: List = []
        self.total_bytes = 0

    def acquire(self, size: int):
        for i, buf in enumerate(self._available):
            if buf.size >= size:
                del self._available[i]
                self._in_use.append(buf)
                return buf
        buf = PooledBuffer(size=size, array=self._allocate(size))
        self.total_bytes += size
        self._in_use.append(buf)
        return buf

    def release(self, buf) -> None:
        self._in_use.remove(buf)
        self._available.append(buf)

    def stats(self):
        """(available, in_use, total_bytes) — the diagnostics triple
        (renderer.rs:2253)."""
        return (len(self._available), len(self._in_use), self.total_bytes)


MIN_CLASS = 256
MAX_CLASS = 64 * 1024 * 1024


@dataclasses.dataclass
class BufferPoolConfig:
    """optimized_buffer_pool.rs:107-110."""

    max_buffers_per_class: int = 16
    retain_frames: int = 120


@dataclasses.dataclass
class ClassStats:
    """Per-size-class stats (optimized_buffer_pool.rs:62-87)."""

    allocations: int = 0
    reuses: int = 0
    available: int = 0
    in_use: int = 0


class OptimizedBufferPool:
    """Power-of-two size-class bucketing 256B..64MB
    (optimized_buffer_pool.rs:19-37)."""

    def __init__(self, config: BufferPoolConfig | None = None,
                 allocate: Optional[Callable[[int], object]] = None):
        self.config = config or BufferPoolConfig()
        self._allocate = allocate or (lambda n: np.empty(n, np.uint8))
        self._classes: Dict[int, Deque] = {}
        self.stats: Dict[int, ClassStats] = {}

    @staticmethod
    def size_class(size: int) -> int:
        c = MIN_CLASS
        while c < size:
            c *= 2
        if c > MAX_CLASS:
            raise ValueError(f"request {size} exceeds max class {MAX_CLASS}")
        return c

    def acquire(self, size: int):
        cls = self.size_class(size)
        st = self.stats.setdefault(cls, ClassStats())
        bucket = self._classes.setdefault(cls, deque())
        if bucket:
            buf = bucket.popleft()
            st.reuses += 1
        else:
            buf = PooledBuffer(size=cls, array=self._allocate(cls))
            st.allocations += 1
        st.in_use += 1
        st.available = len(bucket)
        return buf

    def release(self, buf) -> None:
        cls = buf.size
        st = self.stats.setdefault(cls, ClassStats())
        bucket = self._classes.setdefault(cls, deque())
        if len(bucket) < self.config.max_buffers_per_class:
            bucket.append(buf)
        st.in_use = max(st.in_use - 1, 0)
        st.available = len(bucket)

    def total_bytes(self) -> int:
        return sum(
            cls * (st.available + st.in_use) for cls, st in self.stats.items()
        )


@dataclasses.dataclass
class PoolStats:
    """thread_safe_pool.rs:26-62."""

    hits: int = 0
    misses: int = 0
    returns: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class PooledResource(Generic[T]):
    """Auto-return guard (thread_safe_pool.rs:64-110)."""

    def __init__(self, pool: "ThreadSafeResourcePool[T]", value: T):
        self.pool = pool
        self.value = value
        self._returned = False

    def __enter__(self) -> T:
        return self.value

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def release(self) -> None:
        if not self._returned:
            self._returned = True
            self.pool._return(self.value)

    def __del__(self):
        self.release()


class ThreadSafeResourcePool(Generic[T]):
    """Channel-based pool with hit/miss stats (thread_safe_pool.rs)."""

    def __init__(self, factory: Callable[[], T], capacity: int = 64):
        self._factory = factory
        self._q: "queue.SimpleQueue[T]" = queue.SimpleQueue()
        self._capacity = capacity
        self._lock = threading.Lock()
        self.stats = PoolStats()

    def acquire(self) -> PooledResource[T]:
        try:
            value = self._q.get_nowait()
            with self._lock:
                self.stats.hits += 1
        except queue.Empty:
            value = self._factory()
            with self._lock:
                self.stats.misses += 1
        return PooledResource(self, value)

    def _return(self, value: T) -> None:
        if self._q.qsize() < self._capacity:
            self._q.put(value)
        with self._lock:
            self.stats.returns += 1
