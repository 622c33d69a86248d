"""Deferred-destroy queue (copy of ash_tpu/render/deletion_queue.py;
reference src/vulkan/deletion_queue.rs).

Thread-safe LIFO of cleanup closures, flushed explicitly (end of frame /
resize) or on drop with a warning. A deferred device tensor is held until
the flush, which drops the reference so the caching allocator can reuse
its memory. A closure that raises is logged and the flush goes on, as in
the reference: one failed release must not leak the rest.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, List

log = logging.getLogger("ash_tpu_torch.deletion_queue")


class DeletionQueue:
    def __init__(self, name: str = "deletion_queue"):
        self.name = name
        self._items: List[Callable[[], None]] = []
        self._lock = threading.Lock()

    def push(self, fn: Callable[[], None]) -> None:
        with self._lock:
            self._items.append(fn)

    def push_array(self, array) -> None:
        """Hold a device tensor until the flush drops it."""
        self.push([array].clear)

    def __len__(self) -> int:
        return len(self._items)

    def flush(self) -> int:
        """Run all deferred deletions in LIFO order
        (deletion_queue.rs LIFO contract)."""
        with self._lock:
            items, self._items = self._items, []
        count = 0
        for fn in reversed(items):
            try:
                fn()
            except Exception as exc:
                log.warning("%s: deferred delete failed: %s", self.name, exc)
            count += 1
        return count

    def __del__(self):
        if self._items:
            log.warning(
                "%s dropped with %d pending deletions; flushing",
                self.name,
                len(self._items),
            )
            self.flush()
