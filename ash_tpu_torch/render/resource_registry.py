"""Dependency-aware resource registry (copy of
ash_tpu/render/resource_registry.py).

The reference's src/renderer/resource_registry.rs: UUID-keyed registration
of typed resources with declared dependencies, cycle detection
(resource_registry.rs:286-303), a reverse-dependency guard on removal
(:311-318), topological cleanup via DFS so dependents die before their
dependencies (:351-404), and an idempotent, error-tolerant `cleanup()`
(:95-115).

Here "resources" are device tensors, kernel libraries, pools — anything
with an optional `destroy` callback (for a tensor: dropping the registry's
reference). The typed `register_*` helpers mirror the
reference's Vulkan object kinds so ported call sites read the same.
"""

from __future__ import annotations

import dataclasses
import enum
import logging
import threading
import uuid
from typing import Callable, Dict, List, Optional, Set

log = logging.getLogger("ash_tpu_torch.registry")


class ResourceType(enum.Enum):
    # The reference's kinds (resource_registry.rs:117-197) + device kinds.
    FRAMEBUFFER = "framebuffer"
    RENDER_PASS = "render_pass"
    DEPTH_BUFFER = "depth_buffer"
    IMAGE_VIEW = "image_view"
    COMMAND_POOL = "command_pool"
    SEMAPHORE = "semaphore"
    FENCE = "fence"
    PIPELINE_LAYOUT = "pipeline_layout"
    PIPELINE = "pipeline"
    DESCRIPTOR_POOL = "descriptor_pool"
    DEVICE_ARRAY = "device_array"
    EXECUTABLE = "executable"
    TEXTURE_POOL = "texture_pool"
    OTHER = "other"


@dataclasses.dataclass
class _Entry:
    rid: uuid.UUID
    rtype: ResourceType
    name: str
    destroy: Optional[Callable[[], None]]
    dependencies: Set[uuid.UUID]


class RegistryError(Exception):
    pass


class ResourceRegistry:
    def __init__(self):
        self._entries: Dict[uuid.UUID, _Entry] = {}
        self._lock = threading.Lock()
        self._cleaned = False

    def __len__(self) -> int:
        return len(self._entries)

    # -------------------------------------------------------------- core

    def register(
        self,
        rtype: ResourceType,
        name: str = "",
        destroy: Optional[Callable[[], None]] = None,
        dependencies: Optional[List[uuid.UUID]] = None,
    ) -> uuid.UUID:
        deps = set(dependencies or [])
        with self._lock:
            for d in deps:
                if d not in self._entries:
                    raise RegistryError(f"unknown dependency {d} for {name!r}")
            rid = uuid.uuid4()
            entry = _Entry(rid, rtype, name, destroy, deps)
            self._entries[rid] = entry
            if self._has_cycle_from(rid):
                del self._entries[rid]
                raise RegistryError(f"dependency cycle via {name!r}")
            self._cleaned = False
            return rid

    def _has_cycle_from(self, start: uuid.UUID) -> bool:
        """DFS cycle check (resource_registry.rs:286-303)."""
        seen: Set[uuid.UUID] = set()
        stack = [start]
        while stack:
            cur = stack.pop()
            if cur == start and seen:
                return True
            if cur in seen:
                continue
            seen.add(cur)
            stack.extend(self._entries[cur].dependencies)
        return False

    def dependents_of(self, rid: uuid.UUID) -> List[uuid.UUID]:
        return [
            e.rid for e in self._entries.values() if rid in e.dependencies
        ]

    def remove(self, rid: uuid.UUID, force: bool = False) -> None:
        """Remove one resource; refuses while dependents exist
        (resource_registry.rs:311-318)."""
        with self._lock:
            entry = self._entries.get(rid)
            if entry is None:
                return
            deps = self.dependents_of(rid)
            if deps and not force:
                names = [self._entries[d].name for d in deps]
                raise RegistryError(
                    f"cannot remove {entry.name!r}: dependents {names}"
                )
            self._destroy_entry(entry)
            del self._entries[rid]

    @staticmethod
    def _destroy_entry(entry: _Entry) -> None:
        if entry.destroy is None:
            return
        try:
            entry.destroy()
        except Exception as exc:  # poison-tolerant (reference :95-115)
            log.warning("destroy of %s failed: %s", entry.name, exc)

    def cleanup(self) -> int:
        """Destroy everything, dependents first (topological DFS order,
        resource_registry.rs:351-404). Idempotent."""
        with self._lock:
            if self._cleaned and not self._entries:
                return 0
            order: List[uuid.UUID] = []
            marked: Set[uuid.UUID] = set()

            def visit(rid: uuid.UUID):
                if rid in marked:
                    return
                marked.add(rid)
                for dep in self.dependents_of(rid):
                    visit(dep)
                order.append(rid)

            for rid in list(self._entries):
                visit(rid)
            count = 0
            for rid in order:
                entry = self._entries.pop(rid, None)
                if entry is not None:
                    self._destroy_entry(entry)
                    count += 1
            self._cleaned = True
            return count

    # ------------------------------------------------- typed helpers

    def register_framebuffer(self, name, destroy=None, deps=None):
        return self.register(ResourceType.FRAMEBUFFER, name, destroy, deps)

    def register_render_pass(self, name, destroy=None, deps=None):
        return self.register(ResourceType.RENDER_PASS, name, destroy, deps)

    def register_depth_buffer(self, name, destroy=None, deps=None):
        return self.register(ResourceType.DEPTH_BUFFER, name, destroy, deps)

    def register_image_view(self, name, destroy=None, deps=None):
        return self.register(ResourceType.IMAGE_VIEW, name, destroy, deps)

    def register_pipeline(self, name, destroy=None, deps=None):
        return self.register(ResourceType.PIPELINE, name, destroy, deps)

    def register_device_array(self, name, array, deps=None):
        """Track a device tensor; destroy drops the registry's reference."""
        return self.register(
            ResourceType.DEVICE_ARRAY, name, [array].clear, deps
        )

    def stats(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self._entries.values():
            out[e.rtype.value] = out.get(e.rtype.value, 0) + 1
        return out
