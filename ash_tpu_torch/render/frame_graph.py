"""Frame graph: named render-pass registry (copy of
ash_tpu/render/frame_graph.py; reference src/renderer/frame_graph.rs).

The reference stores {pipeline, layout, render_pass, dynamic state} per named
pass; here a pass is a callable stage of the frame program plus its config
and declared reads/writes — useful for tooling/introspection and for
assembling custom frame pipelines without editing render/frame.py.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass
class PassDescription:
    name: str
    run: Callable  # (inputs dict) -> outputs dict
    reads: List[str] = dataclasses.field(default_factory=list)
    writes: List[str] = dataclasses.field(default_factory=list)
    config: Optional[object] = None
    enabled: bool = True


class FrameGraph:
    def __init__(self):
        self._passes: Dict[str, PassDescription] = {}
        self._order: List[str] = []

    def add_pass(self, desc: PassDescription) -> None:
        if desc.name in self._passes:
            raise ValueError(f"duplicate pass {desc.name!r}")
        self._passes[desc.name] = desc
        self._order.append(desc.name)

    def get(self, name: str) -> Optional[PassDescription]:
        return self._passes.get(name)

    def remove(self, name: str) -> bool:
        if name in self._passes:
            del self._passes[name]
            self._order.remove(name)
            return True
        return False

    def __len__(self) -> int:
        return len(self._passes)

    def execute(self, resources: Dict[str, object]) -> Dict[str, object]:
        """Run enabled passes in insertion order over a resource dict."""
        for name in self._order:
            p = self._passes[name]
            if not p.enabled:
                continue
            missing = [r for r in p.reads if r not in resources]
            if missing:
                raise KeyError(f"pass {name!r} missing inputs {missing}")
            out = p.run({r: resources[r] for r in p.reads}) or {}
            resources.update(out)
        return resources
