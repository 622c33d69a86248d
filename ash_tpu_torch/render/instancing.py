"""Instancing manager (a host-only copy of ash_tpu/render/instancing.py).

Batches instances by (mesh_id, material_id) with per-instance model rows,
colour and custom data, bounds accumulation and stats;
MAX_INSTANCES_PER_BATCH = 65536. `to_draw_items` expands the batches into
the port Renderer's draw list, where the packed scene stores each mesh's
vertex attributes once and the vertex stage transforms every instance in
one batched pass.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

MAX_INSTANCES_PER_BATCH = 65536


@dataclasses.dataclass
class InstanceData:
    """Per-instance payload (instancing.rs:19-34): model matrix rows +
    color + custom vec4."""

    model: np.ndarray  # (4, 4)
    color: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(4, np.float32)
    )
    custom: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(4, np.float32)
    )

    def flat(self) -> np.ndarray:
        """4x vec4 model rows + color + custom = 24 floats
        (matches the reference GPU layout)."""
        return np.concatenate(
            [np.asarray(self.model, np.float32).reshape(16),
             self.color, self.custom]
        )


@dataclasses.dataclass
class InstanceBatch:
    mesh_id: int
    material_id: int
    instances: List[InstanceData] = dataclasses.field(default_factory=list)
    bounds_min: np.ndarray = dataclasses.field(
        default_factory=lambda: np.full(3, np.inf, np.float32)
    )
    bounds_max: np.ndarray = dataclasses.field(
        default_factory=lambda: np.full(3, -np.inf, np.float32)
    )

    def add(self, instance: InstanceData) -> bool:
        if len(self.instances) >= MAX_INSTANCES_PER_BATCH:
            return False
        self.instances.append(instance)
        pos = np.asarray(instance.model, np.float32)[:3, 3]
        self.bounds_min = np.minimum(self.bounds_min, pos)
        self.bounds_max = np.maximum(self.bounds_max, pos)
        return True

    def packed(self) -> np.ndarray:
        """(N, 24) float32 instance table."""
        if not self.instances:
            return np.zeros((0, 24), np.float32)
        return np.stack([i.flat() for i in self.instances])


@dataclasses.dataclass
class InstancingStats:
    """instancing.rs:158-190."""

    total_instances: int = 0
    batch_count: int = 0
    draw_calls_saved: int = 0


class InstancingManager:
    def __init__(self):
        self.batches: Dict[Tuple[int, int], InstanceBatch] = {}

    def add_instance(
        self, mesh_id: int, material_id: int, instance: InstanceData
    ) -> bool:
        key = (mesh_id, material_id)
        batch = self.batches.get(key)
        if batch is None:
            batch = InstanceBatch(mesh_id=mesh_id, material_id=material_id)
            self.batches[key] = batch
        return batch.add(instance)

    def clear(self) -> None:
        self.batches.clear()

    def stats(self) -> InstancingStats:
        total = sum(len(b.instances) for b in self.batches.values())
        return InstancingStats(
            total_instances=total,
            batch_count=len(self.batches),
            draw_calls_saved=max(total - len(self.batches), 0),
        )

    def to_draw_items(self, renderer) -> None:
        """Submit all batches through the renderer's command path."""
        from .renderer import RenderCommand

        commands = []
        for (mesh_id, material_id), batch in self.batches.items():
            for inst in batch.instances:
                commands.append(
                    RenderCommand(
                        mesh=mesh_id,
                        transform=inst.model,
                        material=material_id,
                    )
                )
        renderer.submit_render_commands(commands)
