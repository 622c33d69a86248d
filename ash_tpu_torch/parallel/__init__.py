"""Rendering over several devices, from one process (port of
ash_tpu/parallel/).

Two axes, over a `Mesh` of torch devices (`render_mesh`):
- make_sharded_frame: screen-space bands of one frame, for latency;
- make_frame_parallel: one frame per device, for throughput (offline and
  animation rendering), and make_frame_parallel_banded, both at once over
  a 2D mesh.
A mesh may repeat a device: `render_mesh(devices=["cpu"] * 8)` runs the
eight-band path on the host, `["cuda:0"] * 4` on one card.
"""

from .frame_parallel import (
    batch_uniforms,
    make_frame_parallel,
    make_frame_parallel_banded,
)
from .sharded import Mesh, make_sharded_frame, render_mesh

__all__ = [
    "batch_uniforms",
    "make_frame_parallel",
    "make_frame_parallel_banded",
    "make_sharded_frame",
    "render_mesh",
]
