"""The frame and the shadow pass as CUDA graphs: the port's counterpart of
the reference's compiled programs (ash_tpu/render/frame.py
`compiled_frame`, `compiled_shadow`), which the reference's renderer runs
once per FrameConfig.

A `Graphed` runs one step function under a key: the caller's, the set of
things that shape the step's work (render/renderer.py builds them: the
FrameConfig, the scene, material, pool, light and environment versions,
the post chain's values, TAA's switches), together with the step's
argument structure and the memory each tensor argument reads (its
address, shape, strides, dtype and device). A caller whose step should
replay passes the same buffers every call and writes each call's values
into them in place (the renderer's constants buffer, its models region,
its TAA history, previous depth and shadow map); a tensor in other memory
makes a new key. On a CUDA device, unless turned off (`enabled`, true by
default, which Renderer.set_cuda_graphs(False) clears):

- the key's first call runs the step eagerly: it loads the kernels'
  libraries, fills the shared device constants (device.constant) and warms
  the allocator (a call inside `eager()` warms the key as well);
- the second captures the step in a `torch.cuda.CUDAGraph`, in a private
  memory pool, and replays it;
- every later call replays it. The captured arguments are held, so their
  memory stays theirs while the graph lives.

A new key frees the old key's graph first, so a `Graphed` holds at most
one. A replay returns what the step returned, with every tensor of graph
memory cloned out, so a frame's outputs stay valid after the next replay;
an argument the step returns comes back as itself. A capture that fails
raises; nothing runs eagerly in its place.

Graphs are on by default, as the reference always runs its compiled frame
and shadow pass. A profile that reads the eager frame's `pass_*` scopes or
its kernel observers, which a replay does not enter, runs the frame inside
`eager(...)` (the benchmark's traces, benchmark/trace.py, read a replay's
kernels by name instead).

The kernels' launch counters (ops/raster_cuda.rasterize.launches and the
`launches` dicts of the other ops/*_cuda.py modules) count their wrappers'
calls: an eager launch, or a launch a capture records, once. A replay
makes no call and adds nothing; its launches are read from a profiler
trace by kernel name (chip_smoke.py phase 15).

Eager calls are counted by reason in `stats`: "first" (a key's warm-up),
"cpu" (a CPU frame: the step runs directly each frame, on the same static
buffers the card captures), "graphs off" (turned off), "observers" (a
kernel observer is registered: it is handed every launch's tensors, which
a replay makes no call to hand), and whatever a caller names with
`eager(...)` (the chunked frame, the bands and farms of parallel/, the
cost analysis, the pass profiler, profile_frame.py and host_profile.py,
which read the eager frame's `pass_*` scopes or Python calls) or
`count_eager(...)`.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Callable, Dict, List, Optional

import torch
from torch.utils import _pytree as pytree

# Per step name ("frame", "shadow", "models"): eager calls by reason,
# captures and replays.
stats: Dict[str, dict] = {}

_eager_reasons: List[str] = []
_sync_checked = [False]


def _stats(name: str) -> dict:
    if name not in stats:
        stats[name] = {"eager": collections.Counter(), "captures": 0,
                       "replays": 0}
    return stats[name]


def reset_stats() -> None:
    stats.clear()


def count_eager(reason: str, name: str = "frame") -> None:
    """Count one eager call of step `name` (a path that never captures)."""
    _stats(name)["eager"][reason] += 1


@contextlib.contextmanager
def eager(reason: str = "asked"):
    """Run every step eagerly inside the block, counted under `reason`;
    captured graphs are kept for later calls."""
    _eager_reasons.append(reason)
    try:
        yield
    finally:
        _eager_reasons.pop()


@contextlib.contextmanager
def no_host_sync():
    """Inside the block, a CUDA step that runs eagerly after its key's
    first call runs under torch.cuda.set_sync_debug_mode("error"): any host
    sync it makes (an item(), a pageable host-to-device copy) raises, as it
    would in a capture."""
    _sync_checked[0] = True
    try:
        yield
    finally:
        _sync_checked[0] = False


def _counter_modules():
    from ..ops import (bloom_cuda, gbuffer_cuda, lights_cuda, shade_cuda,
                       shadow_cuda, texture_cuda)
    return (bloom_cuda, gbuffer_cuda, lights_cuda, shade_cuda, shadow_cuda,
            texture_cuda)


def counters() -> Dict[tuple, int]:
    """Every kernel launch counter: {(module, key): count}."""
    from ..ops import raster_cuda

    out = {("raster_cuda", "launches"): raster_cuda.rasterize.launches,
           ("raster_cuda", "layer_launches"):
               raster_cuda.rasterize.layer_launches}
    for mod in _counter_modules():
        name = mod.__name__.rsplit(".", 1)[1]
        out.update({(name, k): v for k, v in mod.launches.items()})
    return out


def _observed() -> bool:
    """Whether any kernel observer is registered."""
    from ..ops import raster_cuda

    return bool(raster_cuda.rasterize.observers) or any(
        mod.observers for mod in _counter_modules())


def _memory(t: torch.Tensor) -> tuple:
    """What a captured launch reads of t: its memory and its layout."""
    return (t.data_ptr(), t.shape, t.stride(), t.dtype, t.device)


class Graphed:
    """One step function as a CUDA graph under a key (see the module's
    docstring); `name` keys `stats`."""

    def __init__(self, name: str):
        self.name = name
        self.enabled = True
        self.reset()

    def reset(self) -> None:
        """Free the graph, its pool's hold and its captured arguments."""
        self.key = None
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._static: List[torch.Tensor] = []
        self._out = None

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def __call__(self, key, fn: Callable, *args):
        """fn(*args), eagerly, captured or replayed as the module's
        docstring says. `key` must cover every non-tensor argument, and
        every tensor value, that shapes fn's work."""
        leaves, spec = pytree.tree_flatten(args)
        tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
        key = (key, spec, tuple(map(_memory, tensors)))
        first = key != self.key
        if first:
            self.reset()
            self.key = key
        st = _stats(self.name)
        reason = self._eager_reason(tensors, first)
        if reason is not None:
            st["eager"][reason] += 1
            return self._eager(fn, args, checked=not first)
        if self._graph is None:
            self._capture(fn, args, tensors)
        self._graph.replay()
        st["replays"] += 1
        return self._copy_out()

    def _eager_reason(self, tensors, first: bool) -> Optional[str]:
        """Why this call runs eagerly, or None to capture or replay."""
        if _eager_reasons:
            return _eager_reasons[-1]
        if not any(t.is_cuda for t in tensors):
            return "cpu"
        if not self.enabled:
            return "graphs off"
        if _observed():
            return "observers"
        return "first" if first else None

    def _eager(self, fn, args, checked: bool):
        """fn(*args); under no_host_sync, and `checked` (the key's first
        call, which fills the shared constants, is not), in the sync debug
        mode's "error"."""
        if not (checked and _sync_checked[0] and torch.cuda.is_initialized()):
            return fn(*args)
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    def _capture(self, fn, args, tensors) -> None:
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                out = fn(*args)
        except Exception as e:
            self.reset()
            raise RuntimeError(
                f"CUDA graph capture of the {self.name} step failed: "
                f"{type(e).__name__}: {e}") from e
        self._graph, self._static, self._out = graph, tensors, out
        _stats(self.name)["captures"] += 1

    def _copy_out(self):
        args = {id(s) for s in self._static}
        clones: dict = {}

        def out(t):
            if not isinstance(t, torch.Tensor) or id(t) in args:
                return t
            if id(t) not in clones:
                clones[id(t)] = t.clone()
            return clones[id(t)]

        return pytree.tree_map(out, self._out)


def counter_delta(after: Dict[tuple, int],
                  before: Dict[tuple, int]) -> Dict[tuple, int]:
    """The counters that moved between two counters() readings, by how
    much."""
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}
