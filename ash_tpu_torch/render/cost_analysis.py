"""Operation and byte counts of one frame (the port's counterpart of the
reference's `Renderer.frame_cost_analysis`, which sums XLA's static cost
analysis over the programs a frame dispatches).

`FrameCost` is a TorchDispatchMode that sees every aten op the frame runs:

- bytes: each op's tensor operands plus its results, the same upper-bound
  meaning as XLA's fusion-level "bytes accessed" (an op's inputs count
  again where another op wrote them);
- flops: torch.utils.flop_counter's formula for the ops it knows (matrix
  products, convolutions), and one per output element for a pointwise op;
- programs: the `pass_*` scopes that ran, in order of first entry.

The raster, texture, light, shadow, bloom, G-buffer and shading kernels
launch through ctypes, which the dispatcher does not see:
`ops/raster_cuda.rasterize`, `ops/texture_cuda`, `ops/lights_cuda`,
`ops/shadow_cuda`, `ops/bloom_cuda`, `ops/gbuffer_cuda` and
`ops/shade_cuda` report each
launch's inputs and outputs, counted as bytes
(their work is not an aten op, so it adds no flops). On the CPU the plain
versions' aten ops are counted instead.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..ops import (bloom_cuda, gbuffer_cuda, lights_cuda, raster_cuda,
                   shade_cuda, shadow_cuda, texture_cuda)

_ENTER = torch.ops.profiler._record_function_enter_new.default


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


class FrameCost(TorchDispatchMode):
    """Counts while active; read `result()` after."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.programs: List[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is _ENTER and args[0].startswith("pass_"):
            if args[0] not in self.programs:
                self.programs.append(args[0])
        out = func(*args, **kwargs)
        self.bytes_accessed += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        elif torch.Tag.pointwise in func.tags:
            self.flops += sum(t.numel() for t in tree_flatten(out)[0]
                              if isinstance(t, torch.Tensor))
        return out

    def _kernel_launch(self, inputs, outputs) -> None:
        self.bytes_accessed += _tensor_bytes(inputs) + _tensor_bytes(outputs)

    def __enter__(self):
        raster_cuda.rasterize.observers.append(self._kernel_launch)
        texture_cuda.observers.append(self._kernel_launch)
        lights_cuda.observers.append(self._kernel_launch)
        shadow_cuda.observers.append(self._kernel_launch)
        bloom_cuda.observers.append(self._kernel_launch)
        gbuffer_cuda.observers.append(self._kernel_launch)
        shade_cuda.observers.append(self._kernel_launch)
        return super().__enter__()

    def __exit__(self, *exc):
        raster_cuda.rasterize.observers.remove(self._kernel_launch)
        texture_cuda.observers.remove(self._kernel_launch)
        lights_cuda.observers.remove(self._kernel_launch)
        shadow_cuda.observers.remove(self._kernel_launch)
        bloom_cuda.observers.remove(self._kernel_launch)
        gbuffer_cuda.observers.remove(self._kernel_launch)
        shade_cuda.observers.remove(self._kernel_launch)
        return super().__exit__(*exc)

    def result(self) -> Dict:
        return {"flops": float(self.flops),
                "bytes_accessed": float(self.bytes_accessed),
                "programs": list(self.programs)}
