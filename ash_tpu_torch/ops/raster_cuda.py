"""The rasterizer's entry point: the CUDA kernels of csrc/raster.cu on the card.

Replaces ash_tpu/ops/raster_pallas.py:rasterize_pallas. Every raster of a
frame (the shadow pass, the main pass and the passes of iterated peeling)
calls `rasterize` here.

- CUDA tensors launch a hand-written kernel (built by ops/_build.py at first
  use) or raise; nothing falls back. layers=1 launches the one-layer kernel,
  layers=2..8 the K-layer depth peel. Every warp of the kernels rejects
  the candidates whose conservative pixel rectangle misses its pixels; a
  pre-pass kernel in the same C call computes the rectangles from the
  setup's edge rows exactly as ops/raster.py:candidate_rects does
  (`device_rects` runs it alone, to show that on a card).
- CPU tensors run the plain version, ops/raster.py:rasterize, which is the
  kernels' reference.

`rasterize.launches` counts launches of the one-layer kernel and
`rasterize.layer_launches` those of the K-layer kernel (and nothing else),
so a run can show which kernel its frames went through. Each callable in
`rasterize.observers` is handed every launch's input and output tensors
(render/cost_analysis.py counts their bytes).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build
from .binning import TileBins, grid_shape
from .geometry import TriangleSetup
from .raster import VisibilityBuffer
from .raster import rasterize as rasterize_plain

MAX_LAYERS = 8
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("raster")
    lib.ash_raster.argtypes = [_P] * 7 + [_I] * 7 + [_P]
    lib.ash_raster.restype = _I
    lib.ash_raster_layers.argtypes = [_P] * 8 + [_I] * 8 + [_P]
    lib.ash_raster_layers.restype = _I
    lib.ash_candidate_rects.argtypes = [_P] * 2 + [_I] * 4 + [_P]
    lib.ash_candidate_rects.restype = _I
    return lib


def _check(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"raster kernel: {name} is {t.dtype} {tuple(t.shape)} on "
            f"{t.device}; expected {dtype} {shape} on {device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"raster kernel: {name} must be contiguous")


def launcher(
    setup: TriangleSetup,
    bins: TileBins,
    height: int,
    width: int,
    tile_h: int,
    tile_w: int,
    y0: int = 0,
    layers: int = 1,
    depth_floor: Optional[torch.Tensor] = None,
):
    """Check the inputs of `rasterize` on a CUDA device, allocate the
    (layers, H, W) outputs and return (launch, depth, tri_id): `launch()`
    runs the kernel once on the current stream into those outputs and
    counts nothing. `rasterize` is the entry point; this split lets a
    timing loop (or a CUDA graph) replay the bare launch."""
    device = setup.edge.device
    if device.type != "cuda":
        raise ValueError(f"raster kernel: unsupported device {device}")
    ty, tx = grid_shape(height, width, tile_h, tile_w)
    t = setup.edge.shape[0]
    k = bins.tri_ids.shape[1]
    _check("setup.edge", setup.edge, torch.float32, (t, 3, 3), device)
    _check("setup.z_clip", setup.z_clip, torch.float32, (t, 3), device)
    _check("bins.tri_ids", bins.tri_ids, torch.int32, (ty * tx, k), device)
    _check("bins.counts", bins.counts, torch.int32, (ty * tx,), device)
    if depth_floor is not None:
        _check("depth_floor", depth_floor, torch.float32, (height, width), device)
    if layers * height * width >= 2**31 or t >= 2**31 // 9:
        raise ValueError("raster kernel: 32-bit index range exceeded")

    depth = torch.empty((layers, height, width), dtype=torch.float32, device=device)
    tri_id = torch.empty((layers, height, width), dtype=torch.int32, device=device)
    rects = torch.empty((t, 4), dtype=torch.int32, device=device)  # scratch
    lib = _library()
    ins = (setup.edge, setup.z_clip, rects, bins.tri_ids, bins.counts)
    dims = (t, height, width, tile_h, tile_w, k, int(y0))

    def launch():
        ptrs = [x.data_ptr() for x in ins]
        outs = (depth.data_ptr(), tri_id.data_ptr())
        if layers == 1:
            err = _build.launch(device, lib.ash_raster, *ptrs, *outs, *dims)
        else:
            floor = None if depth_floor is None else depth_floor.data_ptr()
            err = _build.launch(device, lib.ash_raster_layers, *ptrs, floor,
                                *outs, *dims, layers)
        if err != 0:
            raise RuntimeError(f"raster kernel launch failed: CUDA error {err}")

    return launch, depth, tri_id


def rasterize(
    setup: TriangleSetup,
    bins: TileBins,
    height: int,
    width: int,
    tile_h: int,
    tile_w: int,
    y0: int = 0,
    layers: int = 1,
    depth_floor: Optional[torch.Tensor] = None,
) -> VisibilityBuffer:
    """Visibility buffer of shape (height, width), with `layers` peel layers,
    for the band whose first global row is `y0`; `depth_floor` is
    band-local. See ops/raster.py:rasterize."""
    if not 1 <= layers <= MAX_LAYERS:
        raise ValueError(f"raster: layers {layers} outside [1, {MAX_LAYERS}]")
    if depth_floor is not None and layers < 2:
        raise ValueError("depth_floor needs layers >= 2")
    device = setup.edge.device
    if device.type == "cpu":
        return rasterize_plain(setup, bins, height, width, tile_h, tile_w, y0,
                               layers=layers, depth_floor=depth_floor)
    if device.type != "cuda":
        raise ValueError(f"raster: unsupported device {device}")
    launch, depth, tri_id = launcher(setup, bins, height, width, tile_h,
                                     tile_w, y0, layers, depth_floor)
    launch()
    if layers == 1:
        rasterize.launches += 1
    else:
        rasterize.layer_launches += 1
    for observe in rasterize.observers:
        observe((setup.edge, setup.z_clip, bins.tri_ids, bins.counts,
                 depth_floor), (depth, tri_id))
    return VisibilityBuffer.from_layers(depth, tri_id)


rasterize.launches = 0
rasterize.layer_launches = 0
rasterize.observers = []


def device_rects(setup: TriangleSetup, height: int, width: int,
                 y0: int = 0) -> torch.Tensor:
    """(T, 4) int32: the candidate rectangles as the kernels compute them
    (their device function, one thread per triangle), to hold against
    ops/raster.py:candidate_rects on a card. Not on the frame's path."""
    device = setup.edge.device
    t = setup.edge.shape[0]
    _check("setup.edge", setup.edge, torch.float32, (t, 3, 3), device)
    rects = torch.empty((t, 4), dtype=torch.int32, device=device)
    err = _build.launch(device, _library().ash_candidate_rects,
                        setup.edge.data_ptr(), rects.data_ptr(), t, height,
                        width, int(y0))
    if err != 0:
        raise RuntimeError(f"candidate rects launch failed: CUDA error {err}")
    return rects
