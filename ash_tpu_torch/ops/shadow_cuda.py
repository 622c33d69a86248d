"""The directional light's shadow term: the CUDA kernel of csrc/shadow.cu on
the card.

Replaces the eager 16-tap PCF of ops/shadow.py on the shaded frames' path
(the port of ash_tpu/ops/shadow.py's shadow_pcf16 and shadow_pcf16_csm,
jax.numpy that XLA fuses; not a TPU kernel), about 300 small kernels a
shade call for the single map and 740 for three blended cascades. Two
entries, one launch a call:

- `shadow_pcf16(shadow_map, light_space_matrix, world, normal, light_dir)`:
  the single map, the light-space projection (geometry.transform_points)
  folded into the launch;
- `shadow_pcf16_csm(cascade_maps, cascade_matrices, split_distances, view,
  world, normal, light_dir, blend_size)`: the cascades.

- CUDA tensors launch the hand-written kernel (built by ops/_build.py at
  first use) or raise; nothing falls back. The matrices, the splits and
  the view are read on the device (no host sync).
- CPU tensors run the plain version (`plain`, `plain_csm`), on any float
  dtype, as before (`check_inputs` and `check_inputs_csm` say what the
  card takes, and run on CPU tensors too).

Either way the result is the f32 shadow fraction, shaped like `world`
without its last axis. `light_dir` is one (3,) direction, expanded over the
elements with stride 0 as shade_pbr hands it, or one direction an element.

`launches["pcf"]` and `launches["csm"]` count the kernel's launches (and
nothing else), so a run can show that its frames went through it. Each
callable in `observers` is handed every launch's input and output tensors
(render/cost_analysis.py counts their bytes). `probe_path` runs the kernel
on either of its two tap paths with its own counts of the lookups read as
one window, for the tests and chip_smoke.py.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from . import _build, shadow
from .geometry import transform_points

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# The normal's (and light direction's) dtypes the kernel has an
# instantiation for.
DTYPES = (torch.float32, torch.bfloat16)
MAX_CASCADES = 4

launches = {"pcf": 0, "csm": 0}
observers = []


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("shadow")
    pcf16 = [_P, _I, _I, _I] + [_P] * 6 + [_I] * 4 + [_F] * 3 + [_P]
    lib.ash_shadow_pcf16.argtypes = pcf16 + [_P]
    lib.ash_shadow_pcf16.restype = _I
    lib.ash_shadow_pcf16_probe.argtypes = pcf16 + [
        _I, _P, ctypes.POINTER(ctypes.c_int), _P]
    lib.ash_shadow_pcf16_probe.restype = _I
    lib.ash_shadow_probe_floor.argtypes = [_P, _I, _P, _P]
    lib.ash_shadow_probe_floor.restype = _I
    return lib


def probe_floor(x: torch.Tensor) -> torch.Tensor:
    """floor(x) as int64 for each element of a contiguous f32 CUDA tensor, as
    the kernel converts a tap's coordinate (the tests' probe of
    `.to(torch.int64)`)."""
    if x.device.type != "cuda" or x.dtype != torch.float32 or \
            not x.is_contiguous() or x.numel() == 0:
        raise ValueError("shadow probe: a non-empty contiguous f32 CUDA "
                         "tensor")
    out = torch.empty(x.shape, dtype=torch.int64, device=x.device)
    err = _build.launch(x.device, _library().ash_shadow_probe_floor,
                        x.data_ptr(), x.numel(), out.data_ptr())
    if err != 0:
        raise RuntimeError(f"shadow probe launch failed: CUDA error {err}")
    return out


def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"shadow kernel: {name} is not a tensor")
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"shadow kernel: {name} is {t.dtype} {tuple(t.shape)} on "
            f"{t.device}; expected {dtype} {shape} on {device}")
    if not t.is_contiguous():
        raise ValueError(f"shadow kernel: {name} must be contiguous")


def light_dir_stride(light_dir: torch.Tensor, world: torch.Tensor) -> int:
    """The elements' stride in `light_dir`: 0 for one (3,) direction (or
    one expanded over the elements with stride 0), 3 for a contiguous
    direction an element. Anything else raises."""
    if tuple(light_dir.shape) == (3,) and light_dir.stride(0) == 1:
        return 0
    if tuple(light_dir.shape) == tuple(world.shape) and \
            light_dir.stride(-1) == 1:
        if all(s == 0 for s in light_dir.stride()[:-1]):
            return 0
        if light_dir.is_contiguous():
            return 3
    raise ValueError(
        f"shadow kernel: light_dir is {tuple(light_dir.shape)} with strides "
        f"{light_dir.stride()}; expected (3,), or world's shape "
        f"{tuple(world.shape)} contiguous or expanded from (3,)")


def _check_elements(maps, world, normal, light_dir) -> int:
    """What both entries check: the maps' dtype, layout and index range,
    and the elements' world, normal and light_dir. -> light_dir_stride."""
    if not isinstance(world, torch.Tensor):
        raise ValueError("shadow kernel: world is not a tensor")
    device = world.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"shadow kernel: unsupported device {device}")
    if world.dim() < 1 or world.shape[-1] != 3:
        raise ValueError(f"shadow kernel: world is {tuple(world.shape)}; "
                         "expected (..., 3)")
    _check("world", world, torch.float32, tuple(world.shape), device)
    if not isinstance(normal, torch.Tensor) or normal.dtype not in DTYPES:
        raise ValueError(f"shadow kernel: normal's dtype is not one of "
                         f"{DTYPES}")
    _check("normal", normal, normal.dtype, tuple(world.shape), device)
    if not isinstance(light_dir, torch.Tensor) or \
            light_dir.device != device or light_dir.dtype != normal.dtype:
        raise ValueError("shadow kernel: light_dir must be a tensor of the "
                         f"normal's dtype {normal.dtype} on {device}")
    stride = light_dir_stride(light_dir, world)
    _check("maps", maps, torch.float32, tuple(maps.shape), device)
    if maps.numel() == 0:
        raise ValueError("shadow kernel: the shadow map is empty")
    if maps.numel() >= 2**31 or world.numel() >= 2**31:
        raise ValueError("shadow kernel: 32-bit index range exceeded")
    return stride


def check_inputs(shadow_map, light_space_matrix, world, normal,
                 light_dir) -> int:
    """Raise ValueError unless shadow_pcf16's inputs are what the kernel
    takes: one device; a contiguous f32 (S_y, S_x) `shadow_map` and (4, 4)
    `light_space_matrix`; contiguous f32 `world` (..., 3); `normal` of
    world's shape in f32 or bf16, contiguous; `light_dir` of the normal's
    dtype, (3,) or world's shape (contiguous, or expanded from (3,) with
    stride 0); fewer than 2^31 texels and position floats. Both devices
    check, so a CPU run shows what the card would refuse. -> the elements'
    stride in light_dir (light_dir_stride)."""
    if not isinstance(shadow_map, torch.Tensor) or shadow_map.dim() != 2:
        raise ValueError("shadow kernel: shadow_map must be (S_y, S_x)")
    stride = _check_elements(shadow_map, world, normal, light_dir)
    _check("light_space_matrix", light_space_matrix, torch.float32, (4, 4),
           world.device)
    return stride


def check_inputs_csm(cascade_maps, cascade_matrices, split_distances, view,
                     world, normal, light_dir, blend_size=0.0) -> int:
    """Raise ValueError unless shadow_pcf16_csm's inputs are what the kernel
    takes: as check_inputs, with a contiguous f32 (C, S_y, S_x)
    `cascade_maps` for C in 1..4, f32 `cascade_matrices` (C, 4, 4), f32
    `split_distances` (K,) with K >= C and f32 `view` (4, 4), contiguous;
    `blend_size` a finite float >= 0. -> light_dir_stride."""
    if not isinstance(cascade_maps, torch.Tensor) or cascade_maps.dim() != 3:
        raise ValueError("shadow kernel: cascade_maps must be (C, S_y, S_x)")
    c = cascade_maps.shape[0]
    if not 1 <= c <= MAX_CASCADES:
        raise ValueError(f"shadow kernel: {c} cascades; the kernel takes 1 "
                         f"to {MAX_CASCADES}")
    stride = _check_elements(cascade_maps, world, normal, light_dir)
    device = world.device
    _check("cascade_matrices", cascade_matrices, torch.float32, (c, 4, 4),
           device)
    if not isinstance(split_distances, torch.Tensor) or \
            split_distances.dim() != 1 or split_distances.shape[0] < c:
        raise ValueError(f"shadow kernel: split_distances must be (K,) with "
                         f"K >= {c}")
    _check("split_distances", split_distances, torch.float32,
           tuple(split_distances.shape), device)
    _check("view", view, torch.float32, (4, 4), device)
    if (isinstance(blend_size, bool)
            or not isinstance(blend_size, (int, float))
            or not math.isfinite(blend_size) or blend_size < 0):
        raise ValueError(f"shadow kernel: blend_size {blend_size!r} is not a "
                         "finite float >= 0")
    return stride


def _arguments(maps, mats, splits, view, world, normal, light_dir,
               blend_size, stride):
    """(the C entry's arguments but its stream, out, elements) over (C,
    S_y, S_x) maps, `stride` the elements' in light_dir."""
    device = world.device
    if device.type != "cuda":
        raise ValueError(f"shadow kernel: unsupported device {device}")
    c, rows, cols = maps.shape
    n = world.numel() // 3
    out = torch.empty(world.shape[:-1], dtype=torch.float32, device=device)
    blend = blend_size > 0.0 and c > 1
    # The Python floats of the plain version, rounded to f32 as PyTorch
    # rounds a CPU scalar operand.
    args = (maps.data_ptr(), c, rows, cols, mats.data_ptr(),
            None if splits is None else splits.data_ptr(),
            None if view is None else view.data_ptr(), world.data_ptr(),
            normal.data_ptr(), light_dir.data_ptr(), stride, n,
            int(normal.dtype == torch.bfloat16), int(blend),
            float(np.float32(1.0 / rows)), float(np.float32(blend_size)),
            float(np.float32(1.0 - blend_size)), out.data_ptr())
    return args, out, n


def _launcher(maps, mats, splits, view, world, normal, light_dir,
              blend_size, stride):
    """(launch, out) over (C, S_y, S_x) maps, `stride` the elements' in
    light_dir; see launcher."""
    args, out, n = _arguments(maps, mats, splits, view, world, normal,
                              light_dir, blend_size, stride)
    device, entry = world.device, _library().ash_shadow_pcf16

    def launch() -> bool:
        if n == 0:
            return False
        err = _build.launch(device, entry, *args)
        if err != 0:
            raise RuntimeError(
                f"shadow kernel launch failed: CUDA error {err}")
        return True

    return launch, out


def launcher(shadow_map, light_space_matrix, world, normal, light_dir):
    """Check shadow_pcf16's inputs on a CUDA device and return (launch,
    out): `launch()` runs ash_shadow_pcf16 once on the current stream,
    writing the shadow fraction into `out`, counts nothing, and returns
    whether it launched (not for an empty element grid). The entry point
    counts; this split lets a timing loop replay the bare launch."""
    stride = check_inputs(shadow_map, light_space_matrix, world, normal,
                          light_dir)
    return _launcher(shadow_map[None], light_space_matrix, None, None, world,
                     normal, light_dir, 0.0, stride)


def launcher_csm(cascade_maps, cascade_matrices, split_distances, view,
                 world, normal, light_dir, blend_size=0.0):
    """launcher for shadow_pcf16_csm's inputs."""
    stride = check_inputs_csm(cascade_maps, cascade_matrices,
                              split_distances, view, world, normal, light_dir,
                              blend_size)
    return _launcher(cascade_maps, cascade_matrices, split_distances, view,
                     world, normal, light_dir, blend_size, stride)


def probe_path(path: int, csm: bool, *args, blend_size: float = 0.0):
    """Run the kernel once through ash_shadow_pcf16_probe on the taps' path
    `path` at shadow_pcf16's arguments (`csm` false) or
    shadow_pcf16_csm's (true, with `blend_size`) -> (out, the path taken,
    the lookups that reached the taps, those read as one 4x4 window).
    `path` -1 takes the entries' own path (csrc/shadow.cu, windows_pay),
    0 the taps quad by quad, 1 the window path. The counts are the
    kernel's own, made on the window path: quad by quad they stay 0.
    Counts no launch; the tests and chip_smoke.py read it, no frame
    does."""
    if path not in (-1, 0, 1):
        raise ValueError(f"shadow probe: path {path!r} is not -1, 0 or 1")
    if csm:
        stride = check_inputs_csm(*args, blend_size)
        maps, mats, splits, view, world, normal, light_dir = args
    else:
        stride = check_inputs(*args)
        shadow_map, mats, world, normal, light_dir = args
        maps, splits, view, blend_size = shadow_map[None], None, None, 0.0
    c_args, out, n = _arguments(maps, mats, splits, view, world, normal,
                                light_dir, blend_size, stride)
    if n == 0:
        raise ValueError("shadow probe: no elements")
    counts = torch.zeros(2, dtype=torch.int64, device=world.device)
    taken = ctypes.c_int(-1)
    err = _build.launch(world.device, _library().ash_shadow_pcf16_probe,
                        *c_args, path, counts.data_ptr(), ctypes.byref(taken))
    if err != 0:
        raise RuntimeError(f"shadow probe launch failed: CUDA error {err}")
    reads, windows = counts.tolist()
    return out, taken.value, reads, windows


def plain(shadow_map, light_space_matrix, world, normal,
          light_dir) -> torch.Tensor:
    """shadow_pcf16's plain version, on either device: the light-space
    projection (geometry.transform_points), then ops/shadow.py's
    shadow_pcf16. The CPU entry runs it; a card run patches it in to hold
    the kernel's frames to it."""
    return shadow.shadow_pcf16(
        shadow_map, transform_points(light_space_matrix, world), normal,
        light_dir)


def plain_csm(cascade_maps, cascade_matrices, split_distances, view, world,
              normal, light_dir, blend_size=0.0) -> torch.Tensor:
    """shadow_pcf16_csm's plain version, ops/shadow.py's, on either
    device."""
    return shadow.shadow_pcf16_csm(cascade_maps, cascade_matrices,
                                   split_distances, view, world, normal,
                                   light_dir, blend_size=blend_size)


def _observe(inputs, out, light_dir):
    if not observers:
        return
    # The elements read one direction where light_dir is expanded.
    if light_dir_stride(light_dir, inputs[-2]) == 0:
        light_dir = light_dir.as_strided((3,), (light_dir.stride(-1),))
    for fn in observers:
        fn((*inputs, light_dir), (out,))


def shadow_pcf16(shadow_map, light_space_matrix, world, normal,
                 light_dir) -> torch.Tensor:
    """The fraction of the 16 PCF taps in shadow, 0..1, of each element
    against a single (S_y, S_x) map: ops/shadow.py's shadow_pcf16 of
    transform_points(light_space_matrix, world). On the card one launch,
    bit for bit the plain version."""
    if world.device.type == "cpu":
        return plain(shadow_map, light_space_matrix, world, normal, light_dir)
    launch, out = launcher(shadow_map, light_space_matrix, world, normal,
                           light_dir)
    if launch():
        launches["pcf"] += 1
        _observe((shadow_map, light_space_matrix, world, normal), out,
                 light_dir)
    return out


def shadow_pcf16_csm(cascade_maps, cascade_matrices, split_distances, view,
                     world, normal, light_dir,
                     blend_size: float = 0.0) -> torch.Tensor:
    """The cascaded 16-tap PCF: ops/shadow.py's shadow_pcf16_csm. On the
    card one launch, bit for bit the plain version."""
    if world.device.type == "cpu":
        return plain_csm(cascade_maps, cascade_matrices, split_distances,
                         view, world, normal, light_dir, blend_size)
    launch, out = launcher_csm(cascade_maps, cascade_matrices,
                               split_distances, view, world, normal,
                               light_dir, blend_size)
    if launch():
        launches["csm"] += 1
        _observe((cascade_maps, cascade_matrices, split_distances, view,
                  world, normal), out, light_dir)
    return out
