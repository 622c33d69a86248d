"""The Forward+ light loop's entry point: the CUDA kernel of csrc/lights.cu on
the card.

Replaces the eager, slot-by-slot loop on the lit frames' path (the port of
the light loop in ash_tpu/ops/shade.py:shade_pbr, a jax.numpy
`lax.fori_loop`; not a TPU kernel). `add_lights` takes shade_pbr's light
loop: every covered element walks its tile's culled light list and adds
each light's contribution to `lo`, in slot order.

- CUDA tensors launch the hand-written kernel (built by ops/_build.py at
  first use) or raise; nothing falls back. Each tile walks its own count,
  so no trip count is taken from the device (no host sync).
- CPU tensors run the plain version, ops/light_loop.py's light_slots, for
  min(the largest tile count, K) slots: one host sync, as before the
  kernel, and on any float dtypes, as before (`check_inputs` says what the
  card takes, and runs on CPU tensors too).

Either way `lo` is updated in place and returned. Elements outside the
G-buffer's mask keep their `lo` on the card, and every caller discards
them. Slots past a tile's count must hold -1, as ops/light_cull.py makes
them: the plain loop adds nothing there, and the kernel does not walk them.

`launches["loop"]` counts the kernel's launches (and nothing else), so a
run can show that its frames went through the kernel. Each callable in
`observers` is handed every launch's input and output tensors
(render/cost_analysis.py counts their bytes).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, light_loop

_P, _I = ctypes.c_void_p, ctypes.c_int

# The shading dtypes the kernel has an instantiation for.
DTYPES = (torch.float32, torch.bfloat16)
# Floats in a packed GpuLight row (render/features/light_culling.py).
LIGHT_ROW = 16

launches = {"loop": 0}
observers = []


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("lights")
    lib.ash_light_loop.argtypes = ([_P, _I, _P, _I, _I, _I, _I, _P, _I, _P, _P]
                                   + [_P] * 10 + [_I] * 3 + [_P])
    lib.ash_light_loop.restype = _I
    lib.ash_light_probe_bf16.argtypes = [_P, _I, _P, _P]
    lib.ash_light_probe_bf16.restype = _I
    return lib


def probe_bf16(x: torch.Tensor) -> torch.Tensor:
    """The bf16 of each element of a contiguous f32 CUDA tensor as the
    kernel rounds it (the tests' probe of the conversion)."""
    if x.device.type != "cuda" or x.dtype != torch.float32 or \
            not x.is_contiguous() or x.numel() == 0:
        raise ValueError("light probe: a non-empty contiguous f32 CUDA "
                         "tensor")
    out = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    err = _build.launch(x.device, _library().ash_light_probe_bf16,
                        x.data_ptr(), x.numel(), out.data_ptr())
    if err != 0:
        raise RuntimeError(f"light probe launch failed: CUDA error {err}")
    return out


def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"light kernel: {name} is not a tensor")
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"light kernel: {name} is {t.dtype} {tuple(t.shape)} on "
            f"{t.device}; expected {dtype} {shape} on {device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"light kernel: {name} must be contiguous")


def check_inputs(lo, mask, world, normal, view_dir, base_color, metallic,
                 roughness, f0, ndotv, lights, tile_indices, tile_counts,
                 light_tile_size, pixel_xy=None) -> None:
    """Raise ValueError unless the inputs are what ash_light_loop takes:
    one device; the elements' (H, W) grid with bool `mask` and f32 `world`
    (H, W, 3); `lo`, `normal`, `view_dir`, `base_color` and `f0` (H, W, 3)
    and `metallic`, `roughness` and `ndotv` (H, W) in one shading dtype (f32
    or bf16); f32 `lights` (L, 16); int32 `tile_indices` (ty, tx, K), whose
    last dimension is contiguous (a view cut to K slots of a longer list is
    taken); int32 `tile_counts` (ty, tx) or None; a positive int
    `light_tile_size`; `pixel_xy` None or two int32 (H, W); every other
    tensor contiguous. Both devices check, so a CPU run shows what the card
    would refuse."""
    device = world.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"light kernel: unsupported device {device}")
    if world.dim() != 3:
        raise ValueError(f"light kernel: world is {tuple(world.shape)}; "
                         "expected (H, W, 3)")
    grid = tuple(world.shape[:2])
    dtype = lo.dtype
    if dtype not in DTYPES:
        raise ValueError(f"light kernel: shading dtype {dtype} is not one of "
                         f"{DTYPES}")
    _check("mask", mask, torch.bool, grid, device)
    _check("world", world, torch.float32, grid + (3,), device)
    for name, t in (("lo", lo), ("normal", normal), ("view_dir", view_dir),
                    ("base_color", base_color), ("f0", f0)):
        _check(name, t, dtype, grid + (3,), device)
    for name, t in (("metallic", metallic), ("roughness", roughness),
                    ("ndotv", ndotv)):
        _check(name, t, dtype, grid, device)
    if not isinstance(lights, torch.Tensor) or lights.dim() != 2:
        raise ValueError("light kernel: lights must be (L, 16)")
    _check("lights", lights, torch.float32, (lights.shape[0], LIGHT_ROW),
           device)
    if not isinstance(tile_indices, torch.Tensor) or tile_indices.dim() != 3:
        raise ValueError("light kernel: tile_indices must be (ty, tx, K)")
    ty, tx, k = tile_indices.shape
    if (tile_indices.device != device or tile_indices.dtype != torch.int32
            or ty == 0 or tx == 0):
        raise ValueError(
            f"light kernel: tile_indices is {tile_indices.dtype} "
            f"{tuple(tile_indices.shape)} on {tile_indices.device}; expected "
            f"int32 (ty > 0, tx > 0, K) on {device}")
    slot_stride = tile_indices.stride(1)
    if (tile_indices.stride(2) != 1 and k > 1) or slot_stride < k or \
            tile_indices.stride(0) != tx * slot_stride:
        raise ValueError("light kernel: tile_indices must be a contiguous "
                         "list, or one cut to its first K slots")
    if tile_counts is not None:
        _check("tile_counts", tile_counts, torch.int32, (ty, tx), device)
    if (not isinstance(light_tile_size, int)
            or not 0 < light_tile_size < 2**31):
        raise ValueError(f"light kernel: light_tile_size {light_tile_size!r} "
                         "is not a positive 32-bit int")
    if pixel_xy is not None:
        if len(pixel_xy) != 2:
            raise ValueError("light kernel: pixel_xy must be (px, py)")
        for name, t in zip(("pixel_xy[0]", "pixel_xy[1]"), pixel_xy):
            _check(name, t, torch.int32, grid, device)
    if (mask.numel() * 3 >= 2**31 or ty * tx * slot_stride >= 2**31
            or lights.shape[0] >= 2**31):
        raise ValueError("light kernel: 32-bit index range exceeded")


def launcher(lo, mask, world, normal, view_dir, base_color, metallic,
             roughness, f0, ndotv, lights, tile_indices, tile_counts,
             light_tile_size, pixel_xy=None):
    """Check the inputs on a CUDA device and return (launch, lo): `launch()`
    runs ash_light_loop once on the current stream, adding the lights into
    `lo` in place, counts nothing, and returns whether it launched (not for
    an empty grid, list or light table). The entry point counts; this split
    lets a timing loop replay the bare launch."""
    device = world.device
    if device.type != "cuda":
        raise ValueError(f"light kernel: unsupported device {device}")
    check_inputs(lo, mask, world, normal, view_dir, base_color, metallic,
                 roughness, f0, ndotv, lights, tile_indices, tile_counts,
                 light_tile_size, pixel_xy)
    rows, cols = mask.shape
    ty, tx, k = tile_indices.shape
    px, py = (None, None) if pixel_xy is None else pixel_xy
    args = (lights.data_ptr(), lights.shape[0], tile_indices.data_ptr(), ty,
            tx, tile_indices.stride(1), k,
            None if tile_counts is None else tile_counts.data_ptr(),
            light_tile_size,
            None if px is None else px.data_ptr(),
            None if py is None else py.data_ptr(),
            mask.data_ptr(), world.data_ptr(), normal.data_ptr(),
            view_dir.data_ptr(), base_color.data_ptr(), metallic.data_ptr(),
            roughness.data_ptr(), f0.data_ptr(), ndotv.data_ptr(),
            lo.data_ptr(), rows, cols, int(lo.dtype == torch.bfloat16))
    entry = _library().ash_light_loop

    def launch() -> bool:
        if rows == 0 or cols == 0 or k == 0 or lights.shape[0] == 0:
            return False
        err = _build.launch(device, entry, *args)
        if err != 0:
            raise RuntimeError(f"light kernel launch failed: CUDA error {err}")
        return True

    return launch, lo


def plain(lo, mask, world, normal, view_dir, base_color, metallic, roughness,
          f0, ndotv, lights, tile_indices, tile_counts, light_tile_size,
          pixel_xy=None) -> torch.Tensor:
    """add_lights' plain version, on either device: light_loop.light_slots
    for min(the largest tile count, K) slots (a host sync), or all K without
    counts, over every element, written into `lo`. The CPU entry runs it;
    a card run patches it in to hold the kernel's frames to it."""
    k = tile_indices.shape[-1]
    n_iter = k if tile_counts is None else min(int(tile_counts.max()), k)
    # The shading dtype is the BRDF inputs'; on the CPU `lo` may be wider
    # (f64 uniforms make it so).
    dtype = normal.dtype

    def cast(x):
        return x if dtype == torch.float32 else x.to(dtype)

    return lo.copy_(light_loop.light_slots(
        lo, world, lights, tile_indices, n_iter, light_tile_size, normal,
        view_dir, base_color, metallic, roughness, f0, ndotv, cast, pixel_xy))


def add_lights(lo, mask, world, normal, view_dir, base_color, metallic,
               roughness, f0, ndotv, lights, tile_indices, tile_counts,
               light_tile_size: int, pixel_xy=None) -> torch.Tensor:
    """Add the Forward+ lights of each element's tile to `lo` in place and
    return it; see ops/light_loop.py:light_slots. With `tile_counts` a tile
    walks its first min(count, K) slots, without it all K. On the card one
    launch walks every covered element's slots, which gives the plain
    version's bits there (±0 aside: the plain loop adds +0 for an empty
    slot)."""
    if world.device.type == "cpu":
        return plain(lo, mask, world, normal, view_dir, base_color, metallic,
                     roughness, f0, ndotv, lights, tile_indices, tile_counts,
                     light_tile_size, pixel_xy)
    launch, lo = launcher(lo, mask, world, normal, view_dir, base_color,
                          metallic, roughness, f0, ndotv, lights,
                          tile_indices, tile_counts, light_tile_size,
                          pixel_xy)
    if launch():
        launches["loop"] += 1
        inputs = (mask, world, normal, view_dir, base_color, metallic,
                  roughness, f0, ndotv, lo, lights, tile_indices,
                  tile_counts, *(pixel_xy or ()))
        for observe in observers:
            observe(tuple(t for t in inputs if t is not None), (lo,))
    return lo
