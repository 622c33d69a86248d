"""Texture sampling's entry points: the CUDA kernel of csrc/texture.cu on the
card.

Replaces the eager, tap-by-tap sampler on the textured frame's path (the
port of ash_tpu/ops/shade.py:_sample_map, jax.numpy over
ash_tpu/ops/texture_sample.py:sample_trilinear; not a TPU kernel). Every
texture sample of a frame goes through here: `sample_maps` takes shade_pbr's
five maps, footprints and anisotropic samples together, in one launch;
`sample_trilinear` takes the alpha test's sample (`resolve_alpha_test`) and
the blend's alpha (`pixel_alpha`).

- CUDA tensors launch the hand-written kernel (built by ops/_build.py at
  first use) or raise; nothing falls back. Each element runs its own tap
  count, so no trip count is taken from the device (no host sync).
- CPU tensors run the plain versions, ops/texture_sample.py's sample_maps
  and sample_trilinear, which are the kernel's reference.

Every caller passes the G-buffer's mask: elements where it is False are
written 0 on either device (the kernel skips them), and every caller
discards them.

`launches["maps"]` and `launches["trilinear"]` count the kernel's launches
through each entry (and nothing else), so a run can show that its frames
went through the kernel. Each callable in `observers` is handed every
launch's input and output tensors (render/cost_analysis.py counts their
bytes).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, texture_sample
from .texture_sample import TexturePool

_P, _I = ctypes.c_void_p, ctypes.c_int

# The maps a shade_pbr call samples: base colour, normal, metallic-roughness,
# occlusion, emissive.
MAPS = 5

launches = {"maps": 0, "trilinear": 0}
observers = []


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("texture")
    pool_args = [_P, _I, _P, _I, _I, _P, _P]
    lib.ash_sample_maps.argtypes = (pool_args + [_P] * 5 + [_I, _P]
                                    + [_I] * 2 + [_P])
    lib.ash_sample_maps.restype = _I
    lib.ash_sample_trilinear.argtypes = pool_args + [_P] * 5 + [_I] * 2 + [_P]
    lib.ash_sample_trilinear.restype = _I
    return lib


def _check(name, t, dtype, shape, device):
    if t is None:
        raise ValueError(f"texture kernel: {name} is missing")
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"texture kernel: {name} is {t.dtype} {tuple(t.shape)} on "
            f"{t.device}; expected {dtype} {shape} on {device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"texture kernel: {name} must be contiguous")


def _check_elements(pool: TexturePool, uv, mask, outputs: int):
    """Check the pool, `uv` and `mask` -> (device, the elements' shape S)."""
    device = uv.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"texture kernel: unsupported device {device}")
    shape = tuple(uv.shape[:-1])
    if not shape:
        raise ValueError("texture kernel: the elements need a dimension")
    n_tex, max_mips = pool.table.shape[0], pool.table.shape[1]
    _check("pool.texels", pool.texels, torch.bfloat16,
           (pool.texels.shape[0], 4), device)
    _check("pool.table", pool.table, torch.int32, (n_tex, max_mips, 3), device)
    _check("pool.levels", pool.levels, torch.int32, (n_tex,), device)
    if pool.min_level is not None:
        _check("pool.min_level", pool.min_level, torch.int32, (n_tex,), device)
    _check("uv", uv, torch.float32, shape + (2,), device)
    _check("mask", mask, torch.bool, shape, device)
    if (mask.numel() * outputs * 4 >= 2**31 or pool.texels.shape[0] >= 2**31
            or n_tex * max_mips * 3 >= 2**31):
        raise ValueError("texture kernel: 32-bit index range exceeded")
    return device, shape


def check_maps(pool: TexturePool, indices, uv, ddx, ddy, max_aniso,
               mask) -> None:
    """Raise ValueError unless the inputs are what ash_sample_maps takes:
    one device, the pool's dtypes and shapes, f32 `uv`, `ddx` and `ddy` of
    shape S + (2,) for the elements' shape S (one dimension or more), int32
    `indices` S + (5,), bool `mask` S, an int `max_aniso`, every tensor
    contiguous. Both devices check, so a CPU run shows what the card would
    refuse."""
    device, shape = _check_elements(pool, uv, mask, MAPS)
    _check("indices", indices, torch.int32, shape + (MAPS,), device)
    _check("ddx", ddx, torch.float32, shape + (2,), device)
    _check("ddy", ddy, torch.float32, shape + (2,), device)
    if not isinstance(max_aniso, int) or not -2**31 <= max_aniso < 2**31:
        raise ValueError(f"texture kernel: max_aniso {max_aniso!r} is not "
                         "a 32-bit int")


def check_trilinear(pool: TexturePool, index, uv, lod, mask) -> None:
    """Raise ValueError unless the inputs are what ash_sample_trilinear
    takes: as check_maps, with int32 `index` of shape S and f32 `lod` S or
    None."""
    device, shape = _check_elements(pool, uv, mask, 1)
    _check("index", index, torch.int32, shape, device)
    if lod is not None:
        _check("lod", lod, torch.float32, shape, device)


def _cuda_only(uv, pool):
    device = uv.device
    if device.type != "cuda":
        raise ValueError(f"texture kernel: unsupported device {device}")
    if pool.texels.data_ptr() % 8:
        raise ValueError("texture kernel: pool.texels must be 8-byte aligned")
    return device


def _pool_args(pool):
    return (pool.texels.data_ptr(), pool.texels.shape[0],
            pool.table.data_ptr(), pool.table.shape[0], pool.table.shape[1],
            pool.levels.data_ptr(),
            None if pool.min_level is None else pool.min_level.data_ptr())


def _grid(mask):
    cols = mask.shape[-1]
    return (mask.numel() // cols if cols else 0), cols


def _launch_fn(device, rows, entry, *args):
    def launch():
        if rows == 0:
            return
        err = _build.launch(device, entry, *args)
        if err != 0:
            raise RuntimeError(
                f"texture kernel launch failed: CUDA error {err}")

    return launch


def maps_launcher(pool: TexturePool, indices, uv, ddx, ddy, max_aniso, mask):
    """Check the inputs on a CUDA device, allocate the five (..., 4) outputs
    and return (launch, outs): `launch()` runs ash_sample_maps once on the
    current stream into `outs` and counts nothing. The entry points count;
    this split lets a timing loop replay the bare launch."""
    device = _cuda_only(uv, pool)
    check_maps(pool, indices, uv, ddx, ddy, max_aniso, mask)
    outs = tuple(torch.empty(tuple(mask.shape) + (4,), dtype=torch.float32,
                             device=device) for _ in range(MAPS))
    out_ptrs = (ctypes.c_void_p * MAPS)(*(o.data_ptr() for o in outs))
    rows, cols = _grid(mask)
    return _launch_fn(
        device, rows, _library().ash_sample_maps, *_pool_args(pool),
        indices.data_ptr(), uv.data_ptr(), ddx.data_ptr(), ddy.data_ptr(),
        mask.data_ptr(), max_aniso, out_ptrs, rows, cols), outs


def launcher(pool: TexturePool, index, uv, lod, mask):
    """As maps_launcher, for ash_sample_trilinear -> (launch, (..., 4))."""
    device = _cuda_only(uv, pool)
    check_trilinear(pool, index, uv, lod, mask)
    out = torch.empty(tuple(mask.shape) + (4,), dtype=torch.float32,
                      device=device)
    rows, cols = _grid(mask)
    return _launch_fn(
        device, rows, _library().ash_sample_trilinear, *_pool_args(pool),
        index.data_ptr(), uv.data_ptr(),
        None if lod is None else lod.data_ptr(), mask.data_ptr(),
        out.data_ptr(), rows, cols), out


def _run(entry, launch, outs, inputs):
    launch()
    if inputs[-1].numel():
        launches[entry] += 1
        for observe in observers:
            observe(inputs, outs)
    return outs


def sample_maps(pool: TexturePool, indices, uv, ddx, ddy, max_aniso: int,
                mask) -> torch.Tensor:
    """Sample shade_pbr's five maps (`indices` (..., 5)) over their
    footprints where `mask` holds, 0 elsewhere -> five (..., 4); see
    ops/texture_sample.py:sample_maps. On the card one launch computes the
    footprints and the samples, every element running its own taps, which
    gives the plain version's bits."""
    if uv.device.type == "cpu":
        check_maps(pool, indices, uv, ddx, ddy, max_aniso, mask)
        return texture_sample.sample_maps(pool, indices, uv, ddx, ddy,
                                          max_aniso, mask)
    launch, outs = maps_launcher(pool, indices, uv, ddx, ddy, max_aniso,
                                 mask)
    return _run("maps", launch, outs, (*pool, indices, uv, ddx, ddy, mask))


def sample_trilinear(pool: TexturePool, index, uv, lod, mask) -> torch.Tensor:
    """Sample with REPEAT addressing and trilinear filtering at `lod` (None:
    0) where `mask` holds, 0 elsewhere -> (..., 4); see
    ops/texture_sample.py:sample_trilinear."""
    if uv.device.type == "cpu":
        check_trilinear(pool, index, uv, lod, mask)
        color = texture_sample.sample_trilinear(pool, index, uv, lod)
        return torch.where(mask[..., None], color, 0.0)
    launch, out = launcher(pool, index, uv, lod, mask)
    return _run("trilinear", launch, (out,), (*pool, index, uv, lod, mask))[0]
