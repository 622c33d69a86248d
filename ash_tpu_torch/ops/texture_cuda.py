"""Texture sampling's entry point: the CUDA kernel of csrc/texture.cu on the
card.

Replaces the eager, tap-by-tap sampler on the textured frame's path (the
port of ash_tpu/ops/shade.py:_sample_map, jax.numpy over
ash_tpu/ops/texture_sample.py:sample_trilinear; not a TPU kernel). Every
texture sample of a frame goes through here: shade_pbr's five maps, the
alpha test (`resolve_alpha_test`) and the blend's alpha (`pixel_alpha`).

- CUDA tensors launch the hand-written kernel (built by ops/_build.py at
  first use) or raise; nothing falls back. Each element runs its own tap
  count, so no trip count is taken from the device (no host sync).
- CPU tensors run the plain versions, ops/texture_sample.py's
  sample_footprint and sample_trilinear, which are the kernel's reference.

Every caller passes the G-buffer's mask: elements where it is False are
written 0 on either device (the kernel skips them), and every caller
discards them.

`launches["footprint"]` and `launches["trilinear"]` count the kernel's
launches through each entry (and nothing else), so a run can show that its
frames went through the kernel. Each callable in `observers` is handed
every launch's input and output tensors (render/cost_analysis.py counts
their bytes).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, texture_sample
from .texture_sample import TexturePool

_P, _I = ctypes.c_void_p, ctypes.c_int

launches = {"footprint": 0, "trilinear": 0}
observers = []


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("texture")
    lib.ash_sample_footprint.argtypes = (
        [_P, _I, _P, _I, _I] + [_P] * 9 + [_I] * 2 + [_P])
    lib.ash_sample_footprint.restype = _I
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


def check_inputs(pool: TexturePool, index, uv, mask, lod=None, n_taps=None,
                 major_uv=None) -> None:
    """Raise ValueError unless the inputs are what the kernel takes: one
    device, the pool's dtypes and shapes, int32 `index` of the elements'
    shape S (one dimension or more), f32 `uv` S + (2,), bool `mask` S, f32
    `lod` S, f32 `n_taps` S with f32 `major_uv` S + (2,) (both or neither),
    every tensor contiguous. Both devices check, so a CPU run shows
    what the card would refuse."""
    device = uv.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"texture kernel: unsupported device {device}")
    shape = tuple(index.shape)
    if not shape:
        raise ValueError("texture kernel: index needs a dimension")
    n_tex, max_mips = pool.table.shape[0], pool.table.shape[1]
    _check("pool.texels", pool.texels, torch.bfloat16,
           (pool.texels.shape[0], 4), device)
    _check("pool.table", pool.table, torch.int32, (n_tex, max_mips, 3), device)
    _check("pool.levels", pool.levels, torch.int32, (n_tex,), device)
    if pool.min_level is not None:
        _check("pool.min_level", pool.min_level, torch.int32, (n_tex,), device)
    _check("index", index, torch.int32, shape, device)
    _check("uv", uv, torch.float32, shape + (2,), device)
    _check("mask", mask, torch.bool, shape, device)
    if lod is not None:
        _check("lod", lod, torch.float32, shape, device)
    if (n_taps is None) != (major_uv is None):
        raise ValueError("texture kernel: n_taps and major_uv go together")
    if n_taps is not None:
        _check("n_taps", n_taps, torch.float32, shape, device)
        _check("major_uv", major_uv, torch.float32, shape + (2,), device)
    if (index.numel() * 4 >= 2**31 or pool.texels.shape[0] >= 2**31
            or n_tex * max_mips * 3 >= 2**31):
        raise ValueError("texture kernel: 32-bit index range exceeded")


def launcher(pool: TexturePool, index, uv, mask, lod=None, n_taps=None,
             major_uv=None):
    """Check the inputs on a CUDA device, allocate the (..., 4) output and
    return (launch, out): `launch()` runs the kernel once on the current
    stream into `out` and counts nothing. The entry points count; this
    split lets a timing loop replay the bare launch."""
    device = uv.device
    if device.type != "cuda":
        raise ValueError(f"texture kernel: unsupported device {device}")
    check_inputs(pool, index, uv, mask, lod, n_taps, major_uv)
    if pool.texels.data_ptr() % 8:
        raise ValueError("texture kernel: pool.texels must be 8-byte aligned")
    out = torch.empty(tuple(index.shape) + (4,), dtype=torch.float32,
                      device=device)
    cols = index.shape[-1]
    rows = index.numel() // cols if cols else 0
    lib = _library()

    def ptr(t):
        return None if t is None else t.data_ptr()

    def launch():
        if rows == 0:
            return
        with torch.cuda.device(device):
            err = lib.ash_sample_footprint(
                ptr(pool.texels), pool.texels.shape[0], ptr(pool.table),
                pool.table.shape[0], pool.table.shape[1], ptr(pool.levels),
                ptr(pool.min_level), ptr(index), ptr(uv), ptr(lod),
                ptr(n_taps), ptr(major_uv), ptr(mask), ptr(out), rows, cols,
                torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"texture kernel launch failed: CUDA error {err}")

    return launch, out


def _run(entry, pool, index, uv, mask, lod, n_taps=None, major_uv=None):
    launch, out = launcher(pool, index, uv, mask, lod, n_taps, major_uv)
    launch()
    if index.numel():
        launches[entry] += 1
        for observe in observers:
            observe((*pool, index, uv, mask, lod, n_taps, major_uv), (out,))
    return out


def sample_footprint(pool: TexturePool, index, uv, fp, mask) -> torch.Tensor:
    """Sample texture `index` over its footprint `fp`
    (ops/texture_sample.Footprint) where `mask` holds, 0 elsewhere ->
    (..., 4); see ops/texture_sample.py:sample_footprint. On the card every
    element runs its own n_taps taps, which gives the plain version's bits
    (its trip count is at or above them)."""
    if uv.device.type == "cpu":
        check_inputs(pool, index, uv, mask, fp.lod, fp.n_taps, fp.major_uv)
        color = texture_sample.sample_footprint(pool, index, uv, fp)
        return torch.where(mask[..., None], color, 0.0)
    return _run("footprint", pool, index, uv, mask, fp.lod, fp.n_taps,
                fp.major_uv)


def sample_trilinear(pool: TexturePool, idx, uv, lod, mask) -> torch.Tensor:
    """Sample with REPEAT addressing and trilinear filtering at `lod` (None:
    0) where `mask` holds, 0 elsewhere -> (..., 4); see
    ops/texture_sample.py:sample_trilinear."""
    if uv.device.type == "cpu":
        check_inputs(pool, idx, uv, mask, lod)
        color = texture_sample.sample_trilinear(pool, idx, uv, lod)
        return torch.where(mask[..., None], color, 0.0)
    return _run("trilinear", pool, idx, uv, mask, lod)
