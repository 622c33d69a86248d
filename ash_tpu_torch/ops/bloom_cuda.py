"""The bloom pyramid's entry point: the CUDA kernels of csrc/bloom.cu on the
card.

Replaces the eager chain of ops/bloom.py:bloom_pyramid on the post frames'
path (the port of ash_tpu/ops/bloom.py:bloom_pyramid, jax.numpy that XLA
fuses; not a TPU kernel), which runs about 3,200 small kernels at 1080p with
5 mips. Here each level of the pyramid is one launch each way: the
downsample (ash_bloom_down, the first launch thresholding the HDR frame as
it reads it) and the tent upsample with the level's add (ash_bloom_up, the
last launch writing the bloom). `levels` gives the plan.

- CUDA tensors launch the hand-written kernels (built by ops/_build.py at
  first use) or raise; nothing falls back.
- CPU tensors run the plain chain, ops/bloom.py's bloom_pyramid, on any
  float dtype, as before (`check_inputs` says what the card takes, and runs
  on CPU tensors too).

`launches["down"]` and `launches["up"]` count the kernels' launches (and
nothing else), so a run can show that its frames went through them. Each
callable in `observers` is handed every launch's input and output tensors
(render/cost_analysis.py counts their bytes).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import _build, bloom

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

launches = {"down": 0, "up": 0}
observers = []


class Step(NamedTuple):
    """One launch of the chain: `kind` "down" or "up", from a `src` (h, w)
    level to a `dst` (h, w) level by `path` ("blocks": the 2x2 blocks of an
    even source, "double": the separable lerps of an exact 2x target, or
    "gather": the bilinear gather); `threshold`: the source is the HDR
    frame, read through the soft threshold; `add`: the level of the
    target's size is added (the upsample's `+ down[i]`)."""
    kind: str
    src: Tuple[int, int]
    dst: Tuple[int, int]
    path: str
    threshold: bool
    add: bool


def levels(h: int, w: int, mip_count: int) -> Tuple[Step, ...]:
    """The launches of a pyramid over an (h, w) frame, in order, with the
    stopping rule of ops/bloom.py:bloom_pyramid: a level is built while its
    source's shorter side exceeds 2, at most mip_count times. L levels give
    L downs then L ups; none gives one up, the frame to its own size."""
    shapes = [(h, w)]
    for _ in range(mip_count):
        sh, sw = shapes[-1]
        if min(sh, sw) <= 2:
            break
        shapes.append((max(sh // 2, 1), max(sw // 2, 1)))
    n = len(shapes) - 1
    if n == 0:
        return (Step("up", (h, w), (h, w), "gather", True, False),)
    steps = []
    for i in range(n):
        (sh, sw), dst = shapes[i], shapes[i + 1]
        steps.append(Step("down", (sh, sw), dst,
                          "blocks" if sh % 2 == 0 and sw % 2 == 0
                          else "gather", i == 0, False))
    for i in range(n, 0, -1):
        (sh, sw), dst = shapes[i], shapes[i - 1]
        steps.append(Step("up", (sh, sw), dst,
                          "double" if dst == (2 * sh, 2 * sw) else "gather",
                          False, i > 1))
    return tuple(steps)


def threshold_operands(threshold: float, soft_knee: float):
    """The soft threshold's f32 operands as the plain chain's CUDA ops take
    them: the threshold, the knee, the f32 of 2 knee (clamp's bound) and the
    f32 reciprocal of the f32 of 4 knee + 1e-5 (a division by a CPU
    scalar)."""
    return (float(np.float32(threshold)), float(np.float32(soft_knee)),
            float(np.float32(2.0 * soft_knee)),
            float(np.float32(1.0) / np.float32(4.0 * soft_knee + 1e-5)))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("bloom")
    lib.ash_bloom_down.argtypes = ([_P, _I, _I, _I] + [_F] * 4
                                   + [_P, _I, _I, _P])
    lib.ash_bloom_down.restype = _I
    lib.ash_bloom_up.argtypes = ([_P, _I, _I, _I] + [_F] * 4
                                 + [_P, _P, _I, _I, _P])
    lib.ash_bloom_up.restype = _I
    lib.ash_bloom_probe_rcp.argtypes = [_P, _I, _P, _P, _P]
    lib.ash_bloom_probe_rcp.restype = _I
    return lib


def probe_reciprocal(x: torch.Tensor):
    """(__frcp_rn(x), __fdiv_rn(1, x)) of a contiguous f32 CUDA tensor, as
    the kernels compute them (the tests' probe of the Karis weight's
    reciprocal)."""
    if x.device.type != "cuda" or x.dtype != torch.float32 or \
            not x.is_contiguous() or x.numel() == 0:
        raise ValueError("bloom probe: a non-empty contiguous f32 CUDA "
                         "tensor")
    rcp, quot = torch.empty_like(x), torch.empty_like(x)
    err = _build.launch(x.device, _library().ash_bloom_probe_rcp,
                        x.data_ptr(), x.numel(), rcp.data_ptr(),
                        quot.data_ptr())
    if err != 0:
        raise RuntimeError(f"bloom probe launch failed: CUDA error {err}")
    return rcp, quot


def c_args(src, h, w, threshold_src, t, k, hi, inv, *rest):
    """A launch's arguments as ctypes values, converted once when the chain
    is planned, so that a launch from the host skips the conversion."""
    *ptrs, dh, dw = rest
    return (_P(src), _I(h), _I(w), _I(threshold_src), _F(t), _F(k), _F(hi),
            _F(inv), *(_P(p) for p in ptrs), _I(dh), _I(dw))


def check_inputs(hdr, threshold, soft_knee, mip_count) -> None:
    """Raise ValueError unless the inputs are what the kernels take: a
    contiguous f32 (H, W, 3) tensor, H and W at least 1, on the CPU or a
    CUDA device; float threshold and knee; an int mip_count >= 0. Both
    devices check, so a CPU run shows what the card would refuse."""
    if not isinstance(hdr, torch.Tensor):
        raise ValueError("bloom kernel: hdr is not a tensor")
    if hdr.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bloom kernel: unsupported device {hdr.device}")
    if (hdr.dtype != torch.float32 or hdr.dim() != 3 or hdr.shape[2] != 3
            or hdr.shape[0] < 1 or hdr.shape[1] < 1):
        raise ValueError(f"bloom kernel: hdr is {hdr.dtype} "
                         f"{tuple(hdr.shape)}; expected float32 (H, W, 3)")
    if not hdr.is_contiguous():
        raise ValueError("bloom kernel: hdr must be contiguous")
    if hdr.numel() >= 2**31:
        raise ValueError("bloom kernel: 32-bit index range exceeded")
    for name, x in (("threshold", threshold), ("soft_knee", soft_knee)):
        if isinstance(x, bool) or not isinstance(x, (int, float)):
            raise ValueError(f"bloom kernel: {name} {x!r} is not a float")
    if (isinstance(mip_count, bool) or not isinstance(mip_count, int)
            or mip_count < 0):
        raise ValueError(f"bloom kernel: mip_count {mip_count!r} is not an "
                         "int >= 0")


def launcher(hdr, threshold=0.8, soft_knee=0.5, mip_count=5):
    """Check the inputs on a CUDA device and allocate the levels -> (launch,
    bloom): `launch()` runs the chain's launches on the current stream,
    writing the (H, W, 3) bloom, counts nothing, and returns the launches
    it made as (kind, inputs, outputs); `launch(steps)` runs only the
    launches at those indices of `levels`' plan. The entry point counts;
    this split lets a timing loop replay the bare chain, or one level."""
    if hdr.device.type != "cuda":
        raise ValueError(f"bloom kernel: unsupported device {hdr.device}")
    check_inputs(hdr, threshold, soft_knee, mip_count)
    h, w = hdr.shape[:2]
    plan = levels(h, w, mip_count)
    ops = threshold_operands(threshold, soft_knee)
    lib = _library()

    def image(shape):
        return torch.empty(shape + (3,), dtype=torch.float32,
                           device=hdr.device)

    # Each launch reads the last one's output; up k (from 0) adds down[L - 1
    # - k], L levels; the last output is the bloom.
    n_levels = sum(s.kind == "down" for s in plan)
    down, src, calls = [hdr], hdr, []
    for s in plan:
        dst = image(s.dst)
        if s.kind == "down":
            calls.append(("down", lib.ash_bloom_down,
                          c_args(src.data_ptr(), *s.src, int(s.threshold),
                                 *ops, dst.data_ptr(), *s.dst),
                          (src,), (dst,)))
            down.append(dst)
        else:
            k = len(calls) - n_levels
            add = down[n_levels - 1 - k] if s.add else None
            calls.append(("up", lib.ash_bloom_up,
                          c_args(src.data_ptr(), *s.src, int(s.threshold),
                                 *ops, None if add is None else add.data_ptr(),
                                 dst.data_ptr(), *s.dst),
                          (src,) if add is None else (src, add), (dst,)))
        src = dst
    out = calls[-1][4][0]
    made = [(kind, ins, outs) for kind, _, _, ins, outs in calls]
    device = hdr.device

    def launch(steps=None):
        run = calls if steps is None else [calls[i] for i in steps]
        for kind, entry, args, _, _ in run:
            err = _build.launch(device, entry, *args)
            if err != 0:
                raise RuntimeError(f"bloom kernel ({kind}) launch "
                                   f"failed: CUDA error {err}")
        return made if steps is None else [made[i] for i in steps]

    return launch, out


def bloom_pyramid(hdr: torch.Tensor, threshold: float = 0.8,
                  soft_knee: float = 0.5, mip_count: int = 5) -> torch.Tensor:
    """The whole bloom chain -> (H, W, 3) bloom buffer, its intensity not
    applied; see ops/bloom.py:bloom_pyramid. On the card one launch a level
    each way, bit for bit the plain chain there."""
    if hdr.device.type == "cpu":
        return bloom.bloom_pyramid(hdr, threshold, soft_knee, mip_count)
    launch, out = launcher(hdr, threshold, soft_knee, mip_count)
    for kind, inputs, outputs in launch():
        launches[kind] += 1
        for observe in observers:
            observe(inputs, outputs)
    return out
