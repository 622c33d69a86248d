"""The G-buffer fetch: the CUDA kernel of csrc/gbuffer.cu on the card.

Replaces the eager interpolate_gbuffer of ops/shade.py on the shaded frames'
path (the port of ash_tpu/ops/shade.py:127, jax.numpy that XLA fuses into
one gather program; not a TPU kernel), about 74 small kernels a shaded
layer, 92 with the motion vectors. One entry, one launch a call:

- `interpolate_gbuffer(...)`: the plain function's signature and its
  `GBuffer`, every field contiguous.

- CUDA tensors launch the hand-written kernel (built by ops/_build.py at
  first use) or raise; nothing falls back.
- CPU tensors run the plain version (ops/shade.py's interpolate_gbuffer)
  unchanged, on any dtype; `check_inputs` says what the card takes and runs
  on CPU tensors too.

`launches["gbuffer"]` counts the kernel's launches (and nothing else), so a
run can show that its frames went through it. Each callable in `observers`
is handed every launch's input and output tensors
(render/cost_analysis.py counts their bytes).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build, shade
from .shade import GBuffer

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

launches = {"gbuffer": 0}
observers = []

# The largest value of a 32-bit index, stride or count.
_INT_MAX = 2**31 - 1


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("gbuffer")
    lib.ash_gbuffer.argtypes = (
        [_P] + [_I] * 4 + [_P, _P] + [_I] * 5 + [_F, _F] + [_P] * 4 + [_I]
        + [_P, _I] + [_P] * 6 + [_I, _F, _F] + [_P] * 11 + [_P])
    lib.ash_gbuffer.restype = _I
    return lib


def _check(name, t, dtype, shape, device, contiguous=True):
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"gbuffer kernel: {name} is not a tensor")
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"gbuffer kernel: {name} is {t.dtype} {tuple(t.shape)} on "
            f"{t.device}; expected {dtype} {shape} on {device}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"gbuffer kernel: {name} must be contiguous")
    if any(abs(s) > _INT_MAX for s in t.stride()):
        raise ValueError(f"gbuffer kernel: {name}'s strides exceed 32 bits")


def _rows(name, t, width, device) -> int:
    """The row count V of a contiguous, non-empty f32 (V, width) table."""
    if not isinstance(t, torch.Tensor) or t.dim() != 2 or t.shape[0] == 0:
        raise ValueError(f"gbuffer kernel: {name} must be a non-empty "
                         f"(V, {width}) tensor")
    _check(name, t, torch.float32, (t.shape[0], width), device)
    return int(t.shape[0])


def _is_int(x) -> bool:
    return isinstance(x, (int, np.integer)) and not isinstance(x, bool)


def check_inputs(tri_id, setup, tri_v, tri_draw, verts, vert_uv, vert_color,
                 y0=0, vert_uid=None, prev_clip=None, fb_height=None,
                 fb_width=None, pixel_xy=None, deriv_step=(1.0, 1.0)) -> None:
    """Raise ValueError unless interpolate_gbuffer's inputs are what the
    kernel takes: one device; int32 `tri_id` (rows, cols), any strides;
    f32 `setup.edge` (T, 3, 3) and `setup.det` (T,), int32 `tri_v` (T, 3)
    and `tri_draw` (T,); f32 `verts.world`, `verts.normal` (Ve, 3) and
    `verts.tangent` (Ve, 4); f32 `vert_uv` (Vu, 2) and `vert_color` (Vu, 3);
    `vert_uid` None or int32 (Ve,); `prev_clip` None or f32 (Ve, 4); these
    tables contiguous; `pixel_xy` None or two f32 tensors of tri_id's shape
    (any strides: expanded views are taken as they are); ints `y0`,
    `fb_height` and `fb_width` (None, or above 0), finite `deriv_step`
    floats; 32-bit indices and strides. Both devices check, so a CPU run
    shows what the card would refuse."""
    if not isinstance(tri_id, torch.Tensor) or tri_id.dim() != 2:
        raise ValueError("gbuffer kernel: tri_id must be a 2-D tensor")
    device = tri_id.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"gbuffer kernel: unsupported device {device}")
    shape = tuple(tri_id.shape)
    _check("tri_id", tri_id, torch.int32, shape, device, contiguous=False)
    if tri_id.numel() == 0 or tri_id.numel() * 4 > _INT_MAX:
        raise ValueError(f"gbuffer kernel: {shape} elements; the kernel "
                         "takes 1 to 2^29")
    edge, det = setup.edge, setup.det
    if not isinstance(edge, torch.Tensor) or edge.dim() != 3 or \
            edge.shape[0] == 0:
        raise ValueError("gbuffer kernel: setup.edge must be (T, 3, 3)")
    n_tri = int(edge.shape[0])
    if n_tri * 9 > _INT_MAX:
        raise ValueError("gbuffer kernel: 32-bit index range exceeded")
    _check("setup.edge", edge, torch.float32, (n_tri, 3, 3), device)
    _check("setup.det", det, torch.float32, (n_tri,), device)
    _check("tri_v", tri_v, torch.int32, (n_tri, 3), device)
    _check("tri_draw", tri_draw, torch.int32, (n_tri,), device)
    n_vert = _rows("verts.world", verts.world, 3, device)
    for name, t, width in (("verts.normal", verts.normal, 3),
                           ("verts.tangent", verts.tangent, 4)):
        _check(name, t, torch.float32, (n_vert, width), device)
    n_unique = _rows("vert_uv", vert_uv, 2, device)
    _check("vert_color", vert_color, torch.float32, (n_unique, 3), device)
    if max(n_vert, n_unique) * 4 > _INT_MAX:
        raise ValueError("gbuffer kernel: 32-bit index range exceeded")
    if vert_uid is not None:
        _check("vert_uid", vert_uid, torch.int32, (n_vert,), device)
    if prev_clip is not None:
        _check("prev_clip", prev_clip, torch.float32, (n_vert, 4), device)
    if pixel_xy is not None:
        if not isinstance(pixel_xy, (tuple, list)) or len(pixel_xy) != 2:
            raise ValueError("gbuffer kernel: pixel_xy must be (px, py)")
        for name, t in zip(("px", "py"), pixel_xy):
            _check(name, t, torch.float32, shape, device, contiguous=False)
    if not _is_int(y0) or abs(int(y0)) > _INT_MAX:
        raise ValueError(f"gbuffer kernel: y0 {y0!r} is not a 32-bit int")
    for name, v in (("fb_height", fb_height), ("fb_width", fb_width)):
        if v is not None and not (_is_int(v) and 0 < int(v) <= _INT_MAX):
            raise ValueError(f"gbuffer kernel: {name} {v!r} is not an int "
                             "above 0")
    if not isinstance(deriv_step, (tuple, list)) or len(deriv_step) != 2 or \
            not all(isinstance(s, (int, float, np.number))
                    and not isinstance(s, bool) and np.isfinite(s)
                    for s in deriv_step):
        raise ValueError(f"gbuffer kernel: deriv_step {deriv_step!r} is not "
                         "two finite numbers")


def _f32(x) -> float:
    """A Python number as PyTorch's CUDA kernels take a CPU scalar operand:
    rounded to f32."""
    return float(np.float32(x))


def _reciprocal(n: int) -> float:
    """1.0f / f32(n), as PyTorch divides a CUDA tensor by a host scalar
    (the product with its f32 reciprocal)."""
    return float(np.float32(1.0) / np.float32(n))


def launcher(tri_id, setup, tri_v, tri_draw, verts, vert_uv, vert_color,
             y0=0, vert_uid=None, prev_clip=None, fb_height=None,
             fb_width=None, pixel_xy=None, deriv_step=(1.0, 1.0)):
    """Check interpolate_gbuffer's inputs on a CUDA device and return
    (launch, GBuffer): `launch()` runs ash_gbuffer once on the current
    stream, writing every field of the GBuffer, and counts nothing. The
    entry point counts; this split lets a timing loop replay the bare
    launch."""
    check_inputs(tri_id, setup, tri_v, tri_draw, verts, vert_uv, vert_color,
                 y0, vert_uid, prev_clip, fb_height, fb_width, pixel_xy,
                 deriv_step)
    device = tri_id.device
    if device.type != "cuda":
        raise ValueError(f"gbuffer kernel: unsupported device {device}")
    rows, cols = tri_id.shape

    def empty(*last, dtype=torch.float32):
        return torch.empty((rows, cols, *last), dtype=dtype, device=device)

    gbuf = GBuffer(
        mask=empty(dtype=torch.bool), world=empty(3), normal=empty(3),
        tangent=empty(4), uv=empty(2), color=empty(3),
        front_facing=empty(dtype=torch.bool),
        draw_id=empty(dtype=torch.int32), uv_ddx=empty(2), uv_ddy=empty(2),
        velocity=None if prev_clip is None else empty(2))
    if pixel_xy is None:
        px = py = None
        strides = (0, 0, 0, 0)
    else:
        px, py = pixel_xy
        strides = (*px.stride(), *py.stride())

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = (
        tri_id.data_ptr(), rows, cols, *tri_id.stride(), ptr(px), ptr(py),
        *strides, int(y0), _f32(deriv_step[0]), _f32(deriv_step[1]),
        setup.edge.data_ptr(), setup.det.data_ptr(), tri_v.data_ptr(),
        tri_draw.data_ptr(), int(setup.edge.shape[0]), ptr(vert_uid),
        int(verts.world.shape[0]), verts.world.data_ptr(),
        verts.normal.data_ptr(), verts.tangent.data_ptr(), ptr(prev_clip),
        vert_uv.data_ptr(), vert_color.data_ptr(), int(vert_uv.shape[0]),
        _reciprocal(cols if fb_width is None else fb_width),
        _reciprocal(rows if fb_height is None else fb_height),
        gbuf.mask.data_ptr(), gbuf.world.data_ptr(), gbuf.normal.data_ptr(),
        gbuf.tangent.data_ptr(), gbuf.uv.data_ptr(), gbuf.color.data_ptr(),
        gbuf.front_facing.data_ptr(), gbuf.draw_id.data_ptr(),
        gbuf.uv_ddx.data_ptr(), gbuf.uv_ddy.data_ptr(), ptr(gbuf.velocity))
    entry = _library().ash_gbuffer

    def launch() -> None:
        err = _build.launch(device, entry, *args)
        if err != 0:
            raise RuntimeError(
                f"gbuffer kernel launch failed: CUDA error {err}")

    return launch, gbuf


def _observe(tri_id, setup, tri_v, tri_draw, verts, vert_uv, vert_color,
             vert_uid, prev_clip, pixel_xy, gbuf):
    inputs = (tri_id, setup.edge, setup.det, tri_v, tri_draw, verts.world,
              verts.normal, verts.tangent, vert_uv, vert_color)
    inputs += tuple(t for t in (vert_uid, prev_clip) if t is not None)
    if pixel_xy is not None:
        # An expanded view reads each of its distinct elements once.
        inputs += tuple(t.as_strided(
            [n if s else 1 for n, s in zip(t.shape, t.stride())], t.stride())
            for t in pixel_xy)
    outputs = tuple(t for t in gbuf if t is not None)
    for fn in observers:
        fn(inputs, outputs)


def interpolate_gbuffer(
    tri_id: torch.Tensor,
    setup,
    tri_v: torch.Tensor,
    tri_draw: torch.Tensor,
    verts,
    vert_uv: torch.Tensor,
    vert_color: torch.Tensor,
    y0: int = 0,
    vert_uid=None,
    prev_clip=None,
    fb_height=None,
    fb_width=None,
    pixel_xy=None,
    deriv_step: tuple = (1.0, 1.0),
) -> GBuffer:
    """ops/shade.py's interpolate_gbuffer (same arguments, same GBuffer).
    On the card one launch, bit for bit the plain version; on the CPU the
    plain version itself."""
    if tri_id.device.type == "cpu":
        return shade.interpolate_gbuffer(
            tri_id, setup, tri_v, tri_draw, verts, vert_uv, vert_color,
            y0=y0, vert_uid=vert_uid, prev_clip=prev_clip,
            fb_height=fb_height, fb_width=fb_width, pixel_xy=pixel_xy,
            deriv_step=deriv_step)
    launch, gbuf = launcher(tri_id, setup, tri_v, tri_draw, verts, vert_uv,
                            vert_color, y0, vert_uid, prev_clip, fb_height,
                            fb_width, pixel_xy, deriv_step)
    launch()
    launches["gbuffer"] += 1
    if observers:
        _observe(tri_id, setup, tri_v, tri_draw, verts, vert_uv, vert_color,
                 vert_uid, prev_clip, pixel_xy, gbuf)
    return gbuf
