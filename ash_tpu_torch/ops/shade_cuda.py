"""The surface shading's entry point: the CUDA kernels of csrc/shade.cu on the
card.

Replaces the eager rest of shade_pbr on the shaded frames' path (the port of
ash_tpu/ops/shade.py:415, jax.numpy that XLA fuses; not a TPU kernel):
about 88 small kernels a shaded layer (about 150 with a texture pool) for
the material gather, the normal frame, the directional light's BRDF, the
ambient and emissive terms and the composite. One entry:

- `shade_pbr(...)`: ops/shade.py's shade_pbr (same arguments, same colour),
  and with `with_alpha=True` also the blend's coverage alpha
  (ops/shade.py:pixel_alpha), as (colour, alpha).

On the card, in f32 with the flat ambient term, a call runs the kernels that
shade_pbr's parts already have (the five texture samples, ops/texture_cuda;
the shadow term, ops/shadow_cuda; the Forward+ lights, ops/lights_cuda,
unchanged) and, around them, csrc/shade.cu: one launch (`shade`) without
lights; with lights `surface`, which writes `lo` and the light kernel's
inputs, then the light kernel, then `compose`. Before the launches, a few
eager ops make the kernels' inputs: the light direction (four ops on a
(3,) tensor); with a shadow map the flipped normal the shadow kernel takes
(two ops); with a pool the texture indices (three ops); with lights and
explicit coordinates their contiguous copies. The pool's coverage alpha
(an LOD-0 sample) stays eager; without a pool the alpha is the shade
launch's second output.

- `dtype=torch.bfloat16` and `ibl=` take the eager path (the plain version)
  on either device, chosen from the arguments before anything runs and
  counted in `launches["eager"]`; the kernels' own checks refuse them.
- Other CUDA tensors launch the hand-written kernels (built by
  ops/_build.py at first use) or raise; nothing falls back.
- CPU tensors run the plain version (`plain`: ops/shade.py's shade_pbr, and
  pixel_alpha) unchanged; `check_inputs` says what the card takes and runs
  on CPU tensors too.

`launches["shade"]`, `["surface"]` and `["compose"]` count the kernels'
launches (and nothing else), so a run can show that its frames went through
them. Each callable in `observers` is handed every launch's input and
output tensors (render/cost_analysis.py counts their bytes).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _build, lights_cuda, shade, shadow_cuda, texture_cuda

_P, _I = ctypes.c_void_p, ctypes.c_int

# The C entry's stages.
STAGES = {"shade": 0, "surface": 1, "compose": 2}
# Floats in a packed MaterialUniform row.
MATERIAL_ROW = 18

launches = {"shade": 0, "surface": 0, "compose": 0, "eager": 0}
observers = []

# The largest value of a 32-bit index or count.
_INT_MAX = 2**31 - 1


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("shade")
    lib.ash_shade.argtypes = ([_I, _I] + [_P] * 7 + [_I, _P, _P, _P, _I]
                              + [_P] * 4)
    lib.ash_shade.restype = _I
    return lib


def eager(dtype=torch.float32, ibl=None) -> bool:
    """Whether shade_pbr's arguments take the eager path: the BRDF in bf16
    (`dtype`) or image-based lighting (`ibl`), which the kernels do not
    code yet."""
    return dtype != torch.float32 or ibl is not None


class Surface(NamedTuple):
    """What the surface stage writes for the light kernel and compose, each
    (..., 3) or (...,) f32, contiguous."""

    lo: torch.Tensor
    normal: torch.Tensor
    view_dir: torch.Tensor
    base_color: torch.Tensor
    metallic: torch.Tensor
    roughness: torch.Tensor
    f0: torch.Tensor
    ndotv: torch.Tensor
    ambient: torch.Tensor
    emissive: torch.Tensor


def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"shade kernel: {name} is not a tensor")
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"shade kernel: {name} is {t.dtype} {tuple(t.shape)} on "
            f"{t.device}; expected {dtype} {shape} on {device}")
    if not t.is_contiguous():
        raise ValueError(f"shade kernel: {name} must be contiguous")


def check_inputs(gbuf, materials, uniforms, shadow_map=None, pool=None,
                 clear_color=(0.0, 0.0, 0.0), reinhard=True, lights=None,
                 tile_light_indices=None, tile_light_counts=None,
                 light_tile_size=16, max_anisotropy=1, csm=None,
                 csm_blend_size=0.0, ibl=None, dtype=torch.float32,
                 pixel_xy=None, with_alpha=False) -> None:
    """Raise ValueError unless shade_pbr's arguments are what the kernels
    take: f32 shading (`dtype`) without `ibl` (those take the eager path);
    one device; the G-buffer's mask and front_facing bool (rows, cols),
    world and normal f32 (rows, cols, 3), draw_id int32 (rows, cols), and
    with a pool its tangent f32 (rows, cols, 4), all contiguous (the
    tangent 16-byte aligned); f32 `materials` (D, 18), D > 0; the uniforms'
    camera_pos, light_direction, light_color and ambient_color f32 (3,);
    `clear_color` three numbers or an f32 (3,) tensor; bools `reinhard` and
    `with_alpha`; fewer than 2^29 elements. The shadow, texture and light
    kernels check their own inputs. Both devices check, so a CPU run shows
    what the card would refuse."""
    if eager(dtype, ibl):
        raise ValueError("shade kernel: bf16 shading and image-based "
                         "lighting take the eager path (shade_cuda.eager)")
    mask = gbuf.mask
    if not isinstance(mask, torch.Tensor) or mask.dim() != 2:
        raise ValueError("shade kernel: gbuf.mask must be (rows, cols)")
    device = mask.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"shade kernel: unsupported device {device}")
    grid = tuple(mask.shape)
    n = mask.numel()
    if n == 0 or n * 4 > _INT_MAX:
        raise ValueError(f"shade kernel: {grid} elements; the kernel takes "
                         "1 to 2^29")
    _check("gbuf.mask", mask, torch.bool, grid, device)
    _check("gbuf.front_facing", gbuf.front_facing, torch.bool, grid, device)
    _check("gbuf.draw_id", gbuf.draw_id, torch.int32, grid, device)
    _check("gbuf.world", gbuf.world, torch.float32, grid + (3,), device)
    _check("gbuf.normal", gbuf.normal, torch.float32, grid + (3,), device)
    if pool is not None:
        _check("gbuf.tangent", gbuf.tangent, torch.float32, grid + (4,),
               device)
        if gbuf.tangent.data_ptr() % 16:
            raise ValueError("shade kernel: gbuf.tangent must be 16-byte "
                             "aligned")
    if not isinstance(materials, torch.Tensor) or materials.dim() != 2 or \
            materials.shape[0] == 0:
        raise ValueError(f"shade kernel: materials must be a non-empty (D, "
                         f"{MATERIAL_ROW}) tensor")
    _check("materials", materials, torch.float32,
           (materials.shape[0], MATERIAL_ROW), device)
    if materials.numel() > _INT_MAX:
        raise ValueError("shade kernel: 32-bit index range exceeded")
    for name in ("camera_pos", "light_direction", "light_color",
                 "ambient_color"):
        _check(f"uniforms.{name}", getattr(uniforms, name), torch.float32,
               (3,), device)
    if isinstance(clear_color, torch.Tensor):
        _check("clear_color", clear_color, torch.float32, (3,), device)
    elif not (isinstance(clear_color, (tuple, list)) and len(clear_color) == 3
              and all(isinstance(c, (int, float, np.number))
                      and not isinstance(c, bool) for c in clear_color)):
        raise ValueError(f"shade kernel: clear_color {clear_color!r} is not "
                         "three numbers or an f32 (3,) tensor")
    for name, v in (("reinhard", reinhard), ("with_alpha", with_alpha)):
        if not isinstance(v, bool):
            raise ValueError(f"shade kernel: {name} {v!r} is not a bool")


def plain(gbuf, materials, uniforms, shadow_map=None, pool=None,
          clear_color=(0.0, 0.0, 0.0), reinhard=True, lights=None,
          tile_light_indices=None, tile_light_counts=None,
          light_tile_size=16, max_anisotropy=1, csm=None, csm_blend_size=0.0,
          ibl=None, dtype=torch.float32, pixel_xy=None, with_alpha=False):
    """The entry's plain version, on either device: ops/shade.py's shade_pbr
    and, with `with_alpha`, pixel_alpha -> colour or (colour, alpha). The
    CPU entry runs it; a card run patches it in to hold the kernels' frames
    to it."""
    color = shade.shade_pbr(
        gbuf, materials, uniforms, shadow_map=shadow_map, pool=pool,
        clear_color=clear_color, reinhard=reinhard, lights=lights,
        tile_light_indices=tile_light_indices,
        tile_light_counts=tile_light_counts, light_tile_size=light_tile_size,
        max_anisotropy=max_anisotropy, csm=csm, csm_blend_size=csm_blend_size,
        ibl=ibl, dtype=dtype, pixel_xy=pixel_xy)
    if not with_alpha:
        return color
    return color, shade.pixel_alpha(gbuf, materials, pool)


class Prepared(NamedTuple):
    """A call's inputs to the kernels, made by `prepare`."""

    light_dir: torch.Tensor  # (3,) normalised direction towards the light
    shadow: Optional[torch.Tensor]  # (...,) f32, or None
    samples: Optional[tuple]  # the five (..., 4) texture samples, or None
    clear: torch.Tensor  # (3,) f32 on the device


def prepare(gbuf, materials, uniforms, shadow_map=None, pool=None,
            clear_color=(0.0, 0.0, 0.0), max_anisotropy=1, csm=None,
            csm_blend_size=0.0) -> Prepared:
    """The kernels' inputs that shade_pbr's other parts make, as the plain
    version makes them and in its order: the five samples through
    ops/texture_cuda; the light direction; the shadow term through
    ops/shadow_cuda (with the flipped geometric normal); the clear colour
    on the device."""
    device = gbuf.mask.device
    samples = None
    if pool is not None:
        indices = materials[:, 12:17].to(torch.int32)[gbuf.draw_id.long()]
        samples = tuple(texture_cuda.sample_maps(
            pool, indices, gbuf.uv, gbuf.uv_ddx, gbuf.uv_ddy, max_anisotropy,
            gbuf.mask))
    light_dir = shade._normalize(-uniforms.light_direction)
    shadow = None
    if shadow_map is not None:
        flip = torch.where(gbuf.front_facing[..., None], 1.0, -1.0)
        n = gbuf.normal * flip
        ld = light_dir.expand_as(gbuf.world)
        if csm is not None:
            matrices, splits, view = csm
            shadow = shadow_cuda.shadow_pcf16_csm(
                shadow_map, matrices, splits, view, gbuf.world, n, ld,
                blend_size=csm_blend_size)
        else:
            shadow = shadow_cuda.shadow_pcf16(
                shadow_map, uniforms.light_space_matrix, gbuf.world, n, ld)
    clear = torch.as_tensor(clear_color, dtype=torch.float32, device=device)
    return Prepared(light_dir, shadow, samples, clear)


def launcher(gbuf, materials, uniforms, prepared: Prepared, reinhard=True,
             lit=False, with_alpha=False):
    """Check `prepared` on a CUDA device (the entry checks the call's own
    arguments first, with check_inputs) and return (stages, color, alpha,
    surface): `stages` maps "shade" (without lights) or "surface"
    and "compose" (with lights, `lit`) to a function that runs that
    stage's ash_shade launch once on the current stream and counts
    nothing; `color` (..., 3), `alpha` (...,) or None and `surface` (a
    Surface, or None without lights) are the tensors they write. The entry
    point counts and runs the light kernel between surface and compose;
    this split lets a timing loop replay the bare launches."""
    device = gbuf.mask.device
    if device.type != "cuda":
        raise ValueError(f"shade kernel: unsupported device {device}")
    samples, shadow = prepared.samples, prepared.shadow
    grid = tuple(gbuf.mask.shape)
    for name, t in (("light_dir", prepared.light_dir),
                    ("clear", prepared.clear)):
        _check(name, t, torch.float32, (3,), device)
    if shadow is not None:
        _check("shadow", shadow, torch.float32, grid, device)
    if samples is not None:
        if len(samples) != 5:
            raise ValueError("shade kernel: five texture samples")
        for i, s in enumerate(samples):
            _check(f"samples[{i}]", s, torch.float32, grid + (4,), device)
            if s.data_ptr() % 16:
                raise ValueError("shade kernel: samples must be 16-byte "
                                 "aligned")

    def empty(*last):
        return torch.empty(grid + last, dtype=torch.float32, device=device)

    color = empty(3)
    alpha = empty() if with_alpha else None
    surface = None
    if lit:
        surface = Surface(lo=empty(3), normal=empty(3), view_dir=empty(3),
                          base_color=empty(3), metallic=empty(),
                          roughness=empty(), f0=empty(3), ndotv=empty(),
                          ambient=empty(3), emissive=empty(3))

    def ptr(t):
        return None if t is None else t.data_ptr()

    uniform_ptrs = (_P * 5)(uniforms.camera_pos.data_ptr(),
                            prepared.light_dir.data_ptr(),
                            uniforms.light_color.data_ptr(),
                            uniforms.ambient_color.data_ptr(),
                            prepared.clear.data_ptr())
    sample_ptrs = (None if samples is None
                   else (_P * 5)(*(s.data_ptr() for s in samples)))
    surface_ptrs = (None if surface is None
                    else (_P * 10)(*(t.data_ptr() for t in surface)))
    n = gbuf.mask.numel()
    common = (gbuf.mask.data_ptr(), gbuf.world.data_ptr(),
              gbuf.normal.data_ptr(),
              None if samples is None else gbuf.tangent.data_ptr(),
              gbuf.front_facing.data_ptr(), gbuf.draw_id.data_ptr(),
              materials.data_ptr(), int(materials.shape[0]), uniform_ptrs,
              ptr(shadow), sample_ptrs, int(bool(reinhard)))
    entry = _library().ash_shade

    def stage(name, color_out, alpha_out):
        args = (STAGES[name], n, *common, ptr(color_out), ptr(alpha_out),
                surface_ptrs)

        def launch() -> None:
            err = _build.launch(device, entry, *args)
            if err != 0:
                raise RuntimeError(
                    f"shade kernel launch failed ({name}): CUDA error {err}")
        return launch

    if lit:
        stages = {"surface": stage("surface", None, alpha),
                  "compose": stage("compose", color, None)}
    else:
        stages = {"shade": stage("shade", color, alpha)}
    return stages, color, alpha, surface


def _observe(name, gbuf, materials, uniforms, prepared, color, alpha,
             surface):
    if name == "compose":
        inputs = (gbuf.mask, surface.lo, surface.ambient, surface.emissive,
                  prepared.clear)
        outputs = (color,)
    else:
        inputs = (gbuf.mask, gbuf.world, gbuf.normal, gbuf.front_facing,
                  gbuf.draw_id, materials, uniforms.camera_pos,
                  prepared.light_dir, uniforms.light_color,
                  uniforms.ambient_color, prepared.clear)
        if prepared.shadow is not None:
            inputs += (prepared.shadow,)
        if prepared.samples is not None:
            inputs += (gbuf.tangent, *prepared.samples)
        outputs = (color,) if name == "shade" else tuple(surface)
        if alpha is not None:
            outputs += (alpha,)
    for fn in observers:
        fn(inputs, outputs)


def shade_pbr(gbuf, materials, uniforms, shadow_map=None, pool=None,
              clear_color=(0.0, 0.0, 0.0), reinhard: bool = True,
              lights=None, tile_light_indices=None, tile_light_counts=None,
              light_tile_size: int = 16, max_anisotropy: int = 1, csm=None,
              csm_blend_size: float = 0.0, ibl=None,
              dtype: torch.dtype = torch.float32, pixel_xy=None,
              with_alpha: bool = False):
    """ops/shade.py's shade_pbr (same arguments, same colour) and, with
    `with_alpha`, also pixel_alpha's coverage alpha -> colour or (colour,
    alpha). On the card one launch of csrc/shade.cu a call (surface and
    compose around the light kernel with lights), bit for bit the plain
    version; on the CPU, and for bf16 or IBL (counted in
    launches["eager"]), the plain version itself."""
    kw = dict(shadow_map=shadow_map, pool=pool, clear_color=clear_color,
              reinhard=reinhard, lights=lights,
              tile_light_indices=tile_light_indices,
              tile_light_counts=tile_light_counts,
              light_tile_size=light_tile_size, max_anisotropy=max_anisotropy,
              csm=csm, csm_blend_size=csm_blend_size, ibl=ibl, dtype=dtype,
              pixel_xy=pixel_xy, with_alpha=with_alpha)
    if eager(dtype, ibl):
        launches["eager"] += 1
        return plain(gbuf, materials, uniforms, **kw)
    if gbuf.mask.device.type == "cpu":
        return plain(gbuf, materials, uniforms, **kw)
    check_inputs(gbuf, materials, uniforms, **kw)
    prepared = prepare(gbuf, materials, uniforms, shadow_map, pool,
                       clear_color, max_anisotropy, csm, csm_blend_size)
    lit = lights is not None and tile_light_indices is not None
    stages, color, alpha, surface = launcher(
        gbuf, materials, uniforms, prepared, reinhard, lit,
        with_alpha and pool is None)
    for name, launch in stages.items():
        launch()
        launches[name] += 1
        if observers:
            _observe(name, gbuf, materials, uniforms, prepared, color, alpha,
                     surface)
        if name == "surface":
            # In place, as the plain version's loop adds into its own `lo`.
            lights_cuda.add_lights(
                surface.lo, gbuf.mask, gbuf.world, surface.normal,
                surface.view_dir, surface.base_color, surface.metallic,
                surface.roughness, surface.f0, surface.ndotv, lights,
                tile_light_indices, tile_light_counts, light_tile_size,
                None if pixel_xy is None
                else tuple(c.contiguous() for c in pixel_xy))
    if not with_alpha:
        return color
    if pool is not None:
        alpha = shade.pixel_alpha(gbuf, materials, pool)
    return color, alpha
