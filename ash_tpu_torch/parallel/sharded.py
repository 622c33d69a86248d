"""Screen-space bands: one frame rendered across a list of devices (port of
ash_tpu/parallel/sharded.py).

The reference shard_maps its band pipeline over a jax Mesh inside one jit.
The port keeps that model, one controller over a list of devices, in one
process: `make_sharded_frame(config, mesh)` returns one assembled
FrameOutputs, as the reference's does. A mesh may repeat a device, so four
bands on one card run the real n = 4 code path, and `["cpu"] * 8` runs the
reference tests' eight-device cases in one process.

- The scene, the uniforms, the texture pool and the lights are replicated:
  each band's device gets its own copy (a no-op on a repeated device).
- The shadow pass renders band-wise (`shadow_program(band=)`), and the whole
  map, every cascade of it, is gathered to every band's device: each band
  needs all of it for its PCF. A LOD scene's bands render under the level
  mask (`lod_tri_mask`), computed once per device, as the reference's
  bands render under theirs.
- Each band bins, rasterizes and shades its own rows (`render_band(band=)`):
  the bands' tile grids are disjoint, so the raster needs no exchange.
- The scalars reduce as the reference's psum and pmax do: covered pixels
  and edge overflow sum, binning and shadow overflow take their max.
- The bands are cropped and assembled on the mesh's first device, and the
  post chain (`finalize_frame`) runs there once, as the reference's runs
  outside its shard_map.

Every move between devices is an explicit `.to(device, non_blocking=True)`
between device tensors: a no-op on one device, a peer copy between cards.
The mesh adds no host sync of its own.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device
from ..render.frame import (
    BandOutputs,
    BandSpec,
    FrameConfig,
    FrameOutputs,
    FrameUniforms,
    finalize_frame,
    lod_tri_mask,
    raster_size,
    render_band,
    shadow_program,
)
from ..render.scene import SceneBuffers


class Mesh:
    """A named array of torch devices, one axis name per dimension (the
    port's jax.sharding.Mesh). A device may appear more than once."""

    def __init__(self, devices, axis_names: Union[str, Sequence[str]]):
        names = ((axis_names,) if isinstance(axis_names, str)
                 else tuple(axis_names))
        specs = np.array(devices, dtype=object)
        if specs.ndim != len(names) or specs.size == 0:
            raise ValueError(f"a mesh of shape {specs.shape} cannot take the "
                             f"axes {names}")
        flat = np.empty(specs.size, dtype=object)
        flat[:] = [resolve_device(d) for d in specs.ravel()]
        self.devices = flat.reshape(specs.shape)
        self.axis_names = names

    @property
    def shape(self) -> dict:
        """{axis name: size}, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, devices="
                f"{[str(d) for d in self.devices.ravel()]})")


def render_mesh(n_devices: Optional[int] = None, axis="sp",
                devices=None) -> Mesh:
    """A screen-parallel mesh. With `devices` left out it takes the
    machine's CUDA devices (the first n_devices) and raises where there
    are none. An explicit list may repeat a device (`["cpu"] * 8`,
    `["cuda:0"] * 4`); a nested list with a pair of axis names makes a 2D
    mesh (frames x bands, make_frame_parallel_banded)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "render_mesh: torch.cuda.is_available() is False; pass "
                "devices=['cpu'] * n to build a mesh on the host")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    if n_devices is not None:
        if isinstance(axis, (tuple, list)) or n_devices > len(devices):
            raise ValueError(f"render_mesh: {n_devices} devices asked of a "
                             f"{len(devices)}-device list along {axis!r}")
        devices = list(devices)[:n_devices]
    return Mesh(devices, axis)


def to_device(x, device: torch.device):
    """`x` (a tensor, or a tuple or NamedTuple of them, nested) with
    every tensor on `device`; anything else is kept as it is. A tensor
    already there is not copied. A move into a card does not wait on the
    host; a move to the host is a synchronous copy."""
    if isinstance(x, torch.Tensor):
        return x.to(device, non_blocking=device.type == "cuda")
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_device(v, device) for v in x))
    if isinstance(x, tuple):
        return tuple(to_device(v, device) for v in x)
    return x


def render_bands(cfg: FrameConfig, devices: Sequence[torch.device],
                 scene: SceneBuffers, uni: FrameUniforms, pool=None,
                 lights=None, prev_depth=None, ibl=None) -> BandOutputs:
    """The raster and shade stage of one frame, band i on devices[i]: the
    shadow pass band-wise and gathered, then every band's rows -> the
    assembled BandOutputs on devices[0], cropped to the frame's rows (the
    internal rows under TAAU), with the scalars reduced."""
    n = len(devices)
    home = devices[0]
    inputs = {d: to_device((scene, uni, pool, lights, prev_depth, ibl), d)
              for d in dict.fromkeys(devices)}
    shadows = dict.fromkeys(devices)
    if cfg.shadow_enabled:
        # A LOD scene's map takes the level mask. It reads only the models,
        # view_proj and the scene, so one mask per device serves its bands.
        masks = {d: (sc.tri_valid & lod_tri_mask(cfg, sc, u)
                     if cfg.lod_enabled else None)
                 for d, (sc, u, *_) in inputs.items()}
        parts = []
        for i, d in enumerate(devices):
            sc, u, pl = inputs[d][:3]
            parts.append(shadow_program(
                cfg, sc, u.models, u.light_space_matrix, pl,
                u.cascade_matrices, masks[d], band=BandSpec(i, n)))
        # The all-gather: the rows of every band's map, on every device.
        for d in shadows:
            shadows[d] = (
                torch.cat([to_device(m, d) for m, _ in parts], dim=-2),
                torch.stack([to_device(o, d) for _, o in parts]).amax())
    outs = []
    for i, d in enumerate(devices):
        sc, u, pl, li, pd, ib = inputs[d]
        outs.append(render_band(cfg, sc, u, shadows[d], pl, li, pd, ib,
                                band=BandSpec(i, n)))
    rows = raster_size(cfg)[1] if cfg.render_scale != 1.0 else cfg.height

    def rows_of(field):
        parts = [getattr(o, field) for o in outs]
        if parts[0] is None:
            return None
        return torch.cat([to_device(p, home) for p in parts])[:rows]

    def reduce(field, op):
        parts = [getattr(o, field) for o in outs]
        if parts[0] is None:
            return None
        return op(torch.stack([to_device(p, home) for p in parts]))

    first = outs[0]
    return BandOutputs(
        color=rows_of("color"),
        depth=rows_of("depth"),
        velocity=rows_of("velocity"),
        shadow_map=to_device(first.shadow_map, home),
        covered=reduce("covered", lambda x: x.sum(dtype=torch.int32)),
        overflow=reduce("overflow", lambda x: x.amax()),
        shadow_overflow=reduce("shadow_overflow", lambda x: x.amax()),
        visible_draws=to_device(first.visible_draws, home),
        msaa_edge_overflow=reduce("msaa_edge_overflow",
                                  lambda x: x.sum(dtype=torch.int32)),
    )


def make_sharded_frame(config: FrameConfig, mesh: Mesh, axis: str = "sp"):
    """The frame over `mesh`'s devices along `axis` (1D), band i on device
    i. Returns fn(scene, uni, pool=None, post=None, taa_params=None,
    history=None, lights=None, prev_depth=None, ibl=None) -> FrameOutputs,
    the reference's surface, on the mesh's first device. The framebuffer
    is padded so every band has the same rows; the outputs are cropped
    back. Raises (ValueError) when the shadow map does not divide into the
    bands."""
    if mesh.devices.ndim != 1 or axis not in mesh.shape:
        raise ValueError(f"make_sharded_frame needs a 1D mesh with axis "
                         f"{axis!r}, got {mesh.shape}")
    devices = list(mesh.devices)
    cfg = config

    def frame(scene: SceneBuffers, uni: FrameUniforms, pool=None, post=None,
              taa_params=None, history=None, lights=None, prev_depth=None,
              ibl=None) -> FrameOutputs:
        bo = render_bands(cfg, devices, scene, uni, pool, lights, prev_depth,
                          ibl)
        return finalize_frame(cfg, bo, post, taa_params,
                              to_device(history, devices[0]))

    return frame
