"""Frame-parallel rendering: each device renders a different frame (port of
ash_tpu/parallel/frame_parallel.py).

The second axis beside screen bands (sharded.py): bands cut one frame's
latency, frames raise the throughput of many, the axis for offline and
animation rendering. The scene and the texture pool are replicated, the
per-frame uniforms are split along the mesh, and device i renders frame i
through the whole single-device frame (`render_frame_program`), with no
exchange between devices.

TAA serializes only the resolve, not the render: with taa_enabled every
device renders its frame, then the resolves run in the reference's ring
order. Frame j blends against frame j-1's resolved history, moved to
device j; frame 0 takes `history0`, which chains batches. An n-frame batch
costs about render / n + n x resolve a frame in place of render + resolve.

`make_frame_parallel_banded` composes the two axes over a 2D mesh: along
the frame axis different frames, along the band axis the bands of one
frame (sharded.render_bands). Outputs carry a leading frame axis and sit on
the mesh's first device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.taa import TaaParams, taa_resolve
from ..render import compiled
from ..render.frame import (
    FrameConfig,
    FrameOutputs,
    FrameUniforms,
    finalize_frame,
    render_band,
    render_frame_program,
    shadow_program,
)
from ..render.scene import SceneBuffers
from .sharded import Mesh, render_bands, to_device


def _tensor(x, device: torch.device) -> torch.Tensor:
    """A tensor, or a numpy array (float64 taken as float32, as jax takes
    it), on `device`."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
        x = torch.from_numpy(np.ascontiguousarray(
            x.astype(np.float32) if x.dtype == np.float64 else x))
    return to_device(x, device)


def _frame_of(batch, i: int, device: torch.device):
    """Frame i of a batched NamedTuple (numpy arrays or tensors with a
    leading frame axis) on `device`; None fields stay None."""
    return type(batch)(*(None if x is None else _tensor(x[i], device)
                         for x in batch))


def _lead(uni_batch) -> int:
    return next(x for x in uni_batch if x is not None).shape[0]


def _stack(outs: list, home: torch.device) -> FrameOutputs:
    """Per-frame FrameOutputs -> one with a leading frame axis on `home`."""
    return FrameOutputs(*(
        None if getattr(outs[0], f) is None
        else torch.stack([to_device(getattr(o, f), home) for o in outs])
        for f in FrameOutputs._fields))


def _shadow(cfg: FrameConfig, scene, uni, pool):
    """The frame's shadow map, or None: without shadows, or for a LOD
    frame, which renders its whole map inside render_band under its level
    mask (one device renders the whole frame here, as in the reference)."""
    if not cfg.shadow_enabled or cfg.lod_enabled:
        return None
    return shadow_program(cfg, scene, uni.models, uni.light_space_matrix,
                          pool, uni.cascade_matrices)


def make_frame_parallel(config: FrameConfig, mesh: Mesh, axis: str = "fp"):
    """Frame i of a batch on device i of the 1D `mesh`. Returns fn(scene,
    uni_batch, pool=None, post=None, lights=None, ibl=None, taa_batch=None,
    history0=None) -> FrameOutputs: every field of `uni_batch` (and of
    `lights` and `taa_batch`, if given) carries a leading axis of the mesh's
    n frames, and so does every output. With config.taa_enabled,
    `taa_batch` (TaaParams of host arrays) and `history0` ((H, W, 3), the
    history before the batch's first frame, zeros when None) drive the
    resolve ring; outputs.history[i] is frame i's resolved frame (feed
    history[n - 1] to the next batch)."""
    if config.taa_enabled and config.render_scale != 1.0:
        raise ValueError(
            "frame-parallel TAA does not support render_scale (TAAU); "
            "use band mode")
    if mesh.devices.ndim != 1 or axis not in mesh.shape:
        raise ValueError(f"make_frame_parallel needs a 1D mesh with axis "
                         f"{axis!r}, got {mesh.shape}")
    devices = list(mesh.devices)
    n = len(devices)
    cfg = config

    def frames(scene: SceneBuffers, uni_batch: FrameUniforms, pool=None,
               post=None, lights=None, ibl=None, taa_batch=None,
               history0=None) -> FrameOutputs:
        lead = _lead(uni_batch)
        if lead != n:
            raise ValueError(
                f"uniform batch has {lead} frames, mesh has {n} devices")
        if not cfg.taa_enabled and taa_batch is not None:
            raise ValueError("taa_batch given but config.taa_enabled=False")
        if cfg.taa_enabled and taa_batch is None:
            raise ValueError(
                "config.taa_enabled needs taa_batch (TaaParams with a "
                "leading frame axis) and history0")
        for _ in range(n):  # a frame a device, each eager
            compiled.count_eager("farm")
        reps = {d: to_device((scene, pool, ibl), d)
                for d in dict.fromkeys(devices)}
        args = []
        for i, d in enumerate(devices):
            sc, pl, ib = reps[d]
            uni = _frame_of(uni_batch, i, d)
            li = None if lights is None else _tensor(lights[i], d)
            args.append((sc, uni, pl, li, ib))
        if not cfg.taa_enabled:
            outs = [render_frame_program(cfg, sc, uni, _shadow(cfg, sc, uni, pl),
                                         pl, li, post, None, None, None, ib)
                    for sc, uni, pl, li, ib in args]
            return _stack(outs, devices[0])
        # Every frame renders first; then the resolves run in ring order.
        bands = [render_band(cfg, sc, uni, _shadow(cfg, sc, uni, pl), pl, li,
                             None, ib) for sc, uni, pl, li, ib in args]
        incoming = (torch.zeros((cfg.height, cfg.width, 3),
                                dtype=torch.float32, device=devices[0])
                    if history0 is None else history0)
        outs = []
        for j, (d, bo) in enumerate(zip(devices, bands)):
            taa = TaaParams(*(np.asarray(x)[j] for x in taa_batch))
            resolved = taa_resolve(bo.color, to_device(incoming, d), taa,
                                   velocity=bo.velocity)
            # taa_params=None: the post chain after the resolve only.
            out = finalize_frame(cfg, bo._replace(color=resolved), post)
            outs.append(out._replace(history=resolved))
            incoming = resolved
        return _stack(outs, devices[0])

    return frames


def batch_uniforms(unis: list):
    """Stack per-frame NamedTuples (FrameUniforms, TaaParams) field by field
    into one with a leading frame axis: tensors with torch.stack, anything
    else with np.stack; a field None in every frame stays None."""
    def stack(xs):
        if all(x is None for x in xs):
            return None
        if isinstance(xs[0], torch.Tensor):
            return torch.stack(xs)
        return np.stack([np.asarray(x) for x in xs])

    return type(unis[0])(*(stack(xs) for xs in zip(*unis)))


def make_frame_parallel_banded(config: FrameConfig, mesh: Mesh,
                               frame_axis: str = "fp", band_axis: str = "sp"):
    """Frames x screen bands over a 2D `mesh`: row i of the mesh renders
    frame i, each of its devices one band of it. Returns fn(scene,
    uni_batch, pool=None, post=None, lights=None, prev_depth_batch=None,
    ibl=None) -> FrameOutputs with a leading frame axis on every per-frame
    field. TAA and TAAU are not supported (the resolve's history crosses
    band boundaries; use a 1D mode for TAA)."""
    if config.taa_enabled or config.render_scale != 1.0:
        raise ValueError(
            "make_frame_parallel_banded supports neither TAA nor TAAU "
            "(history reprojection crosses band boundaries); use "
            "make_frame_parallel (frames) or make_sharded_frame (bands)")
    if mesh.axis_names != (frame_axis, band_axis):
        raise ValueError(f"mesh axes {mesh.axis_names} are not "
                         f"({frame_axis!r}, {band_axis!r})")
    rows = [list(r) for r in mesh.devices]
    nf = mesh.shape[frame_axis]
    cfg = config

    def frames(scene: SceneBuffers, uni_batch: FrameUniforms, pool=None,
               post=None, lights=None, prev_depth_batch=None,
               ibl=None) -> FrameOutputs:
        lead = _lead(uni_batch)
        if lead != nf:
            raise ValueError(
                f"uniform batch has {lead} frames, mesh frame axis has {nf}")
        outs = []
        for i, devs in enumerate(rows):
            compiled.count_eager("farm bands")
            home = devs[0]
            bo = render_bands(
                cfg, devs, scene, _frame_of(uni_batch, i, home), pool,
                None if lights is None else _tensor(lights[i], home),
                None if prev_depth_batch is None else prev_depth_batch[i],
                ibl)
            outs.append(finalize_frame(cfg, bo, post))
        return _stack(outs, rows[0][0])

    return frames
