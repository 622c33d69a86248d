"""Per-stage device timing: the GpuProfiler's named-scope readout (the
port's counterpart of ash_tpu/render/pass_profiler.py).

`profile_passes` runs each stage of a frame on its own, `n` times in a row,
between two CUDA events on a CUDA device (a host clock around the calls on
the CPU, where PyTorch runs synchronously), after one warm-up call. Scope
names are the reference's: Vertex, ShadowEnd (with shadows), Setup,
Binning, Raster, GBuffer, SceneEnd. Each stage repeats on the same inputs,
so its time includes none of the host work between stages that a frame
pays; a frame's own `pass_*` scopes under torch.profiler
(ash_tpu_torch.profile_frame) give that breakdown.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import torch

from ..ops import gbuffer_cuda, geometry, shade_cuda
from ..ops.raster_cuda import rasterize
from ..ops.shade import ShadeUniforms
from . import frame


def _time(fn: Callable, n: int, device: torch.device):
    """(ms per call of fn over n calls after a warm-up, fn's output)."""
    out = fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) * 1e3 / n, out
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n, out


def profile_passes(renderer, view, proj, camera_pos,
                   n: int = 64) -> Dict[str, float]:
    """ms per scope of `renderer`'s frame seen through (view, proj); stored
    on its DeviceProfiler and in its diagnostics' GpuTimings."""
    inputs = renderer.prepare_frame(view, proj, camera_pos)
    cfg, sb, uni = inputs.config, inputs.scene.buffers, inputs.uniforms
    dev = renderer.device
    rw, rh = frame.raster_size(cfg)
    timings: Dict[str, float] = {}

    timings["Vertex"], tv = _time(lambda: geometry.transform_vertices(
        uni.models, uni.view_proj, sb.position, sb.normal, sb.tangent,
        sb.vert_draw, vert_uid=sb.vert_uid), n, dev)
    shadow_map = None
    if cfg.shadow_enabled:
        timings["ShadowEnd"], (shadow_map, _) = _time(
            lambda: frame.shadow_program(cfg, sb, uni.models,
                                         uni.light_space_matrix, inputs.pool,
                                         uni.cascade_matrices), n, dev)
    timings["Setup"], setup = _time(lambda: geometry.triangle_setup(
        tv.clip, sb.tri_v, sb.tri_valid, rw, rh, cull_mode="back"), n, dev)
    binner = frame._binner(cfg, sb.num_triangles)
    timings["Binning"], bins = _time(lambda: binner(
        setup.bbox, setup.valid, rh, rw, cfg.tile_h, cfg.tile_w,
        cfg.max_tris_per_tile), n, dev)
    timings["Raster"], vis = _time(lambda: rasterize(
        setup, bins, rh, rw, cfg.tile_h, cfg.tile_w), n, dev)
    timings["GBuffer"], gbuf = _time(lambda: gbuffer_cuda.interpolate_gbuffer(
        vis.tri_id, setup, sb.tri_v, sb.tri_draw, tv, sb.uv, sb.color,
        vert_uid=sb.vert_uid), n, dev)
    su = ShadeUniforms(
        camera_pos=uni.camera_pos, light_direction=uni.light_direction,
        light_color=uni.light_color, ambient_color=uni.ambient_color,
        light_space_matrix=uni.light_space_matrix)
    csm = ((uni.cascade_matrices, uni.cascade_splits, uni.view)
           if cfg.shadow_cascades > 1 else None)
    timings["SceneEnd"], _ = _time(lambda: shade_cuda.shade_pbr(
        gbuf, sb.materials, su, shadow_map, None, csm=csm), n, dev)

    renderer.device_profiler._samples = dict(timings)
    renderer.diagnostics_state.gpu_timings.passes = dict(timings)
    return timings
