"""Where a standard frame's time goes, on one CUDA device.

    python3 -m ash_tpu_torch.profile_frame [--frames N] [--out DIR]
        [--glass [--transparency-passes P]] [--textured] [--lights N]
        [--max-anisotropy A] [--rich [--render-scale S]]
        [--max-tris-per-tile K] [--animate] [--mega [--escalate]]
        [--occlusion] [--bf16] [--instancing] [--lod] [--ibl]
        [--msaa x2|x4|x8 [--edge]] [--overlay] [--bands N] [--example10]

Renders the bench scene (render/bench_scene.py: 1000 cubes, 1920x1080,
2048^2 shadow map), or with --glass the glass standard frame (every fourth
cube alpha 0.5, a 4-layer depth peel run P times), with --textured the
textured standard frame (four meshes with five 256x256 maps each, every
fourth cube alpha-tested, anisotropy A, 16 by default), with --lights N
bench.py's N point lights added (Forward+), and with --rich bench.py's
rich frame (HDR post with bloom and ACES, TAA, three 1024^2 shadow
cascades, 32 lights), rastered and shaded at S times the size with
--render-scale S (TAA upsampling; a tile then covers more of the scene,
so raise the main pass's tile cap with --max-tris-per-tile). With
--animate it renders bench.py's animated frame instead: each frame takes
the next pose (t += 1/60) through `update_transforms_trs` and the orbiting
camera, so the shadow map re-renders every frame. With --mega it renders
bench.py's 1,002,528-triangle frame (two-level binning, caps of 8192), and
with --escalate first grows the caps (`escalate_tile_capacities`) until no
triangle drops. --occlusion adds Hi-Z occlusion culling to the bench
scene and --bf16 shades it in bfloat16 (bench.py's --bf16). The examples'
scenes: --instancing is example 07's 65,536 instanced cubes (1080p, 8x128
tiles, a cap of 2048, Hi-Z on; the InstancingManager's seconds are
printed), --lod its 400 LOD spheres (traced from distance 15 and from 30;
the shadow map re-renders in every frame of a LOD scene), --ibl example
06's IBL sphere grid (640x400, HDR, no shadows). --msaa renders the bench
scene at an MSAA preset (x2 = 2x1, x4 = 2x2, x8 = 4x2 samples a pixel),
shading every sample, or with --edge only the edge pixels' samples
(RendererConfig.msaa_resolve="edge"); --overlay turns on the diagnostics
overlay (the text patch and the overflow taint). --bands N renders the
chosen frame through parallel.make_sharded_frame over N bands on one card
(mesh ["cuda:0"] * N, the renderer's own inputs, the shadow map rendered
in bands every frame). --example10 renders example 10's chunked frame
(10,000 instanced 98x49 spheres, 33 chunks of 312 draws, 1080p, 8x128
tiles, K=2048, no shadows). It traces N static frames
and N frames that re-render the shadow map (N animated frames with
--animate) with `torch.profiler`. For each kind it prints the wall time
per frame, the peak device memory, the device's busy and idle share of
that wall time, the kernels and copies the frame launches, device time
per `pass_*` scope (the kernels its PyTorch ops launched, the span from its
first to its last kernel on the device, and its host time), and the device
work that takes the most time. The raster kernel is launched through
ctypes, so it shows as a kernel and in its scope's device span but not in
the scope's kernel sum. With --out, the full tables and a Chrome trace are
written there.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .parallel import make_sharded_frame, render_mesh
from .render.diagnostics import DiagnosticsMode
from .render.bench_scene import (
    animated_models_trs,
    build_bench_renderer,
    build_mega_instancing_renderer,
    build_ibl_renderer,
    build_instancing_renderer,
    build_lod_renderer,
    build_mega_renderer,
    lod_camera,
    orbit_camera,
)


def _trace(step, frames):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(frames):
            step(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return prof, wall_ms


def _report(name, prof, wall_ms, frames):
    """Print one trace's summary; return its full table."""
    avgs = prof.key_averages()
    on_device = [e for e in avgs if e.device_type == DeviceType.CUDA]
    # Device events are kernels, copies and the GPU-side spans of the
    # pass_* scopes; busy time counts only the first two.
    work = [e for e in on_device if not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in work) / 1e3
    print(f"{name}: wall {wall_ms / frames:.3f} ms/frame; device busy "
          f"{busy_ms / frames:.3f} ms/frame ({100 * busy_ms / wall_ms:.1f}% "
          f"of wall, idle {100 * (1 - busy_ms / wall_ms):.1f}%); "
          f"{sum(e.count for e in work) / frames:g} kernels and copies "
          f"per frame")
    spans = {e.key: e for e in on_device if e.is_user_annotation}
    for e in sorted((e for e in avgs if e.device_type == DeviceType.CPU
                     and e.key.startswith("pass_")),
                    key=lambda e: -e.device_time_total):
        span = spans.get(e.key)
        print(f"  {e.key}: kernels {e.device_time_total / 1e3 / frames:.3f} "
              f"ms/frame, device span "
              f"{(span.device_time_total if span else 0) / 1e3 / frames:.3f} "
              f"ms/frame, host {e.cpu_time_total / 1e3 / frames:.3f} ms/frame")
    for e in sorted(work, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  device {e.key[:70]}: {e.self_device_time_total / 1e3 / frames:.3f}"
              f" ms/frame, {e.count / frames:g} per frame")
    return avgs.table(sort_by="self_device_time_total", row_limit=60)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--out", default=None)
    ap.add_argument("--glass", action="store_true")
    ap.add_argument("--transparency-passes", type=int, default=1)
    ap.add_argument("--textured", action="store_true")
    ap.add_argument("--lights", type=int, default=0)
    ap.add_argument("--max-anisotropy", type=int, default=16)
    ap.add_argument("--rich", action="store_true")
    ap.add_argument("--render-scale", type=float, default=1.0)
    ap.add_argument("--max-tris-per-tile", type=int, default=256)
    ap.add_argument("--animate", action="store_true")
    ap.add_argument("--mega", action="store_true")
    ap.add_argument("--escalate", action="store_true")
    ap.add_argument("--occlusion", action="store_true")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--instancing", action="store_true")
    ap.add_argument("--lod", action="store_true")
    ap.add_argument("--ibl", action="store_true")
    ap.add_argument("--msaa", choices=("x2", "x4", "x8"), default=None)
    ap.add_argument("--edge", action="store_true")
    ap.add_argument("--overlay", action="store_true")
    ap.add_argument("--bands", type=int, default=0)
    ap.add_argument("--example10", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_frame: needs a CUDA device", file=sys.stderr)
        return 1
    if args.example10:
        r, _, cam, _ = build_mega_instancing_renderer(1920, 1080, "cuda")
    elif args.mega:
        r, _, cam, _ = build_mega_renderer(1920, 1080, "cuda")
    elif args.instancing:
        r, _, cam, host_s = build_instancing_renderer(1920, 1080, "cuda")
        print(f"InstancingManager: {host_s:.2f} s on the host")
    elif args.lod:
        r, _ = build_lod_renderer(1920, 1080, "cuda")
        cam = lod_camera(15.0, 1920, 1080)
    elif args.ibl:
        r, _, cam = build_ibl_renderer(640, 400, "cuda")
    else:
        r, _, cam, anim = build_bench_renderer(
            1920, 1080, 1000, "cuda", glass=args.glass,
            transparency_passes=args.transparency_passes,
            textured=args.textured, lights=args.lights,
            max_anisotropy=args.max_anisotropy, rich=args.rich,
            render_scale=args.render_scale,
            max_tris_per_tile=args.max_tris_per_tile, animate=args.animate,
            occlusion=args.occlusion,
            shade_dtype="bf16" if args.bf16 else "f32",
            msaa_resolve="edge" if args.edge else "ssaa",
        )
    if args.msaa:
        r.set_msaa_preset(args.msaa)
    if args.overlay:
        r.set_diagnostics_mode(DiagnosticsMode.OVERLAY_ONLY)
    view, proj, pos = cam.view_matrix(), cam.projection_matrix(), cam.position
    for _ in range(3):  # build the kernel, the scene and the shadow map
        r.render_frame(view, proj, pos)
    for _ in range(4 if args.escalate else 0):
        out = r.last_outputs()
        changed = r.escalate_tile_capacities(int(out.binning_overflow),
                                             int(out.shadow_overflow))
        if not changed:
            break
        print(f"escalated: {changed}")
        r.render_frame(view, proj, pos)
    lights = ([-0.5, -1.0, -0.3], [-0.45, -1.0, -0.35])
    clock = [0.0]

    def animated(i):
        clock[0] += 1.0 / 60.0
        r.update_transforms_trs(*animated_models_trs(anim, clock[0]))
        r.render_frame(orbit_camera(cam, anim["extent"], clock[0]), proj,
                       cam.position)

    if args.bands:
        cfg, scene, uni, pool, lights, post, taa = r.prepare_frame(view, proj,
                                                                   pos)
        history = (None if taa is None else
                   torch.zeros((cfg.height, cfg.width, 3), device="cuda"))
        sharded = make_sharded_frame(
            cfg, render_mesh(devices=["cuda:0"] * args.bands))

        def static(i):
            sharded(scene.buffers, uni, pool, post, taa, history,
                    lights).image.cpu()
    else:
        def static(i):
            r.render_frame(view, proj, pos)

    def shadow(i):
        r.shadow_feature.set_light_direction(lights[i % 2])
        r.render_frame(view, proj, pos)

    far = lod_camera(30.0, 1920, 1080)

    def lod_far(i):
        r.render_frame(far.view_matrix(), far.projection_matrix(),
                       far.position)

    out = r.last_outputs()
    shadow_of = (None if out.shadow_overflow is None
                 else int(out.shadow_overflow))
    edge_of = (None if out.msaa_edge_overflow is None
               else int(out.msaa_edge_overflow))
    print(f"device: {torch.cuda.get_device_name(0)}; overflow main "
          f"{int(out.binning_overflow)}, shadow {shadow_of}; visible draws "
          f"{None if out.visible_draws is None else int(out.visible_draws)}; "
          f"msaa_edge_overflow {edge_of}")
    del out  # or the peak would count a second frame's outputs
    if args.animate:
        kinds = (("animated", animated),)
    elif args.bands or args.example10:
        kinds = (("static", static),)
    elif args.lod:
        kinds = (("near", static), ("far", lod_far))
    elif args.ibl:
        kinds = (("static", static),)
    else:
        kinds = (("static", static), ("shadow_rerender", shadow))
    for name, step in kinds:
        torch.cuda.reset_peak_memory_stats()
        prof, wall_ms = _trace(step, args.frames)
        print(f"{name}: peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
        table = _report(name, prof, wall_ms, args.frames)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, f"{name}_table.txt"), "w") as f:
                f.write(table)
            prof.export_chrome_trace(os.path.join(args.out, f"{name}_trace.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
