#!/usr/bin/env python3
"""Drive the PyTorch port's standard frame and glass frame on one NVIDIA GPU.

Run from the repository root with no arguments: `python3 chip_smoke.py`.
It needs one CUDA device and `nvcc`; it exits non-zero without a result when
CUDA is absent, when the repository is not beside it, or when any phase
fails. Phases, one stdout line each:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: compiles ash_tpu_torch/csrc/raster.cu, which holds both kernels
   (the one-layer raster and the K-layer depth peel), and prints each
   instantiation's registers and spills;
3. kernels against plain: each CUDA kernel and the plain PyTorch raster on
   the same CUDA tensors at the main path's shapes; tri_id and depth of
   every layer must be equal bit for bit. One layer: the 1080p main pass
   (64x128 tiles), the 2048^2 shadow pass (32x128 tiles), K=256, and a
   y0 band. The peel: the 1080p main pass at 2, 4 and 8 layers, 4 layers
   under a floor taken from the first pass's deepest layer, 4 layers in a
   y0 band, and the 2048^2 shadow shapes at 2 layers;
4. the slice: the standard frame (1000 instanced PBR cubes, bench.py's
   recipe) rendered at 1920x1080 through ash_tpu_torch.Renderer: the
   one-layer kernel runs twice on frame 1 and once per static frame after
   (cached shadow map), the peel never. Then the glass standard frame
   (every fourth cube alpha 0.5, 4 peel layers) with 1 and with 2
   transparency passes: the peel runs once per pass per frame and the
   one-layer kernel once, for the shadow map of frame 1. Every frame has
   no binning overflow, finite colour, and equals the same frame rendered
   with the plain raster; static frames are equal. The golden scenes
   (cube_pbr, flat_cube, k_layer_stack) reach PSNR >= 40 dB against
   tests/golden/, and the small bench and small glass scenes on the card
   against the port's CPU render;
5. times (CUDA events): static frame, frame with a shadow re-render, the
   glass frames, and each kernel against the plain raster.

Then one JSON line on the kernels and, last, the device JSON line.
"""

import json
import os
import re
import statistics
import subprocess
import sys
import time
from unittest import mock


def check(cond, what):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def cuda_ms(fn, n):
    """Mean device time of n calls of fn, by CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def frame_ms(step, n):
    """Median of n frames, each timed by CUDA events around `step` (a frame
    ends in its image's copy to the host, so the events span all of it)."""
    import torch

    times = []
    for i in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(i)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ptxas_usage(log):
    """{instantiation: "R registers, S spill bytes"} from nvcc's -Xptxas -v
    log; raster_kernel<L, HAS_FLOOR> is named by its L and floor."""
    usage, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"raster_kernelILi(\d+)ELb([01])E", ln)
        if "Compiling entry function" in ln and m:
            name = f"L={m.group(1)}{' floor' if m.group(2) == '1' else ''}"
            spill = None
        elif name and "spill stores" in ln:
            spill = sum(int(x) for x in re.findall(r"(\d+) bytes spill", ln))
        elif name and "Used" in ln and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            usage[name] = f"{regs} registers, {spill} spill bytes"
            name = None
    return usage


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)

    import ash_tpu_torch
    from ash_tpu_torch.ops import _build, binning, raster, raster_cuda
    from ash_tpu_torch.render import frame, golden_scenes
    from ash_tpu_torch.render.bench_scene import build_bench_renderer

    # 1. Device.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"phase1 device: {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | {kind}", flush=True)

    # 2. Build.
    t0 = time.perf_counter()
    lib = _build.build("raster")
    build_s = time.perf_counter() - t0
    usage = ptxas_usage(lib.with_suffix(".log").read_text())
    check(len(usage) == 15, f"{len(usage)} kernel instantiations, want 15")
    print(f"phase2 build: {lib.name} (both kernels) in {build_s:.3f} s; "
          + "; ".join(f"{k}: {v}" for k, v in sorted(usage.items())),
          flush=True)

    # 3. Kernel against plain at the main path's shapes.
    r, _, cam, _ = build_bench_renderer(1920, 1080, 1000, "cuda")
    view, proj, pos = cam.view_matrix(), cam.projection_matrix(), cam.position
    cfg, scene, uni = r.prepare_frame(view, proj, pos)
    _, setup, bins, _ = frame.main_pass_bins(cfg, scene.buffers, uni)
    setup_s, bins_s = frame.shadow_pass_bins(
        cfg, scene.buffers, frame.shadow_world(scene.buffers, uni.models),
        uni.light_space_matrix,
    )
    band_y0, band_h = 512, 512
    bins_band = binning.bin_triangles(
        setup.bbox, setup.valid, band_h, cfg.width, cfg.tile_h, cfg.tile_w,
        cfg.max_tris_per_tile, y0=band_y0,
    )
    s = cfg.shadow_resolution
    passes = {
        "main": (setup, bins, cfg.height, cfg.width, cfg.tile_h, cfg.tile_w, 0),
        "shadow": (setup_s, bins_s, s, s, cfg.shadow_rows, cfg.shadow_tile, 0),
        "band": (setup, bins_band, band_h, cfg.width, cfg.tile_h, cfg.tile_w,
                 band_y0),
    }
    max_err = 0.0
    for name, args in passes.items():
        got = raster_cuda.rasterize(*args)
        want = raster.rasterize(*args)
        torch.cuda.synchronize()
        tid_bad = int((got.tri_id != want.tri_id).sum())
        depth_bad = int((got.depth != want.depth).sum())
        err = float((got.depth - want.depth).abs().max())
        max_err = max(max_err, err)
        h, w, th, tw = args[2:6]
        print(f"phase3 {name}: {w}x{h} tiles {th}x{tw} "
              f"K={args[1].tri_ids.shape[1]} y0={args[6]}: tri_id mismatches "
              f"{tid_bad}, depth mismatches {depth_bad}, max |depth err| {err}, "
              f"covered {int((got.tri_id >= 0).sum())}, max tile count "
              f"{int(args[1].counts.max())}, overflow {int(args[1].overflow)}",
              flush=True)
        check(tid_bad == 0 and depth_bad == 0, f"kernel != plain on {name}")

    # The K-layer peel: (pass, layers, floor).
    floor4 = raster.rasterize(*passes["main"][:6], layers=4).layer(3)[0]
    peel_cases = [("main", 2, None), ("main", 4, None), ("main", 8, None),
                  ("main", 4, floor4), ("band", 4, None), ("shadow", 2, None)]
    max_err_layers = 0.0
    for name, layers, floor in peel_cases:
        args = passes[name]
        kw = dict(y0=args[6], layers=layers, depth_floor=floor)
        got = raster_cuda.rasterize(*args[:6], **kw)
        want = raster.rasterize(*args[:6], **kw)
        torch.cuda.synchronize()
        tid_bad = depth_bad = 0
        err = 0.0
        covered = []
        for i in range(layers):
            (gd, gt), (wd, wt) = got.layer(i), want.layer(i)
            tid_bad += int((gt != wt).sum())
            depth_bad += int((gd != wd).sum())
            err = max(err, float((gd - wd).abs().max()))
            covered.append(int((gt >= 0).sum()))
        max_err_layers = max(max_err_layers, err)
        h, w, th, tw = args[2:6]
        print(f"phase3 peel {name}: {w}x{h} tiles {th}x{tw} y0={args[6]} "
              f"layers={layers} floor={floor is not None}: tri_id mismatches "
              f"{tid_bad}, depth mismatches {depth_bad} (all layers), max "
              f"|depth err| {err}, covered per layer {covered}", flush=True)
        check(tid_bad == 0 and depth_bad == 0,
              f"peel kernel != plain on {name}, {layers} layers")
        check(covered[1] > 0, f"peel on {name}: empty second layer")

    # 4. The slice, through the renderer; count the kernels' launches on
    # each path from 0.
    raster_cuda.rasterize.launches = 0
    raster_cuda.rasterize.layer_launches = 0
    deltas, outs = [], []
    for _ in range(6):
        before = raster_cuda.rasterize.launches
        outs.append(r.render_frame(view, proj, pos))
        deltas.append(raster_cuda.rasterize.launches - before)
    launches = {"standard": raster_cuda.rasterize.launches}
    layer_launches = {"standard": raster_cuda.rasterize.layer_launches}
    image = r.read_back().copy()
    out = outs[0]
    check(deltas == [2, 1, 1, 1, 1, 1],
          f"kernel launches per frame {deltas}, want [2, 1, 1, 1, 1, 1]")
    check(layer_launches["standard"] == 0,
          f"the opaque frame launched the peel {layer_launches['standard']}x")
    check(image.shape == (1080, 1920, 4) and image.dtype.name == "uint8",
          f"image {image.shape} {image.dtype}")
    check(bool(torch.isfinite(out.color).all()), "non-finite colour")
    check(int(out.binning_overflow) == 0 and int(out.shadow_overflow) == 0,
          f"overflow main {int(out.binning_overflow)} "
          f"shadow {int(out.shadow_overflow)}")
    covered = int(out.covered_pixels)
    check(covered > 0, "no covered pixels")
    check(all(o.image.equal(out.image) for o in outs[1:]), "static frames differ")

    r_plain, _, _, _ = build_bench_renderer(1920, 1080, 1000, "cuda")
    with mock.patch.object(frame, "rasterize", raster.rasterize):
        r_plain.render_frame(view, proj, pos)
    plain_equal = bool((r_plain.read_back() == image).all())
    check(plain_equal, "frame with the kernel != frame with the plain raster")

    # The glass standard frame, with 1 and 2 transparency passes.
    glass = {}
    for tp in (1, 2):
        rg, _, _, _ = build_bench_renderer(1920, 1080, 1000, "cuda",
                                           glass=True, transparency_passes=tp)
        path = f"glass_passes{tp}"
        raster_cuda.rasterize.launches = 0
        raster_cuda.rasterize.layer_launches = 0
        one, peel, gouts = [], [], []
        for _ in range(4):
            b1 = raster_cuda.rasterize.launches
            b2 = raster_cuda.rasterize.layer_launches
            gouts.append(rg.render_frame(view, proj, pos))
            one.append(raster_cuda.rasterize.launches - b1)
            peel.append(raster_cuda.rasterize.layer_launches - b2)
        launches[path] = raster_cuda.rasterize.launches
        layer_launches[path] = raster_cuda.rasterize.layer_launches
        gout = gouts[0]
        gimage = rg.read_back().copy()
        check(peel == [tp] * 4, f"{path}: peel launches per frame {peel}")
        check(one == [1, 0, 0, 0], f"{path}: one-layer launches {one}")
        check(bool(torch.isfinite(gout.color).all()), f"{path}: non-finite")
        check(int(gout.binning_overflow) == 0
              and int(gout.shadow_overflow) == 0, f"{path}: overflow")
        check(all(o.image.equal(gout.image) for o in gouts[1:]),
              f"{path}: static frames differ")
        rg_plain, _, _, _ = build_bench_renderer(
            1920, 1080, 1000, "cuda", glass=True, transparency_passes=tp)
        with mock.patch.object(frame, "rasterize", raster.rasterize):
            rg_plain.render_frame(view, proj, pos)
        gequal = bool((rg_plain.read_back() == gimage).all())
        check(gequal, f"{path}: frame with the kernels != plain-raster frame")
        opaque_psnr = ash_tpu_torch.psnr(gimage, image)
        check(opaque_psnr < 40.0, f"{path}: the glass does not show")
        glass[tp] = (rg, peel, one, gout, gequal, opaque_psnr)
        del rg_plain

    goldens = {}
    for name, scene_fn in golden_scenes.SCENES.items():
        golden = ash_tpu_torch.read_png(
            os.path.join(repo, "tests", "golden", f"{name}.png"))
        goldens[name] = ash_tpu_torch.psnr(scene_fn("cuda").read_back(), golden)
        check(goldens[name] >= 40.0, f"{name} PSNR {goldens[name]:.2f} dB < 40")
    small_psnr = {}
    for small_glass in (False, True):
        rs, _, scam, _ = build_bench_renderer(192, 128, 64, "cuda",
                                              glass=small_glass)
        rc, _, _, _ = build_bench_renderer(192, 128, 64, "cpu",
                                           glass=small_glass)
        for rr in (rs, rc):
            rr.render_frame(scam.view_matrix(), scam.projection_matrix(),
                            scam.position)
        name = "small glass" if small_glass else "small bench"
        small_psnr[name] = ash_tpu_torch.psnr(rs.read_back(), rc.read_back())
        check(small_psnr[name] >= 40.0,
              f"{name} card vs CPU {small_psnr[name]:.2f} dB")
    print(f"phase4 slice: {cfg.width}x{cfg.height}, {scene.num_draws} cubes, "
          f"{scene.num_triangles} triangles: kernel "
          f"launches per frame {deltas}; overflow main "
          f"{int(out.binning_overflow)} shadow {int(out.shadow_overflow)}; "
          f"covered {covered}; visible draws {int(out.visible_draws)}; "
          f"equal to the plain-raster frame: {plain_equal}; golden PSNR "
          + ", ".join(f"{k} {v:.2f} dB" for k, v in goldens.items())
          + "; " + ", ".join(f"{k} card vs CPU {v:.2f} dB"
                             for k, v in small_psnr.items()), flush=True)
    for tp, (_, peel, one, gout, gequal, opaque_psnr) in glass.items():
        print(f"phase4 glass frame, passes={tp}: peel launches per frame "
              f"{peel}, one-layer launches per frame {one}; overflow main "
              f"{int(gout.binning_overflow)} shadow "
              f"{int(gout.shadow_overflow)}; covered "
              f"{int(gout.covered_pixels)}; equal to the plain-raster frame: "
              f"{gequal}; PSNR against the opaque frame {opaque_psnr:.2f} dB",
              flush=True)

    # 5. Times.
    static_ms = frame_ms(lambda i: r.render_frame(view, proj, pos), 20)
    lights = ([-0.5, -1.0, -0.3], [-0.45, -1.0, -0.35])

    def shadow_frame(i):
        r.shadow_feature.set_light_direction(lights[i % 2])
        r.render_frame(view, proj, pos)

    shadow_frame_ms = frame_ms(shadow_frame, 10)
    glass_ms = {tp: frame_ms(lambda i, rg=g[0]: rg.render_frame(view, proj, pos),
                             10)
                for tp, g in glass.items()}
    kernel_ms, plain_ms = {}, {}
    timed = [("main", 1), ("shadow", 1), ("main", 2), ("main", 4), ("main", 8)]
    for name, layers in timed:
        args = passes[name]
        k, p = [], []
        for order in ("plain", "kernel", "kernel", "plain"):
            if order == "kernel":
                k.append(cuda_ms(lambda: raster_cuda.rasterize(
                    *args[:6], layers=layers), 50))
            else:
                p.append(cuda_ms(lambda: raster.rasterize(
                    *args[:6], layers=layers), 3))
        kernel_ms[name, layers] = statistics.mean(k)
        plain_ms[name, layers] = statistics.mean(p)
    print(f"phase5 times on {card}: static frame {static_ms} ms, frame with "
          f"shadow re-render {shadow_frame_ms} ms (medians of 20 and 10); "
          f"glass frame passes=1 {glass_ms[1]} ms, passes=2 {glass_ms[2]} ms "
          f"(medians of 10); raster main 1080p kernel "
          f"{kernel_ms['main', 1]} ms vs plain {plain_ms['main', 1]} ms; "
          f"raster shadow 2048^2 kernel {kernel_ms['shadow', 1]} ms vs plain "
          f"{plain_ms['shadow', 1]} ms; "
          + "; ".join(f"peel main 1080p {k} layers kernel "
                      f"{kernel_ms['main', k]} ms vs plain "
                      f"{plain_ms['main', k]} ms" for k in (2, 4, 8)),
          flush=True)

    check("jax" not in sys.modules, "jax was imported")
    print(json.dumps({"kernels": [{
        "name": "raster",
        "route": "cuda",
        "source": "ash_tpu_torch/csrc/raster.cu",
        "replaces": "ash_tpu/ops/raster_pallas.py:106",
        "launches": sum(launches.values()),
        "launches_by_path": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms["main", 1],
        "plain_ms": plain_ms["main", 1],
        "shadow_ms": kernel_ms["shadow", 1],
        "shadow_plain_ms": plain_ms["shadow", 1],
    }, {
        "name": "raster_layers",
        "route": "cuda",
        "source": "ash_tpu_torch/csrc/raster.cu",
        "replaces": "ash_tpu/ops/raster_pallas.py:138",
        "launches": sum(layer_launches.values()),
        "launches_by_path": layer_launches,
        "max_abs_err": max_err_layers,
        "ms": kernel_ms["main", 4],
        "plain_ms": plain_ms["main", 4],
        "ms_by_layers": {k: kernel_ms["main", k] for k in (2, 4, 8)},
        "plain_ms_by_layers": {k: plain_ms["main", k] for k in (2, 4, 8)},
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
