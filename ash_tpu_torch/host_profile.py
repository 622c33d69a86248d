"""Where the frame loop's host time goes (port of tools/host_profile.py).

    python3 -m ash_tpu_torch.host_profile [--frames 200] [--objects 1000]
        [--static] [--matrices] [--small] [--device cuda|cpu] [--cprofile]

Drives the benchmark's animated frame loop (render/bench_scene.py at
1920x1080, 1000 cubes): each frame takes the next pose, t += 1/60, through
`animated_models_trs` + `update_transforms_trs` and the orbiting camera
(`orbit_camera`), so the shadow map re-renders every frame. --matrices
feeds the reference tool's update instead (`animated_models` +
`update_transforms`); --static drives the standard frame (no update, a
static camera, the shadow map cached after frame 0). --small renders
160x120 with 16 objects. The frames that build the kernels, the scene and
the shadow map run before the clock starts.

The untimed work is the reference's: the loop's host time per frame in
buckets (animation math, the update, camera math, `render_frame`, loop
overhead) and the device drain, a `torch.cuda.synchronize()` after the
loop where the reference blocks on the last image. The port's
`render_frame` ends in the image's blocking copy to the host, so most of
the drain hides inside it. A second loop over the same poses runs under
`torch.profiler` (CPU and CUDA activities, no stacks) and splits
`render_frame`'s host time into spans read from the trace: the frame's
preparation (with the constants' upload, the longest host-to-device
`aten::to` in it), each `pass_*` scope's own host time with its kernel
launches and copies (CUDA runtime calls) and ctypes raster calls, the time
between scopes, the image copy's wait (from the copy's start until it
returns) and the rest (present, diagnostics). The traced loop's ms a frame
is printed beside the untraced one: the difference is the profiler's cost.

Checks: the buckets add up to the loop's host time, and the spans to the
traced loop's `render_frame` time within 1%. The last line is one JSON
object with every bucket and span (ms a frame), the frame count, the scene
and the card's name and power limit (nvidia-smi). --cprofile adds a
cProfile top-40 of a third loop over the same poses, by cumulative time.
Nothing here changes what a frame does; the tool adds no host sync inside
a frame.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import subprocess
import sys
import time
from typing import Dict, Optional

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from .device import resolve_device
from .ops import raster_cuda
from .render.bench_scene import (
    animated_models,
    animated_models_trs,
    build_bench_renderer,
    orbit_camera,
)

FRAME_DT = 1.0 / 60.0
BUCKETS = ("anim_math", "update_transforms", "orbit_camera", "render_frame")
# The tool's own markers in the trace: one range around each render_frame
# call and an instant at each ctypes raster call.
FRAME_MARK = "host_profile.render_frame"
RASTER_MARK = "host_profile.raster_call"
# Kernels of the port's ctypes library (csrc/raster.cu): a runtime launch
# of one of these is part of a ctypes raster call, counted once as that.
CTYPES_KERNELS = ("raster_warp_kernel", "candidate_rects_kernel")
SPLIT_TOLERANCE = 0.01
# What each span counts: CUDA runtime calls by kind, and ctypes raster calls.
COUNTS = ("kernel_launches", "copies", "syncs", "raster_calls")


def card_info(device: torch.device) -> Optional[str]:
    """The card's name and power limit as nvidia-smi prints them, or None
    on the CPU."""
    if device.type != "cuda":
        return None
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[device.index or 0]


class FrameLoop:
    """The bench scene and its frame loop. `step(t, buckets)` renders the
    pose at time t, adding each part's host seconds to `buckets`."""

    def __init__(self, device, objects: int = 1000, static: bool = False,
                 matrices: bool = False, small: bool = False):
        self.device = resolve_device(device)
        self.static, self.matrices = static, matrices
        self.width, self.height = (160, 120) if small else (1920, 1080)
        self.objects = objects
        # The animated cell's main cap: 256 drops triangles in frames
        # 45-77 of the orbit (benchmark/cells/animated-1080p-1000obj.json).
        caps = {} if static or small else {"max_tris_per_tile": 512}
        self.renderer, _, self.camera, self.anim = build_bench_renderer(
            self.width, self.height, objects, self.device, animate=True,
            **caps)
        self.proj = self.camera.projection_matrix()
        self.view = self.camera.view_matrix()
        self.traced = False

    @property
    def scene(self) -> str:
        return "standard" if self.static else "animated"

    @property
    def update(self) -> str:
        return "none" if self.static else (
            "matrices" if self.matrices else "trs")

    def warm_up(self) -> float:
        """The reference's warm-up: one frame at the static camera (the
        kernels, the scene, the shadow map), then one at pose 0.01 (the
        animated path; a second static frame with --static). -> seconds of
        the first frame."""
        t0 = time.perf_counter()
        self.renderer.render_frame(self.view, self.proj, self.camera.position)
        first = time.perf_counter() - t0
        self.step(0.01, dict.fromkeys(BUCKETS, 0.0))
        self.sync()
        return first

    def step(self, t: float, buckets: Dict[str, float]) -> None:
        r, cam = self.renderer, self.camera
        if not self.static:
            t0 = time.perf_counter()
            pose = (animated_models(self.anim, t) if self.matrices
                    else animated_models_trs(self.anim, t))
            t1 = time.perf_counter()
            if self.matrices:
                r.update_transforms(pose)
            else:
                r.update_transforms_trs(*pose)
            t2 = time.perf_counter()
            self.view = orbit_camera(cam, self.anim["extent"], t)
            t3 = time.perf_counter()
            buckets["anim_math"] += t1 - t0
            buckets["update_transforms"] += t2 - t1
            buckets["orbit_camera"] += t3 - t2
        with (record_function(FRAME_MARK) if self.traced
              else contextlib.nullcontext()):
            t0 = time.perf_counter()
            r.render_frame(self.view, self.proj, cam.position)
            buckets["render_frame"] += time.perf_counter() - t0

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, n: int) -> dict:
        """The timed loop over poses 1..n -> {"buckets": seconds each,
        "host": the loop's host seconds, "total": with the drain}."""
        buckets = dict.fromkeys(BUCKETS, 0.0)
        self.sync()
        t_loop = time.perf_counter()
        for i in range(1, n + 1):
            self.step(i * FRAME_DT, buckets)
        t_host = time.perf_counter() - t_loop
        self.sync()
        return {"buckets": buckets, "host": t_host,
                "total": time.perf_counter() - t_loop}


def _traced(loop: FrameLoop, n: int):
    """The same loop under torch.profiler, each ctypes raster call marked.
    -> (its run() result, the profiler)."""
    acts = [ProfilerActivity.CPU]
    if loop.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)

    def mark(inputs, outputs):
        with record_function(RASTER_MARK):
            pass

    raster_cuda.rasterize.observers.append(mark)
    loop.traced = True
    try:
        with profile(activities=acts) as prof:
            res = loop.run(n)
    finally:
        loop.traced = False
        raster_cuda.rasterize.observers.remove(mark)
    return res, prof


def _segments(lo, hi, intervals, base="base"):
    """Non-overlapping (start, end, owner) covering [lo, hi): each instant
    belongs to the innermost of the nested `intervals` (start, end, name)
    that holds it, else to `base`."""
    out, stack, t = [], [], lo

    def emit(upto):
        nonlocal t
        if upto > t:
            out.append((t, upto, stack[-1][1] if stack else base))
            t = upto

    def close():
        emit(stack[-1][0])
        stack.pop()

    for s, e, name in sorted(intervals, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            close()
        emit(s)
        stack.append((e, name))
    while stack:
        close()
    emit(hi)
    return out


def _kind(name: str) -> Optional[str]:
    """What a CUDA runtime call is: a kernel launch, a copy, a sync."""
    if "LaunchKernel" in name:
        return "kernel_launches"
    if name.startswith(("cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset")):
        return "copies"
    if name.startswith(("cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize")):
        return "syncs"
    return None


def split_render_frame(prof, frames: int) -> dict:
    """render_frame's host time per frame, by span, from the trace: ms and
    counts of CUDA runtime calls (kernel launches, copies, syncs) and ctypes
    raster calls in each. A runtime launch of the ctypes library's kernels
    counts as part of its raster call, not again as a launch."""
    cpu, ctypes_corr = [], set()
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        # Host ranges and the runtime calls (host events, whatever device
        # the trace files them under); the device's kernels only by name.
        if e.device_type() == DeviceType.CPU or _kind(name):
            cpu.append((e.start_ns(), e.start_ns() + e.duration_ns(), name,
                        e.correlation_id()))
        elif name.startswith(CTYPES_KERNELS):
            ctypes_corr.add(e.correlation_id())
    cpu.sort()
    marks = [(s, e) for s, e, name, _ in cpu if name == FRAME_MARK]
    starts = [s for s, *_ in cpu]
    ms: Dict[str, float] = {}
    counts: Dict[str, Dict[str, int]] = {}
    calls: Dict[str, int] = {}
    upload_ns = 0
    for fs, fe in marks:
        inside = cpu[bisect.bisect_left(starts, fs):
                     bisect.bisect_left(starts, fe)]
        passes = [(s, e, n) for s, e, n, _ in inside if n.startswith("pass_")]
        for *_, n in passes:
            calls[n] = calls.get(n, 0) + 1
        first = min((s for s, *_ in passes), default=fe)
        last = max((e for _, e, _ in passes), default=fs)
        copies_after = [(s, e) for s, e, n, _ in inside
                        if n == "aten::to" and s >= last]
        spans = list(passes)
        if copies_after:
            spans.append((*copies_after[0], "image_copy"))
        uploads = [e - s for s, e, n, _ in inside
                   if n == "aten::to" and s < first]
        upload_ns += max(uploads, default=0)
        segs = []
        for s, e, owner in _segments(fs, fe, spans):
            if owner == "base":
                owner = ("prepare" if e <= first else
                         "present_rest" if s >= last else "between_passes")
            segs.append((s, e, owner))
            ms[owner] = ms.get(owner, 0.0) + (e - s) / 1e6
        seg_starts = [s for s, *_ in segs]
        for s, e, name, corr in inside:
            kind = ("raster_calls" if name == RASTER_MARK
                    else None if corr in ctypes_corr else _kind(name))
            if kind is None:
                continue
            owner = segs[max(0, bisect.bisect_right(seg_starts, s) - 1)][2]
            c = counts.setdefault(owner, dict.fromkeys(COUNTS, 0))
            c[kind] += 1
    n = frames

    def span(owner):
        out = {"ms": ms.get(owner, 0.0) / n}
        c = counts.get(owner, dict.fromkeys(COUNTS, 0))
        out.update({k: c[k] / n for k in COUNTS})
        return out

    passes = {p: dict(span(p), calls=calls[p] / n)
              for p in sorted(calls, key=lambda p: -ms.get(p, 0.0))}
    out = {
        "prepare": dict(span("prepare"), upload_ms=upload_ns / 1e6 / n),
        "passes": passes,
        "between_passes": span("between_passes"),
        "image_copy": span("image_copy"),
        "present_rest": span("present_rest"),
        "frames_traced": len(marks),
    }
    out["sum_ms"] = sum(ms.values()) / n
    return out


def _print_buckets(res: dict, n: int) -> None:
    t_host, t_total, b = res["host"], res["total"], res["buckets"]
    print(f"loop: {t_total / n * 1000:.3f} ms/frame total "
          f"({n / t_total:.0f} fps), host-side sum {t_host / n * 1000:.3f} ms")
    for k, v in sorted(b.items(), key=lambda kv: -kv[1]):
        print(f"  {k:20s} {v / n * 1000:.3f} ms/frame")
    other = t_host - sum(b.values())
    print(f"  {'(loop overhead)':20s} {other / n * 1000:.3f} ms/frame")
    print(f"  {'(device drain)':20s} {(t_total - t_host) / n * 1000:.3f} "
          "ms/frame")


def _print_split(split: dict, traced_rf_ms: float) -> None:
    def counts(s):
        return (f"{s['kernel_launches']:g} launches, {s['copies']:g} copies, "
                f"{s['syncs']:g} syncs, {s['raster_calls']:g} raster calls")

    p = split["prepare"]
    print("render_frame split (traced loop, host ms/frame):")
    print(f"  {'prepare':20s} {p['ms']:.3f} (upload {p['upload_ms']:.3f}); "
          f"{counts(p)}")
    for name, s in split["passes"].items():
        print(f"  {name:20s} {s['ms']:.3f} x{s['calls']:g}; {counts(s)}")
    for name in ("between_passes", "image_copy", "present_rest"):
        print(f"  {name:20s} {split[name]['ms']:.3f}; {counts(split[name])}")
    print(f"  spans sum {split['sum_ms']:.3f} ms/frame against the traced "
          f"render_frame {traced_rf_ms:.3f}")


def _cprofile(loop: FrameLoop, n: int) -> None:
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    loop.run(n)
    prof.disable()
    pstats.Stats(prof).sort_stats("cumulative").print_stats(40)


def measure(loop: FrameLoop, n: int, cprofile: bool = False) -> dict:
    """Warm up, run the timed and the traced loop over poses 1..n (and the
    cProfile loop), print the reference's lines and the split, check them
    -> the JSON line's object."""
    first = loop.warm_up()
    print(f"first frame (kernels, scene, shadow map): {first:.1f}s",
          file=sys.stderr)
    res = loop.run(n)
    _print_buckets(res, n)
    traced, prof = _traced(loop, n)
    split = split_render_frame(prof, n)
    traced_rf_ms = traced["buckets"]["render_frame"] / n * 1e3
    print(f"traced loop: {traced['total'] / n * 1e3:.3f} ms/frame (untraced "
          f"{res['total'] / n * 1e3:.3f}; the profiler's cost)")
    _print_split(split, traced_rf_ms)
    if cprofile:
        _cprofile(loop, n)
    buckets = {k: v / n * 1e3 for k, v in res["buckets"].items()}
    host_ms = res["host"] / n * 1e3
    buckets["loop_overhead"] = host_ms - sum(buckets.values())
    buckets["device_drain"] = (res["total"] - res["host"]) / n * 1e3
    off = abs(split["sum_ms"] - traced_rf_ms) / max(traced_rf_ms, 1e-12)
    if split["frames_traced"] != n:
        raise RuntimeError(f"host_profile: {split['frames_traced']} traced "
                           f"frames in the trace, {n} run")
    if off > SPLIT_TOLERANCE:
        raise RuntimeError(
            f"host_profile: the spans sum to {split['sum_ms']:.3f} ms/frame, "
            f"{100 * off:.2f}% off the traced render_frame {traced_rf_ms:.3f}")
    dev = loop.device
    return {
        "tool": "host_profile", "scene": loop.scene, "update": loop.update,
        "frames": n, "objects": loop.objects, "width": loop.width,
        "height": loop.height, "device": dev.type,
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "card": card_info(dev),
        "loop_ms": res["total"] / n * 1e3, "host_ms": host_ms,
        "buckets_ms": buckets,
        "traced_loop_ms": traced["total"] / n * 1e3,
        "traced_render_frame_ms": traced_rf_ms,
        "render_frame_split": split, "split_off": off,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--objects", type=int, default=None,
                    help="default 1000, 16 with --small")
    ap.add_argument("--cprofile", action="store_true")
    ap.add_argument("--static", action="store_true")
    ap.add_argument("--matrices", action="store_true")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.static and args.matrices:
        ap.error("--static has no update to feed as matrices")
    objects = args.objects or (16 if args.small else 1000)
    loop = FrameLoop(args.device, objects, args.static, args.matrices,
                     args.small)
    print(json.dumps(measure(loop, args.frames, args.cprofile)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
