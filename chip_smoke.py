#!/usr/bin/env python3
"""Drive the PyTorch port's standard, glass, textured, lit, rich, animated
and 1M-triangle frames, examples 02, 06 and 07's frames, the bf16 standard
frame, the standard frame with Hi-Z occlusion culling, with MSAA and with
the diagnostics overlay, the file sink and the profilers, the sharded
frames (example 07's LOD scene among them), the frame farms (example 09),
example 10's chunked frame and the frame loop's host profile on one
NVIDIA GPU; and the seven hand-written kernels against their plain
versions: the raster kernels, the texture sampler, the Forward+ light
loop, the bloom pyramid, the shadow PCF, the G-buffer fetch and the
surface shading.

Run from the repository root with no arguments: `python3 chip_smoke.py`.
It needs one CUDA device and `nvcc`; it exits non-zero without a result when
CUDA is absent, when the repository is not beside it, or when any phase
fails. Phases, one stdout line each:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: compiles ash_tpu_torch/csrc/raster.cu, which holds both raster
   kernels (the one-layer raster and the K-layer depth peel, and the
   pre-pass that computes their candidate rectangles), csrc/texture.cu
   (the texture sampler: the five maps and the trilinear tap) and
   csrc/lights.cu (the Forward+ light loop: a tile and an element kernel,
   f32 and bf16), csrc/bloom.cu (the bloom pyramid: the downsample and
   the tent upsample, by path, eight instantiations), csrc/shadow.cu
   (the shadow PCF: the single map and 2-4 cascades, with and without the
   blend, f32 and bf16 normals, fourteen instantiations),
   csrc/gbuffer.cu (the G-buffer fetch, one kernel) and csrc/shade.cu
   (the surface shading: the whole call and the surface stage, untextured
   and textured, and compose, five kernels), one nvcc each, started
   together, and prints each instantiation's registers and spills (none
   may spill);
3. kernels against plain: each CUDA kernel and the plain PyTorch raster on
   the same CUDA tensors at the main path's shapes; tri_id and depth of
   every layer must be equal bit for bit. One layer: the 1080p main pass
   (64x128 tiles), the 2048^2 shadow pass (32x128 tiles), K=256, and a
   y0 band, and the rich frame's three cascade shadow passes (1024^2, 32x128
   tiles, K=512). The peel: the 1080p main pass at 2, 4 and 8 layers, 4 layers
   under a floor taken from the first pass's deepest layer, 4 layers in a
   y0 band, and the 2048^2 shadow shapes at 2 layers. Then the small bench
   and small glass scenes at 192x128 with 16x32 tiles (one layer, 4
   layers, 4 under a floor), and seeded random triangles at 1080p whose
   bins hold near-plane crossers and grazing triangles (one layer, 4).
   Then the one-layer kernel on the mega frame's own main (1080p, 32x128
   tiles) and shadow (2048^2, 32x128) passes, two-level binned, at the base
   caps of 8192 and at the caps the escalation reaches, the whole targets,
   and on example 07's instancing frame 1 (65,536 cubes from the
   InstancingManager, 786,432 triangles): its main pass at 8x128 tiles and
   K=2048 and its shadow pass; and the standard frame's main pass at the
   MSAA presets' sample rates (3840x1080, 3840x2160, 7680x2160; the peel
   at 2 layers at 3840x2160); and band 1 of the sharded frame's 4, its
   main pass (1920x320 from row 320) and its shadow pass (2048x512 from
   row 512), as render_band and shadow_program bin them;
4. the slice: the standard frame (1000 instanced PBR cubes, bench.py's
   recipe) rendered at 1920x1080 through ash_tpu_torch.Renderer: the
   one-layer kernel runs twice on frame 1 and once per static frame after
   (cached shadow map), the peel never. Then the glass standard frame
   (every fourth cube alpha 0.5, 4 peel layers) with 1 and with 2
   transparency passes: the peel runs once per pass per frame and the
   one-layer kernel once, for the shadow map of frame 1. Every frame has
   no binning overflow, finite colour, and equals the same frame rendered
   with the plain raster; static frames are equal. Then the textured
   standard frame (four meshes with five 256x256 maps, anisotropy 16, every
   fourth cube alpha-tested): the peel runs at 2 layers in the shadow pass
   and the main pass of frame 1 and in the main pass after, the one-layer
   kernel never, and the texture kernel once a frame for the five maps and
   once for the alpha test (twice on frame 1, with the shadow pass); its
   kernels and copies a static frame (torch.profiler) beside PR 12's 1,032;
   it equals its plain-raster frame, the alpha test takes the
   second layer at some pixels, the frame differs from the same frame
   without the cutoff, and a frame with a new light direction re-renders
   the alpha-tested shadow map. Then the lit standard frame (bench.py's 32
   point lights): the one-layer kernel runs as on the standard frame, the
   light kernel once a frame, it equals its plain-raster frame, and the
   lights change it. Then the rich
   standard frame (bench.py's --rich: the HDR post chain with bloom and
   ACES, TAA, three 1024^2 shadow cascades with a tile cap of 512, the 32
   lights) for 8 frames: the one-layer kernel runs four times on frame 1
   (three cascades and the main pass) and once per frame after, the light
   kernel once a frame, the bloom kernels ten times a frame, the peel
   never; no overflow, finite colour; TAA gives every frame another jitter,
   so frame N is held against frame N of a plain-raster renderer (4
   frames); the history is non-zero after frame 1, the post chain changes
   the lit frame, a new light direction re-renders all three cascades, and
   with TAA off two static frames are equal. The same frame at
   render_scale=0.5 (internal 960x540, TAA upsampling) for 8 frames against
   the native frame 8: its PSNR and its gain over its own first frame. The
   seven golden scenes reach PSNR >= 40 dB against tests/golden/, and the
   small bench, glass, textured, lit and rich scenes on the card against
   the port's CPU render. Then the animated frame (bench.py --animate: 8
   poses of update_transforms_trs and the orbiting camera after frame 1):
   the one-layer kernel runs twice every frame (the moved scene re-renders
   its shadow map), no overflow, every pose changes the image, frame N
   equals frame N of a plain-raster renderer and of a renderer fed
   update_transforms(mat4_trs_batch(...)), and resubmitting the same
   handles with submit_render_commands builds the scene once and equals
   update_transforms. Then the mega frame (bench.py --mega: 1,002,528
   triangles): overflow at the base caps, escalate_tile_capacities until
   nothing drops (at most 4 rounds), the final caps, the base-cap image's
   PSNR against the drop-free one, and the drop-free frame against the
   plain-raster frame. Then the A14 paths. Example 07's instancing frame
   (Hi-Z on) for 3 frames: B1 [2, 1, 1], visible draws per frame (frame 1
   frustum only, fewer after), overflow, each frame against a plain-raster
   renderer's, frame 2's cull_objects with the pyramid on the card held
   to the same call on CPU copies of its inputs (the card's verdicts equal
   frame 2's visible draws, equal pyramids, at most 1% of the flags
   differ), frame 2 against a renderer with occlusion culling off (the
   pixels that differ, recorded, not held),
   peak memory, and the host seconds of the InstancingManager (outside the
   frame times). Example 07's LOD scene from distance 15 and 30: B1 [2, 2]
   (a LOD scene renders its shadow map in every frame, under the camera's
   level mask, which must change the map), lod_stats at each, each frame
   against its plain-raster frame. Example 06's IBL frame: against the same
   scene without the environment (it must differ) and its plain-raster
   frame. bench.py --bf16's standard frame: PSNR >= 40 dB against the f32
   frame and not identical, and its plain-raster frame. The standard frame
   with Hi-Z: visible draws, frame 2's cull held to the CPU as above, the
   pixels it changes against the frustum-only frame (recorded: the
   reference's Hi-Z test culls visible draws here too), its plain-raster
   frame 3. Then MSAA (A15): the standard frame at x2, x4 and x8 SSAA and
   x4 and x8 edge resolve for 3 frames each (B1 [2, 1, 1], no overflow,
   msaa_edge_overflow None under SSAA, static frames equal, each against
   its plain-raster frame, PSNR against the 1x frame, edge against SSAA),
   and tests/test_edge_msaa.py's 64x64 scenes (edge against SSAA >= 40
   dB). Then A17: example 02's 30 frames (diagnostics().frame_stats), the
   standard frame in overlay mode at a tile cap of 16 (the magenta block,
   and every pixel equal to the frame without diagnostics with the CPU's
   composite of the same text), a FileStreamSurface of three card frames,
   profile_passes and frame_cost_analysis on the standard frame;
5. times (CUDA events) and peak device memory: static frame, frame with a
   shadow re-render, the glass frames, the textured frame (static, with a
   shadow re-render, and at anisotropy 1 for scale), the lit frame, the
   rich frame (static, with a shadow re-render, at render_scale=0.5), the
   animated frame (median, min and max of 30 poses) and the mega frame
   (8 frames at the drop-free caps and at the base caps), with kernels and
   copies per frame (torch.profiler) for the last two; the instancing frame
   (median, min and max of 5), the LOD frames, the IBL frame, the bf16 and
   f32 standard frames and the standard frame with Hi-Z, the five MSAA
   frames (median, min and max of 5, kernels and copies per frame); then,
   at each kernel shape of the main path (1080p one layer, 2048^2 one
   layer, the three 1024^2 cascades, 1080p K = 2, 4, 8 and K = 4 under a
   floor, the x4 and x8 MSAA main passes, the two band passes, the mega
   frame's four passes and
   the instancing frame's two,
   which add the time with only the heaviest tile's list left): the
   wrapper-loop time (50 calls of raster_cuda.rasterize, host work
   included; the `ms` of the kernels line, as in earlier versions), the
   device time (`graph_ms`: a CUDA graph of bare launches), the device time
   with every tile's list empty (the clear, the stores, the pre-pass and
   the launches alone), the plain raster's time, the pairs the kernel
   evaluates, its bound and its share of the bound (`work`);
6. multi-device rendering (A18) and chunked geometry (A16), each path's
   launch counts from 0: the standard, rich and rich render_scale=0.5
   frames (the rich ones launch the light kernel once a band) through
   make_sharded_frame over four bands on one card (mesh
   ["cuda:0"] * 4; with more cards also the standard frame over cuda:0..n-1),
   each equal to the single-device frame of the same inputs (u8, scalars,
   the gathered shadow map, the history); example 09's farm (4 frames a
   batch, two batches chained through the TAA ring's history) and a (2, 2)
   frames x bands mesh, each frame equal to the frame rendered alone;
   example 10's chunked frame (96,040,000 triangles, 33 chunks) for 2
   frames, B1 on chunk 0 against the plain raster (one call) and timed,
   and the first 3 chunks against the same draws unchunked: recorded at
   the example's caps, equal at caps over the largest tile counts
   (max_tile_counts), where neither side drops a triangle. Each with frame
   ms, kernels and copies, device busy and idle share, and peak memory;
7. the frame loop's host profile (ash_tpu_torch.host_profile) of the
   animated and the standard frame at 1920x1080, 60 frames each: the
   reference tool's buckets must add up to the loop's host time and the
   split of render_frame to the traced render_frame time, every pass_*
   scope of the frame must show with its CUDA runtime launches, and
   pass_raster (and the animated frame's pass_shadow) one ctypes raster
   call a frame; then example 07's LOD scene through make_sharded_frame
   over four bands on cuda:0, equal to its single frame bit for bit (u8,
   scalars, the gathered shadow map) with each band's shadow raster S/4
   rows and none of S, and pass_shadow's device time beside the single
   frame's;
8. the benchmark (benchmark/run.py) in this process on its standard cell
   (the standard frame at 1920x1080, graphed) with 3 timed and 2 traced
   frames: its result line must be well formed (every end-to-end metric
   with its unit and sample count, the card's name and power limit, the
   per-layer numbers; the 3 timed frames 3 replays of the frame's graph;
   the footprint above the peak allocated, the graphs' pools above 0;
   from a trace whose hand kernels' launches equal the eager frames', B1
   once a frame by name, the G-buffer, shade and shadow kernels by name,
   and a raster bound share in (0, 1]; from a lossy one, after its tries,
   none of these numbers; an idle share in [0, 1) of the traced frames;
   no module of the reference loaded) and `correct` (no failed frame, no
   overflow, B1 by name in every traced frame, the three check frames at
   PSNR >= 40 dB and through the float check against
   benchmark/reference/); then the animated cell, the same way, whose 3
   timed frames must each replay all three of its graphs (the TRS
   composition, the shadow pass, the frame), and `correct`; then the
   standard cell shaded in bfloat16 (the control), whose check frames keep
   PSNR >= 40 dB and must fail the float check;
9. the texture kernel (csrc/texture.cu): the 1080p textured frame's own
   sampler calls at anisotropy 16 and 1 (frame 1: the shadow pass's alpha
   test at 2048^2, the main pass's at 1920x1080, the five maps in one
   call), recorded from the entry points, through the kernel and the plain
   sampler: bit for bit on covered pixels and 0 elsewhere; each call's
   device time (50 bare launches), the entry's time and the plain
   sampler's, in turns, beside its bound (bytes: a covered element's inputs
   and outputs once, an uncovered one's mask and outputs, the table
   entries and the mip levels the covered elements select once;
   operations: 26 f32 operations a footprint, 115 an anisotropic tap, 104 a
   trilinear one, over the taps the covered pixels need); the old path's
   five eager footprints (map_footprint a map), their device time under
   torch.profiler; frames 2 and 3 of each anisotropy with the kernel (1
   maps and 1 alpha-test launch a frame, counted from 0, and no eager
   map_footprint) against the same frames with the plain sampler patched
   in (u8 and colour, bit for bit), pass_shade's and pass_raster's device
   span beside the plain sampler's pass_shade, and the texture kernel's
   launches and device time a frame, read by name from the frame's trace;
10. the light kernel (csrc/lights.cu): its instantiations' registers and
   spills; the 1080p rich, lit and bf16 lit frames' own shade calls
   (frame 1), recorded from the entry point, through the kernel and the
   plain loop (ops/lights_cuda.plain): bit for bit on covered elements
   (torch.equal), the others untouched; the
   kernel's device time (50 bare launches) and the plain loop's, in turns,
   the entry's time, beside its bound (bytes: a covered element's inputs
   and `lo` once each way, an uncovered one's mask, the counts, the slots
   walked and the light rows once; operations: 149 f32 operations a
   pixel-light pair over the pairs the tile counts give); frames 2 and 3 of
   each with the kernel (1 launch a frame, counted from 0, the plain loop
   never called) against the same frames with the plain loop patched in
   (u8 and colour); then, for the rich and lit frames, kernel and plain-loop
   frames in turns: frame ms, peak memory, pass_shade's device span,
   kernels and copies and device busy a frame, and the light kernel's
   launches and device time a frame, read by name from the frame's trace;
11. the bloom kernels (csrc/bloom.cu): the 1080p rich frame's own
   pass_bloom input (frame 1) and example 09's farm frame's (256x192, 3
   mips), recorded from the entry point, and BLOOM_SIZES' seeded frames
   (down to 2x2, and mip_count 0), through the kernels and the plain chain
   (ops/bloom.py): torch.equal; the chain's device time (50 bare chains
   between CUDA events, and bare chains in a CUDA graph, which leaves out
   the host's launches; in turns with the plain chain; at the rich input
   each launch alone in a CUDA graph, with the instantiations' registers
   and spills), the entry's and the plain chain's, the plain chain's own
   kernel time, beside its bound (the larger of the frame read and the
   bloom written once at the memory rate and OPS_BLOOM's f32 operations at
   the f32 rate) and each kernel's time by name; frames 2 and 3 of rich
   with the kernels (10 launches a frame, counted from 0, the plain chain
   never called) against the same frames with the plain
   chain patched in (u8 and colour); then kernel and plain-chain frames in
   turns: frame ms, peak memory, pass_bloom's device span and its PyTorch
   kernels' time, kernels and copies and device busy a frame, and the bloom
   kernels' launches and device time a frame, read by name from the trace.
   Phases 4 and 6 count the bloom launches of the rich, the sharded and the
   farm frames from 0 as well;
12. the shadow kernel (csrc/shadow.cu): its instantiations' registers and
   spills; the 1080p standard (one 2048^2 map), glass (a call a shaded
   layer), rich (3 cascades of 1024^2, blend 0.1) and edge MSAA x4 (the
   centres and the worklist) frames' own shade calls (frame 1), recorded
   from the entry points, the rich frame's at 2 and 4 cascades, and from
   them rich without the blend, the standard and rich calls in bf16 and
   seeded 257^2 and 1000^2 maps, through the kernel and the plain PCF
   (ops/shadow_cuda.plain, plain_csm): bit for bit, NaN in the same
   places; each call's device time (50 bare launches between CUDA events,
   and in a CUDA graph), the entry's and the plain PCF's, in turns, beside
   its bound by bytes (a position, a normal and a result an element, and
   each texel the taps touch, once), the taps' path the launch takes and,
   by the kernel's own counts (shadow_cuda.probe_path), the share of its
   lookups read as one 4x4 window, and the entry's host time by part
   (checks, launcher, bare launch, whole entry); frames 2 and 3 of
   standard, rich and glass with the kernel (one launch a shade call,
   counted from 0, the plain PCF never called) against the same frames
   with the plain PCF patched in (u8 and colour); then kernel and plain
   frames in turns: frame ms, kernels and copies a frame, device busy and
   idle, and for rich pass_shade's device span and the kernel's time a
   frame by name.
   Phases 4 and 6 count the shadow launches of the standard, glass, lit,
   rich and sharded frames from 0 as well;
13. the G-buffer kernel (csrc/gbuffer.cu): its registers and spills; the
   1080p standard, animated (its first moved pose), rich (with the
   velocity), textured, glass (two passes: 8 shaded layers), mega (at the
   drop-free caps) and edge MSAA x4 (the centres and the worklist)
   frames' own G-buffer calls (frame 1), recorded from the entry point,
   through the kernel and the plain fetch (ops/shade.py's
   interpolate_gbuffer): every field equal, the floats bit for bit with
   NaN in the same places; each call's device time (50 bare launches
   between CUDA events, and in a CUDA graph), the entry's and the plain
   fetch's, in turns, beside its bound (bytes: a triangle id read and the
   fields written an element, pixel_xy's distinct elements, and each table
   row the elements reach once; operations: OPS_GBUFFER an element);
   frames 2 and 3 of standard, rich and glass with the kernel (one launch
   a shaded layer, counted from 0, the plain fetch never called) against
   the same frames with the plain fetch patched in (u8, colour and
   scalars); then kernel and plain frames in turns: frame ms, kernels and
   copies a frame, device busy and idle, pass_gbuffer's device span and
   the kernel's time a frame by name. Phase 4 counts the G-buffer
   launches of the standard, glass, lit, rich and rich render_scale 0.5
   frames from 0 as well (one a shaded layer);
14. the shading kernels (csrc/shade.cu): their registers and spills; the
   same frames' own shade_pbr calls (frame 1, recorded with phase 13's
   from ops/shade_cuda's entry: standard, animated, rich with its lights
   (surface, the light kernel, compose), textured, glass's 8 shaded layers
   with the coverage alpha, mega, edge MSAA x4's centres and worklist),
   through the kernels and the plain shade_pbr (ops/shade_cuda.plain):
   the colour and alpha bit for bit with NaN in the same places; each
   call's device time (50 bare launches of its stages between CUDA
   events, and in a CUDA graph), the entry's (with the texture, shadow
   and light kernels it runs) and the plain version's, in turns, beside
   its bound by bytes (shade_work); frames 2 and 3 of standard, rich,
   textured and glass with the kernels (one launch a shaded layer, two
   with lights, counted from 0, the plain shade_pbr never called) against
   the same frames with the plain version patched in (u8, colour and
   scalars); then kernel and plain frames in turns: frame ms, kernels and
   copies a frame, device busy and idle, pass_shade's device span and the
   kernels' time a frame by name. Phase 4 counts the shading launches of
   the standard, glass, lit, rich and rich render_scale 0.5 frames from 0
   as well.
15. the graphed frame (render/compiled.py): the benchmark's six cells
   (benchmark/scenes.py at 1920x1080), each through two fresh renderers,
   one eager (set_cuda_graphs(False)), one graphed
   (set_cuda_graphs(True)). Frames 0-3 of both, their camera turned about
   the origin by 0.05 rad a frame on top of the cell's own pose so that
   every frame's inputs differ from the last: equal bit for bit in every
   FrameOutputs field (u8 image, colour, depth, the scalars, the shadow
   map, the history), each eager image unlike the one before, every frame
   unchanged after the later frames, the eager renderer's steps from frame
   1 on free of host syncs (sync debug mode "error"), the graphed renderer
   capturing at least once and replaying every frame it did not run
   eagerly. Then 30 frames a timed window in turns (eager, graphed,
   graphed, eager), each frame waited for on the host (torch.cuda.
   synchronize): p50 and p90 frame ms, render_frame's host ms up to the
   present, peak memory allocated and reserved. Then 3 frames of each
   under torch.profiler, after a warm-up frame it keeps nothing of, the
   graphed ones all replays: each hand kernel of csrc/ launched as often by
   name as in the eager frames, which shows that the replays ran each
   kernel the eager frames' wrappers launched (the other device kernels
   compared and printed, copies aside); profiled afresh, up to 3 tries,
   where the two traces differ, since a trace can lose a replay's records;
   the kernels and copies, the host's launch calls and the device busy
   time a frame. Then the graphs' own device time (20 replays between CUDA
   events), the image copy's time alone (freed at once, the previous copy
   held as render_frame holds it, into a pinned buffer) and the graphs'
   private pools. Each line carries the card's name and power limit.
16. the asynchronous frame loop: each of the six cells, built as phase 15
   builds them, through renderers built with default settings (no
   set_cuda_graphs call), against a renderer with graphs off whose images
   are copied to the host after each frame with `.cpu()`, as render_frame
   did before it presented the tensor. (a) The default renderer's graphs
   are on, its frame step replays from frame 2 on (frame 0 eager, frame 1
   captured; under TAA from frame 3, the key warming up twice) and every
   step from frame 3 on (animated's TRS composition first runs in frame
   1). (b) From frame 3 on, render_frame (and in animated
   update_transforms_trs) runs under torch.cuda.set_sync_debug_mode(
   "error"), and frames 10-29 run so with no readback at all. (c)
   read_back() of frames 0-9, the camera turning 0.05 rad a frame, and of
   frame 29 equal the blocking path's images bit for bit; the wrappers the
   graphed frames called (frame 0 and the captures) are those the eager
   frames called. (d) A FileStreamSurface raw stream of 20 frames at
   max_frames_in_flight 1, 2 and 3 is byte for byte the blocking path's
   frames, each written max_frames_in_flight - 1 presents later. (e) In
   turns in one process, 30 frames a window: render_frame's return on the
   host and the frame's completion by CUDA events with the end event waited
   for (as the benchmark's clock), and the loop's ms a frame with no
   readback, with a FileStreamSurface at depth 2 (to os.devnull) and with
   a read_back() every frame; then the image's pinned copy's device ms.
   Each line carries the card's name and power limit.

Phases 3-14 run their frames eagerly (graphs_off: set_cuda_graphs(False)
on every renderer they build): they count the wrappers' launches frame by
frame, patch plain versions into the entries, record the entries' calls
through observers and read the eager frame's `pass_*` scopes, none of
which a replay re-enters.

Then one JSON line of phase 15's rows, one of phase 16's, one on the
kernels and, last, the device JSON line.

`python3 chip_smoke.py --graphs FRAMES` runs phases 1, 2 and 15 only, with
FRAMES frames a timed window, then phase 15's JSON line and the device
line; `--present FRAMES` does so for phase 16.

`python3 chip_smoke.py --parent DIR [--variant LABEL=DIR ...]` runs phase 1
and then, instead of the phases above, ab_phase: another checkout's light,
bloom and shadow kernels (DIR, for example the parent commit unpacked with
`git archive`) against this tree's, in turns in one process, at phases
10-12's inputs and in the rich and glass frames, DIR's shadow entry
against this tree's on the host, and prints one JSON line of what it
measured.
"""

import argparse
import collections
import concurrent.futures
import contextlib
import functools
import json
import math
import os
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np


# H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s, f32 FLOP/s outside
# the tensor cores.
MEM_RATE = 3.35e12
F32_RATE = 67e12
# f32 operations of `covers` per (pixel, candidate) pair (csrc/raster.cu).
OPS_PER_PAIR = 30
# Bytes of a candidate's record that a kernel reads: 9 edge and 3 z floats.
RECORD_BYTES = 48
# (pass, layers, floor): the kernel shapes the main path runs.
# The main pass's tile cap of the rich frame at render_scale 0.5 (the
# standard frame's is 256 at the native size).
HALF_SCALE_TILE_CAP = 1024
CASCADES = ["cascade0", "cascade1", "cascade2"]
# The standard frame's MSAA presets: (preset, the main pass's sample-rate
# size), and the (resolve, preset) frames driven.
MSAA_PRESETS = {"x2": (3840, 1080), "x4": (3840, 2160), "x8": (7680, 2160)}
MSAA_FRAMES = [("ssaa", "x2"), ("ssaa", "x4"), ("ssaa", "x8"),
               ("edge", "x4"), ("edge", "x8")]
SHAPES = [("main", 1, False), ("shadow", 1, False),
          *((c, 1, False) for c in CASCADES), ("main", 2, False),
          ("main", 4, False), ("main", 8, False), ("main", 4, True),
          ("msaa x4", 1, False), ("msaa x8", 1, False),
          ("band 1/4", 1, False), ("shadow band 1/4", 1, False)]


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


def graph_ms(launch, n=20, reps=10):
    """Device ms per launch: n launches captured in one CUDA graph, replayed
    `reps` times between two CUDA events after a warm replay."""
    import torch

    launch()  # warm: library loaded, caches filled
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            launch()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (n * reps)


def pass_inputs(r, cam, band=None):
    """-> {pass: (setup, bins, height, width, tile_h, tile_w, y0)} of
    renderer r's main pass (at the sample rate under MSAA) and shadow pass
    seen from `cam`, as a frame computes them; with `band` (a
    frame.BandSpec), over that band's rows as a sharded frame bins them."""
    from ash_tpu_torch.render import frame

    cfg, scene, uni = r.prepare_frame(
        cam.view_matrix(), cam.projection_matrix(), cam.position)[:3]
    _, setup, bins, _ = frame.main_pass_bins(cfg, scene.buffers, uni,
                                             band=band)
    setup_s, bins_s = frame.shadow_pass_bins(
        cfg, scene.buffers, frame.shadow_world(scene.buffers, uni.models),
        uni.light_space_matrix, band=band,
    )
    y0, rows, _ = frame.band_extent(cfg, band)
    s_rows, sy0 = frame.shadow_band(cfg, band)
    s = cfg.shadow_resolution
    return {
        "main": (setup, bins, rows, frame.raster_size(cfg)[0], cfg.tile_h,
                 cfg.tile_w, y0),
        "shadow": (setup_s, bins_s, s_rows, s, cfg.shadow_rows,
                   cfg.shadow_tile, sy0),
    }


def cascade_inputs(r, cam):
    """-> {"cascade<i>": (setup, bins, S, S, tile_h, tile_w, 0)}: the shadow
    pass of each cascade of renderer r seen from `cam`, as a frame computes
    them. It takes one TAA jitter of r's sequence."""
    from ash_tpu_torch.render import frame

    inputs = r.prepare_frame(cam.view_matrix(), cam.projection_matrix(),
                             cam.position)
    cfg, sb, uni = inputs.config, inputs.scene.buffers, inputs.uniforms
    world = frame.shadow_world(sb, uni.models)
    s = cfg.shadow_resolution
    out = {}
    for i in range(cfg.shadow_cascades):
        setup, bins = frame.shadow_pass_bins(cfg, sb, world,
                                             uni.cascade_matrices[i])
        out[f"cascade{i}"] = (setup, bins, s, s, cfg.shadow_rows,
                              cfg.shadow_tile, 0)
    return out


def work(setup, bins, height, width, tile_h, tile_w, y0=0, layers=1,
         floor=False):
    """What a raster launch does and needs, from its inputs: pairs_tested
    (the kernel's warps: accepted candidates x 128 pixels), pairs_tile
    (every candidate at every pixel of its tile), pairs_needed (pixel centre
    in the candidate's bbox), bytes (outputs written once; counts, live bin
    slots, the records of the binned triangles and the floor read once),
    ops (pairs_needed x OPS_PER_PAIR), bound_ms and bound_by."""
    import torch

    from ash_tpu_torch.ops import raster

    rects = raster.candidate_rects(setup, height, width, y0).long()
    rh, rw = raster.WARP_RECT
    tx = -(-width // tile_w)
    ids = bins.tri_ids.long()
    slot = torch.arange(ids.shape[1], device=ids.device)[None, :]
    live = (ids >= 0) & (slot < bins.counts.long()[:, None])
    bb = setup.bbox[ids.clamp_min(0)]  # (tiles, K, 4)
    tile = torch.arange(ids.shape[0], device=ids.device)[:, None]
    x0 = ((tile % tx) * tile_w).float()
    r0 = ((tile // tx) * tile_h).float()
    first_c = torch.maximum(torch.ceil(bb[..., 0] - 0.5), x0)
    last_c = torch.minimum(torch.floor(bb[..., 2] - 0.5),
                           torch.clamp(x0 + tile_w, max=width) - 1)
    first_r = torch.maximum(torch.ceil(bb[..., 1] - 0.5) - y0, r0)
    last_r = torch.minimum(torch.floor(bb[..., 3] - 0.5) - y0,
                           torch.clamp(r0 + tile_h, max=height) - 1)
    n = ((last_c - first_c + 1).clamp_min(0)
         * (last_r - first_r + 1).clamp_min(0))
    needed = int(torch.where(live, n, torch.zeros_like(n)).sum())
    # The kernel's warps own aligned rh x rw rectangles of the tile; a
    # candidate is evaluated by each warp its rectangle overlaps
    # (raster.warp_bins, counted without building its lists).
    rc = rects[ids.clamp_min(0)]  # (tiles, K, 4)
    c0 = torch.maximum(rc[..., 0], x0.long())
    c1 = torch.minimum(rc[..., 2], torch.clamp(x0.long() + tile_w,
                                               max=width) - 1)
    q0 = torch.maximum(rc[..., 1], r0.long())
    q1 = torch.minimum(rc[..., 3], torch.clamp(r0.long() + tile_h,
                                               max=height) - 1)
    warps = ((c1 // rw - c0 // rw + 1) * (q1 // rh - q0 // rh + 1))
    warps = torch.where(live & (c0 <= c1) & (q0 <= q1), warps, 0)
    out_bytes = layers * height * width * 8
    in_bytes = (bins.counts.numel() * 4 + int(live.sum()) * 4
                + int(torch.unique(ids[live]).numel()) * RECORD_BYTES
                + (height * width * 4 if floor else 0))
    ops = needed * OPS_PER_PAIR
    mem_ms = (out_bytes + in_bytes) / MEM_RATE * 1e3
    ops_ms = ops / F32_RATE * 1e3
    return {
        "pairs_tested": int(warps.sum()) * rh * rw,
        "pairs_tile": int(bins.counts.sum()) * tile_h * tile_w,
        "pairs_needed": needed,
        "bytes": out_bytes + in_bytes,
        "ops": ops,
        "bound_ms": max(mem_ms, ops_ms),
        "bound_by": "bytes" if mem_ms >= ops_ms else "operations",
    }


def floor_for(passes):
    """The 1080p floor of the K=4-under-a-floor shape: the deepest layer of
    a first 4-layer pass, as a frame's second transparency pass gets it."""
    from ash_tpu_torch.ops import raster

    return raster.rasterize(*passes["main"][:6], layers=4).layer(3)[0]


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


def bloom_path(kind, path, threshold):
    """The name of csrc/bloom.cu's bloom_{kind}_kernel<path, threshold>:
    path 0 the gather, 1 the 2x2 blocks or 2x lerps one thread a target, 2
    the same staged in shared memory."""
    name = {"down": ("gather", "blocks", "blocks staged"),
            "up": ("gather", "double", "double staged")}[kind][path]
    return f"{kind} {name}{' threshold' if threshold else ''}"


def ptxas_usage(log):
    """{kernel: (registers, spill bytes)} from nvcc's -Xptxas -v log;
    raster_warp_kernel<L, HAS_FLOOR> is named by its L and floor, the
    rectangles' pre-pass "rects", csrc/texture.cu's texture_maps_kernel
    and texture_trilinear_kernel "texture maps" and "texture trilinear",
    csrc/lights.cu's light_tile_kernel<bf16> and light_element_kernel<bf16>
    "light tile" / "light element", with " bf16" for the bf16 ones,
    csrc/bloom.cu's bloom_down_kernel<path, threshold> "bloom down gather"
    / "bloom down blocks" / "bloom down blocks staged" and
    bloom_up_kernel<path, threshold> "bloom up gather" / "bloom up double" /
    "bloom up double staged" (bloom_path), with " threshold" for those that
    read the HDR frame; PR 15's bloom_{down,up}_kernel<bool, threshold>, a
    build of another tree that ab_phase times, by the same names, its bool
    as path 0 or 1; csrc/shadow.cu's shadow_pcf_kernel<C, blend, bf16>
    "shadow C=<C>", with " blend" and " bf16", and shadow_window_kernel
    by the same names with " windows"; csrc/gbuffer.cu's gbuffer_kernel
    "gbuffer"; csrc/shade.cu's shade_kernel<textured, split> "shade", with
    " surface" for the split and " textured", and compose_kernel "shade
    compose"."""
    usage, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"raster_warp_kernelILi(\d+)ELb([01])E", ln)
        texture_kernel = re.search(r"texture_(maps|trilinear)_kernel", ln)
        light_kernel = re.search(r"light_(tile|element)_kernelILb([01])E", ln)
        bloom_kernel = re.search(
            r"bloom_(down|up)_kernelIL[ib]([012])ELb([01])E", ln)
        shadow_kernel = re.search(
            r"shadow_(pcf|window)_kernelILi(\d)ELb([01])ELb([01])E", ln)
        gbuffer_kernel = "gbuffer_kernel" in ln
        shade_kernel = re.search(r"shade_kernelILb([01])ELb([01])E", ln)
        if "Compiling entry function" in ln and m:
            name = f"L={m.group(1)}{' floor' if m.group(2) == '1' else ''}"
            spill = None
        elif "Compiling entry function" in ln and "candidate_rects_kernel" in ln:
            name, spill = "rects", None
        elif "Compiling entry function" in ln and texture_kernel:
            name = f"texture {texture_kernel.group(1)}"
            spill = None
        elif "Compiling entry function" in ln and light_kernel:
            name = (f"light {light_kernel.group(1)}"
                    f"{' bf16' if light_kernel.group(2) == '1' else ''}")
            spill = None
        elif "Compiling entry function" in ln and bloom_kernel:
            kind, path, thresh = bloom_kernel.groups()
            name = f"bloom {bloom_path(kind, int(path), thresh == '1')}"
            spill = None
        elif "Compiling entry function" in ln and shadow_kernel:
            path, c, blend, bf16 = shadow_kernel.groups()
            name = (f"shadow C={c}{' blend' if blend == '1' else ''}"
                    f"{' bf16' if bf16 == '1' else ''}"
                    f"{' windows' if path == 'window' else ''}")
            spill = None
        elif "Compiling entry function" in ln and gbuffer_kernel:
            name, spill = "gbuffer", None
        elif "Compiling entry function" in ln and shade_kernel:
            textured, split = shade_kernel.groups()
            name = (f"shade{' surface' if split == '1' else ''}"
                    f"{' textured' if textured == '1' else ''}")
            spill = None
        elif "Compiling entry function" in ln and "compose_kernel" in ln:
            name, spill = "shade compose", None
        elif name and "spill stores" in ln:
            spill = sum(int(x) for x in re.findall(r"(\d+) bytes spill", ln))
        elif name and "Used" in ln and "registers" in ln:
            regs = int(re.search(r"Used (\d+) registers", ln).group(1))
            usage[name] = (regs, spill)
            name = None
    return usage


def synthetic_setup(width, height, seed=11):
    """Seeded random triangles at (width, height): 3000 small ones over the
    screen, 24 that cross the eye plane (a vertex behind the eye: the
    full-screen bbox) and 60 grazing ones (an edge just in front of the
    eye, the third vertex far), all through the port's setup, no culling."""
    import torch

    from ash_tpu_torch.ops import geometry

    rng = np.random.default_rng(seed)
    n = 3000
    w = rng.uniform(0.5, 4.0, (n, 1))
    centre = rng.uniform(-1.0, 1.0, (n, 1, 2))
    xy = (centre + rng.uniform(-0.03, 0.03, (n, 3, 2))) * w[..., None]
    small = np.concatenate([xy, np.broadcast_to(w[..., None] * 0.5, (n, 3, 1)),
                            np.broadcast_to(w[..., None], (n, 3, 1))], -1)
    small[..., 2] *= rng.uniform(0.2, 1.8, (n, 3))
    c = 24
    cw = np.stack([rng.uniform(-1.0, -0.1, c), rng.uniform(0.5, 3.0, c),
                   rng.uniform(0.5, 3.0, c)], -1)
    cxy = rng.uniform(-0.8, 0.8, (c, 3, 2)) * np.abs(cw)[..., None]
    crossers = np.concatenate([cxy, 0.5 * np.abs(cw)[..., None],
                               cw[..., None]], -1)
    g = 60
    gw = np.stack([rng.uniform(1e-4, 3e-4, g)] * 2
                  + [rng.uniform(10.0, 50.0, g)], -1)
    gx = np.stack([rng.uniform(-0.9, -0.1, g), rng.uniform(0.1, 0.9, g),
                   rng.uniform(-0.5, 0.5, g)], -1)
    gy = np.stack([rng.uniform(-0.6, 0.2, g)] * 2 + [np.full(g, 0.95)], -1)
    grazing = np.stack([gx * gw, gy * gw, 0.5 * gw, gw], -1)
    clip = np.concatenate([small, crossers, grazing]).astype(np.float32)
    t = clip.shape[0]
    return geometry.triangle_setup(
        torch.from_numpy(clip.reshape(-1, 4)).cuda(),
        torch.arange(3 * t, dtype=torch.int32).reshape(t, 3).cuda(),
        torch.ones(t, dtype=torch.bool).cuda(), width, height,
        cull_mode="none",
    )


def frame_ms_spread(step, n):
    """(median, min, max) of n frames timed as frame_ms times them, and the
    peak device MiB over them."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(i)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return ((statistics.median(times), min(times), max(times)),
            torch.cuda.max_memory_allocated() / 2**20)


def frame_ms_mem(step, n):
    """(frame_ms(step, n), peak device MiB over those frames)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = frame_ms(step, n)
    return ms, torch.cuda.max_memory_allocated() / 2**20


def launches_per_frame(rend, view, proj, pos, frames, step=None):
    """Render `frames` frames of `rend` (through step(i) if given) -> (one-
    layer launches per frame, peel launches per frame, outputs)."""
    from ash_tpu_torch.ops import raster_cuda

    one, peel, outs = [], [], []
    for i in range(frames):
        b1 = raster_cuda.rasterize.launches
        b2 = raster_cuda.rasterize.layer_launches
        if step is not None:
            step(i)
        else:
            rend.render_frame(view, proj, pos)
        outs.append(rend.last_outputs())
        one.append(raster_cuda.rasterize.launches - b1)
        peel.append(raster_cuda.rasterize.layer_launches - b2)
    return one, peel, outs


def alpha_fallthrough(rend, view, proj, pos):
    """Pixels of rend's main pass where the alpha test took the second
    layer, from the plain raster's two layers."""
    from ash_tpu_torch.ops import raster, shade
    from ash_tpu_torch.render import frame

    cfg, scene, uni, pool = rend.prepare_frame(view, proj, pos)[:4]
    sb = scene.buffers
    _, setup, bins, _ = frame.main_pass_bins(cfg, sb, uni)
    vis = raster.rasterize(setup, bins, cfg.height, cfg.width, cfg.tile_h,
                           cfg.tile_w, layers=2)
    res = shade.resolve_alpha_test(vis, setup, sb.tri_v, sb.tri_draw,
                                   sb.materials, sb.uv, pool,
                                   vert_uid=sb.vert_uid)
    return int((res.tri_id != vis.tri_id).sum())


def largest_tile_light_count(rend, view, proj, pos):
    """The largest per-tile light count of rend's last frame."""
    import torch

    from ash_tpu_torch.ops import light_cull

    cfg, _, uni, _, lights = rend.prepare_frame(view, proj, pos)[:5]
    tl = light_cull.cull_lights(
        lights, uni.view, torch.linalg.inv(uni.projection),
        rend.last_outputs().depth, cfg.width, cfg.height,
        max_per_tile=cfg.max_lights_per_tile, tile=cfg.light_tile_size)
    return int(tl.counts.max())


def hiz_cull_card_vs_cpu(rend, depth, view, proj, pos):
    """The Hi-Z cull of `rend`'s next frame over the pyramid of `depth` (the
    last frame's), by cull_objects on the card and on CPU copies of the
    same inputs -> (visible on the card, visible on the CPU, flags that
    differ, pyramid texels equal bit for bit)."""
    import torch

    from ash_tpu_torch.ops.hiz import build_hiz
    from ash_tpu_torch.ops.occlusion import cull_objects

    inputs = rend.prepare_frame(view, proj, pos)
    cfg, sb, uni = inputs.config, inputs.scene.buffers, inputs.uniforms
    args = (sb.draw_center, sb.draw_extents, uni.models, sb.draw_enabled,
            uni.view_proj)
    texels, vis = {}, {}
    for dev in ("cuda", "cpu"):
        pyr = build_hiz(depth.to(dev))
        texels[dev] = pyr.texels.cpu()
        vis[dev] = cull_objects(*(a.to(dev) for a in args), pyr, cfg.width,
                                cfg.height).visibility.cpu()
    return (int(vis["cuda"].sum()), int(vis["cpu"].sum()),
            int((vis["cuda"] != vis["cpu"]).sum()),
            bool(torch.equal(texels["cuda"], texels["cpu"])))


def check_hiz_cull(name, rend, outs, fargs):
    """Frame 2's culling, held to the same cull on the CPU: the card's
    verdicts equal frame 2's visible draws, the pyramids are equal and at
    most 1% of frame 1's visible draws flip (tests/test_torch_hiz.py holds
    the CPU's to the reference at the same 1%). -> the cull's numbers."""
    card, cpu, flips, same_pyr = hiz_cull_card_vs_cpu(rend, outs[0].depth,
                                                      *fargs)
    visible = [int(o.visible_draws) for o in outs]
    check(card == visible[1] and same_pyr
          and flips <= max(1, visible[0] // 100),
          f"{name}: Hi-Z cull on the card {card} visible (frame 2: "
          f"{visible[1]}), on the CPU {cpu}, {flips} flags differ, pyramids "
          f"equal: {same_pyr}")
    return card, cpu, flips


def compare_layers(got, want, layers):
    """(tri_id mismatches, depth mismatches, max |depth err|, covered per
    layer) over every layer of two visibility buffers."""
    import torch

    tid_bad = depth_bad = 0
    err, covered = 0.0, []
    for i in range(layers):
        (gd, gt), (wd, wt) = got.layer(i), want.layer(i)
        tid_bad += int((gt != wt).sum())
        depth_bad += int((gd != wd).sum())
        err = max(err, float((gd - wd).abs().max()))
        covered.append(int((gt >= 0).sum()))
    torch.cuda.synchronize()
    return tid_bad, depth_bad, err, covered


def busy_profile(step, n=2):
    """(wall ms, device busy ms, idle share, kernels and copies) per frame
    over n frames of step under torch.profiler, as profile_frame.py reads
    them (busy: the kernels' and copies' own device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            step(i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    work = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy = sum(e.self_device_time_total for e in work) / 1e3
    return wall / n, busy / n, 1.0 - busy / wall, sum(e.count for e in work) / n


def bloom_launched():
    """The bloom kernels' launches since their counts were zeroed."""
    from ash_tpu_torch.ops import bloom_cuda

    return sum(bloom_cuda.launches.values())


def zero_bloom():
    from ash_tpu_torch.ops import bloom_cuda

    for k in bloom_cuda.launches:
        bloom_cuda.launches[k] = 0


def shadow_launched():
    """The shadow kernel's launches since its counts were zeroed."""
    from ash_tpu_torch.ops import shadow_cuda

    return sum(shadow_cuda.launches.values())


def zero_shadow():
    from ash_tpu_torch.ops import shadow_cuda

    for k in shadow_cuda.launches:
        shadow_cuda.launches[k] = 0


def gbuffer_launched():
    """The G-buffer kernel's launches since its count was zeroed."""
    from ash_tpu_torch.ops import gbuffer_cuda

    return gbuffer_cuda.launches["gbuffer"]


def zero_gbuffer():
    from ash_tpu_torch.ops import gbuffer_cuda

    gbuffer_cuda.launches["gbuffer"] = 0


def shade_launched():
    """The shading kernels' launches since their counts were zeroed: every
    stage's (shade, surface, compose)."""
    from ash_tpu_torch.ops import shade_cuda

    return sum(shade_cuda.launches[k] for k in ("shade", "surface",
                                                "compose"))


def zero_shade():
    from ash_tpu_torch.ops import shade_cuda

    for k in shade_cuda.launches:
        shade_cuda.launches[k] = 0


def bloom_per_frame(cfg):
    """The bloom kernels' launches a frame of `cfg`: one a level each way
    (ops/bloom_cuda.levels), none without the post chain's bloom."""
    from ash_tpu_torch.ops import bloom_cuda

    if not (cfg.post_enabled and cfg.bloom_enabled):
        return 0
    return len(bloom_cuda.levels(cfg.height, cfg.width, cfg.bloom_mips))


def counted(fn):
    """Zero the kernels' launch counts, run fn() -> (its result, one-layer
    launches, peel launches); the light kernel's count is left in
    lights_cuda.launches["loop"], the bloom kernels' in bloom_launched(),
    the shadow kernel's in shadow_launched()."""
    from ash_tpu_torch.ops import lights_cuda, raster_cuda

    raster_cuda.rasterize.launches = 0
    raster_cuda.rasterize.layer_launches = 0
    lights_cuda.launches["loop"] = 0
    zero_bloom()
    zero_shadow()
    zero_gbuffer()
    zero_shade()
    out = fn()
    return (out, raster_cuda.rasterize.launches,
            raster_cuda.rasterize.layer_launches)


def u8_diff(a, b):
    """(largest u8 difference, pixels that differ) of two RGBA8 images."""
    a = np.asarray(a.cpu() if hasattr(a, "cpu") else a).astype(np.int16)
    b = np.asarray(b.cpu() if hasattr(b, "cpu") else b).astype(np.int16)
    d = np.abs(a - b)
    return int(d.max()), int((d.max(-1) > 0).sum())


# The scalars of a FrameOutputs that the frame checks compare.
SCALAR_FIELDS = ("covered_pixels", "binning_overflow", "shadow_overflow",
                 "visible_draws", "msaa_edge_overflow")


def same_scalars(got, want, fields=SCALAR_FIELDS):
    """The fields of two FrameOutputs that differ, as {field: (got, want)}."""
    bad = {}
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        g = None if g is None else int(g)
        w = None if w is None else int(w)
        if g != w:
            bad[f] = (g, w)
    return bad


def single_frame(inputs, history=None):
    """The frame of prepare_frame's `inputs` on one device, its shadow map
    rendered here: the counterpart of a sharded frame of the same inputs."""
    from ash_tpu_torch.render import frame

    cfg, sc, uni, pool, lights, post, taa = inputs
    shadow = None
    if cfg.shadow_enabled and not cfg.lod_enabled:
        shadow = frame.shadow_program(cfg, sc.buffers, uni.models,
                                      uni.light_space_matrix, pool,
                                      uni.cascade_matrices)
    return frame.render_frame_program(cfg, sc.buffers, uni, shadow, pool,
                                      lights, post, taa, history)


def sharded_paths(card, view, proj, pos, launches, layer_launches, mem,
                  light_launches, bloom_launches, shadow_launches):
    """A18's screen bands on the card: the standard frame, the rich frame
    and the rich frame at render_scale 0.5, each sharded over four bands on
    cuda:0 (mesh ["cuda:0"] * 4), against the same inputs' single-device
    frame (u8 and scalars equal, the gathered shadow map bit for bit); and
    with more than one card the standard frame over cuda:0..n-1. Then
    times: frame ms (median, min, max of 5, the image copied to the host),
    kernels and copies, device busy and idle share, peak MiB. -> result
    rows by path."""
    import torch

    from ash_tpu_torch.ops import lights_cuda
    from ash_tpu_torch.parallel import make_sharded_frame, render_mesh
    from ash_tpu_torch.render.bench_scene import build_bench_renderer

    cases = [("sharded standard x4", {}, ["cuda:0"] * 4),
             ("sharded rich x4", dict(rich=True), ["cuda:0"] * 4),
             ("sharded rich 0.5 x4", dict(rich=True, render_scale=0.5,
                                          max_tris_per_tile=HALF_SCALE_TILE_CAP),
              ["cuda:0"] * 4)]
    if torch.cuda.device_count() > 1:
        n = torch.cuda.device_count()
        cases.append((f"sharded standard cuda:0..{n - 1}", {},
                      [f"cuda:{i}" for i in range(n)]))
    rows = {}
    for path, kw, devices in cases:
        r = build_bench_renderer(1920, 1080, 1000, "cuda", **kw)[0]
        inputs = r.prepare_frame(view, proj, pos)
        cfg, sc, uni, pool, lights, post, taa = inputs
        history = None
        if taa is not None:
            history = torch.zeros((cfg.height, cfg.width, 3),
                                  device=uni.models.device)
        fn = make_sharded_frame(cfg, render_mesh(devices=devices))

        def sharded():
            return fn(sc.buffers, uni, pool, post, taa, history, lights)

        out, b1, b2 = counted(sharded)
        launches[path], layer_launches[path] = b1, b2
        lit = lights_cuda.launches["loop"]
        if lit:
            light_launches[path] = lit
        bloomed = bloom_launched()
        if bloomed:
            bloom_launches[path] = bloomed
        shadow_launches[path] = shadow_launched()
        check(shadow_launches[path] == len(devices),
              f"{path}: shadow kernel launches {shadow_launches[path]}, want "
              "one a band")
        check(bloomed == bloom_per_frame(cfg),
              f"{path}: bloom kernel launches {bloomed}, want "
              f"{bloom_per_frame(cfg)}")
        want = single_frame(inputs, history)
        n = len(devices)
        per_band = cfg.shadow_cascades + 1
        check(b1 == n * per_band and b2 == 0,
              f"{path}: one-layer launches {b1}, peel {b2}, want "
              f"{n * per_band} and 0")
        check(lit == (n if cfg.lights_enabled else 0),
              f"{path}: light kernel launches {lit}, want one a band")
        most, px = u8_diff(out.image, want.image)
        bad = same_scalars(out, want)
        same_map = bool(torch.equal(out.shadow_map, want.shadow_map))
        check(out.image.shape == want.image.shape and most == 0 and not bad
              and same_map and bool(torch.isfinite(out.color).all()),
              f"{path}: against the single-device frame: largest u8 "
              f"difference {most} at {px} pixels, scalars {bad}, shadow map "
              f"equal {same_map}")
        if history is not None:
            check(bool(torch.equal(out.history, want.history)),
                  f"{path}: history != the single-device frame's")
        del want

        def step(i):
            fn(sc.buffers, uni, pool, post, taa, history, lights).image.cpu()

        ms, mem[path] = frame_ms_spread(step, 5)
        wall, busy, idle, ops = busy_profile(step)
        rows[path] = dict(
            launches=(b1, b2), covered=int(out.covered_pixels),
            overflow=(int(out.binning_overflow), int(out.shadow_overflow)),
            ms=ms, wall=wall, busy=busy, idle=idle, ops=ops,
            rows_per_band=frame_rows(cfg, n))
        print(f"phase6 {path}: {cfg.width}x{cfg.height}, {n} bands of "
              f"{rows[path]['rows_per_band']} rows on {devices}: one-layer "
              f"launches {b1} ({cfg.shadow_cascades} shadow band(s) and the "
              f"main pass per band), peel {b2}, light kernel {lit}, bloom "
              f"kernels {bloomed}; covered "
              f"{int(out.covered_pixels)}"
              f", overflow (main, shadow) {rows[path]['overflow']}; equal to "
              f"the single-device frame (u8, scalars, shadow map"
              f"{', history' if history is not None else ''}): True; frame "
              f"{ms[0]} ms (median of 5, min {ms[1]}, max {ms[2]}) on {card}; "
              f"under the profiler {wall:.2f} ms, device busy {busy:.2f} ms, "
              f"idle {100 * idle:.1f}%, {ops:g} kernels and copies per frame; "
              f"peak {mem[path]:.1f} MiB", flush=True)
        del r, inputs, out, fn, sc, uni, pool, lights
    return rows


def frame_rows(cfg, n):
    """Rows per band of an n-band frame (internal rows under TAAU)."""
    from ash_tpu_torch.render import frame

    return frame.band_extent(cfg, frame.BandSpec(0, n))[1]


def farm_paths(card, launches, layer_launches, mem, bloom_launches):
    """A18's frame farm on the card: example 09 (12 cubes at 256x192, HDR
    post, TAA) as 4 frames a batch on mesh ["cuda:0"] * 4, two batches
    chained through history0 (8 frames of the orbit), each frame against
    the same frame rendered alone with the history carried (u8, covered
    and history equal); then a (2, 2) mesh of cuda:0, frames x bands, over
    example 09's scene without TAA against single frames. Times per batch.
    -> result rows by path."""
    import dataclasses

    import torch

    from ash_tpu_torch.parallel import (
        batch_uniforms,
        make_frame_parallel,
        make_frame_parallel_banded,
        render_mesh,
    )
    from ash_tpu_torch.render import bench_scene, frame

    scene, uni0 = bench_scene.example_scene(n_cubes=12, device="cuda")
    cfg = bench_scene.example09_config()
    n, total = 4, 8
    unis, prev = [], bench_scene.example09_uniforms(uni0, 0, total)
    for i in range(total):
        u = bench_scene.example09_uniforms(uni0, i, total)
        unis.append(u._replace(prev_view_proj=prev.view_proj,
                               prev_models=u.models))
        prev = u
    taas = [bench_scene.example09_taa(i) for i in range(total)]
    farm = make_frame_parallel(cfg, render_mesh(devices=["cuda:0"] * n,
                                                axis="fp"))

    def batches():
        outs, history = [], None
        for b in range(0, total, n):
            o = farm(scene, batch_uniforms(unis[b:b + n]),
                     taa_batch=batch_uniforms(taas[b:b + n]),
                     history0=history)
            outs.append(o)
            history = o.history[n - 1]
        return outs

    outs, b1, b2 = counted(batches)
    path = "farm example 09"
    launches[path], layer_launches[path] = b1, b2
    check(b1 == 2 * total and b2 == 0,
          f"{path}: one-layer launches {b1}, peel {b2}, want {2 * total}, 0")
    farm_bloom = bloom_per_frame(cfg)
    bloom_launches[path] = bloom_launched()
    check(bloom_launches[path] == farm_bloom * total,
          f"{path}: bloom kernel launches {bloom_launches[path]}")
    history = torch.zeros((cfg.height, cfg.width, 3), device=scene.tri_v.device)
    equal = []
    for i in range(total):
        o = outs[i // n]
        sm = frame.shadow_program(cfg, scene, unis[i].models,
                                  unis[i].light_space_matrix)
        want = frame.render_frame_program(cfg, scene, unis[i], sm,
                                          taa_params=taas[i], history=history)
        history = want.history
        equal.append(bool(torch.equal(o.image[i % n], want.image)
                          and torch.equal(o.history[i % n], want.history)
                          and int(o.covered_pixels[i % n])
                          == int(want.covered_pixels)))
    check(all(equal), f"{path}: frame i != the same frame alone: {equal}")
    moving = sum(not torch.equal(outs[0].image[i], outs[0].image[i + 1])
                 for i in range(n - 1))
    check(moving == n - 1, f"{path}: the orbit does not move the image")

    def farm_step(i):
        batches()[-1].image.cpu()

    ms, mem[path] = frame_ms_spread(farm_step, 3)
    wall, busy, idle, ops = busy_profile(farm_step, 1)
    rows = {path: dict(launches=(b1, b2), ms=ms, wall=wall, busy=busy,
                       idle=idle, ops=ops, frames=total, equal=equal)}
    print(f"phase6 {path}: {cfg.width}x{cfg.height}, 12 cubes, TAA ring: "
          f"{total // n} batches of {n} frames on ['cuda:0'] * {n}: one-layer "
          f"launches {b1} (shadow and main pass a frame), peel {b2}, bloom "
          f"kernels {bloom_launches[path]}; frame i "
          f"equal to frame i rendered alone with the history carried (u8, "
          f"history, covered): {equal}; {total} frames in {ms[0]} ms (median "
          f"of 3, min {ms[1]}, max {ms[2]}), {ms[0] / total:.3f} ms a frame, on "
          f"{card}; under the profiler {wall:.2f} ms, device busy "
          f"{busy:.2f} ms, idle {100 * idle:.1f}%, {ops:g} kernels and copies "
          f"per {total} frames; peak {mem[path]:.1f} MiB", flush=True)

    cfg2 = dataclasses.replace(cfg, taa_enabled=False)
    mesh2 = render_mesh(devices=[["cuda:0"] * 2] * 2, axis=("fp", "sp"))
    banded = make_frame_parallel_banded(cfg2, mesh2)
    plain = [u._replace(prev_view_proj=None, prev_models=None)
             for u in unis[:2]]
    out2, b1, b2 = counted(lambda: banded(scene, batch_uniforms(plain)))
    path = "farm banded 2x2"
    launches[path], layer_launches[path] = b1, b2
    check(b1 == 8 and b2 == 0, f"{path}: one-layer launches {b1}, peel {b2}")
    bloom_launches[path] = bloom_launched()
    check(bloom_launches[path] == 2 * farm_bloom,
          f"{path}: bloom kernel launches {bloom_launches[path]}")
    equal2 = []
    for i in range(2):
        sm = frame.shadow_program(cfg2, scene, plain[i].models,
                                  plain[i].light_space_matrix)
        want = frame.render_frame_program(cfg2, scene, plain[i], sm)
        equal2.append(bool(torch.equal(out2.image[i], want.image))
                      and not same_scalars(
                          frame.FrameOutputs(*(None if x is None else x[i]
                                               for x in out2)), want))
    check(all(equal2), f"{path}: frame i != the frame alone: {equal2}")

    def banded_step(i):
        banded(scene, batch_uniforms(plain)).image.cpu()

    ms2, mem[path] = frame_ms_spread(banded_step, 5)
    wall, busy, idle, ops = busy_profile(banded_step)
    rows[path] = dict(launches=(b1, b2), ms=ms2, wall=wall, busy=busy,
                      idle=idle, ops=ops, frames=2, equal=equal2)
    print(f"phase6 {path}: 2 frames x 2 bands of {frame_rows(cfg2, 2)} rows "
          f"on cuda:0, example 09's scene without TAA: one-layer launches "
          f"{b1} (a shadow band and a main band per device), peel {b2}, "
          f"bloom kernels {bloom_launches[path]}; "
          f"equal to each frame alone (u8, scalars): {equal2}; 2 frames in "
          f"{ms2[0]} ms (median of 5, min {ms2[1]}, max {ms2[2]}) on {card}; "
          f"under the profiler {wall:.2f} ms, device busy {busy:.2f} ms, idle "
          f"{100 * idle:.1f}%, {ops:g} kernels and copies; peak "
          f"{mem[path]:.1f} MiB", flush=True)
    return rows


def pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def max_tile_counts(setup, cfg):
    """(largest fine-tile count, largest coarse-tile count) of the bins
    ops/binning.py builds from `setup`'s bboxes for cfg's main pass: each
    valid triangle counted in every tile of its bbox's tile range, as
    bin_triangles tests it, on the fine grid and on the two-level binner's
    coarse grid of 4x2 fine tiles over the padded grid. A 2D difference
    array sums them in O(triangles) memory, where the binner itself needs
    tiles x candidates."""
    import torch

    from ash_tpu_torch.ops.binning import grid_shape

    def largest(height, width, th, tw):
        ty, tx = grid_shape(height, width, th, tw)
        b = setup.bbox
        ok = (setup.valid & (b[:, 3] >= 0) & (b[:, 1] < height)
              & (b[:, 2] >= 0.0) & (b[:, 0] < width))
        b = b[ok]

        def index(c, size, hi):
            return torch.floor(c / size).clamp(0, hi).long()

        x0, x1 = index(b[:, 0], tw, tx - 1), index(b[:, 2], tw, tx - 1)
        y0, y1 = index(b[:, 1], th, ty - 1), index(b[:, 3], th, ty - 1)
        d = torch.zeros((ty + 1, tx + 1), dtype=torch.int64, device=b.device)
        one = torch.ones_like(x0)
        for ys, xs, v in ((y0, x0, one), (y0, x1 + 1, -one),
                          (y1 + 1, x0, -one), (y1 + 1, x1 + 1, one)):
            d.index_put_((ys, xs), v, accumulate=True)
        return int(d.cumsum(0).cumsum(1)[:ty, :tx].max())

    h, w = cfg.height, cfg.width
    ty, tx = grid_shape(h, w, cfg.tile_h, cfg.tile_w)
    ty_p, tx_p = -(-ty // 4) * 4, -(-tx // 2) * 2
    return (largest(h, w, cfg.tile_h, cfg.tile_w),
            largest(ty_p * cfg.tile_h, tx_p * cfg.tile_w, cfg.tile_h * 4,
                    cfg.tile_w * 2))


def chunked_paths(card, launches, layer_launches, mem, timed):
    """A16's chunked frame on the card: example 10's default scene (10,000
    instances of the 98x49 UV sphere, 96,040,000 triangles, 312 draws a
    chunk: 33 chunks, 8x128 tiles, K=2048, "nearest", no shadows, 1080p)
    for 2 frames: one B1 launch a chunk, overflow and covered recorded.
    B1 against the plain raster on chunk 0's main pass (one plain call),
    timed. Then the first 3 chunks (936 draws) chunked against the same
    draws unchunked, with the caps raised (escalate_tile_capacities on
    both) until neither drops a triangle: equal u8 images. At the
    example's own caps the nearest K of each chunk are kept, not of the
    scene, so there the two are recorded (overflow, PSNR), not held.
    -> (result row, max |depth err| of the kernel check)."""
    import statistics

    import torch

    import ash_tpu_torch
    from ash_tpu_torch.ops import raster, raster_cuda
    from ash_tpu_torch.render import bench_scene, frame

    t0 = time.perf_counter()
    r, _, cam, tris = bench_scene.build_mega_instancing_renderer(
        1920, 1080, "cuda")
    submit_s = time.perf_counter() - t0
    fargs = (cam.view_matrix(), cam.projection_matrix(), cam.position)
    chunks = r.prepare_chunked_frame(*fargs)
    c0 = chunks[0]
    cfg = c0.config
    _, setup, bins, _ = frame.main_pass_bins(cfg, c0.scene.buffers,
                                             c0.uniforms)
    args = (setup, bins, cfg.height, cfg.width, cfg.tile_h, cfg.tile_w)
    name = f"example 10 chunk K={bins.tri_ids.shape[1]}"
    per_chunk = r.config.max_draws_per_chunk
    n_chunks = -(-len(r.draw_items) // per_chunk)
    check((cfg.tile_h, cfg.tile_w, bins.tri_ids.shape[1], len(chunks))
          == (8, 128, 2048, n_chunks),
          f"example 10: {len(chunks)} chunks, tiles "
          f"{cfg.tile_h}x{cfg.tile_w}, K {bins.tri_ids.shape[1]}")
    got = raster_cuda.rasterize(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = raster.rasterize(*args)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    tid_bad = int((got.tri_id != want.tri_id).sum())
    depth_bad = int((got.depth != want.depth).sum())
    err = float((got.depth - want.depth).abs().max())
    check(tid_bad == 0 and depth_bad == 0, f"kernel != plain on {name}")
    launch, _, _ = raster_cuda.launcher(*args)
    empty = bins._replace(counts=torch.zeros_like(bins.counts))
    launch_empty, _, _ = raster_cuda.launcher(setup, empty, *args[2:])
    row = work(*args)
    row.update(wrapper_ms=cuda_ms(lambda: raster_cuda.rasterize(*args), 10),
               device_ms=statistics.mean([graph_ms(launch), graph_ms(launch)]),
               clear_ms=graph_ms(launch_empty), plain_ms=plain_ms,
               size=f"{cfg.width}x{cfg.height}")
    row["share_of_bound"] = row["bound_ms"] / row["device_ms"]
    timed[name, 1, False] = row
    print(f"phase6 kernel {name} {cfg.width}x{cfg.height} tiles 8x128 "
          f"(example 10, chunk 0 "
          f"of {len(chunks)}): tri_id mismatches {tid_bad}, depth mismatches "
          f"{depth_bad}, max |depth err| {err}, covered "
          f"{int((got.tri_id >= 0).sum())}, max tile count "
          f"{int(bins.counts.max())}, overflow {int(bins.overflow)}; device "
          f"{row['device_ms']} ms (every list empty {row['clear_ms']} ms), "
          f"wrapper loop {row['wrapper_ms']} ms, plain {plain_ms} ms (one "
          f"call); pairs evaluated {row['pairs_tested']} (in the bbox "
          f"{row['pairs_needed']}); bound {row['bound_ms']} ms by "
          f"{row['bound_by']}, {100 * row['share_of_bound']:.1f}% of it",
          flush=True)
    del chunks, c0, setup, bins, got, want, launch, launch_empty, empty, args

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, outs = [], []

    def two_frames():
        for _ in range(2):
            s0 = torch.cuda.Event(enable_timing=True)
            s1 = torch.cuda.Event(enable_timing=True)
            s0.record()
            o = r.render_frame(*fargs)
            s1.record()
            s1.synchronize()
            times.append(s0.elapsed_time(s1))
            outs.append(o)

    _, b1, b2 = counted(two_frames)
    path = "chunked example 10"
    launches[path], layer_launches[path] = b1, b2
    mem[path] = torch.cuda.max_memory_allocated() / 2**20
    image = r.read_back().copy()
    o = outs[-1]
    check(b1 == 2 * n_chunks and b2 == 0, f"{path}: one-layer launches {b1} "
          f"in 2 frames, peel {b2}, want {2 * n_chunks} and 0")
    check(image.shape == (cfg.height, cfg.width, 4) and int(o.covered_pixels) > 0
          and bool(torch.isfinite(o.color).all())
          and outs[0].image.equal(o.image),
          f"{path}: frame {image.shape}, covered {int(o.covered_pixels)}")
    wall, busy, idle, ops = busy_profile(lambda i: r.render_frame(*fargs), 1)
    result = dict(tris=tris, chunks=len(r._chunk_scenes),
                  shared=len({id(s.buffers.position)
                              for s in r._chunk_scenes}),
                  submit_s=submit_s, times=times, launches=(b1, b2),
                  covered=int(o.covered_pixels),
                  overflow=int(o.binning_overflow), wall=wall, busy=busy,
                  idle=idle, ops=ops)
    del r, outs, o

    # The first 3 chunks, chunked against unchunked.
    cut = 3 * per_chunk
    torch.cuda.empty_cache()
    pair = {k: bench_scene.build_mega_instancing_renderer(
        cfg.width, cfg.height, "cuda", n=cut, max_draws_per_chunk=c)[0]
        for k, c in (("chunked", per_chunk), ("unchunked", None))}
    imgs, own = {}, {}
    for k, rend in pair.items():
        out = rend.render_frame(*fargs)
        imgs[k] = rend.read_back().copy()
        own[k] = int(out.binning_overflow)
    own_psnr = ash_tpu_torch.psnr(imgs["chunked"], imgs["unchunked"])
    own_diff = u8_diff(imgs["chunked"], imgs["unchunked"])
    # Caps that drop nothing on either side: the largest fine and coarse
    # tile counts of every chunk's and of the unchunked main pass.
    counts = {}
    for k, rend in pair.items():
        inputs = (rend.prepare_chunked_frame(*fargs) if k == "chunked"
                  else [rend.prepare_frame(*fargs)])
        counts[k] = [max_tile_counts(frame.main_pass_setup(
            c.config, c.scene.buffers, c.uniforms)[1], c.config)
            for c in inputs]
        del inputs
    fine = max(f for v in counts.values() for f, _ in v)
    coarse = max(c for v in counts.values() for _, c in v)
    caps = dict(max_tris_per_tile=pow2(fine),
                binning_coarse_cap=pow2(max(coarse, fine)))
    print(f"phase6 example 10 cut to {cut} draws: largest (fine, coarse) "
          f"tile counts {counts}; drop-free caps {caps}", flush=True)
    for k, rend in pair.items():
        for name, value in caps.items():
            setattr(rend.config, name, value)
        out = rend.render_frame(*fargs)
        imgs[k] = rend.read_back().copy()
        check(int(out.binning_overflow) == 0, f"example 10 cut, {k}: "
              f"overflow {int(out.binning_overflow)} at the caps {caps}")
    drop_free = u8_diff(imgs["chunked"], imgs["unchunked"])
    check(drop_free == (0, 0), f"example 10 cut to {cut} draws: chunked != "
          f"unchunked at the drop-free caps {caps}: {drop_free}")
    result.update(cut=cut, own_overflow=own, own_psnr=own_psnr,
                  own_diff=own_diff, counts=counts, caps=caps)
    del pair, imgs
    print(f"phase6 {path}: {cfg.width}x{cfg.height}, {tris} triangles in "
          f"{result['chunks']} "
          f"chunks sharing {result['shared']} scene buffers; submit "
          f"{submit_s:.2f} s on the host; one-layer launches {b1} in 2 frames "
          f"(one a chunk), peel {b2}; frames {times} ms (CUDA events) on "
          f"{card}; covered {result['covered']}, overflow "
          f"{result['overflow']} (the nearest 2048 a tile a chunk kept); "
          f"under the profiler {wall:.1f} ms, device busy {busy:.1f} ms, "
          f"idle {100 * idle:.1f}%, {ops:g} kernels and copies per frame; "
          f"peak {mem[path]:.1f} MiB. Cut to {cut} draws (3 chunks): at the "
          f"example's caps overflow {own}, chunked against unchunked "
          f"{own_psnr:.2f} dB (largest u8 difference, pixels {own_diff}), "
          f"recorded; at the caps {caps}, overflow 0 on both sides: chunked "
          f"equal to unchunked: True", flush=True)
    return result, err


HOST_PROFILE_FRAMES = 60
# The scopes of a frame of the bench scene; the animated frame adds the
# shadow pass (the standard frame's map is cached after frame 0).
FRAME_PASSES = {"pass_vertex", "pass_cull", "pass_setup", "pass_binning",
                "pass_raster", "pass_gbuffer", "pass_shade", "pass_pack"}


def host_profile_phase(card, kind, launches, layer_launches):
    """Phase 7, part 1: ash_tpu_torch.host_profile of the animated and the
    standard frame at 1920x1080, 60 frames each (the tool's own lines go to
    a buffer): the buckets add up to the loop's host time, the spans to
    the traced render_frame within 1% (the tool raises otherwise), every
    pass_* scope of the frame shows, with its CUDA runtime calls, and
    pass_raster (and the animated pass_shadow) makes one ctypes raster
    call a frame. One line per scene; each path's launches counted from 0.
    -> {scene: the tool's JSON object}."""
    import io

    from ash_tpu_torch import host_profile

    lines = {}
    for static in (False, True):
        loop = host_profile.FrameLoop("cuda", 1000, static=static)
        path = f"host_profile {loop.scene}"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            line, b1, b2 = counted(
                lambda: host_profile.measure(loop, HOST_PROFILE_FRAMES))
        launches[path], layer_launches[path] = b1, b2
        # Warm-up frames 1-2, then the timed and the traced loop.
        per = 1 if static else 2
        want_b1 = 2 + per + 2 * HOST_PROFILE_FRAMES * per
        check(b1 == want_b1 and b2 == 0,
              f"{path}: one-layer launches {b1}, peel {b2}, want {want_b1}")
        check(line["card"] == card and line["device_name"] == kind
              and line["frames"] == HOST_PROFILE_FRAMES,
              f"{path}: the device or the frame count")
        b = line["buckets_ms"]
        host = sum(v for k, v in b.items() if k != "device_drain")
        check(abs(host - line["host_ms"]) <= 1e-9 * line["host_ms"],
              f"{path}: buckets sum to {host} ms, host {line['host_ms']} ms")
        split = line["render_frame_split"]
        passes = split["passes"]
        want = FRAME_PASSES | (set() if static else {"pass_shadow"})
        check(set(passes) == want,
              f"{path}: scopes {sorted(passes)}, want {sorted(want)}")
        check(all(p["kernel_launches"] > 0 for n, p in passes.items()
                  if n != "pass_raster"),
              f"{path}: a scope without CUDA runtime launches: "
              f"{ {n: p['kernel_launches'] for n, p in passes.items()} }")
        raster_calls = {n: p["raster_calls"] for n, p in passes.items()
                        if p["raster_calls"]}
        check(raster_calls == {"pass_raster": 1.0,
                               **({} if static else {"pass_shadow": 1.0})},
              f"{path}: ctypes raster calls a frame {raster_calls}")
        spans = [split["prepare"], *passes.values(), split["between_passes"],
                 split["image_copy"], split["present_rest"]]
        calls = sum(x["kernel_launches"] + x["copies"] + x["raster_calls"]
                    for x in spans)
        top = sorted(passes.items(), key=lambda kv: -kv[1]["ms"])[:3]
        print(f"phase7 {path} ({HOST_PROFILE_FRAMES} frames, {card}): loop "
              f"{line['loop_ms']:.3f} ms/frame, host {line['host_ms']:.3f}; "
              "buckets " + ", ".join(f"{k} {v:.3f}" for k, v in b.items())
              + f"; traced loop {line['traced_loop_ms']:.3f} ms/frame; "
              f"render_frame split: prepare {split['prepare']['ms']:.3f} "
              f"(upload {split['prepare']['upload_ms']:.3f}), passes "
              + ", ".join(f"{n} {p['ms']:.3f}" for n, p in top)
              + f", between passes {split['between_passes']['ms']:.3f}, "
              f"image copy wait {split['image_copy']['ms']:.3f}, rest "
              f"{split['present_rest']['ms']:.3f}; sum {split['sum_ms']:.3f} "
              f"against the traced render_frame "
              f"{line['traced_render_frame_ms']:.3f}; {calls:g} launches, "
              f"copies and raster calls a frame", flush=True)
        lines[loop.scene] = line
        del loop
    return lines


def scope_device_ms(step, scope, n=3):
    """(device span, kernel time) of `scope` a frame over n frames of step
    under torch.profiler, in ms. The span is the scope's GPU range, which
    holds the ctypes raster kernel too; the kernel time counts only the
    kernels of PyTorch's ops in it (as profile_frame.py reads them)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            step(i)
        torch.cuda.synchronize()
    span = kern = 0.0
    for e in prof.key_averages():
        if e.key != scope:
            continue
        if e.device_type == DeviceType.CUDA and e.is_user_annotation:
            span += e.device_time_total
        elif e.device_type == DeviceType.CPU:
            kern += e.device_time_total
    return span / 1e3 / n, kern / 1e3 / n


def kernel_device_ms(step, names, n=3):
    """(launches, device ms) a frame of the kernels whose name holds one of
    `names` over n frames of step under torch.profiler, read by name from
    the trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            step(i)
        torch.cuda.synchronize()
    found = [e for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and any(name in e.key for name in names)]
    return (sum(e.count for e in found) / n,
            sum(e.self_device_time_total for e in found) / 1e3 / n)


def lod_sharded_phase(card, launches, layer_launches):
    """Phase 7, part 2: example 07's LOD scene (distance 15) through
    make_sharded_frame over ["cuda:0"] * 4 against the same inputs' single
    frame: the image, the gathered shadow map and the scalars bit for bit;
    each band's shadow raster covers S/4 rows and none covers S (the single
    frame renders the whole map once); pass_shadow's device ms beside the
    single frame's. -> the result row."""
    import torch

    from ash_tpu_torch.ops import raster_cuda
    from ash_tpu_torch.parallel import make_sharded_frame, render_mesh
    from ash_tpu_torch.render.bench_scene import build_lod_renderer, lod_camera

    path, n = "sharded lod x4", 4
    r, _ = build_lod_renderer(1920, 1080, "cuda")
    cam = lod_camera(15.0, 1920, 1080)
    inputs = r.prepare_frame(cam.view_matrix(), cam.projection_matrix(),
                             cam.position)
    cfg, sc, uni, pool, lights, post, taa = inputs
    s = cfg.shadow_resolution
    check(cfg.lod_enabled and cfg.shadow_enabled and s != cfg.width,
          f"{path}: not a shadowed LOD frame of a {cfg.width}-wide target")
    fn = make_sharded_frame(cfg, render_mesh(devices=["cuda:0"] * n))
    shapes = []

    def observe(ins, outs):
        shapes.append(tuple(outs[0].shape))

    def sharded():
        return fn(sc.buffers, uni, pool, post, taa, None, lights)

    raster_cuda.rasterize.observers.append(observe)
    try:
        out, b1, b2 = counted(sharded)
        band_shapes, shapes[:] = list(shapes), []
        want = single_frame(inputs)
        single_shapes = list(shapes)
    finally:
        raster_cuda.rasterize.observers.remove(observe)
    launches[path], layer_launches[path] = b1, b2
    shadow_rows = [h for _, h, w in band_shapes if w == s]
    check(shadow_rows == [s // n] * n and b1 == 2 * n and b2 == 0,
          f"{path}: shadow rasters of {shadow_rows} rows, one-layer launches "
          f"{b1}, peel {b2}; want {n} of {s // n} rows, {2 * n} and 0")
    check([h for _, h, w in single_shapes if w == s] == [s],
          f"{path}: the single frame's shadow rasters {single_shapes}")
    most, px = u8_diff(out.image, want.image)
    bad = same_scalars(out, want)
    same_map = bool(torch.equal(out.shadow_map, want.shadow_map))
    check(most == 0 and not bad and same_map
          and bool(torch.equal(out.image, want.image))
          and bool(torch.isfinite(out.color).all()),
          f"{path}: against the single frame: largest u8 difference {most} "
          f"at {px} pixels, scalars {bad}, shadow map equal {same_map}")
    ms = frame_ms_spread(lambda i: sharded().image.cpu(), 5)[0]
    single_ms = frame_ms_spread(lambda i: single_frame(inputs).image.cpu(),
                                5)[0]
    span, kern = scope_device_ms(lambda i: sharded(), "pass_shadow")
    single_span, single_kern = scope_device_ms(
        lambda i: single_frame(inputs), "pass_shadow")
    row = dict(launches=(b1, b2), shadow_rows=shadow_rows,
               covered=int(out.covered_pixels),
               overflow=(int(out.binning_overflow), int(out.shadow_overflow)),
               ms=ms, single_ms=single_ms, pass_shadow_span_ms=span,
               pass_shadow_kernel_ms=kern, single_span_ms=single_span,
               single_kernel_ms=single_kern)
    print(f"phase7 {path} (example 07's LOD scene, distance 15, 1920x1080, "
          f"{s}^2 map, {n} bands on cuda:0): one-layer launches {b1}, peel "
          f"{b2}; shadow rasters of {shadow_rows} rows (the single frame: "
          f"one of {s}); covered {row['covered']}, overflow (main, shadow) "
          f"{row['overflow']}; equal to the single frame (u8, scalars, "
          f"shadow map): True; pass_shadow device span {span:.3f} ms a frame "
          f"(PyTorch kernels {kern:.3f}) against the single frame's "
          f"{single_span:.3f} ({single_kern:.3f}); frame {ms[0]:.2f} ms "
          f"(median of 5) against {single_ms[0]:.2f} on {card}", flush=True)
    return row


def benchmark_phase(card, kind):
    """Phase 8: benchmark/run.py's standard cell, short, in this process."""
    from benchmark import run as bench_run

    t0 = time.perf_counter()
    line = bench_run.run_cell("standard-1080p-1000obj", "cuda", timed=3,
                              traced=2)
    seconds = time.perf_counter() - t0
    print(f"phase8 benchmark standard-1080p-1000obj ({seconds:.1f} s): "
          f"{json.dumps(line)}", flush=True)
    check(line["card"] == card and line["device_name"] == kind
          and line["device"] == "cuda", "benchmark line: the device")
    for metric, unit in bench_run.METRICS.items():
        check(line["units"][metric] == unit and line[metric] > 0,
              f"benchmark line: {metric}")
    check(line["samples"] == line["frames_attempted"] == 3
          and len(line["frame_ms"]) == 3, "benchmark line: samples")
    graphs = line["checks"]["graphs"]
    check(graphs["frame"]["replays"] == 3 and not graphs["frame"]["eager"]
          and not graphs["frame"]["captures"]
          and line["checks"]["graphs_replayed"] is True,
          f"benchmark line: the timed frames' graph steps {graphs}")
    layers = line["layers"]
    check(layers["graph_pool_mib"] > 0
          and line["device_footprint_mib"] > layers["peak_allocated_mib"],
          f"benchmark line: footprint {line['device_footprint_mib']} MiB, "
          f"peak allocated {layers['peak_allocated_mib']}, graph pools "
          f"{layers['graph_pool_mib']}")
    print(f"phase8 benchmark trace: complete {layers['trace_complete']} in "
          f"{layers['trace_tries']} tries", flush=True)
    check(layers["traced_frames"] == 2 and "pass_shade" in layers["passes"]
          and layers["launches_per_frame"] > 0
          and layers["host_launch_calls_per_frame"] > 0
          and len(layers["top_device_ops"]) == 10
          and len(layers["idle_gaps"]) == 10, "benchmark line: the layers")
    if layers["trace_complete"]:
        check(layers["raster_launches_per_frame"] == 1
              and all(layers[f"{f}_launches_per_frame"] >= 1
                      and layers[f"{f}_kernel_ms"] > 0
                      for f in ("gbuffer", "shade", "shadow")),
              "benchmark line: the hand kernels by name")
        check(0 < layers["raster_bound_share"] <= 1,
              f"benchmark line: raster bound share "
              f"{layers['raster_bound_share']}")
    else:
        check(layers["raster_bound_share"] is None
              and layers["raster_kernel_ms"] is None,
              "benchmark line: numbers read from a lossy trace")
    check(line["checks"]["reference_check"] == "pass"
          and len(line["checks"]["reference_psnr_db"]) == 3
          and len(line["checks"]["reference_colour"]) == 3
          and all(c["pass"] for c in line["checks"]["reference_colour"]),
          "benchmark line: the reference check")
    check(0 <= layers["device_idle_share"] < 1,
          f"benchmark line: the idle share {layers['device_idle_share']}")
    check(line["checks"]["foreign_modules"] == []
          and line["checks"]["kernels_launched"] == {"raster": True},
          "benchmark line: the modules loaded, the kernels by name")
    check(line["correct"] is True, "benchmark line: not correct")
    # The animated cell runs three graphs a frame (the TRS composition, the
    # shadow pass, the frame): each must replay in every timed frame.
    t0 = time.perf_counter()
    line = bench_run.run_cell("animated-1080p-1000obj", "cuda", timed=3,
                              traced=2)
    graphs = line["checks"]["graphs"]
    print(f"phase8 benchmark animated-1080p-1000obj "
          f"({time.perf_counter() - t0:.1f} s): graphs {graphs}, trace "
          f"complete {line['layers']['trace_complete']} in "
          f"{line['layers']['trace_tries']} tries, kernels from "
          f"{line['checks']['kernels_launched_from']}, correct "
          f"{line['correct']}", flush=True)
    check(all(graphs[s] == {"eager": {}, "captures": 0, "replays": 3}
              for s in ("frame", "shadow", "models"))
          and line["checks"]["graphs_replayed"] is True
          and line["correct"] is True,
          f"benchmark animated: the timed frames' graph steps {graphs}")
    # The control: frame 0-2 shaded in bfloat16 keep their 8-bit PSNR, and
    # the float check must refuse them.
    line = bench_run.run_cell("standard-1080p-1000obj", "cuda", timed=1,
                              traced=0, control="bf16")
    checks = line["checks"]
    print(f"phase8 benchmark control bf16: PSNR {checks['reference_psnr_db']}"
          f" dB, share beyond the float tolerance "
          f"{[c['share_beyond'] for c in checks['reference_colour']]}",
          flush=True)
    check(min(checks["reference_psnr_db"]) >= bench_run.PSNR_MIN_DB
          and not any(c["pass"] for c in checks["reference_colour"])
          and line["correct"] is False, "benchmark control: not refused")


# f32 operations of csrc/texture.cu: a tap, two bilinear levels of 46 (the
# texel coordinates, floors, weights and three 4-channel lerps) and the
# trilinear blend (12); an anisotropic tap adds its position (7) and the sum
# (4); a footprint (map_footprint) is 26 with anisotropy (level 0's size
# (2), the four scaled derivatives, two norms of 4, the clamped max and min
# (4), ceil(rho_max / rho_min) clamped (4), log2(rho_max / n) clamped (3),
# the major axis' compare), 18 without.
OPS_TRILINEAR_TAP = 104
OPS_FOOTPRINT_TAP = 115
OPS_FOOTPRINT = {True: 26, False: 18}
# f32 operations of csrc/lights.cu a pixel-light pair, as light_loop.py's
# loop body counts them (a compare, clamp or select is one): the direction
# and distance (13), the directional select (1), the falloff (9), the cone
# (8), the attenuation's selects (4), n.l (6), the half vector (13), n.h
# and v.h (12), GGX (9), Smith (12), Fresnel (14), the specular term and
# its cap (22), kD (7), the contribution (16) and the sum into lo (3).
OPS_PER_LIGHT_PAIR = 149
# Bytes of a packed GpuLight row.
LIGHT_ROW_BYTES = 64
# csrc/bloom.cu's instantiations, as ptxas_usage names them.
BLOOM_INSTANTIATIONS = sorted([
    "bloom down blocks", "bloom down blocks staged threshold",
    "bloom down gather", "bloom down gather threshold", "bloom up double",
    "bloom up double staged", "bloom up gather", "bloom up gather threshold"])
# Bloom launches a rich 1080p frame: five levels, each down and up.
RICH_BLOOM_LAUNCHES = 10
# f32 operations of the bloom chain (ops/bloom.py, as csrc/bloom.cu runs
# it; a compare, clamp, floor or select is one): the soft threshold, once a
# frame texel (the brightness (2), the knee (4 with the clamp), its square
# and scale (2), the max (2), the floor and quotient (2), the colour (3));
# a target texel of each path: the 2x2-block downsample (9 taps of 3
# channels x 9, the Karis sums 131, the 3 quotients), the gathered
# downsample (the centre 4, 9 taps of 12 for the position and 27 for the
# lerps, the Karis sums and quotients 134), the 2x tent (9 taps of 27, the
# sum 36, the add 3) and the gathered tent (the centre 4, 9 taps of 39, the
# sum 36, the add 3).
OPS_BLOOM_THRESHOLD = 15
OPS_BLOOM = {("down", "blocks"): 377, ("down", "gather"): 489,
             ("up", "double"): 282, ("up", "gather"): 394}
# The sizes phase 11 holds the kernels to the plain chain at besides the
# frames' own inputs: tests/test_torch_bloom_kernel.py's (H, W, mips).
BLOOM_SIZES = [(128, 192, 5), (135, 240, 2), (270, 480, 5), (20, 12, 5),
               (2, 2, 5), (64, 96, 0), (3, 5, 4)]
# The frames whose shade calls phase 10 replays: (name, bench scene keywords).
LIGHT_FRAMES = [("rich", dict(rich=True)), ("lit", dict(lights=32)),
                ("lit bf16", dict(lights=32, shade_dtype="bf16"))]
# A textured frame 1's sampler calls, in order: the shadow pass's alpha
# test, the main pass's, then shade_pbr's five maps in one call.
SAMPLER_CALLS = ["alpha test shadow", "alpha test main", "maps"]
# csrc/shadow.cu's instantiations, as ptxas_usage names them: C cascades
# (1: the single map), the blend of the next cascade, bf16 normals, the
# window path.
SHADOW_INSTANTIATIONS = sorted(
    [f"shadow C=1{d}{w}" for d in ("", " bf16") for w in ("", " windows")]
    + [f"shadow C={c}{b}{d}{w}" for c in (2, 3, 4) for b in ("", " blend")
       for d in ("", " bf16") for w in ("", " windows")])
# Its kernels' names, as a trace shows them: quad by quad, the window path.
SHADOW_KERNELS = ("shadow_pcf_kernel", "shadow_window_kernel")
# The 1080p frames whose shade calls phase 12 replays: (name, bench scene
# keywords, with "cascades" for a CsmConfig of that many 1024^2 cascades,
# MSAA preset); of them, the frames it renders with the kernel and with the
# plain PCF.
SHADOW_CALL_FRAMES = [("standard", {}, None), ("glass", dict(glass=True), None),
                      ("rich", dict(rich=True), None),
                      ("rich 2 cascades", dict(rich=True, cascades=2), None),
                      ("rich 4 cascades", dict(rich=True, cascades=4), None),
                      ("edge x4", dict(msaa_resolve="edge"), "x4")]
SHADOW_FRAMES = ("standard", "rich", "glass")
# Seeded square maps of sizes that are not powers of two, at the standard
# and rich calls' elements.
SHADOW_ODD_SIZES = (257, 1000)
# The 1080p frames whose G-buffer calls phase 13 replays: (name, bench
# scene keywords, None for the mega frame, MSAA preset); of them, the frames
# it renders with the kernel and with the plain fetch.
GBUFFER_CALL_FRAMES = [
    ("standard", {}, None), ("animated", dict(animate=True), None),
    ("rich", dict(rich=True), None), ("textured", dict(textured=True), None),
    ("glass", dict(glass=True, transparency_passes=2), None),
    ("mega", None, None), ("edge x4", dict(msaa_resolve="edge"), "x4")]
GBUFFER_FRAMES = ("standard", "rich", "glass")
# csrc/shade.cu's kernels, as ptxas_usage names them: the whole call and the
# surface stage, untextured and textured, and compose.
SHADE_INSTANTIATIONS = sorted(
    [f"shade{s}{t}" for s in ("", " surface") for t in ("", " textured")]
    + ["shade compose"])
# The frames phase 14 renders with the shading kernels and with the plain
# shade_pbr (their keywords are GBUFFER_CALL_FRAMES').
SHADE_FRAMES = ("standard", "rich", "textured", "glass")
# f32 operations an element of csrc/shade.cu, as the plain shade_pbr counts
# them (a compare, clamp or select is one): the view direction (13), the
# flip (4), the roughness clamp (1), n.l (6), f0 (8), the half vector (13),
# n.v, n.h and v.h (18), GGX (9), Smith (11), Fresnel (14), the specular
# term (10) and its cap (12), kD (7), the diffuse term (6), the light's
# weight and lo (11), the ambient term (3), the sum (6), Reinhard (6) and
# the clear colour (3); textured, also the base colour (3), the TBN frame
# (41), the normal map (38), its tests and normalisation (25) and the
# metallic-roughness, occlusion and emissive terms (12).
OPS_SHADE = {False: 161, True: 280}
# f32 operations an element of the G-buffer fetch, as the plain version
# counts them (csrc/gbuffer.cu): the weights at three positions (3 x 20, and
# the two steps), 13 channels interpolated at the element and uv's 2 at the
# two steps (19 x 5), the normal's normalisation (10), the uv derivatives
# (4), the mask, the clamp and the facing (3); with the velocity also the
# last clip position's 4 channels (20) and its projection against the
# element's uv (17).
OPS_GBUFFER = {False: 174, True: 211}
# The textured frame's kernels and copies a frame in PR 12's benchmark
# trace (PERF.md section 5), before the maps were fused.
PR12_TEXTURED_LAUNCHES = 1032


def sampler_calls(rend, view, proj, pos):
    """Render frame 1 of `rend` with the texture entry points wrapped ->
    [(name, the entry's arguments)] in call order, named as SAMPLER_CALLS
    names a textured frame 1's calls: (pool, indices, uv, ddx, ddy,
    max_aniso, mask) for the maps, (pool, index, uv, lod, mask) for an
    alpha test."""
    from ash_tpu_torch.ops import texture_cuda

    calls = []
    real_maps = texture_cuda.sample_maps
    real_tri = texture_cuda.sample_trilinear

    def maps(*args):
        calls.append(args)
        return real_maps(*args)

    def trilinear(pool, index, uv, lod, mask):
        calls.append((pool, index, uv, lod, mask))
        return real_tri(pool, index, uv, lod, mask)

    with mock.patch.object(texture_cuda, "sample_maps", maps), \
            mock.patch.object(texture_cuda, "sample_trilinear", trilinear):
        rend.render_frame(view, proj, pos)
    kinds = [len(c) == 7 for c in calls]
    check(kinds == [False, False, True],
          f"textured frame 1: sampler calls (maps?) {kinds}")
    return list(zip(SAMPLER_CALLS, calls))


def plain_sample(*args):
    """The plain sampler on the same tensors, 0 where the mask does not
    hold (five (..., 4) for the maps)."""
    import torch

    from ash_tpu_torch.ops import texture_sample

    if len(args) == 7:
        return texture_sample.sample_maps(*args)
    pool, index, uv, lod, mask = args
    return torch.where(mask[..., None],
                       texture_sample.sample_trilinear(pool, index, uv, lod),
                       0.0)


def texture_work(*args):
    """(bound ms, "bytes" or "operations", bytes, operations, taps) of one
    launch of either entry at the memory rate and the f32 rate, counted
    from these inputs. Bytes: a covered element reads its inputs once for
    every map (mask, uv and the indices; the maps' derivatives, the alpha
    test's LOD) and writes 16 a map; an uncovered one reads its mask and
    writes 16 a map; the mip table entries that the covered elements'
    footprints and levels read, each texture's level count (and residency),
    and the texels of the levels they select, over all maps, are read once.
    Operations: the footprints and the taps these inputs need (covered
    elements with a texture, n_taps each)."""
    import torch

    from ash_tpu_torch.ops import texture_sample

    pool, mask = args[0], args[-1]
    maps = len(args) == 7
    if maps:
        _, indices, uv, ddx, ddy, aniso, _ = args
        lods = [None] * indices.shape[-1]
        per_covered = 8 + 16 + 4 * indices.shape[-1]
    else:
        _, index, uv, lod, _ = args
        indices, aniso = index[..., None], 1
        lods = [lod if lod is not None else torch.zeros_like(uv[..., 0])]
        per_covered = 8 + 4 + (4 if lod is not None else 0)
    n, k = mask.numel(), indices.shape[-1]
    covered = int(mask.sum())
    nbytes = n * (mask.element_size() + 16 * k) + covered * per_covered
    max_mips = pool.table.shape[1]
    keys, textures, taps, ops = [], [], 0.0, 0.0
    for m in range(k):
        index = indices[..., m]
        tex = index.clamp_min(0).long()
        live = mask & (index >= 0)
        if maps:
            fp = texture_sample.map_footprint(pool, index, ddx, ddy, aniso)
            lods[m] = fp.lod
            keys.append((tex * max_mips)[mask])  # level 0's size
            ops += covered * OPS_FOOTPRINT[aniso > 1]
            if fp.n_taps is not None:
                m_taps = float(torch.where(live, fp.n_taps, 0.0).sum())
                ops += m_taps * OPS_FOOTPRINT_TAP
            else:
                m_taps = float(live.sum())
                ops += m_taps * OPS_TRILINEAR_TAP
        else:
            m_taps = float(live.sum())
            ops += m_taps * OPS_TRILINEAR_TAP
        taps += m_taps
        # The two levels an element reads (texture_sample.sample_trilinear).
        levels = pool.levels[tex]
        floor_level = (pool.min_level[tex].to(torch.float32)
                       if pool.min_level is not None
                       else torch.zeros_like(lods[m]))
        lv = torch.minimum(torch.maximum(lods[m], floor_level),
                           (levels - 1).to(torch.float32))
        l0 = torch.floor(lv).to(torch.int32)
        for level in (l0, torch.minimum(l0 + 1, levels - 1)):
            key = tex * max_mips + level.clamp(0, max_mips - 1).long()
            keys.append(key[mask])
            # Texels only where a texture is sampled (not white).
            keys.append(-1 - key[live])
        textures.append(tex[mask])
    keys = torch.cat(keys).unique()
    entries = keys[keys >= 0]
    sampled = -1 - keys[keys < 0]
    sizes = pool.table.view(-1, 3)[sampled].long()
    per_texture = 4 * (1 + (pool.min_level is not None))
    nbytes += (entries.numel() * 12
               + int(torch.cat(textures).unique().numel()) * per_texture
               + int((sizes[:, 1] * sizes[:, 2]).sum()) * 8)
    t_bytes, t_ops = nbytes / MEM_RATE * 1e3, ops / F32_RATE * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops, taps)


def busy_ms(fn, n=5):
    """The kernels' and copies' own device time of one call of fn, in ms,
    under torch.profiler (fn may launch many small kernels, whose host
    enqueue time CUDA events around the calls would measure instead)."""
    return busy_profile(lambda i: fn(), n)[1]


def texture_phase(card, view, proj, pos, tex_launches):
    """Phase 9: the texture kernel (csrc/texture.cu) against the plain
    sampler at the 1080p textured frame's own inputs (its frame 1: the
    shadow and main passes' alpha tests and the five maps in one call) at
    anisotropy 16 and 1, bit for bit on covered elements and 0 elsewhere;
    each launch timed (CUDA events, plain, kernel, kernel, plain) beside its
    bound; the old path's eager footprints;
    frames 2 and 3 with the kernel (launches counted from 0) against the
    same frames with the plain sampler patched in. -> ({shape: its
    numbers}, the largest |kernel - plain| on covered elements)."""
    import torch

    from ash_tpu_torch.ops import shade, texture_cuda, texture_sample
    from ash_tpu_torch.render.bench_scene import build_bench_renderer

    def counts():
        return [texture_cuda.launches[k] for k in ("maps", "trilinear")]

    def entry(*args):
        if len(args) == 7:
            return texture_cuda.sample_maps(*args)
        return texture_cuda.sample_trilinear(*args)

    def launcher(*args):
        if len(args) == 7:
            return texture_cuda.maps_launcher(*args)
        return texture_cuda.launcher(*args)

    def compare(got, want, mask, what):
        if isinstance(got, tuple):  # the five maps
            got, want = torch.stack(got), torch.stack(want)
        bad = int((got.view(torch.int32) != want.view(torch.int32))[
            ..., mask, :].sum())
        nonzero = int((got[..., ~mask, :] != 0).sum())
        check(bad == 0 and nonzero == 0,
              f"texture kernel != plain sampler on {what}: {bad} covered "
              f"values differ, {nonzero} uncovered values not 0")
        return float((got - want)[..., mask, :].abs().max())

    def plain_maps(pool, indices, uv, ddx, ddy, max_aniso, mask):
        return texture_sample.sample_maps(pool, indices, uv, ddx, ddy,
                                          max_aniso, mask)

    def plain_trilinear(pool, index, uv, lod, mask):
        return texture_sample.sample_trilinear(pool, index, uv, lod)

    rows, max_err = {}, 0.0
    for aniso in (16, 1):
        rend = build_bench_renderer(1920, 1080, 1000, "cuda", textured=True,
                                    max_anisotropy=aniso)[0]
        for name, args in sampler_calls(rend, view, proj, pos):
            mask = args[-1]
            want = plain_sample(*args)
            err = compare(entry(*args), want, mask,
                          f"{name} (anisotropy {aniso})")
            max_err = max(max_err, err)
            launch, _ = launcher(*args)
            kern, plain = [], []
            for order in ("plain", "kernel", "kernel", "plain"):
                if order == "kernel":
                    kern.append(cuda_ms(launch, 50))
                else:
                    plain.append(cuda_ms(lambda: plain_sample(*args), 3))
            bound, bound_by, nbytes, ops, taps = texture_work(*args)
            row = dict(size="x".join(map(str, mask.shape[::-1])),
                       device_ms=statistics.mean(kern),
                       plain_ms=statistics.mean(plain),
                       wrapper_ms=cuda_ms(lambda: entry(*args), 20),
                       bound_ms=bound, bound_by=bound_by, bytes=nbytes,
                       operations=ops, covered=int(mask.sum()), taps=taps,
                       max_abs_err=err)
            row["share_of_bound"] = row["bound_ms"] / row["device_ms"]
            extra = ""
            if len(args) == 7:
                # The old path's five eager footprints (map_footprint a map).
                pool, indices, uv, ddx, ddy = args[:5]
                row["eager_footprints_ms"] = busy_ms(lambda: [
                    texture_sample.map_footprint(pool, indices[..., m], ddx,
                                                 ddy, aniso)
                    for m in range(indices.shape[-1])])
                extra = (f"; the old path's five eager footprints "
                         f"{row['eager_footprints_ms']} ms of device time")
            rows[f"aniso {aniso} {name}"] = row
            print(f"phase9 texture kernel {name}, anisotropy {aniso} "
                  f"({row['size']}, {row['covered']} covered, {taps:g} "
                  f"taps): covered values unequal to the plain sampler 0, "
                  f"uncovered values not 0: 0, max |err| {err}; device "
                  f"{row['device_ms']} ms (mean of 50 launches), entry "
                  f"{row['wrapper_ms']} ms, plain {row['plain_ms']} ms; bound "
                  f"{row['bound_ms']} ms by {bound_by} ({nbytes} bytes, "
                  f"{ops:g} f32 operations), "
                  f"{100 * row['share_of_bound']:.1f}% of it{extra} ({card})",
                  flush=True)
        # Frames 2 and 3 (frame 1 was sampler_calls') with the kernel, its
        # launches counted from 0 and no eager footprint allowed; the same
        # frames with the plain sampler patched in, which launches nothing.
        path = f"textured aniso{aniso}"
        for k in texture_cuda.launches:
            texture_cuda.launches[k] = 0
        frames = []

        def no_footprint(*args, **kwargs):
            raise AssertionError(f"{path}: the frame computed an eager "
                                 "footprint (map_footprint)")

        with mock.patch.object(texture_sample, "map_footprint",
                               no_footprint), \
                mock.patch.object(shade, "map_footprint", no_footprint):
            for _ in range(2):
                rend.render_frame(view, proj, pos)
                frames.append((rend.read_back().copy(),
                               rend.last_outputs().color.clone()))
        launched = counts()
        if aniso == 1:  # phase 4 counted the anisotropy-16 frame
            tex_launches[path] = launched
        check(launched == [2, 2], f"{path}: texture launches (maps, "
              f"trilinear) {launched}, want [2, 2]")
        plain = build_bench_renderer(1920, 1080, 1000, "cuda", textured=True,
                                     max_anisotropy=aniso)[0]
        with mock.patch.object(texture_cuda, "sample_maps", plain_maps), \
                mock.patch.object(texture_cuda, "sample_trilinear",
                                  plain_trilinear):
            plain.render_frame(view, proj, pos)
            for image, color in frames:
                plain.render_frame(view, proj, pos)
                check(np.array_equal(plain.read_back(), image)
                      and torch.equal(
                          plain.last_outputs().color.view(torch.int32),
                          color.view(torch.int32)),
                      f"{path}: a frame with the kernel != the frame with "
                      "the plain sampler")
            plain_shade = scope_device_ms(
                lambda i: plain.render_frame(view, proj, pos), "pass_shade",
                n=2)[0]
        check(counts() == launched, f"{path}: the plain frames launched the "
              "texture kernel")
        shade_ms = scope_device_ms(lambda i: rend.render_frame(view, proj, pos),
                                   "pass_shade")[0]
        raster_ms = scope_device_ms(
            lambda i: rend.render_frame(view, proj, pos), "pass_raster")[0]
        # The texture kernel's own time in the frame, read by name.
        in_frame = kernel_device_ms(
            lambda i: rend.render_frame(view, proj, pos),
            ("texture_maps_kernel", "texture_trilinear_kernel"))
        rows[f"aniso {aniso} frame"] = dict(
            pass_shade_ms=shade_ms, plain_pass_shade_ms=plain_shade,
            pass_raster_ms=raster_ms, kernel_launches=in_frame[0],
            kernel_ms=in_frame[1])
        del rend, plain, frames
        print(f"phase9 {path} frame: frames 2 and 3 with the kernel equal "
              f"the plain sampler's (u8 and colour); texture launches "
              f"(maps, trilinear) {launched}; device span a static "
              f"frame: pass_shade {shade_ms:.3f} ms (the plain sampler's "
              f"{plain_shade:.3f}), pass_raster {raster_ms:.3f} ms; the "
              f"texture kernel in the frame's trace: {in_frame[0]:g} "
              f"launches, {in_frame[1]} ms a frame ({card})", flush=True)
    return rows, max_err


def light_calls(rend, view, proj, pos):
    """Render a frame of `rend` with the light entry wrapped -> its
    add_lights arguments, `lo` copied before the call."""
    from ash_tpu_torch.ops import lights_cuda

    calls = []
    real = lights_cuda.add_lights

    def record(*args):
        calls.append((args[0].clone(), *args[1:]))
        return real(*args)

    with mock.patch.object(lights_cuda, "add_lights", record):
        rend.render_frame(view, proj, pos)
    return calls


def light_work(lo, mask, world, normal, view_dir, base_color, metallic,
               roughness, f0, ndotv, lights, tile_indices, tile_counts,
               light_tile_size, pixel_xy=None):
    """(bound ms, "bytes" or "operations", bytes, operations, pairs) of one
    launch of the light kernel at the memory rate and the f32 rate, counted
    from these inputs. Bytes: a covered element reads its position and the
    seven shading inputs (and its pixel_xy) once and reads and writes `lo`;
    every element reads its mask; the counts, the slots the covered
    elements' tiles walk and the light rows they name are read once.
    Operations: OPS_PER_LIGHT_PAIR for each (covered element, live slot)."""
    import torch

    ty, tx, k = tile_indices.shape
    if pixel_xy is not None:
        px, py = (c.long() for c in pixel_xy)
    else:
        h, w = mask.shape
        py, px = torch.meshgrid(torch.arange(h, device=mask.device),
                                torch.arange(w, device=mask.device),
                                indexing="ij")
    tile = (torch.div(py, light_tile_size, rounding_mode="floor")
            .clamp(0, ty - 1) * tx
            + torch.div(px, light_tile_size, rounding_mode="floor")
            .clamp(0, tx - 1))[mask]
    counts = (tile_counts.reshape(-1).long().clamp(0, k)
              if tile_counts is not None
              else torch.full((ty * tx,), k, device=mask.device))
    slots = tile_indices.reshape(ty * tx, -1)[:, :k]
    walked = torch.arange(k, device=mask.device) < counts[:, None]
    live = walked & (slots >= 0)
    pairs = int(live.sum(-1)[tile].sum())
    used = tile.unique()
    covered = int(mask.sum())
    d = lo.element_size()
    per_covered = 12 + 12 * d + 3 * d + 6 * d + (8 if pixel_xy else 0)
    nbytes = (mask.numel() + covered * per_covered
              + (4 * ty * tx if tile_counts is not None else 0)
              + 4 * int(walked[used].sum())
              + LIGHT_ROW_BYTES * int(slots[used][live[used]].unique().numel()))
    ops = pairs * OPS_PER_LIGHT_PAIR
    t_bytes, t_ops = nbytes / MEM_RATE * 1e3, ops / F32_RATE * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops, pairs)


def light_phase(card, view, proj, pos, light_launches, usage):
    """Phase 10: the light kernel (csrc/lights.cu) against the plain loop
    at the 1080p rich, lit and bf16 lit frames' own shade calls, bit for bit
    on covered elements and the others untouched; each launch timed (CUDA
    events, plain, kernel, kernel, plain) beside its bound; frames 2 and 3
    with the kernel (launches counted from 0) against the same frames with
    the plain loop patched in; the rich and lit frames timed and traced
    with each. -> ({name: its numbers}, the largest |kernel - plain| on
    covered elements)."""
    import torch

    from ash_tpu_torch.ops import light_loop, lights_cuda
    from ash_tpu_torch.render.bench_scene import build_bench_renderer

    def no_plain_loop(*args, **kwargs):
        raise AssertionError("a card frame ran the plain light loop")

    rows, max_err = {}, 0.0
    rows["usage"] = {k: v for k, v in usage.items() if k.startswith("light")}
    print("phase10 light kernel, registers and spill bytes by instantiation: "
          + "; ".join(f"{k}: {r}, {sp}"
                      for k, (r, sp) in sorted(rows["usage"].items()))
          + f" ({card})", flush=True)
    for name, kw in LIGHT_FRAMES:
        rend = build_bench_renderer(1920, 1080, 1000, "cuda", **kw)[0]
        calls = light_calls(rend, view, proj, pos)
        check(len(calls) == 1, f"{name}: {len(calls)} light calls a frame")
        args = calls[0]
        lo_in, mask = args[0], args[1]
        want = lights_cuda.plain(lo_in.clone(), *args[1:])
        got = lights_cuda.add_lights(lo_in.clone(), *args[1:])
        int_view = torch.int16 if lo_in.dtype == torch.bfloat16 else torch.int32
        equal = bool(torch.equal(got[mask], want[mask]))
        untouched = bool(torch.equal(got[~mask].view(int_view),
                                     lo_in[~mask].view(int_view)))
        check(equal and untouched, f"light kernel != plain loop on the {name} "
              f"frame: covered equal {equal}, uncovered untouched {untouched}")
        err = float((got.float() - want.float())[mask].abs().max())
        max_err = max(max_err, err)
        work = lo_in.clone()
        launch, _ = lights_cuda.launcher(work, *args[1:])
        kern, plain = [], []
        for order in ("plain", "kernel", "kernel", "plain"):
            if order == "kernel":
                kern.append(cuda_ms(launch, 50))
            else:
                plain.append(cuda_ms(
                    lambda: lights_cuda.plain(lo_in.clone(), *args[1:]), 3))
        bound, bound_by, nbytes, ops, pairs = light_work(*args)
        row = dict(size="x".join(map(str, mask.shape[::-1])),
                   dtype=str(lo_in.dtype).replace("torch.", ""),
                   device_ms=statistics.mean(kern),
                   plain_ms=statistics.mean(plain),
                   wrapper_ms=cuda_ms(
                       lambda: lights_cuda.add_lights(work, *args[1:]), 20),
                   bound_ms=bound, bound_by=bound_by, bytes=nbytes,
                   operations=ops, covered=int(mask.sum()), pairs=pairs,
                   largest_count=int(args[12].max()), max_abs_err=err)
        row["share_of_bound"] = row["bound_ms"] / row["device_ms"]
        rows[name] = row
        print(f"phase10 light kernel, {name} frame's shade call "
              f"({row['size']} {row['dtype']}, {row['covered']} covered, "
              f"{pairs} pixel-light pairs, largest tile count "
              f"{row['largest_count']}): equal to the plain loop on covered "
              f"elements, the others untouched, max |err| {err}; device "
              f"{row['device_ms']} ms (mean of 50 launches), entry "
              f"{row['wrapper_ms']} ms, plain {row['plain_ms']} ms; bound "
              f"{bound} ms by {bound_by} ({nbytes} bytes, {ops} f32 "
              f"operations), {100 * row['share_of_bound']:.1f}% of it "
              f"({card})", flush=True)

        # Frames 2 and 3 with the kernel, counted from 0, and the same
        # frames with the plain loop patched in, which launches nothing.
        lights_cuda.launches["loop"] = 0
        frames = []
        with mock.patch.object(light_loop, "light_slots", no_plain_loop):
            for _ in range(2):
                rend.render_frame(view, proj, pos)
                frames.append((rend.read_back().copy(),
                               rend.last_outputs().color.clone()))
        launched = lights_cuda.launches["loop"]
        light_launches[f"{name} frames 2-3"] = launched
        check(launched == 2, f"{name}: light kernel launches {launched} in "
              "frames 2 and 3, want 2")
        plain_r = build_bench_renderer(1920, 1080, 1000, "cuda", **kw)[0]
        plain_loop = mock.patch.object(lights_cuda, "add_lights",
                                       lights_cuda.plain)
        with plain_loop:
            plain_r.render_frame(view, proj, pos)
            for image, color in frames:
                plain_r.render_frame(view, proj, pos)
                check(np.array_equal(plain_r.read_back(), image)
                      and torch.equal(plain_r.last_outputs().color, color),
                      f"{name}: a frame with the light kernel != the frame "
                      "with the plain loop")
        check(lights_cuda.launches["loop"] == launched,
              f"{name}: the plain-loop frames launched the light kernel")
        line = (f"phase10 {name} frames 2 and 3: equal to the plain loop's "
                f"(u8 and colour); light kernel launches {launched}")
        if name != "lit bf16":
            def step(i, r=rend):
                r.render_frame(view, proj, pos)

            def plain_step(i, r=plain_r):
                with plain_loop:
                    r.render_frame(view, proj, pos)

            timed = {"kernel": [], "plain": []}
            for order in ("plain", "kernel", "kernel", "plain"):
                timed[order].append(frame_ms_spread(
                    step if order == "kernel" else plain_step, 5))
            frame_row = {}
            for k, st in (("kernel", step), ("plain", plain_step)):
                wall, busy, idle, n_ops = busy_profile(st)
                frame_row[k] = dict(
                    ms=[t[0][0] for t in timed[k]],
                    peak_mib=max(t[1] for t in timed[k]),
                    pass_shade_ms=scope_device_ms(st, "pass_shade", n=2)[0],
                    busy_ms=busy, idle=idle, ops=n_ops)
            frame_row["kernel"]["light_kernel"] = kernel_device_ms(
                step, ("light_tile_kernel", "light_element_kernel"))
            rows[f"{name} frame"] = frame_row
            kf, pf = frame_row["kernel"], frame_row["plain"]
            line += (f"; frame ms (median of 5, in turns) kernel {kf['ms']}, "
                     f"plain loop {pf['ms']}; peak {kf['peak_mib']:.1f} / "
                     f"{pf['peak_mib']:.1f} MiB; pass_shade device span "
                     f"{kf['pass_shade_ms']:.3f} / {pf['pass_shade_ms']:.3f} "
                     f"ms; kernels and copies a frame {kf['ops']:g} / "
                     f"{pf['ops']:g}; device busy {kf['busy_ms']:.2f} / "
                     f"{pf['busy_ms']:.2f} ms, idle {100 * kf['idle']:.1f} / "
                     f"{100 * pf['idle']:.1f}% (kernel / plain); the light "
                     f"kernel in the frame's trace: "
                     f"{kf['light_kernel'][0]:g} launches, "
                     f"{kf['light_kernel'][1]} ms a frame")
        print(f"{line} ({card})", flush=True)
        del rend, plain_r, frames, calls, args, work
    return rows, max_err


def bloom_work(h, w, mip_count):
    """(bound ms, "bytes" or "operations", bytes, operations, level bytes)
    of the bloom chain over an (h, w) frame at the memory rate and the f32
    rate. Bytes: the frame read once and the bloom written once. Operations:
    the soft threshold once a frame texel and OPS_BLOOM a target texel of
    each launch (ops/bloom_cuda.levels). Level bytes: what the kernels move
    with each level written and read back once (a launch's source, addend
    and target)."""
    from ash_tpu_torch.ops import bloom_cuda

    plan = bloom_cuda.levels(h, w, mip_count)
    nbytes = 2 * h * w * 12
    ops = OPS_BLOOM_THRESHOLD * h * w + sum(
        OPS_BLOOM[s.kind, s.path] * s.dst[0] * s.dst[1] for s in plan)
    level_bytes = sum(12 * (s.src[0] * s.src[1]
                            + s.dst[0] * s.dst[1] * (1 + s.add))
                      for s in plan)
    t_bytes, t_ops = nbytes / MEM_RATE * 1e3, ops / F32_RATE * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops, level_bytes)


def bloom_calls(fn):
    """Run fn() with the bloom entry wrapped -> its (hdr copy, keyword
    arguments) per call."""
    from ash_tpu_torch.ops import bloom_cuda

    calls = []
    real = bloom_cuda.bloom_pyramid

    def record(hdr, **kwargs):
        calls.append((hdr.clone(), kwargs))
        return real(hdr, **kwargs)

    with mock.patch.object(bloom_cuda, "bloom_pyramid", record):
        fn()
    return calls


def bloom_kernel_ms(launch, n=20):
    """{instantiation: (launches a chain, device ms a launch)} of n bare
    chains under torch.profiler, read by kernel name (ptxas_usage's names
    without "bloom "). The profiler may miss a chain's first events, so the
    launches a chain are rounded and a launch's time is the mean over the
    launches it recorded."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            launch()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(r"bloom_(down|up)_kernel<(\d|true|false), "
                      r"(true|false)>", e.key)
        if e.device_type != DeviceType.CUDA or not m or not e.count:
            continue
        path = m.group(2)
        path = int(path) if path.isdigit() else int(path == "true")
        key = bloom_path(m.group(1), path, m.group(3) == "true")
        out[key] = (round(e.count / n),
                    e.self_device_time_total / 1e3 / e.count)
    return out


def bloom_inputs(view, proj, pos):
    """The bloom chain's inputs: the 1080p rich frame's own pass_bloom input
    (frame 1), example 09's farm frame's (256x192, 3 mips) and
    BLOOM_SIZES' seeded frames -> (the rich renderer, {name: (hdr,
    keyword arguments)})."""
    import torch

    from ash_tpu_torch.render import bench_scene, frame
    from ash_tpu_torch.render.bench_scene import build_bench_renderer

    rend = build_bench_renderer(1920, 1080, 1000, "cuda", rich=True)[0]
    calls = bloom_calls(lambda: rend.render_frame(view, proj, pos))
    check(len(calls) == 1, f"rich: {len(calls)} bloom calls a frame")
    inputs = {"rich frame 1": calls[0]}
    scene, uni = bench_scene.example_scene(n_cubes=12, device="cuda")
    cfg9 = bench_scene.example09_config()
    uni9 = bench_scene.example09_uniforms(uni, 1, 8)
    sm = frame.shadow_program(cfg9, scene, uni9.models,
                              uni9.light_space_matrix)
    calls = bloom_calls(lambda: frame.render_frame_program(
        cfg9, scene, uni9, sm, taa_params=bench_scene.example09_taa(1),
        history=torch.zeros((cfg9.height, cfg9.width, 3), device="cuda")))
    check(len(calls) == 1, f"example 09: {len(calls)} bloom calls a frame")
    inputs["example 09 farm frame"] = calls[0]
    rng = np.random.default_rng(7)
    for h, w, mips in BLOOM_SIZES:
        img = rng.random((h, w, 3)) * 0.9
        img = np.where(rng.random((h, w, 1)) < 0.1, img * 8 / 0.9, img)
        inputs[f"{h}x{w} mips {mips}"] = (
            torch.from_numpy(img.astype(np.float32)).cuda(),
            dict(threshold=0.8, soft_knee=0.5, mip_count=mips))
    return rend, inputs


def bloom_timed(name):
    """Whether bloom_inputs' input `name` is timed (the tiny and empty
    chains are only compared)."""
    return not (name.endswith("mips 0") or name.startswith(("2x2", "3x5")))


def bloom_phase(card, view, proj, pos, bloom_launches, usage):
    """Phase 11: the bloom kernels (csrc/bloom.cu) against the plain chain
    at the 1080p rich frame's own pass_bloom input (frame 1), example 09's
    farm frame's and BLOOM_SIZES' seeded frames, by torch.equal; the chain
    timed (plain, kernel, kernel, plain: CUDA events around the plain chain,
    CUDA events around 50 bare chains and a CUDA graph of them) beside its
    bound;
    frames 2 and 3 of rich with the kernels (launches counted from 0, the
    plain chain never called) against the same frames with the plain chain
    patched in; then kernel and plain-chain frames in turns. At the rich
    frame's input each launch is also timed alone (a CUDA graph), and the
    kernels' registers and spills are printed (`usage`: phase 2's
    ptxas_usage). -> ({name: its numbers}, the largest |kernel - plain|)."""
    import torch

    from ash_tpu_torch.ops import bloom, bloom_cuda
    from ash_tpu_torch.render.bench_scene import build_bench_renderer

    def no_plain_chain(*args, **kwargs):
        raise AssertionError("a card frame ran the plain bloom chain")

    rend, inputs = bloom_inputs(view, proj, pos)
    rows, max_err = {}, 0.0
    for name, (hdr, kw) in inputs.items():
        want = bloom.bloom_pyramid(hdr, **kw)
        got = bloom_cuda.bloom_pyramid(hdr, **kw)
        check(bool(torch.equal(got, want)),
              f"bloom kernels != plain chain at {name}")
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        h, w = hdr.shape[:2]
        row = dict(size=f"{w}x{h}", mips=kw["mip_count"],
                   launches=len(bloom_cuda.levels(h, w, kw["mip_count"])),
                   max_abs_err=err)
        rows[name] = row
        if not bloom_timed(name):
            continue
        launch, _ = bloom_cuda.launcher(hdr, **kw)
        kern, graphed, plain = [], [], []
        for order in ("plain", "kernel", "kernel", "plain"):
            if order == "kernel":
                kern.append(cuda_ms(launch, 50))
                graphed.append(graph_ms(launch))
            else:
                plain.append(cuda_ms(lambda: bloom.bloom_pyramid(hdr, **kw),
                                     3))
        bound, bound_by, nbytes, ops, level_bytes = bloom_work(
            h, w, kw["mip_count"])
        # The chain's device time as PR 15 took it: 50 bare chains launched
        # from Python between CUDA events; and in a CUDA graph (`graph_ms`),
        # without the host's launches, which short kernels wait on.
        row.update(device_ms=statistics.mean(kern),
                   graph_ms=statistics.mean(graphed),
                   plain_ms=statistics.mean(plain),
                   plain_busy_ms=busy_ms(lambda: bloom.bloom_pyramid(hdr,
                                                                     **kw)),
                   wrapper_ms=cuda_ms(
                       lambda: bloom_cuda.bloom_pyramid(hdr, **kw), 20),
                   bound_ms=bound, bound_by=bound_by, bytes=nbytes,
                   operations=ops, level_bytes=level_bytes,
                   level_bound_ms=level_bytes / MEM_RATE * 1e3,
                   by_kernel=bloom_kernel_ms(launch))
        row["share_of_bound"] = bound / row["device_ms"]
        if name == "rich frame 1":
            row["by_level"] = {
                f"{s.kind} {s.path}{' threshold' if s.threshold else ''} "
                f"{s.src[1]}x{s.src[0]} -> {s.dst[1]}x{s.dst[0]}":
                graph_ms(lambda: launch([i]))
                for i, s in enumerate(bloom_cuda.levels(h, w,
                                                        kw["mip_count"]))}
            print(f"phase11 bloom kernels, {name}, each launch alone (device "
                  f"ms, a CUDA graph of 20 launches): " + "; ".join(
                      f"{k}: {v:.4f}" for k, v in row["by_level"].items())
                  + "; registers and spill bytes: " + "; ".join(
                      f"{k}: {r}, {sp}" for k, (r, sp) in sorted(
                          usage.items()) if k.startswith("bloom"))
                  + f" ({card})", flush=True)
        print(f"phase11 bloom kernels, {name} ({row['size']}, "
              f"{row['mips']} mips, {row['launches']} launches): equal to "
              f"the plain chain (torch.equal), max |err| {err}; device "
              f"{row['device_ms']} ms (mean of 50 bare chains; "
              f"{row['graph_ms']} ms in a CUDA graph), "
              f"entry {row['wrapper_ms']} ms, plain {row['plain_ms']} ms "
              f"({row['plain_busy_ms']:.3f} ms of its kernels); bound "
              f"{bound} ms by {bound_by} ({nbytes} bytes, {ops} f32 "
              f"operations), {100 * row['share_of_bound']:.1f}% of it; each "
              f"level through memory {level_bytes} bytes, "
              f"{row['level_bound_ms']:.4f} ms; by kernel (launches a "
              f"chain, ms a launch): {row['by_kernel']} ({card})",
              flush=True)
    shapes = ", ".join(f"{k} ({r['size']}, {r['mips']} mips)"
                       for k, r in rows.items())
    print(f"phase11 bloom kernels equal to the plain chain (torch.equal) at "
          f"{shapes}", flush=True)

    # Frames 2 and 3 with the kernels, counted from 0, and the same frames
    # with the plain chain patched in, which launches nothing.
    zero_bloom()
    frames = []
    with mock.patch.multiple(bloom, _downsample_karis=no_plain_chain,
                             _upsample_tent=no_plain_chain):
        for _ in range(2):
            rend.render_frame(view, proj, pos)
            frames.append((rend.read_back().copy(),
                           rend.last_outputs().color.clone()))
    launched = bloom_launched()
    bloom_launches["rich frames 2-3"] = launched
    check(launched == 2 * RICH_BLOOM_LAUNCHES,
          f"rich: bloom kernel launches {launched} in frames 2 and 3")
    plain_r = build_bench_renderer(1920, 1080, 1000, "cuda", rich=True)[0]
    plain_chain = mock.patch.object(bloom_cuda, "bloom_pyramid",
                                    bloom.bloom_pyramid)
    with plain_chain:
        plain_r.render_frame(view, proj, pos)
        for image, color in frames:
            plain_r.render_frame(view, proj, pos)
            check(np.array_equal(plain_r.read_back(), image)
                  and torch.equal(plain_r.last_outputs().color, color),
                  "rich: a frame with the bloom kernels != the frame with "
                  "the plain chain")
    check(bloom_launched() == launched,
          "rich: the plain-chain frames launched the bloom kernels")

    def step(i):
        rend.render_frame(view, proj, pos)

    def plain_step(i):
        with plain_chain:
            plain_r.render_frame(view, proj, pos)

    timed = {"kernel": [], "plain": []}
    for order in ("plain", "kernel", "kernel", "plain"):
        timed[order].append(frame_ms_spread(
            step if order == "kernel" else plain_step, 5))
    frame_row = {}
    for k, st in (("kernel", step), ("plain", plain_step)):
        wall, busy, idle, n_ops = busy_profile(st)
        span, kern = scope_device_ms(st, "pass_bloom", n=2)
        frame_row[k] = dict(ms=[t[0][0] for t in timed[k]],
                            peak_mib=max(t[1] for t in timed[k]),
                            pass_bloom_span_ms=span, pass_bloom_ops_ms=kern,
                            busy_ms=busy, idle=idle, ops=n_ops)
    frame_row["kernel"]["bloom_kernels"] = kernel_device_ms(
        step, ("bloom_down_kernel", "bloom_up_kernel"))
    rows["rich frame"] = frame_row
    kf, pf = frame_row["kernel"], frame_row["plain"]
    print(f"phase11 rich frames 2 and 3: equal to the plain chain's (u8 and "
          f"colour); bloom kernel launches {launched}; frame ms (median of "
          f"5, in turns) kernels {kf['ms']}, plain chain {pf['ms']}; peak "
          f"{kf['peak_mib']:.1f} / {pf['peak_mib']:.1f} MiB; pass_bloom "
          f"device span {kf['pass_bloom_span_ms']:.3f} / "
          f"{pf['pass_bloom_span_ms']:.3f} ms, its PyTorch kernels "
          f"{kf['pass_bloom_ops_ms']:.3f} / {pf['pass_bloom_ops_ms']:.3f} "
          f"ms; kernels and copies a frame {kf['ops']:g} / {pf['ops']:g}; "
          f"device busy {kf['busy_ms']:.2f} / {pf['busy_ms']:.2f} ms, idle "
          f"{100 * kf['idle']:.1f} / {100 * pf['idle']:.1f}% (kernels / "
          f"plain); the bloom kernels in the frame's trace: "
          f"{kf['bloom_kernels'][0]:g} launches, {kf['bloom_kernels'][1]} ms "
          f"a frame ({card})", flush=True)
    return rows, max_err


def shadow_calls(rend, view, proj, pos):
    """Render a frame of `rend` with the shadow entries wrapped -> [(csm?,
    the entry's arguments, the blend size)] in call order."""
    from ash_tpu_torch.ops import shadow_cuda

    calls = []
    real_pcf = shadow_cuda.shadow_pcf16
    real_csm = shadow_cuda.shadow_pcf16_csm

    def pcf(*args):
        calls.append((False, args, 0.0))
        return real_pcf(*args)

    def csm(*args, blend_size=0.0):
        calls.append((True, args, blend_size))
        return real_csm(*args, blend_size=blend_size)

    with mock.patch.multiple(shadow_cuda, shadow_pcf16=pcf,
                             shadow_pcf16_csm=csm):
        rend.render_frame(view, proj, pos)
    return calls


def shadow_entry(kind, is_csm, args, blend):
    """shadow_cuda's entry (kind "entry"), bare launcher ("launcher") or
    plain version ("plain") for one recorded call."""
    from ash_tpu_torch.ops import shadow_cuda

    if kind == "launcher":
        if is_csm:
            return shadow_cuda.launcher_csm(*args, blend_size=blend)
        return shadow_cuda.launcher(*args)
    if is_csm:
        fn = {"entry": shadow_cuda.shadow_pcf16_csm,
              "plain": shadow_cuda.plain_csm}[kind]
        return fn(*args, blend_size=blend)
    return {"entry": shadow_cuda.shadow_pcf16,
            "plain": shadow_cuda.plain}[kind](*args)


def shadow_work(is_csm, args, blend):
    """(bound ms, "bytes", bytes, texels touched, elements) of one launch of
    the shadow kernel at the memory rate. Bytes: each element's position
    and normal read and its result written once, the direction, matrices,
    splits and view once, and each texel that the taps read once: the
    in-bounds taps of the elements at or before the far plane, at their
    layer and, where the blend is not 0, the next, as ops/shadow.py
    indexes them."""
    import torch

    from ash_tpu_torch.ops import shadow_cuda

    if is_csm:
        maps, mats, splits, view, world, normal, light_dir = args
    else:
        maps, mats, world, normal, light_dir = args
        maps, mats, splits, view = maps[None], mats[None], None, None
    c, rows, cols = maps.shape
    w = world.reshape(-1, 3)
    n = w.shape[0]
    layer = torch.zeros(n, dtype=torch.int64, device=w.device)
    if c > 1:
        view_z = -(((view[2, 0] * w[:, 0] + view[2, 1] * w[:, 1])
                    + view[2, 2] * w[:, 2]) + view[2, 3])
        layer = (view_z[:, None] > splits[:c]).sum(-1).clamp(0, c - 1)
    ts = 1.0 / rows

    def texels(at, keep):
        m = mats[at]
        p = ((m[:, :, 0] * w[:, 0:1] + m[:, :, 1] * w[:, 1:2])
             + m[:, :, 2] * w[:, 2:3]) + m[:, :, 3]
        pw = torch.where(p[:, 3].abs() < 1e-8, 1e-8, p[:, 3])
        pr = p[:, :3] / pw[:, None] * 0.5 + 0.5
        keep = keep & ~(pr[:, 2] > 1.0)
        ids = []
        for ox, oy in ((-1.0, -1.0), (1.0, -1.0), (-1.0, 1.0), (1.0, 1.0)):
            x0 = torch.floor((pr[:, 0] + ox * ts) * cols - 0.5).long()
            y0 = torch.floor((pr[:, 1] + oy * ts) * rows - 0.5).long()
            for dy in (0, 1):
                for dx in (0, 1):
                    xi, yi = x0 + dx, y0 + dy
                    inb = keep & (xi >= 0) & (xi < cols) & (yi >= 0) & (
                        yi < rows)
                    ids.append(((at * rows + yi) * cols + xi)[inb])
        return torch.cat(ids)

    ids = texels(layer, torch.ones(n, dtype=torch.bool, device=w.device))
    if is_csm and blend > 0.0 and c > 1:
        split = splits[layer]
        frac = ((view_z - split * (1.0 - blend))
                / (split * blend).clamp_min(1e-6)).clamp(0.0, 1.0)
        nxt = (layer + 1).clamp(0, c - 1)
        ids = torch.cat([ids, texels(nxt, torch.where(nxt > layer, frac, 0.0)
                                     != 0)])
    touched = int(ids.unique().numel())
    d = normal.element_size()
    per_dir = 3 * d * (n if shadow_cuda.light_dir_stride(light_dir, world)
                       else 1)
    nbytes = (n * (12 + 3 * d + 4) + per_dir + 4 * touched + 64 * c
              + (4 * c + 64 if c > 1 else 0))
    return nbytes / MEM_RATE * 1e3, "bytes", nbytes, touched, n


def entry_parts(module, is_csm, args, blend, n=200):
    """{part: host microseconds a call} of a shadow entry module (this
    tree's ops/shadow_cuda, or another tree's in ab_phase) at one recorded
    call: "check" (check_inputs or check_inputs_csm), "launcher" (the
    checks, the output's allocation and the arguments), "launch" (the bare
    ctypes launch) and "entry" (the whole entry point, counts and observers
    included); the mean of n calls after a warm one, the device
    synchronised around each loop."""
    import torch

    kw = {"blend_size": blend} if is_csm else {}
    suffix = "_csm" if is_csm else ""
    parts = {name: functools.partial(getattr(module, attr + suffix), *args,
                                     **kw)
             for name, attr in (("check", "check_inputs"),
                                ("launcher", "launcher"),
                                ("entry", "shadow_pcf16"))}
    # The output stays alive while its bare launch is timed.
    parts["launch"], kept = parts["launcher"]()
    out = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out[name] = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
    del kept
    return out


def shadow_same(got, want):
    """Bit for bit where want has a number, NaN where it has NaN."""
    import torch

    nan = torch.isnan(want)
    return (got.shape == want.shape and got.dtype == want.dtype
            and bool(torch.equal(torch.isnan(got), nan))
            and bool(torch.equal(got[~nan].view(torch.int32),
                                 want[~nan].view(torch.int32))))


def shadow_cases(view, proj, pos):
    """-> ({label: (csm?, the entry's arguments, the blend size)}, {name:
    (renderer, its keywords, shade calls a frame)}): the 1080p shade calls
    of SHADOW_CALL_FRAMES (frame 1, recorded from the entry points; "<name>
    call <i>" where a frame makes more than one), and from them rich
    without the blend, the standard and rich calls in bf16 (the normal and
    direction rounded as a bf16 frame rounds them) and seeded maps of
    257^2 and 1000^2; the renderers of those frames that are in
    SHADOW_FRAMES."""
    import torch

    from ash_tpu_torch.render.bench_scene import build_bench_renderer
    from ash_tpu_torch.render.csm import CsmConfig

    cases, rends = {}, {}
    for name, kw, preset in SHADOW_CALL_FRAMES:
        kw = dict(kw)
        if "cascades" in kw:
            kw["csm"] = CsmConfig(cascade_count=kw.pop("cascades"),
                                  resolution=1024)
        rend = build_bench_renderer(1920, 1080, 1000, "cuda", **kw)[0]
        if preset is not None:
            rend.set_msaa_preset(preset)
        calls = shadow_calls(rend, view, proj, pos)
        check(len(calls) >= 1, f"{name}: no shadow call")
        for i, call in enumerate(calls):
            cases[name if len(calls) == 1 else f"{name} call {i + 1}"] = call
        if name in SHADOW_FRAMES:
            rends[name] = (rend, kw, len(calls))
        del rend
    check("edge x4 call 2" in cases and "edge x4 call 3" not in cases,
          "edge x4: not two shade calls (the centres and the worklist)")
    std, rich = cases["standard"], cases["rich"]
    check(not std[0] and rich[0] and rich[1][0].shape == (3, 1024, 1024)
          and rich[2] > 0.0, "the rich call is not 3 blended cascades")
    for c in (2, 4):
        check(cases[f"rich {c} cascades"][1][0].shape == (c, 1024, 1024),
              f"the rich frame's call at {c} cascades")
    cases["rich hard"] = (True, rich[1], 0.0)

    def bf16(args):
        *head, n, d = args
        return (*head, n.to(torch.bfloat16),
                d[(0,) * (d.dim() - 1)].to(torch.bfloat16).expand(d.shape))

    cases["standard bf16"] = (False, bf16(std[1]), 0.0)
    cases["rich bf16"] = (True, bf16(rich[1]), rich[2])
    rng = np.random.default_rng(12)
    for s in SHADOW_ODD_SIZES:
        seeded = torch.from_numpy(
            rng.uniform(0.2, 1.0, (s, s)).astype(np.float32)).cuda()
        cases[f"standard {s}^2 seeded"] = (False, (seeded, *std[1][1:]), 0.0)
        cases[f"rich 3x{s}^2 seeded"] = (True, (
            torch.stack([seeded, seeded.flip(0), seeded.flip(1)]),
            *rich[1][1:]), rich[2])
    return cases, rends


def shadow_phase(card, view, proj, pos, shadow_launches, usage):
    """Phase 12: the shadow kernel (csrc/shadow.cu) against the plain PCF
    (ops/shadow_cuda.plain, plain_csm) at the 1080p frames' own shade calls
    (frame 1): the standard frame's single 2048^2 map, glass's shaded
    layers, rich's 3 cascades of 1024^2 with the blend of 0.1, and edge
    MSAA x4's two calls (the centres and the worklist), recorded from the
    entry points, and the rich frame's at 2 and 4 cascades; from those,
    rich without the blend, the standard and rich calls in bf16 (the normal
    and direction rounded as a bf16 frame rounds them) and seeded maps of
    257^2 and 1000^2: bit for bit, NaN in the same places. Each call timed
    (plain, kernel, kernel, plain: CUDA events around 50 bare launches, a
    CUDA graph of them, and 3 plain calls) beside its bound by bytes
    (shadow_work), with the taps' path the entry takes there and, by the
    kernel's own counts on that path (shadow_cuda.probe_path), the share
    of the lookups that reach the taps read as one 4x4 window (none quad
    by quad), and the entry's host time by part (entry_parts). Frames 2
    and 3 of the standard, rich and glass frames with the kernel
    (launches counted from 0, the plain PCF never called) against the same
    frames with the plain version patched in (u8 and colour); then kernel
    and plain frames in turns: frame ms, kernels and copies a frame, device
    busy and idle, and for rich pass_shade's device span and the kernel's
    time a frame by name.
    -> ({name: its numbers}, the largest |kernel - plain|)."""
    import torch

    from ash_tpu_torch.ops import shadow, shadow_cuda
    from ash_tpu_torch.render.bench_scene import build_bench_renderer

    def no_plain_pcf(*args, **kwargs):
        raise AssertionError("a card frame ran the plain PCF")

    rows, max_err = {}, 0.0
    rows["usage"] = {k: v for k, v in usage.items() if k.startswith("shadow")}
    print("phase12 shadow kernel, registers and spill bytes by "
          "instantiation: " + "; ".join(
              f"{k}: {r}, {sp}" for k, (r, sp) in sorted(
                  rows["usage"].items())) + f" ({card})", flush=True)
    cases, rends = shadow_cases(view, proj, pos)

    for label, (is_csm, args, blend) in cases.items():
        want = shadow_entry("plain", is_csm, args, blend)
        got = shadow_entry("entry", is_csm, args, blend)
        torch.cuda.synchronize()
        check(shadow_same(got, want), f"shadow kernel != plain PCF at {label}")
        nan = torch.isnan(want)
        err = float((got - want)[~nan].abs().max()) if bool(
            (~nan).any()) else 0.0
        max_err = max(max_err, err)
        launch, _ = shadow_entry("launcher", is_csm, args, blend)
        kern, graphed, plain = [], [], []
        for order in ("plain", "kernel", "kernel", "plain"):
            if order == "kernel":
                kern.append(cuda_ms(launch, 50))
                graphed.append(graph_ms(launch))
            else:
                plain.append(cuda_ms(
                    lambda: shadow_entry("plain", is_csm, args, blend), 3))
        bound, bound_by, nbytes, touched, n = shadow_work(is_csm, args,
                                                          blend)
        probed, path, reads, windows = shadow_cuda.probe_path(
            -1, is_csm, *args, **({"blend_size": blend} if is_csm else {}))
        torch.cuda.synchronize()
        check(shadow_same(probed, want),
              f"shadow kernel's probe != plain PCF at {label}")
        del probed
        row = dict(elements=n, shape=list(args[-3].shape[:-1]),
                   map="x".join(map(str, args[0].shape)),
                   blend=blend, dtype=str(args[-2].dtype).replace(
                       "torch.", ""),
                   device_ms=statistics.mean(kern),
                   graph_ms=statistics.mean(graphed),
                   plain_ms=statistics.mean(plain),
                   wrapper_ms=cuda_ms(
                       lambda: shadow_entry("entry", is_csm, args, blend), 20),
                   bound_ms=bound, bound_by=bound_by, bytes=nbytes,
                   texels_touched=touched, shadowed=float(want[~nan].mean()),
                   nan=int(nan.sum()), max_abs_err=err,
                   path="windows" if path else "quads", lookups=reads,
                   windows=windows, window_share=windows / max(reads, 1),
                   entry_us=entry_parts(shadow_cuda, is_csm, args, blend))
        row["share_of_bound"] = bound / row["graph_ms"]
        rows[label] = row
        print(f"phase12 shadow kernel, {label} ({row['map']} map, "
              f"{n} elements {row['shape']}, {row['dtype']}, blend "
              f"{blend}): equal to the plain PCF (bit for bit, {row['nan']} "
              f"NaN in the same places), mean shadow "
              f"{row['shadowed']:.4f}; device {row['device_ms']} ms (mean of "
              f"50 bare launches; {row['graph_ms']} ms in a CUDA graph), "
              f"entry {row['wrapper_ms']} ms, plain {row['plain_ms']} ms; "
              f"bound {bound} ms by bytes ({nbytes} bytes, {touched} texels), "
              f"{100 * row['share_of_bound']:.1f}% of it; "
              + (f"the window path: of {reads} lookups that reach the taps, "
                 f"{windows} read as one 4x4 window "
                 f"({100 * row['window_share']:.2f}%, the kernel's count)"
                 if path else "the taps quad by quad: no lookup read as a "
                 "window")
              + "; the entry's host us a call: "
              + ", ".join(f"{k} {v:.1f}" for k, v in row["entry_us"].items())
              + f" ({card})",
              flush=True)
    del cases

    # Frames 2 and 3 with the kernel, counted from 0, and the same frames
    # with the plain PCF patched in, which launches nothing.
    plain_pcf = mock.patch.multiple(
        shadow_cuda, shadow_pcf16=shadow_cuda.plain,
        shadow_pcf16_csm=shadow_cuda.plain_csm)
    for name, (rend, kw, per_frame) in rends.items():
        zero_shadow()
        frames = []
        with mock.patch.multiple(shadow, shadow_pcf16=no_plain_pcf,
                                 shadow_pcf16_csm=no_plain_pcf):
            for _ in range(2):
                rend.render_frame(view, proj, pos)
                frames.append((rend.read_back().copy(),
                               rend.last_outputs().color.clone()))
        launched = shadow_launched()
        shadow_launches[f"{name} frames 2-3"] = launched
        check(launched == 2 * per_frame, f"{name}: shadow kernel launches "
              f"{launched} in frames 2 and 3, want {2 * per_frame}")
        plain_r = build_bench_renderer(1920, 1080, 1000, "cuda", **kw)[0]
        with plain_pcf:
            plain_r.render_frame(view, proj, pos)
            for image, color in frames:
                plain_r.render_frame(view, proj, pos)
                check(np.array_equal(plain_r.read_back(), image)
                      and torch.equal(plain_r.last_outputs().color, color),
                      f"{name}: a frame with the shadow kernel != the frame "
                      "with the plain PCF")
        check(shadow_launched() == launched,
              f"{name}: the plain-PCF frames launched the shadow kernel")

        def step(i, r=rend):
            r.render_frame(view, proj, pos)

        def plain_step(i, r=plain_r):
            with plain_pcf:
                r.render_frame(view, proj, pos)

        timed = {"kernel": [], "plain": []}
        for order in ("plain", "kernel", "kernel", "plain"):
            timed[order].append(frame_ms_spread(
                step if order == "kernel" else plain_step, 5)[0][0])
        frame_row = {}
        for k, st in (("kernel", step), ("plain", plain_step)):
            wall, busy, idle, n_ops = busy_profile(st)
            frame_row[k] = dict(ms=timed[k], busy_ms=busy, idle=idle,
                                ops=n_ops)
            if name == "rich":
                frame_row[k]["pass_shade_ms"] = scope_device_ms(
                    st, "pass_shade", n=2)[0]
        if name == "rich":
            frame_row["kernel"]["shadow_kernel"] = kernel_device_ms(
                step, SHADOW_KERNELS)
        rows[f"{name} frame"] = frame_row
        kf, pf = frame_row["kernel"], frame_row["plain"]
        line = (f"phase12 {name} frames 2 and 3: equal to the plain PCF's (u8 "
                f"and colour); shadow kernel launches {launched}; frame ms "
                f"(median of 5, in turns) kernel {kf['ms']}, plain PCF "
                f"{pf['ms']}; kernels and copies a frame {kf['ops']:g} / "
                f"{pf['ops']:g}; device busy {kf['busy_ms']:.2f} / "
                f"{pf['busy_ms']:.2f} ms, idle {100 * kf['idle']:.1f} / "
                f"{100 * pf['idle']:.1f}% (kernel / plain)")
        if name == "rich":
            line += (f"; pass_shade device span {kf['pass_shade_ms']:.3f} / "
                     f"{pf['pass_shade_ms']:.3f} ms; the shadow kernel in the "
                     f"frame's trace: {kf['shadow_kernel'][0]:g} launches, "
                     f"{kf['shadow_kernel'][1]} ms a frame")
        print(f"{line} ({card})", flush=True)
        del plain_r, frames
    del rends
    return rows, max_err


def gbuffer_calls(render):
    """Run render() (one frame) with the G-buffer and shading entry points
    wrapped -> (the G-buffer calls, the shading calls), each [(args,
    kwargs)] in call order."""
    from ash_tpu_torch.ops import gbuffer_cuda, shade_cuda

    calls, shade_calls = [], []
    real = gbuffer_cuda.interpolate_gbuffer
    real_shade = shade_cuda.shade_pbr

    def entry(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    def shade_entry(*args, **kwargs):
        shade_calls.append((args, kwargs))
        return real_shade(*args, **kwargs)

    with mock.patch.object(gbuffer_cuda, "interpolate_gbuffer", entry), \
            mock.patch.object(shade_cuda, "shade_pbr", shade_entry):
        render()
    return calls, shade_calls


def gbuffer_same(got, want):
    """(every field of two GBuffers the same, the largest |got - want| over
    the floats' finite elements): ints and bools equal, floats bit for bit
    where want has a number and NaN where it has NaN."""
    import torch

    err = 0.0
    for f in want._fields:
        g, w = getattr(got, f), getattr(want, f)
        if g is None or w is None:
            if (g is None) != (w is None):
                return False, math.inf
            continue
        if g.shape != w.shape or g.dtype != w.dtype:
            return False, math.inf
        if not w.is_floating_point():
            if not torch.equal(g, w):
                return False, math.inf
            continue
        if not shadow_same(g, w):
            return False, math.inf
        fin = torch.isfinite(w)
        if bool(fin.any()):
            err = max(err, float((g - w)[fin].abs().max()))
    return True, err


def gbuffer_work(args, kw):
    """(bound ms, "bytes" or "operations", bytes, triangles, expanded and
    unique vertices touched) of one launch of the G-buffer kernel. Bytes:
    each element's triangle id read and its 82 bytes of fields written (90
    with the velocity), the distinct elements of pixel_xy read, and each
    table row that the elements reach read once: a triangle's 56 bytes
    (edge rows, det, draw id, vertex ids), an expanded vertex's 40 (world,
    normal, tangent; 4 more for its unique id, 16 for its last clip
    position) and a unique vertex's 20 (uv, colour). Operations:
    OPS_GBUFFER an element at the f32 rate."""
    import torch

    tri_id, setup, tri_v, tri_draw, verts, vert_uv, vert_color = args
    vert_uid, prev_clip = kw.get("vert_uid"), kw.get("prev_clip")
    pixel_xy = kw.get("pixel_xy")
    velocity = prev_clip is not None
    n = tri_id.numel()
    tris = torch.unique(tri_id.clamp_min(0)).long()
    vids = torch.unique(tri_v[tris].long())
    uids = (vids if vert_uid is None
            else torch.unique(vert_uid[vids].long()))
    xy = 0
    if pixel_xy is not None:
        xy = sum(4 * math.prod(k for k, st in zip(t.shape, t.stride()) if st)
                 for t in pixel_xy)
    per_vertex = 40 + (4 if vert_uid is not None else 0) + (
        16 if velocity else 0)
    nbytes = (n * (4 + 82 + (8 if velocity else 0)) + xy
              + 56 * tris.numel() + per_vertex * vids.numel()
              + 20 * uids.numel())
    t_bytes = nbytes / MEM_RATE * 1e3
    t_ops = n * OPS_GBUFFER[velocity] / F32_RATE * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, tris.numel(), vids.numel(), uids.numel())


def frame_scalars(o):
    """The SCALAR_FIELDS of a FrameOutputs, as ints."""
    return {f: None if getattr(o, f) is None else int(getattr(o, f))
            for f in SCALAR_FIELDS}


def gbuffer_cases(view, proj, pos, mega_caps):
    """-> ({label: (args, kwargs)}, {name: (renderer, its keywords, calls a
    frame)}, {label: (args, kwargs)}): the G-buffer calls of
    GBUFFER_CALL_FRAMES' frame 1 at 1920x1080 (the animated frame's first
    moved pose, the mega frame at the drop-free caps `mega_caps`), recorded
    from the entry point, "<name> call <i>" where a frame makes more than
    one; the renderers of those frames that are in GBUFFER_FRAMES; the
    same frames' shading calls, recorded from ops/shade_cuda's entry and
    labelled the same way (phase 14's cases)."""
    import torch

    from ash_tpu_torch.render import bench_scene

    cases, rends, shade_cases = {}, {}, {}
    for name, kw, preset in GBUFFER_CALL_FRAMES:
        if kw is None:
            rend, _, mcam, _ = bench_scene.build_mega_renderer(
                1920, 1080, "cuda", **mega_caps)
            render = functools.partial(
                rend.render_frame, mcam.view_matrix(),
                mcam.projection_matrix(), mcam.position)
        elif kw.get("animate"):
            rend, _, acam, anim = bench_scene.build_bench_renderer(
                1920, 1080, 1000, "cuda", **kw)

            def render(r=rend, cam=acam, anim=anim, ft=1.0 / 60.0):
                r.update_transforms_trs(
                    *bench_scene.animated_models_trs(anim, ft))
                r.render_frame(bench_scene.orbit_camera(
                    cam, anim["extent"], ft), proj, cam.position)
        else:
            rend = bench_scene.build_bench_renderer(1920, 1080, 1000, "cuda",
                                                    **kw)[0]
            if preset is not None:
                rend.set_msaa_preset(preset)
            render = functools.partial(rend.render_frame, view, proj, pos)
        calls, shade_calls = gbuffer_calls(render)
        check(len(calls) >= 1, f"{name}: no G-buffer call")
        check(len(shade_calls) == len(calls), f"{name}: {len(shade_calls)} "
              f"shading calls for {len(calls)} G-buffer calls")
        for i, (call, shade_call) in enumerate(zip(calls, shade_calls)):
            label = name if len(calls) == 1 else f"{name} call {i + 1}"
            cases[label] = call
            shade_cases[label] = shade_call
        if name in GBUFFER_FRAMES:
            rends[name] = (rend, kw, len(calls))
        del rend, render
    check("glass call 8" in cases and "glass call 9" not in cases,
          "glass: not 8 shaded layers")
    check("edge x4 call 2" in cases and "edge x4 call 3" not in cases,
          "edge x4: not two G-buffer calls (the centres and the worklist)")
    check(cases["rich"][1]["prev_clip"] is not None
          and cases["standard"][1]["prev_clip"] is None,
          "the rich call has no velocity, or the standard call has one")
    px = cases["edge x4 call 1"][1]["pixel_xy"][0]
    check(0 in px.stride() and tuple(px.shape) == (1080, 1920),
          f"edge x4's centres: px {tuple(px.shape)} strides {px.stride()}")
    check(all(isinstance(t, torch.Tensor) for t in
              cases["edge x4 call 2"][1]["pixel_xy"]), "edge x4's worklist")
    return cases, rends, shade_cases


def gbuffer_phase(card, view, proj, pos, gbuffer_launches, usage, cases,
                  rends):
    """Phase 13: the G-buffer kernel (csrc/gbuffer.cu) against the plain
    fetch (ops/shade.py:interpolate_gbuffer) at the 1080p frames' own calls
    (frame 1, gbuffer_cases): standard, animated, rich (with the velocity),
    textured, glass's 8 shaded layers, mega and edge MSAA x4's centres and
    worklist: every field equal, the floats bit for bit with NaN in the
    same places. Each call timed (plain, kernel, kernel, plain: CUDA
    events around 50 bare launches, a CUDA graph of them, and 3 plain
    calls) beside its bound (gbuffer_work), and the entry's time. Frames 2
    and 3 of the standard, rich and glass frames with the kernel (launches
    counted from 0, the plain fetch never called) against the same frames
    with the plain fetch patched in (u8, colour and scalars); then kernel
    and plain frames in turns: frame ms, kernels and copies a frame, device
    busy and idle, pass_gbuffer's device span, and the kernel's time a
    frame by name.
    -> ({name: its numbers}, the largest |kernel - plain|)."""
    import torch

    from ash_tpu_torch.ops import gbuffer_cuda, shade
    from ash_tpu_torch.render.bench_scene import build_bench_renderer

    def no_plain_fetch(*args, **kwargs):
        raise AssertionError("a card frame ran the plain G-buffer fetch")

    rows, max_err = {}, 0.0
    rows["usage"] = {k: v for k, v in usage.items() if k == "gbuffer"}
    regs, spill = rows["usage"]["gbuffer"]
    print(f"phase13 G-buffer kernel: {regs} registers, {spill} spill bytes "
          f"({card})", flush=True)

    for label, (args, kw) in cases.items():
        want = shade.interpolate_gbuffer(*args, **kw)
        got = gbuffer_cuda.interpolate_gbuffer(*args, **kw)
        torch.cuda.synchronize()
        same, err = gbuffer_same(got, want)
        check(same, f"G-buffer kernel != plain fetch at {label}")
        max_err = max(max_err, err)
        nan = sum(int(torch.isnan(t).sum()) for t in want
                  if t is not None and t.is_floating_point())
        covered = int(want.mask.sum())
        del got, want
        launch, _ = gbuffer_cuda.launcher(*args, **kw)
        kern, graphed, plain = [], [], []
        for order in ("plain", "kernel", "kernel", "plain"):
            if order == "kernel":
                kern.append(cuda_ms(launch, 50))
                graphed.append(graph_ms(launch))
            else:
                plain.append(cuda_ms(
                    lambda: shade.interpolate_gbuffer(*args, **kw), 3))
        bound, bound_by, nbytes, tris, vids, uids = gbuffer_work(args, kw)
        row = dict(elements=args[0].numel(), shape=list(args[0].shape),
                   velocity=kw.get("prev_clip") is not None,
                   pixel_xy=kw.get("pixel_xy") is not None,
                   covered=covered, nan=nan,
                   device_ms=statistics.mean(kern),
                   graph_ms=statistics.mean(graphed),
                   plain_ms=statistics.mean(plain),
                   wrapper_ms=cuda_ms(lambda: gbuffer_cuda.interpolate_gbuffer(
                       *args, **kw), 20),
                   bound_ms=bound, bound_by=bound_by, bytes=nbytes,
                   triangles=tris, vertices=vids, unique_vertices=uids,
                   max_abs_err=err)
        row["share_of_bound"] = bound / row["graph_ms"]
        rows[label] = row
        print(f"phase13 G-buffer kernel, {label} ({row['elements']} elements "
              f"{row['shape']}, {covered} covered, velocity "
              f"{row['velocity']}, pixel_xy {row['pixel_xy']}): equal to the "
              f"plain fetch (every field; floats bit for bit, {nan} NaN in "
              f"the same places); device {row['device_ms']} ms (mean of 50 "
              f"bare launches; {row['graph_ms']} ms in a CUDA graph), entry "
              f"{row['wrapper_ms']} ms, plain {row['plain_ms']} ms; bound "
              f"{bound} ms by {bound_by} ({nbytes} bytes; {tris} triangles, "
              f"{vids} vertices, {uids} unique vertices), "
              f"{100 * row['share_of_bound']:.1f}% of it ({card})",
              flush=True)
        del launch
    del cases

    # Frames 2 and 3 with the kernel, counted from 0, and the same frames
    # with the plain fetch patched in, which launches nothing.
    plain_fetch = mock.patch.object(gbuffer_cuda, "interpolate_gbuffer",
                                    shade.interpolate_gbuffer)
    for name, (rend, kw, per_frame) in rends.items():
        zero_gbuffer()
        frames = []
        with mock.patch.object(shade, "interpolate_gbuffer", no_plain_fetch):
            for _ in range(2):
                out = rend.render_frame(view, proj, pos)
                frames.append((rend.read_back().copy(), out.color.clone(),
                               frame_scalars(out)))
        launched = gbuffer_launched()
        gbuffer_launches[f"{name} frames 2-3"] = launched
        check(launched == 2 * per_frame, f"{name}: G-buffer kernel launches "
              f"{launched} in frames 2 and 3, want {2 * per_frame}")
        plain_r = build_bench_renderer(1920, 1080, 1000, "cuda", **kw)[0]
        with plain_fetch:
            plain_r.render_frame(view, proj, pos)
            for image, color, scalars in frames:
                out = plain_r.render_frame(view, proj, pos)
                check(np.array_equal(plain_r.read_back(), image)
                      and torch.equal(out.color, color)
                      and frame_scalars(out) == scalars,
                      f"{name}: a frame with the G-buffer kernel != the "
                      "frame with the plain fetch")
        check(gbuffer_launched() == launched,
              f"{name}: the plain-fetch frames launched the G-buffer kernel")

        def step(i, r=rend):
            r.render_frame(view, proj, pos)

        def plain_step(i, r=plain_r):
            with plain_fetch:
                r.render_frame(view, proj, pos)

        timed = {"kernel": [], "plain": []}
        for order in ("plain", "kernel", "kernel", "plain"):
            timed[order].append(frame_ms_spread(
                step if order == "kernel" else plain_step, 5)[0][0])
        frame_row = {}
        for k, st in (("kernel", step), ("plain", plain_step)):
            wall, busy, idle, n_ops = busy_profile(st)
            frame_row[k] = dict(ms=timed[k], busy_ms=busy, idle=idle,
                                ops=n_ops, pass_gbuffer_ms=scope_device_ms(
                                    st, "pass_gbuffer", n=2)[0])
        frame_row["kernel"]["gbuffer_kernel"] = kernel_device_ms(
            step, ("gbuffer_kernel",))
        rows[f"{name} frame"] = frame_row
        kf, pf = frame_row["kernel"], frame_row["plain"]
        print(f"phase13 {name} frames 2 and 3: equal to the plain fetch's "
              f"(u8, colour and scalars); G-buffer kernel launches "
              f"{launched}; frame ms (median of 5, in turns) kernel "
              f"{kf['ms']}, plain fetch {pf['ms']}; kernels and copies a "
              f"frame {kf['ops']:g} / {pf['ops']:g}; device busy "
              f"{kf['busy_ms']:.2f} / {pf['busy_ms']:.2f} ms, idle "
              f"{100 * kf['idle']:.1f} / {100 * pf['idle']:.1f}%; "
              f"pass_gbuffer device span {kf['pass_gbuffer_ms']:.3f} / "
              f"{pf['pass_gbuffer_ms']:.3f} ms (kernel / plain); the "
              f"G-buffer kernel in the frame's trace: "
              f"{kf['gbuffer_kernel'][0]:g} launches, "
              f"{kf['gbuffer_kernel'][1]} ms a frame ({card})", flush=True)
        del plain_r, frames
    del rends
    return rows, max_err


def shade_same(got, want):
    """(colour and alpha of two entry results the same, the largest |got -
    want| over want's finite elements): bit for bit where want has a
    number, NaN where it has NaN."""
    import torch

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if len(got) != len(want):
        return False, math.inf
    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype or not shadow_same(g, w):
            return False, math.inf
        fin = torch.isfinite(w)
        if bool(fin.any()):
            err = max(err, float((g - w)[fin].abs().max()))
    return True, err


def shade_work(args, kw):
    """(bound ms, "bytes" or "operations", bytes, draws reached) of one
    shading call's launches (csrc/shade.cu; the texture, shadow and light
    kernels' own work left out). Bytes: an element's mask, world position,
    normal, facing and draw id (30 bytes), its shadow term (4) with a
    shadow map, its tangent and the five samples' used channels (64) with
    a pool; written, its colour (12) and coverage alpha (4) where asked
    for, or with lights the light kernel's inputs (72) and then `lo` read
    back (12) before the colour; each material row reached (72) once.
    Operations: OPS_SHADE an element at the f32 rate."""
    import torch

    gbuf, materials, _ = args
    n = gbuf.mask.numel()
    textured = kw.get("pool") is not None
    lit = kw.get("lights") is not None and \
        kw.get("tile_light_indices") is not None
    alpha = kw.get("with_alpha") and not textured
    per = 30 + (4 if kw.get("shadow_map") is not None else 0) \
        + (64 if textured else 0) + (4 if alpha else 0) \
        + (72 + 12 + 12 if lit else 12)
    draws = torch.unique(gbuf.draw_id).numel()
    nbytes = n * per + 72 * draws
    t_bytes = nbytes / MEM_RATE * 1e3
    t_ops = n * OPS_SHADE[textured] / F32_RATE * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, draws)


def shade_phase(card, view, proj, pos, shade_launches, usage, cases):
    """Phase 14: the shading kernels (csrc/shade.cu) against the plain
    shade_pbr (ops/shade_cuda.plain: ops/shade.py's shade_pbr and
    pixel_alpha) at the 1080p frames' own calls (frame 1, recorded with
    phase 13's: `cases`): standard, animated, rich (lit: surface, the light
    kernel, compose), textured, glass's 8 shaded layers (with the coverage
    alpha), mega and edge MSAA x4's centres and worklist: the colour (and
    alpha) bit for bit with NaN in the same places. Each call timed (plain,
    kernel, kernel, plain: CUDA events around 50 bare launches of the
    call's stages, a CUDA graph of them, 3 plain calls) beside its bound
    (shade_work), and the entry's time (with the texture, shadow and light
    kernels it runs). Frames 2 and 3 of SHADE_FRAMES with the kernels
    (launches counted from 0, the plain shade_pbr never called) against
    the same frames with the plain version patched in (u8, colour and
    scalars); then kernel and plain frames in turns: frame ms, kernels and
    copies a frame, device busy and idle, pass_shade's device span and the
    kernels' time a frame by name.
    -> ({name: its numbers}, the largest |kernel - plain|)."""
    import torch

    from ash_tpu_torch.ops import shade, shade_cuda
    from ash_tpu_torch.render.bench_scene import build_bench_renderer

    def no_plain_shade(*args, **kwargs):
        raise AssertionError("a card frame ran the plain shade_pbr")

    rows, max_err = {}, 0.0
    rows["usage"] = {k: v for k, v in usage.items() if k.startswith("shade")}
    print("phase14 shading kernels, registers and spill bytes: "
          + "; ".join(f"{k} {r}, {sp}" for k, (r, sp) in
                      sorted(rows["usage"].items())) + f" ({card})",
          flush=True)
    check(cases["rich"][1]["lights"] is not None
          and cases["textured"][1]["pool"] is not None
          and cases["glass call 1"][1]["with_alpha"]
          and cases["edge x4 call 1"][1]["pixel_xy"] is not None,
          "phase 14's cases do not take the lit, textured, alpha and "
          "pixel_xy paths")

    for label, (args, kw) in cases.items():
        want = shade_cuda.plain(*args, **kw)
        got = shade_cuda.shade_pbr(*args, **kw)
        torch.cuda.synchronize()
        same, err = shade_same(got, want)
        check(same, f"shading kernels != plain shade_pbr at {label}")
        max_err = max(max_err, err)
        color = want[0] if isinstance(want, tuple) else want
        nan = int(torch.isnan(color).sum())
        del got, want, color
        gbuf, materials, uniforms = args
        lit = kw["lights"] is not None and kw["tile_light_indices"] is not None
        prepared = shade_cuda.prepare(
            gbuf, materials, uniforms, kw["shadow_map"], kw["pool"],
            kw["clear_color"], kw["max_anisotropy"], kw["csm"],
            kw["csm_blend_size"])
        stages = shade_cuda.launcher(
            gbuf, materials, uniforms, prepared, kw["reinhard"], lit,
            kw["with_alpha"] and kw["pool"] is None)[0]

        def launch(stages=stages):
            for fn in stages.values():
                fn()

        kern, graphed, plain = [], [], []
        for order in ("plain", "kernel", "kernel", "plain"):
            if order == "kernel":
                kern.append(cuda_ms(launch, 50))
                graphed.append(graph_ms(launch))
            else:
                plain.append(cuda_ms(
                    lambda: shade_cuda.plain(*args, **kw), 3))
        bound, bound_by, nbytes, draws = shade_work(args, kw)
        row = dict(elements=gbuf.mask.numel(), shape=list(gbuf.mask.shape),
                   covered=int(gbuf.mask.sum()), nan=nan,
                   stages=list(stages), textured=kw["pool"] is not None,
                   shadow=("none" if kw["shadow_map"] is None else
                           "cascades" if kw["csm"] is not None else "map"),
                   alpha=bool(kw["with_alpha"]),
                   pixel_xy=kw["pixel_xy"] is not None,
                   device_ms=statistics.mean(kern),
                   graph_ms=statistics.mean(graphed),
                   plain_ms=statistics.mean(plain),
                   wrapper_ms=cuda_ms(lambda: shade_cuda.shade_pbr(
                       *args, **kw), 20),
                   bound_ms=bound, bound_by=bound_by, bytes=nbytes,
                   draws=draws, max_abs_err=err)
        row["share_of_bound"] = bound / row["graph_ms"]
        rows[label] = row
        print(f"phase14 shading kernels, {label} ({row['elements']} elements "
              f"{row['shape']}, {row['covered']} covered; stages "
              f"{'+'.join(row['stages'])}, textured {row['textured']}, "
              f"shadow {row['shadow']}, alpha {row['alpha']}, pixel_xy "
              f"{row['pixel_xy']}): equal to the plain shade_pbr (bit for "
              f"bit, {nan} NaN in the same places); device "
              f"{row['device_ms']} ms (mean of 50 bare launches of the "
              f"stages; {row['graph_ms']} ms in a CUDA graph), entry "
              f"{row['wrapper_ms']} ms (with the texture, shadow and light "
              f"kernels), plain {row['plain_ms']} ms; bound {bound} ms by "
              f"{bound_by} ({nbytes} bytes, {draws} draws), "
              f"{100 * row['share_of_bound']:.1f}% of it ({card})",
              flush=True)
        del prepared, stages, launch
    del cases

    # Frames 2 and 3 with the kernels, counted from 0, and the same frames
    # with the plain version patched in, which launches none of them.
    plain_shade = mock.patch.object(shade_cuda, "shade_pbr", shade_cuda.plain)
    frame_kws = {name: (kw, preset) for name, kw, preset in
                 GBUFFER_CALL_FRAMES if name in SHADE_FRAMES}
    for name in SHADE_FRAMES:
        kw, _ = frame_kws[name]
        rend = build_bench_renderer(1920, 1080, 1000, "cuda", **kw)[0]
        rend.render_frame(view, proj, pos)
        zero_shade()
        zero_gbuffer()
        frames = []
        with mock.patch.object(shade, "shade_pbr", no_plain_shade):
            for _ in range(2):
                out = rend.render_frame(view, proj, pos)
                frames.append((rend.read_back().copy(), out.color.clone(),
                               frame_scalars(out)))
        launched = shade_launched()
        layers = gbuffer_launched()
        lit = kw.get("rich") or kw.get("lights")
        shade_launches[f"{name} frames 2-3"] = launched
        check(launched == layers * (2 if lit else 1) and layers >= 2,
              f"{name}: shading kernel launches {launched} in frames 2 and "
              f"3 for {layers} shaded layers")
        plain_r = build_bench_renderer(1920, 1080, 1000, "cuda", **kw)[0]
        with plain_shade:
            plain_r.render_frame(view, proj, pos)
            for image, color, scalars in frames:
                out = plain_r.render_frame(view, proj, pos)
                check(np.array_equal(plain_r.read_back(), image)
                      and torch.equal(out.color, color)
                      and frame_scalars(out) == scalars,
                      f"{name}: a frame with the shading kernels != the "
                      "frame with the plain shade_pbr")
        check(shade_launched() == launched,
              f"{name}: the plain frames launched the shading kernels")

        def step(i, r=rend):
            r.render_frame(view, proj, pos)

        def plain_step(i, r=plain_r):
            with plain_shade:
                r.render_frame(view, proj, pos)

        timed = {"kernel": [], "plain": []}
        for order in ("plain", "kernel", "kernel", "plain"):
            timed[order].append(frame_ms_spread(
                step if order == "kernel" else plain_step, 5)[0][0])
        frame_row = {}
        for k, st in (("kernel", step), ("plain", plain_step)):
            wall, busy, idle, n_ops = busy_profile(st)
            frame_row[k] = dict(ms=timed[k], busy_ms=busy, idle=idle,
                                ops=n_ops, pass_shade_ms=scope_device_ms(
                                    st, "pass_shade", n=2)[0])
        frame_row["kernel"]["shade_kernels"] = kernel_device_ms(
            step, ("shade_kernel", "compose_kernel"))
        rows[f"{name} frame"] = frame_row
        kf, pf = frame_row["kernel"], frame_row["plain"]
        print(f"phase14 {name} frames 2 and 3: equal to the plain "
              f"shade_pbr's (u8, colour and scalars); shading kernel "
              f"launches {launched} for {layers} shaded layers; frame ms "
              f"(median of 5, in turns) kernel {kf['ms']}, plain {pf['ms']}; "
              f"kernels and copies a frame {kf['ops']:g} / {pf['ops']:g}; "
              f"device busy {kf['busy_ms']:.2f} / {pf['busy_ms']:.2f} ms, "
              f"idle {100 * kf['idle']:.1f} / {100 * pf['idle']:.1f}%; "
              f"pass_shade device span {kf['pass_shade_ms']:.3f} / "
              f"{pf['pass_shade_ms']:.3f} ms (kernel / plain); the shading "
              f"kernels in the frame's trace: "
              f"{kf['shade_kernels'][0]:g} launches, "
              f"{kf['shade_kernels'][1]} ms a frame ({card})", flush=True)
        del rend, plain_r, frames
    return rows, max_err


def out_of_reach(lo, mask, world, normal, view_dir, base_color, metallic,
                 roughness, f0, ndotv, lights, tile_indices, tile_counts,
                 light_tile_size, pixel_xy=None):
    """The share of a grid call's live pixel-light pairs whose light is a
    point light out of reach: its window clamp(1 - (d / r)^4, 0, 1) is 0
    (in PyTorch's f32 ops, as light_slots computes it)."""
    import torch

    ty, tx, k = tile_indices.shape
    yy, xx = torch.nonzero(mask, as_tuple=True)
    tile = ((yy // light_tile_size).clamp(max=ty - 1) * tx
            + (xx // light_tile_size).clamp(max=tx - 1))
    slots = tile_indices.reshape(ty * tx, -1)[:, :k][tile]
    count = tile_counts.reshape(-1)[tile].clamp(0, k)
    live = (torch.arange(k, device=mask.device) < count[:, None]) & (
        slots >= 0)
    rows = lights[slots.clamp_min(0).long()]
    dist = torch.linalg.vector_norm(rows[..., :3] - world[yy, xx][:, None],
                                    dim=-1)
    q = dist / rows[..., 3].clamp_min(1e-3)
    q2 = q * q
    window = (1.0 - q2 * q2).clamp(0.0, 1.0)
    out = live & (window == 0) & (rows[..., 11] < 0.5)
    return float(out.sum()) / max(float(live.sum()), 1.0)


def ab_builds(trees):
    """Build each tree's ash_tpu_torch/csrc/bloom.cu, lights.cu and
    shadow.cu, where it has them, with ops/_build.py's flags, one nvcc a
    source, all started together, into build/ash_tpu_torch/ab/; bind each
    library with this tree's C signatures (the C entries are the same) ->
    {(kind, label): (library, ptxas_usage)}; this tree's own libraries
    under "change"."""
    import ctypes

    from ash_tpu_torch.ops import _build, bloom_cuda, lights_cuda, shadow_cuda

    own = {"bloom": (bloom_cuda._library(),
                     ("ash_bloom_down", "ash_bloom_up")),
           "lights": (lights_cuda._library(), ("ash_light_loop",)),
           "shadow": (shadow_cuda._library(), ("ash_shadow_pcf16",))}
    libs = {(kind, "change"): (lib, ptxas_usage(
        _build.library_path(kind).with_suffix(".log").read_text()))
        for kind, (lib, _) in own.items()}
    jobs = {}
    for i, (label, tree) in enumerate(trees.items()):
        for kind in own:
            src = tree / "ash_tpu_torch" / "csrc" / f"{kind}.cu"
            if src.is_file():
                out = _build.BUILD_DIR / "ab" / f"lib{kind}-{i}.so"
                jobs[kind, label] = (out, [_build.find_nvcc(),
                                           *_build.NVCC_FLAGS, "-o", str(out),
                                           str(src)])
    (_build.BUILD_DIR / "ab").mkdir(parents=True, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        procs = dict(zip(jobs, pool.map(
            lambda cmd: subprocess.run(cmd, capture_output=True, text=True),
            [cmd for _, cmd in jobs.values()])))
    for key, proc in procs.items():
        log = proc.stdout + proc.stderr
        check(proc.returncode == 0, f"ab: nvcc failed for {key}:\n{log}")
        lib = ctypes.CDLL(str(jobs[key][0]))
        this, entries = own[key[0]]
        for entry in entries:
            getattr(lib, entry).argtypes = getattr(this, entry).argtypes
            getattr(lib, entry).restype = getattr(this, entry).restype
        libs[key] = (lib, ptxas_usage(log))
    return libs


def tree_module(tree, name):
    """Another tree's ash_tpu_torch/ops/<name>.py, loaded as a module of
    this tree's package (its relative imports are this tree's modules), or
    None where the tree has none."""
    import importlib.util

    path = tree / "ash_tpu_torch" / "ops" / f"{name}.py"
    if not path.is_file():
        return None
    spec = importlib.util.spec_from_file_location(
        f"ash_tpu_torch.ops._ab_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def ab_phase(card, view, proj, pos, trees):
    """--parent DIR [--variant LABEL=DIR ...]: this tree's light, bloom and
    shadow kernels against DIR's, built from DIR's csrc/ and bound to this
    tree's entry points, in one process. Both are held to the plain
    versions at phases 10-12's inputs as those phases hold them
    (torch.equal; the light kernel on covered elements, the others
    untouched; the shadow kernel by shadow_same) and timed there in turns
    (DIR's, this tree's, each variant's, this tree's, DIR's): the light
    launch by CUDA events around 50 launches; the bloom chain by CUDA
    events around 50 bare chains (phase 11's `device_ms`) and in a CUDA
    graph (`graph_ms`), and at the rich and example 09 inputs each launch
    alone in a CUDA graph; the shadow launch at every call phase 12
    replays (shadow_cases) by events around 50 launches and in a CUDA
    graph; beside the unchanged bounds (light_work, bloom_work,
    shadow_work). DIR's shadow entry
    (its ops/shadow_cuda.py, on DIR's kernel) and this tree's are timed on
    the host in turns at the standard and rich calls (entry_parts). A
    variant is a copy of a tree's csrc/ (or of one source there) with one
    change made to measure a part of the time (its output may be wrong by
    design: whether it equals the plain version is printed, not required).
    Then the 1080p rich and glass frames with DIR's and this tree's
    kernels in turns (median of 5 frames, four turns), rich's pass_bloom
    span and the kernels' device ms a frame by name. -> {measurement:
    numbers}."""
    import torch

    from ash_tpu_torch.ops import bloom, bloom_cuda, lights_cuda, shadow_cuda
    from ash_tpu_torch.render.bench_scene import build_bench_renderer

    libs = ab_builds(trees)
    results = {"usage": {" / ".join(k): u for k, (_, u) in libs.items()}}
    for key, u in results["usage"].items():
        print(f"ab build {key}: " + "; ".join(
            f"{k}: {r} registers, {sp} spill bytes"
            for k, (r, sp) in sorted(u.items())), flush=True)
    kinds = {bloom_cuda: "bloom", lights_cuda: "lights",
             shadow_cuda: "shadow"}

    def use(module, label, kind=None):
        return mock.patch.object(
            module, "_library", lambda: libs[kind or kinds[module], label][0])

    def order(kind):
        others = [lb for k, lb in libs if k == kind
                  and lb not in ("parent", "change")]
        return ["parent", "change", *others, "change", "parent"]

    def held(label, equal, what):
        if label in ("parent", "change"):
            check(equal, f"ab: {label}'s {what} != the plain version")
        return equal

    # The light kernel at the rich, lit and lit bf16 shade calls.
    for name, kw in LIGHT_FRAMES:
        rend = build_bench_renderer(1920, 1080, 1000, "cuda", **kw)[0]
        calls = light_calls(rend, view, proj, pos)
        del rend
        args = calls[0]
        lo_in, mask = args[0], args[1]
        want = lights_cuda.plain(lo_in.clone(), *args[1:])
        int_view = torch.int16 if lo_in.dtype == torch.bfloat16 \
            else torch.int32
        launches, works, equal = {}, {}, {}
        for label in dict.fromkeys(order("lights")):
            # Each launch's output stays alive while it is timed.
            work = works[label] = lo_in.clone()
            with use(lights_cuda, label):
                launch, _ = lights_cuda.launcher(work, *args[1:])
            launch()
            torch.cuda.synchronize()
            equal[label] = held(label, bool(
                torch.equal(work[mask], want[mask])
                and torch.equal(work[~mask].view(int_view),
                                lo_in[~mask].view(int_view))),
                f"light kernel at the {name} shade call")
            launches[label] = launch
        times = {}
        for label in order("lights"):
            times.setdefault(label, []).append(cuda_ms(launches[label], 50))
        bound = light_work(*args)[0]
        mean = {k: statistics.mean(v) for k, v in times.items()}
        reach = out_of_reach(*args)
        results[f"lights {name}"] = dict(turns=times, equal=equal,
                                         bound_ms=bound, out_of_reach=reach)
        print(f"ab light kernel, {name} shade call ("
              f"{str(lo_in.dtype).replace('torch.', '')}): device ms (mean "
              f"of 50 launches, in turns) " + "; ".join(
                  f"{k} {v} -> {mean[k]:.4f} ({100 * bound / mean[k]:.1f}% "
                  f"of the bound; equal to the plain loop {equal[k]})"
                  for k, v in times.items())
              + f"; bound {bound:.4f} ms; live pairs out of a point light's "
              f"reach {100 * reach:.1f}% ({card})", flush=True)
        del calls, args, want, launches, works

    # The bloom chain at phase 11's timed inputs.
    rich, inputs = bloom_inputs(view, proj, pos)
    for name, (hdr, kw) in inputs.items():
        if not bloom_timed(name):
            continue
        h, w = hdr.shape[:2]
        plan = bloom_cuda.levels(h, w, kw["mip_count"])
        want = bloom.bloom_pyramid(hdr, **kw)
        chains, equal = {}, {}
        for label in dict.fromkeys(order("bloom")):
            with use(bloom_cuda, label):
                launch, out = bloom_cuda.launcher(hdr, **kw)
            launch()
            torch.cuda.synchronize()
            equal[label] = held(label, bool(torch.equal(out, want)),
                                f"bloom chain at {name}")
            chains[label] = launch
        chain, graphed = {}, {}
        for label in order("bloom"):
            chain.setdefault(label, []).append(cuda_ms(chains[label], 50))
            graphed.setdefault(label, []).append(graph_ms(chains[label]))
        bound = bloom_work(h, w, kw["mip_count"])[0]
        row = dict(device_ms=chain, graph_ms=graphed, equal=equal,
                   bound_ms=bound)
        mean = {k: statistics.mean(v) for k, v in chain.items()}
        line = (f"ab bloom chain, {name} ({w}x{h}, {kw['mip_count']} mips, "
                f"{len(plan)} launches): device ms (mean of 50 bare chains; "
                f"in a CUDA graph; in turns) " + "; ".join(
                    f"{k} {v}; {graphed[k]} -> {mean[k]:.4f}; "
                    f"{statistics.mean(graphed[k]):.4f} "
                    f"({100 * bound / mean[k]:.1f}% of the bound; equal to "
                    f"the plain chain {equal[k]})" for k, v in chain.items())
                + f"; bound {bound:.4f} ms")
        if name in ("rich frame 1", "example 09 farm frame"):
            steps = {}
            for i, s in enumerate(plan):
                t = {}
                for label in order("bloom"):
                    t.setdefault(label, []).append(
                        graph_ms(lambda: chains[label]([i])))
                steps[f"{s.kind} {s.path}"
                      f"{' threshold' if s.threshold else ''} "
                      f"{s.src[1]}x{s.src[0]} -> {s.dst[1]}x{s.dst[0]}"] = {
                    k: statistics.mean(v) for k, v in t.items()}
            row["by_launch"] = steps
            line += ("; each launch alone (device ms, a CUDA graph of 20; "
                     + ", ".join(dict.fromkeys(order("bloom"))) + "): "
                     + "; ".join(f"{k}: " + ", ".join(
                         f"{v:.4f}" for v in t.values())
                         for k, t in steps.items()))
        results[f"bloom {name}"] = row
        print(f"{line} ({card})", flush=True)
        del chains, want

    # The shadow kernel at phase 12's calls.
    cases, rends = shadow_cases(view, proj, pos)
    entries = {"parent": tree_module(trees["parent"], "shadow_cuda"),
               "change": shadow_cuda}
    for name, (is_csm, args, blend) in cases.items():
        want = shadow_entry("plain", is_csm, args, blend)
        launches, outs, equal = {}, {}, {}
        for label in dict.fromkeys(order("shadow")):
            with use(shadow_cuda, label):
                launch, outs[label] = shadow_entry("launcher", is_csm, args,
                                                   blend)
            launch()
            torch.cuda.synchronize()
            equal[label] = held(label, shadow_same(outs[label], want),
                                f"shadow kernel at the {name} call")
            launches[label] = launch
        events, graphed = {}, {}
        for label in order("shadow"):
            events.setdefault(label, []).append(cuda_ms(launches[label], 50))
            graphed.setdefault(label, []).append(graph_ms(launches[label]))
        bound = shadow_work(is_csm, args, blend)[0]
        row = dict(device_ms=events, graph_ms=graphed, equal=equal,
                   bound_ms=bound)
        shape = "x".join(map(str, args[0].shape))
        line = (f"ab shadow kernel, {name} call ({shape} map, "
                f"{args[-3].numel() // 3} elements, "
                f"{str(args[-2].dtype).replace('torch.', '')}, blend "
                f"{blend}): device ms (mean of 50 launches; in a CUDA graph; "
                "in turns) " + "; ".join(
                    f"{k} {v}; {graphed[k]} -> "
                    f"{statistics.mean(graphed[k]):.4f} "
                    f"({100 * bound / statistics.mean(graphed[k]):.1f}% of "
                    f"the bound; equal to the plain PCF {equal[k]})"
                    for k, v in events.items()) + f"; bound {bound:.4f} ms")
        if name in ("standard", "rich") and entries["parent"] is not None:
            host = {}
            for label in ("parent", "change", "change", "parent"):
                with use(entries[label], label, "shadow"):
                    for k, v in entry_parts(entries[label], is_csm, args,
                                            blend).items():
                        host.setdefault(k, {}).setdefault(label, []).append(v)
            row["entry_us"] = host
            line += ("; the entry's host us a call, in turns (parent; "
                     "change): " + ", ".join(
                         f"{k} {v['parent']}; {v['change']}"
                         for k, v in host.items()))
        results[f"shadow {name}"] = row
        print(f"{line} ({card})", flush=True)
        del launches, outs, want
    glass = rends["glass"][0]
    del cases, rends

    # The rich and glass frames with DIR's kernels and this tree's, in
    # turns.
    def step(i):
        rich.render_frame(view, proj, pos)

    def glass_step(i):
        glass.render_frame(view, proj, pos)

    @contextlib.contextmanager
    def _uses(label):
        with use(bloom_cuda, label), use(lights_cuda, label), \
                use(shadow_cuda, label):
            yield

    frames = {"parent": [], "change": []}
    glass_frames = {"parent": [], "change": []}
    for label in ("parent", "change", "change", "parent"):
        with _uses(label):
            frames[label].append(frame_ms_spread(step, 5)[0][0])
            glass_frames[label].append(frame_ms_spread(glass_step, 5)[0][0])
    traced = {}
    for label in ("parent", "change"):
        with _uses(label):
            traced[label] = dict(
                pass_bloom_span_ms=scope_device_ms(step, "pass_bloom")[0],
                bloom_kernels=kernel_device_ms(
                    step, ("bloom_down_kernel", "bloom_up_kernel")),
                light_kernel=kernel_device_ms(
                    step, ("light_tile_kernel", "light_element_kernel")),
                shadow_kernel=kernel_device_ms(step, SHADOW_KERNELS),
                glass_shadow_kernel=kernel_device_ms(
                    glass_step, SHADOW_KERNELS))
    results["rich frame"] = dict(frame_ms=frames, traced=traced)
    results["glass frame"] = dict(frame_ms=glass_frames)
    print(f"ab rich frame (1920x1080), frame ms (median of 5, in turns) "
          f"parent {frames['parent']}, change {frames['change']}; glass "
          f"frame parent {glass_frames['parent']}, change "
          f"{glass_frames['change']}; "
          + "; ".join(
              f"{label}: pass_bloom span {v['pass_bloom_span_ms']:.4f} ms, "
              f"bloom kernels {v['bloom_kernels'][0]:g} launches "
              f"{v['bloom_kernels'][1]:.4f} ms, light kernel "
              f"{v['light_kernel'][0]:g} launches {v['light_kernel'][1]:.4f} "
              f"ms, shadow kernel {v['shadow_kernel'][0]:g} launches "
              f"{v['shadow_kernel'][1]:.4f} ms a frame (glass "
              f"{v['glass_shadow_kernel'][0]:g} launches "
              f"{v['glass_shadow_kernel'][1]:.4f} ms)"
              for label, v in traced.items()) + f" ({card})",
          flush=True)
    return results


# Phase 15: the benchmark's six cells, eager and graphed. The frames held
# equal (frames 0-3 of each renderer; frame 0 is the graphed renderer's
# eager warm-up, frame 1 its capture), the FrameOutputs fields compared,
# and the check frames' camera turn about the origin, rad a frame.
GRAPH_CHECK_FRAMES = 4
GRAPH_CHECK_TURN = 0.05
GRAPH_FIELDS = ("image", "color", "depth", "covered_pixels",
                "binning_overflow", "shadow_overflow", "visible_draws",
                "msaa_edge_overflow", "shadow_map", "history")
# The timed windows' order: eager, graphed, graphed, eager.
GRAPH_TURNS = ("eager", "graphed", "graphed", "eager")
# Profiles of 3 eager and 3 graphed frames taken until their hand kernels'
# counts agree (a trace can lose a replay's records).
GRAPH_PROFILE_TRIES = 3


def hand_kernel_names():
    """The __global__ functions of ash_tpu_torch/csrc/*.cu."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(\w+)")
    import ash_tpu_torch

    csrc = pathlib.Path(ash_tpu_torch.__file__).parent / "csrc"
    return sorted({m for f in csrc.glob("*.cu")
                   for m in pat.findall(f.read_text())})


def moving_pose(cell, data, i):
    """Frame i of the cell's sequence (benchmark/scenes.frame_pose) with its
    camera turned about the vertical axis through its target by
    GRAPH_CHECK_TURN * (i + 1) rad, so that every frame of a static cell
    moves too."""
    import copy

    from benchmark import scenes

    pose = scenes.frame_pose(cell, data, i)
    cam = copy.copy(data["camera"])
    a = GRAPH_CHECK_TURN * (i + 1)
    c, s = np.float32(np.cos(a)), np.float32(np.sin(a))
    d = np.asarray(cam.position, np.float32) - np.asarray(cam.target,
                                                          np.float32)
    cam.position = (np.asarray(cam.target, np.float32) + np.array(
        [c * d[0] + s * d[2], d[1], c * d[2] - s * d[0]], np.float32))
    return {**pose, "args": (cam.view_matrix(), cam.projection_matrix(),
                             cam.position.copy())}


def launch_profile(step, n=3):
    """Per frame over n frames of step under torch.profiler, after one
    frame the profiler runs but keeps nothing of (its warm-up step): (kernels
    and copies on the device, launch calls on the host
    (benchmark/trace.py's HOST_LAUNCH_CALLS),
    device busy ms, {device kernel name: launches}, copies and memsets
    aside). Step is called with 0..n."""
    import torch
    from benchmark.trace import HOST_LAUNCH_CALLS
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=n,
                                   repeat=1)) as prof:
        for i in range(n + 1):
            step(i)
            torch.cuda.synchronize()
            prof.step()
    avgs = prof.key_averages()
    work = [e for e in avgs
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    host = [e for e in avgs if e.device_type == DeviceType.CPU
            and e.key in HOST_LAUNCH_CALLS]
    by_name = collections.Counter()
    for e in work:
        if not re.search("memcpy|memset|copy", e.key, re.I):
            by_name[e.key] += e.count
    return (sum(e.count for e in work) / n, sum(e.count for e in host) / n,
            sum(e.self_device_time_total for e in work) / 1e3 / n,
            {k: v / n for k, v in by_name.items()})


def hand_per_frame(by_name, hand):
    """{hand kernel: launches a frame} of launch_profile's by-name counts
    (a kernel name matches at a word boundary: templates and arguments
    follow it)."""
    c = collections.Counter()
    for k, v in by_name.items():
        c.update({h: v for h in hand if re.search(rf"\b{h}\b", k)})
    return dict(c)


def graph_phase(card, frames):
    """Phase 15 (the module's docstring): each of the benchmark's cells
    (benchmark/scenes.py, at 1920x1080) through two fresh renderers, one
    eager, one graphed; `frames` frames a timed window. -> {cell: row}."""
    import gc

    import torch
    from benchmark import scenes
    from benchmark.run import percentile
    from ash_tpu_torch.render import compiled

    api = scenes.port_api("cuda")
    rows = {}
    hand = hand_kernel_names()

    def pool_segments():
        """{private pool id: bytes} of the allocator's segments."""
        out = collections.Counter()
        for seg in torch.cuda.memory_snapshot():
            pid = tuple(seg.get("segment_pool_id", (0, 0)))
            if pid != (0, 0):
                out[pid] += seg["total_size"]
        return out

    for name in scenes.CELL_NAMES:
        t_cell = time.perf_counter()
        pools_before = set(pool_segments())
        cell = scenes.load_cell(name)
        rends = {}
        for mode in ("eager", "graphed"):
            data = scenes.scene_data(cell, api, 0)
            rends[mode] = [scenes.build_renderer(cell, data, api), data, 0]
            rends[mode][0].set_cuda_graphs(mode == "graphed")

        outs, counts, stats = {}, {}, {}
        for mode, rd in rends.items():
            r, data, _ = rd
            compiled.reset_stats()
            before = compiled.counters()
            got, kept = [], []
            for i in range(GRAPH_CHECK_FRAMES):
                with (compiled.no_host_sync() if mode == "eager" and i > 0
                      else contextlib.nullcontext()):
                    o = scenes.apply_pose(r, moving_pose(cell, data, i))
                got.append({f: (None if getattr(o, f) is None
                                else getattr(o, f).clone())
                            for f in GRAPH_FIELDS})
                kept.append(o)
            # A frame's returned outputs stay as they were after the next.
            moved = [(i, f) for i, (o, g) in enumerate(zip(kept, got))
                     for f in GRAPH_FIELDS if g[f] is not None
                     and not torch.equal(getattr(o, f), g[f])]
            check(not moved, f"phase15 {name} {mode}: returned outputs "
                  f"changed by later frames, (frame, field) {moved[:8]}")
            del kept, o
            rd[2] = GRAPH_CHECK_FRAMES
            counts[mode] = compiled.counter_delta(compiled.counters(), before)
            stats[mode] = {k: {**v, "eager": dict(v["eager"])}
                           for k, v in compiled.stats.items()}
            outs[mode] = got
        differ = [(i, f) for i, (g, e) in enumerate(zip(outs["graphed"],
                                                        outs["eager"]))
                  for f in GRAPH_FIELDS
                  if (g[f] is None) != (e[f] is None)
                  or (g[f] is not None and not torch.equal(g[f], e[f]))]
        check(not differ, f"phase15 {name}: graphed frames differ from "
              f"eager ones in (frame, field) {differ[:8]}")
        still = [i for i in range(1, GRAPH_CHECK_FRAMES)
                 if torch.equal(outs["eager"][i]["image"],
                                outs["eager"][i - 1]["image"])]
        check(not still, f"phase15 {name}: eager frames {still} equal the "
              "frame before: the check frames' inputs did not move")
        check(counts["eager"], f"phase15 {name}: no kernel counter moved")
        st = stats["graphed"]["frame"]
        check(st["captures"] >= 1 and st["replays"] >= 1
              and st["replays"] + sum(st["eager"].values())
              == GRAPH_CHECK_FRAMES
              and set(st["eager"]) <= {"first"},
              f"phase15 {name}: the graphed renderer's frame steps {st}")
        check(stats["eager"]["frame"]["replays"] == 0
              and stats["eager"]["frame"]["eager"]
              == {"graphs off": GRAPH_CHECK_FRAMES},
              f"phase15 {name}: the eager renderer's frame steps "
              f"{stats['eager']['frame']}")
        print(f"phase15 graphs {name}: frames 0-{GRAPH_CHECK_FRAMES - 1}, "
              f"the camera turning {GRAPH_CHECK_TURN} rad a frame, graphed "
              f"== eager bit for bit ({', '.join(GRAPH_FIELDS)}), each "
              f"unchanged after the later frames, each eager image unlike "
              f"the one before; eager frames 1-{GRAPH_CHECK_FRAMES - 1} made "
              f"no host sync in their steps; steps graphed "
              f"{stats['graphed']}; the wrappers' calls, eager "
              f"{ {f'{m}.{k}': v for (m, k), v in counts['eager'].items()} }"
              f", graphed (eager frames and captures only) "
              f"{ {f'{m}.{k}': v for (m, k), v in counts['graphed'].items()} }"
              f" | {card}", flush=True)
        del outs

        marks = []
        for r, _, _ in rends.values():
            def present(outputs, start, _r=r, _orig=type(r)._present):
                marks.append(time.perf_counter())
                return _orig(_r, outputs, start)
            r._present = present
        windows = []
        for w, mode in enumerate(GRAPH_TURNS):
            rd = rends[mode]
            r, data = rd[0], rd[1]
            compiled.reset_stats()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            walls, hosts = [], []
            for _ in range(frames):
                pose = scenes.frame_pose(cell, data, rd[2])
                rd[2] += 1
                del marks[:]
                t0 = time.perf_counter()
                scenes.apply_pose(r, pose)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                hosts.append((marks[0] - t0) * 1e3)
            torch.cuda.synchronize()
            st = compiled.stats.get("frame", {})
            check(st.get("replays", 0) == (frames if mode == "graphed" else 0),
                  f"phase15 {name} window {w} ({mode}): frame steps {st}")
            row = {"mode": mode, "p50_ms": percentile(walls, 50),
                   "p90_ms": percentile(walls, 90),
                   "host_ms_p50": percentile(hosts, 50),
                   "peak_allocated_mib":
                       torch.cuda.max_memory_allocated() / 2**20,
                   "peak_reserved_mib":
                       torch.cuda.max_memory_reserved() / 2**20}
            windows.append(row)
            print(f"phase15 graphs {name} window {w} {mode} ({frames} "
                  f"frames): p50 {row['p50_ms']:.3f} ms, p90 "
                  f"{row['p90_ms']:.3f} ms, render_frame host ms to the "
                  f"present p50 {row['host_ms_p50']:.3f}, peak allocated "
                  f"{row['peak_allocated_mib']:.1f} MiB, reserved "
                  f"{row['peak_reserved_mib']:.1f} MiB | {card}", flush=True)
        # The replays launched each hand kernel the eager frames did, as
        # often, by name in a profiler trace. A trace can now and then lose
        # the records of a whole replay (once seen: one of three animated
        # frames' frame and shadow graphs), while a graph launches the same
        # nodes at every replay. So the eager and graphed frames are
        # profiled afresh, up to GRAPH_PROFILE_TRIES times, until their
        # counts agree; every try is printed, and none agreeing fails. The
        # other kernels are compared and printed, not held: a replay's
        # trace has lost a record of one (glass, 110-frame windows, one of
        # 18 index kernels).
        for attempt in range(1, GRAPH_PROFILE_TRIES + 1):
            prof = {}
            for mode, rd in rends.items():
                r, data = rd[0], rd[1]

                def step(i, r=r, data=data, rd=rd):
                    scenes.render(cell, data, r, rd[2])
                    rd[2] += 1

                compiled.reset_stats()
                prof[mode] = launch_profile(step)
                st = compiled.stats.get("frame", {})
                check(mode == "eager" or st.get("replays") == 4,
                      f"phase15 {name}: profiled graphed frame steps {st}")
                print(f"phase15 graphs {name} {mode}, 3 profiled frames "
                      f"(try {attempt}): {prof[mode][0]:.1f} kernels and "
                      f"copies on the device, {prof[mode][1]:.1f} launch "
                      f"calls on the host, device busy {prof[mode][2]:.3f} ms "
                      f"a frame | {card}", flush=True)
            names = {mode: p[3] for mode, p in prof.items()}
            ours = {mode: hand_per_frame(n, hand) for mode, n in names.items()}
            if ours["graphed"] == ours["eager"] and ours["eager"]:
                break
            print(f"phase15 graphs {name}: try {attempt} of "
                  f"{GRAPH_PROFILE_TRIES}, the traces' hand kernels a frame "
                  f"differ, graphed {ours['graphed']} against eager "
                  f"{ours['eager']} | {card}", flush=True)
        odd = {k[:60]: (names["graphed"].get(k, 0), names["eager"].get(k, 0))
               for k in set(names["graphed"]) | set(names["eager"])
               if names["graphed"].get(k, 0) != names["eager"].get(k, 0)}
        check(ours["graphed"] == ours["eager"] and ours["eager"],
              f"phase15 {name}: hand kernels a frame by name in "
              f"{GRAPH_PROFILE_TRIES} tries, last graphed {ours['graphed']} "
              f"against eager {ours['eager']}")
        print(f"phase15 graphs {name}: 3 replayed frames launched each hand "
              f"kernel as often as 3 eager ones (try {attempt}), a frame "
              f"{ours['graphed']}; "
              f"the other device kernels ({len(names['eager'])} names, "
              f"copies aside; {sum(names['eager'].values()):.1f} a frame), "
              f"(graphed, eager) where the traces differ: {odd or 'none'} "
              f"| {card}", flush=True)
        # The graphs' own device time (replays between CUDA events, no
        # host work), and the image's blocking copy to the host alone.
        r = rends["graphed"][0]
        replay_ms = {k: cuda_ms(g._graph.replay, 20)
                     for k, g in r._graphs.items() if g.captured}
        image = r.last_outputs().image

        def copy_ms_of(fn):
            walls = []
            for _ in range(20):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                walls.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(walls)

        # Freed at once; the previous copy held until replaced, as
        # render_frame holds the last image; into one pinned buffer.
        held = [image.cpu()]
        pinned = torch.empty(image.shape, dtype=image.dtype, pin_memory=True)
        copy_ms = {"freed": copy_ms_of(image.cpu),
                   "held": copy_ms_of(lambda: held.__setitem__(0,
                                                                image.cpu())),
                   "pinned": copy_ms_of(lambda: pinned.copy_(image))}
        del image, held, pinned
        # The graphs' private pools: what a replay's working set holds,
        # which max_memory_allocated does not count during a replay.
        pool_mib = sum(n for pid, n in pool_segments().items()
                       if pid not in pools_before) / 2**20
        print(f"phase15 graphs {name}: graph replay device ms "
              f"{ {k: round(v, 4) for k, v in replay_ms.items()} }, the "
              f"image's copy to the host alone, ms (median of 20) "
              f"{ {k: round(v, 3) for k, v in copy_ms.items()} }, the graphs' "
              f"private pools {pool_mib:.1f} MiB | {card}",
              flush=True)
        rows[name] = {"windows": windows,
                      "profiled": {k: v[:3] for k, v in prof.items()},
                      "hand_kernels_per_frame": ours["graphed"],
                      "replay_device_ms": replay_ms, "image_copy_ms": copy_ms,
                      "graph_pool_mib": pool_mib,
                      "check_frames": GRAPH_CHECK_FRAMES,
                      "seconds": time.perf_counter() - t_cell}
        for rd in rends.values():
            del rd[0]._present  # the timing hook refers to its renderer
        del rends, rd, r, step
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def graphs_off():
    """A patcher (start() / stop(), or a context) under which every
    Renderer built runs eager frames: set_cuda_graphs(False) right after
    its construction. Phases 3-14 and ab_phase count the wrappers' launches
    frame by frame, patch plain versions into the entries and read the
    eager frame's `pass_*` scopes, none of which a replay re-enters; a
    renderer that asks for graphs itself (the benchmark's) still gets
    them."""
    from ash_tpu_torch.render.renderer import Renderer

    init = Renderer.__init__

    @functools.wraps(init)
    def eager_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.set_cuda_graphs(False)

    return mock.patch.object(Renderer, "__init__", eager_init)


# Phase 16: the asynchronous frame loop on renderers built with default
# settings. Frames 0..PRESENT_CHECK_FRAMES-1 read by read_back() (the
# frame step replays from frame 2 on, every step from PRESENT_SYNC_FROM on,
# and those frames make no host sync); then PRESENT_STEADY_FRAMES more with
# no readback, all under
# the sync debug mode's "error"; PRESENT_STREAM_FRAMES through a
# FileStreamSurface at each of PRESENT_DEPTHS; the timed loops in turns.
PRESENT_CHECK_FRAMES = 10
PRESENT_SYNC_FROM = 3
PRESENT_STEADY_FRAMES = 20
PRESENT_STREAM_FRAMES = 20
PRESENT_DEPTHS = (1, 2, 3)
# "clock": each frame between CUDA events and waited for on its end event,
# as the benchmark's Clock times it; "none", "stream" (FileStreamSurface at
# depth 2, to os.devnull) and "read_back" (a read_back() after each frame):
# the loop's wall over its frames, synchronized once at its end.
PRESENT_TURNS = ("clock", "none", "stream", "read_back",
                 "read_back", "stream", "none", "clock")


@contextlib.contextmanager
def sync_error():
    """Any host sync that PyTorch's sync debug mode sees raises inside."""
    import torch

    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def step_calls():
    """{step: (eager calls, captures, replays)} of render/compiled.py."""
    from ash_tpu_torch.render import compiled

    return {k: (sum(v["eager"].values()), v["captures"], v["replays"])
            for k, v in compiled.stats.items()}


def present_phase(card, frames):
    """Phase 16 (the module's docstring): each of the benchmark's cells at
    1920x1080 through renderers built with default settings, against a
    renderer with graphs off whose images are copied as render_frame used
    to copy them (`outputs.image.cpu()` after each frame); `frames` frames
    a timed window. -> {cell: row}."""
    import gc
    import types

    import torch
    import ash_tpu_torch as att
    from benchmark import scenes
    from benchmark.run import percentile
    from ash_tpu_torch.render import compiled

    api = scenes.port_api("cuda")

    def default_api(surface=None):
        """scenes' API, its renderers built with default settings (no
        set_cuda_graphs call) on `surface(w, h)` or a HeadlessSurface."""
        return types.SimpleNamespace(**{
            **vars(api),
            "renderer": lambda s, cfg: att.Renderer(s, cfg, device="cuda"),
            "HeadlessSurface": surface or api.HeadlessSurface})

    def build(cell, surface=None):
        data = scenes.scene_data(cell, api, 0)
        return scenes.build_renderer(cell, data, default_api(surface)), data

    def named(counts):
        return {f"{m}.{k}": v for (m, k), v in counts.items()}

    tmp = pathlib.Path(os.path.dirname(os.path.abspath(__file__))) / "build"
    tmp.mkdir(exist_ok=True)
    rows = {}
    n_all = PRESENT_CHECK_FRAMES + PRESENT_STEADY_FRAMES
    for name in scenes.CELL_NAMES:
        t_cell = time.perf_counter()
        cell = scenes.load_cell(name)
        h, w = cell["height"], cell["width"]
        # The blocking path: graphs off, each image copied to the host
        # after its frame.
        r_old, data = build(cell)
        r_old.set_cuda_graphs(False)
        before = compiled.counters()
        old = []
        for i in range(n_all):
            o = scenes.apply_pose(r_old, moving_pose(cell, data, i))
            old.append(o.image.cpu().numpy())
            if i == PRESENT_CHECK_FRAMES - 1:
                eager_counts = compiled.counter_delta(compiled.counters(),
                                                      before)
        still = [i for i in range(1, n_all)
                 if np.array_equal(old[i], old[i - 1])]
        check(not still, f"phase16 {name}: blocking frames {still} equal the "
              "frame before: the check frames' inputs did not move")
        del r_old, o

        # (a)-(c): a renderer with default settings.
        r, data = build(cell)
        check(all(g.enabled for g in r._graphs.values()),
              f"phase16 {name}: a default renderer's graphs are off")
        compiled.reset_stats()
        before = compiled.counters()
        calls, differ = [], []
        for i in range(PRESENT_CHECK_FRAMES):
            was = step_calls()
            with (sync_error() if i >= PRESENT_SYNC_FROM
                  else contextlib.nullcontext()):
                scenes.apply_pose(r, moving_pose(cell, data, i))
            calls.append({k: tuple(a - b for a, b in
                                   zip(v, was.get(k, (0, 0, 0))))
                          for k, v in step_calls().items()})
            if not np.array_equal(r.read_back(), old[i]):
                differ.append(i)
        counts = compiled.counter_delta(compiled.counters(), before)
        # The frame step replays from frame 2 on; under TAA its key warms up
        # twice (frame 1 reads last frame's models, a buffer of their own),
        # and animated's TRS composition runs first in frame 1, so every
        # step replays from frame 3.
        first = PRESENT_SYNC_FROM if cell.get("hdr_taa") else 2
        replayed = (all(c["frame"] == (0, 0, 1) for c in calls[first:])
                    and all(v[:2] == (0, 0) for c in calls[PRESENT_SYNC_FROM:]
                            for v in c.values()))
        check(replayed, f"phase16 {name}: steps (eager, captures, replays) "
              f"by frame {calls}, want the frame step's replays only from "
              f"frame {first}, every step's from frame {PRESENT_SYNC_FROM}")
        check(not differ, f"phase16 {name}: read_back() of frames {differ} "
              "differs from the blocking path's image")
        check(counts and set(counts) == set(eager_counts),
              f"phase16 {name}: the wrappers called in frames 0-"
              f"{PRESENT_CHECK_FRAMES - 1}, graphed {counts} against eager "
              f"{eager_counts}")
        was = step_calls()
        with sync_error():
            for i in range(PRESENT_CHECK_FRAMES, n_all):
                scenes.apply_pose(r, moving_pose(cell, data, i))
        steady = {k: tuple(a - b for a, b in zip(v, was.get(k, (0, 0, 0))))
                  for k, v in step_calls().items()}
        check(steady["frame"] == (0, 0, PRESENT_STEADY_FRAMES)
              and all(v[:2] == (0, 0) for v in steady.values()),
              f"phase16 {name}: steady frames' steps {steady}")
        check(np.array_equal(r.read_back(), old[-1]),
              f"phase16 {name}: read_back() after {PRESENT_STEADY_FRAMES} "
              "frames with no readback differs from the blocking path's")
        print(f"phase16 present {name}: a renderer with default settings "
              f"replayed the frame step from frame {first} on and every "
              f"step from frame {PRESENT_SYNC_FROM} on (steps (eager, "
              f"captures, replays) by frame {calls}); frames "
              f"{PRESENT_SYNC_FROM}-{n_all - 1} (render_frame"
              + (", update_transforms_trs" if cell["sequence"]["motion"]
                 != "none" else "")
              + f") made no host sync under sync debug mode \"error\"; "
              f"read_back() of frames 0-{PRESENT_CHECK_FRAMES - 1} and of "
              f"frame {n_all - 1} after {PRESENT_STEADY_FRAMES} frames with "
              f"no readback == the graphs-off frames copied with .cpu() bit "
              f"for bit; the wrappers' calls, frames 0-"
              f"{PRESENT_CHECK_FRAMES - 1} graphed (frame 0 and the "
              f"captures) {named(counts)}, eager {named(eager_counts)} | "
              f"{card}", flush=True)

        # (d): FileStreamSurface raw streams at each depth.
        streams = {}
        for depth in PRESENT_DEPTHS:
            path = tmp / f"present-{name}-{depth}.rgba"
            surf = []

            def stream(sw, sh, depth=depth, path=path, surf=surf):
                surf.append(att.FileStreamSurface(
                    sw, sh, str(path), max_frames_in_flight=depth))
                return surf[-1]

            rs, sdata = build(cell, stream)
            written = []
            for i in range(PRESENT_STREAM_FRAMES):
                scenes.apply_pose(rs, moving_pose(cell, sdata, i))
                written.append(surf[0].written_frames)
            surf[0].close()
            raw = np.fromfile(path, np.uint8)
            path.unlink()
            n = raw.size // (h * w * 4)
            bad = [i for i in range(min(n, PRESENT_STREAM_FRAMES))
                   if not np.array_equal(raw[i * h * w * 4:
                                             (i + 1) * h * w * 4]
                                         .reshape(h, w, 4), old[i])]
            check(raw.size == PRESENT_STREAM_FRAMES * h * w * 4 and not bad,
                  f"phase16 {name}: FileStreamSurface depth {depth}: "
                  f"{raw.size} bytes, frames {bad} differ from the blocking "
                  "path's")
            check(written == [max(0, i + 2 - depth)
                              for i in range(PRESENT_STREAM_FRAMES)],
                  f"phase16 {name}: FileStreamSurface depth {depth} wrote "
                  f"{written} frames after each present")
            streams[depth] = raw.size
            del rs, raw
        print(f"phase16 present {name}: FileStreamSurface raw streams of "
              f"{PRESENT_STREAM_FRAMES} frames at max_frames_in_flight "
              f"{', '.join(map(str, PRESENT_DEPTHS))} ({streams} bytes) == "
              "the blocking path's frames byte for byte, each frame written "
              f"max_frames_in_flight - 1 presents later | {card}", flush=True)
        del old

        # (e): the times, in turns.
        r_fs, fdata = build(cell, lambda sw, sh: att.FileStreamSurface(
            sw, sh, os.devnull, max_frames_in_flight=2))
        idx = {id(r): PRESENT_CHECK_FRAMES + PRESENT_STEADY_FRAMES,
               id(r_fs): 0}
        for _ in range(3):  # warm-up: eager, captured, replayed
            scenes.render(cell, fdata, r_fs, idx[id(r_fs)])
            idx[id(r_fs)] += 1
        times = collections.defaultdict(list)
        windows = []
        for mode in PRESENT_TURNS:
            rr, rdata = (r_fs, fdata) if mode == "stream" else (r, data)
            compiled.reset_stats()
            torch.cuda.synchronize()
            evs = []
            t0 = time.perf_counter()
            for _ in range(frames):
                pose = scenes.frame_pose(cell, rdata, idx[id(rr)])
                idx[id(rr)] += 1
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                h0 = time.perf_counter()
                scenes.apply_pose(rr, pose)
                times[mode, "host"].append((time.perf_counter() - h0) * 1e3)
                e1.record()
                evs.append((e0, e1))
                if mode == "clock":
                    e1.synchronize()
                elif mode == "read_back":
                    rr.read_back()
            if mode == "stream":
                rr.surface.flush()
            torch.cuda.synchronize()
            loop_ms = (time.perf_counter() - t0) * 1e3 / frames
            times[mode, "events"] += [a.elapsed_time(b) for a, b in evs]
            times[mode, "loop"].append(loop_ms)
            st = compiled.stats.get("frame", {})
            check(st.get("replays") == frames and not st.get("eager")
                  and not st.get("captures"),
                  f"phase16 {name} {mode} window: frame steps {st}")
            windows.append({"mode": mode, "loop_ms": loop_ms})
        image = r.last_outputs().image
        pinned = torch.empty(image.shape, dtype=image.dtype, pin_memory=True)
        copies = []
        for _ in range(20):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            pinned.copy_(image, non_blocking=True)
            e1.record()
            e1.synchronize()
            copies.append(e0.elapsed_time(e1))
        row = {
            "render_frame_host_ms_p50": percentile(times["clock", "host"], 50),
            "frame_ms_p50_by_events": percentile(times["clock", "events"],
                                                 50),
            "frame_ms_p90_by_events": percentile(times["clock", "events"],
                                                 90),
            "loop_ms": {m: statistics.mean(times[m, "loop"])
                        for m in ("none", "stream", "read_back")},
            "loop_host_ms_p50": {m: percentile(times[m, "host"], 50)
                                 for m in ("none", "stream", "read_back")},
            "loop_events_ms_p50": {m: percentile(times[m, "events"], 50)
                                   for m in ("none", "stream", "read_back")},
            "pinned_copy_device_ms": statistics.median(copies),
            "windows": windows, "frames": frames,
            "seconds": time.perf_counter() - t_cell,
        }
        rows[name] = row
        print(f"phase16 present {name}: timed in turns {PRESENT_TURNS}, "
              f"{frames} frames a window: render_frame returns on the host "
              f"in p50 {row['render_frame_host_ms_p50']:.3f} ms; the frame "
              f"completes by events (the benchmark's clock) in p50 "
              f"{row['frame_ms_p50_by_events']:.3f}, p90 "
              f"{row['frame_ms_p90_by_events']:.3f} ms; the loop's ms a frame "
              f"with no readback {row['loop_ms']['none']:.3f}, with a "
              f"FileStreamSurface at depth 2 {row['loop_ms']['stream']:.3f}, "
              f"with a read_back() every frame "
              f"{row['loop_ms']['read_back']:.3f}; the image's pinned copy "
              f"{row['pinned_copy_device_ms']:.3f} device ms (median of 20) "
              f"| {card}", flush=True)
        del r, r_fs, image, pinned
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(
        description="Drive the port on one CUDA card (see the module's "
        "docstring); with --parent, time another tree's light, bloom and "
        "shadow kernels against this tree's instead (ab_phase).")
    ap.add_argument("--parent", type=pathlib.Path, metavar="DIR",
                    help="another checkout of the repository, for example "
                    "the parent commit unpacked with git archive")
    ap.add_argument("--variant", action="append", default=[],
                    metavar="LABEL=DIR", help="with --parent: a copy of a "
                    "tree's csrc/ changed to measure a part of the time, "
                    "timed between the turns")
    ap.add_argument("--graphs", type=int, default=None, metavar="FRAMES",
                    help="run phases 1, 2 and 15 only, FRAMES frames a "
                    "timed window (the default run times 30)")
    ap.add_argument("--present", type=int, default=None, metavar="FRAMES",
                    help="run phases 1, 2 and 16 only, FRAMES frames a "
                    "timed window (the default run times 30)")
    args = ap.parse_args()
    trees = {}
    if args.parent is not None:
        trees["parent"] = args.parent
        for v in args.variant:
            label, _, tree = v.partition("=")
            check(label and tree and label not in ("parent", "change"),
                  f"--variant {v!r}: LABEL=DIR")
            trees[label] = pathlib.Path(tree)
    else:
        check(not args.variant, "--variant needs --parent")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)

    import ash_tpu_torch
    from ash_tpu_torch.ops import _build, binning, raster, raster_cuda
    from ash_tpu_torch.ops import lights_cuda, texture_cuda
    from ash_tpu_torch.render import RenderCommand, frame, golden_scenes
    from ash_tpu_torch.core import maths
    from ash_tpu_torch.render import bench_scene
    from ash_tpu_torch.render.csm import CsmConfig
    from ash_tpu_torch.render.diagnostics import DiagnosticsMode
    from ash_tpu_torch.render.diagnostics.overlay import DiagnosticsOverlay
    from ash_tpu_torch.render.bench_scene import (
        build_bench_renderer,
        build_ibl_renderer,
        build_instancing_renderer,
        build_lod_renderer,
        build_mega_renderer,
        lod_camera,
    )

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
    if trees:
        cam = build_bench_renderer(1920, 1080, 1000, "cuda")[2]
        with graphs_off():
            ab = ab_phase(card, cam.view_matrix(), cam.projection_matrix(),
                          cam.position, trees)
        print(json.dumps({"ab": ab}, default=str))
        return 0

    # 2. Build: one nvcc per source, started together.
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(7) as pool:
        (lib, tex_lib, light_lib, bloom_lib, shadow_lib, gbuffer_lib,
         shade_lib) = pool.map(_build.build, [
             "raster", "texture", "lights", "bloom", "shadow", "gbuffer",
             "shade"])
    build_s = time.perf_counter() - t0
    usage = ptxas_usage(lib.with_suffix(".log").read_text())
    check(len(usage) == 16, f"{len(usage)} kernels, want 15 raster "
          "instantiations and the rectangles' pre-pass")
    tex_usage = ptxas_usage(tex_lib.with_suffix(".log").read_text())
    check(sorted(tex_usage) == ["texture maps", "texture trilinear"],
          f"texture library kernels {list(tex_usage)}")
    usage.update(tex_usage)
    light_usage = ptxas_usage(light_lib.with_suffix(".log").read_text())
    check(sorted(light_usage) == ["light element", "light element bf16",
                                  "light tile", "light tile bf16"],
          f"light library kernels {list(light_usage)}")
    usage.update(light_usage)
    bloom_usage = ptxas_usage(bloom_lib.with_suffix(".log").read_text())
    check(sorted(bloom_usage) == BLOOM_INSTANTIATIONS,
          f"bloom library kernels {list(bloom_usage)}")
    usage.update(bloom_usage)
    shadow_usage = ptxas_usage(shadow_lib.with_suffix(".log").read_text())
    check(sorted(shadow_usage) == SHADOW_INSTANTIATIONS,
          f"shadow library kernels {list(shadow_usage)}")
    usage.update(shadow_usage)
    gbuffer_usage = ptxas_usage(gbuffer_lib.with_suffix(".log").read_text())
    check(sorted(gbuffer_usage) == ["gbuffer"],
          f"gbuffer library kernels {list(gbuffer_usage)}")
    usage.update(gbuffer_usage)
    shade_usage = ptxas_usage(shade_lib.with_suffix(".log").read_text())
    check(sorted(shade_usage) == SHADE_INSTANTIATIONS,
          f"shade library kernels {list(shade_usage)}")
    usage.update(shade_usage)
    print(f"phase2 build: {lib.name} (both raster kernels), "
          f"{tex_lib.name} (the texture sampler), {light_lib.name} (the "
          f"light loop), {bloom_lib.name} (the bloom pyramid), "
          f"{shadow_lib.name} (the shadow PCF), {gbuffer_lib.name} (the "
          f"G-buffer fetch) and {shade_lib.name} (the surface shading: "
          f"shade, surface and compose) in "
          f"{build_s:.3f} s; "
          + "; ".join(f"{k}: {r} registers, {sp} spill bytes"
                      for k, (r, sp) in sorted(usage.items())), flush=True)
    spills = {k: sp for k, (_, sp) in usage.items() if sp}
    check(not spills, f"instantiations spill: {spills}")
    if args.graphs is not None or args.present is not None:
        if args.graphs is not None:
            rows = {"graphs": graph_phase(card, args.graphs)}
        else:
            rows = {"present": present_phase(card, args.present)}
        foreign = sorted(m for m in sys.modules if m in ("jax", "ash_tpu")
                         or m.startswith(("jax.", "ash_tpu.")))
        check(not foreign, f"the port loaded jax or ash_tpu: {foreign[:5]}")
        print(json.dumps({**rows, "card": card}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0
    # Phases 3-14 run every renderer's frames eagerly.
    eager_phases = graphs_off()
    eager_phases.start()
    # 3. Kernel against plain at the main path's shapes.
    r, _, cam, _ = build_bench_renderer(1920, 1080, 1000, "cuda")
    view, proj, pos = cam.view_matrix(), cam.projection_matrix(), cam.position
    cfg, scene, _ = r.prepare_frame(view, proj, pos)[:3]
    passes = pass_inputs(r, cam)
    setup = passes["main"][0]
    band_y0, band_h = 512, 512
    bins_band = binning.bin_triangles(
        setup.bbox, setup.valid, band_h, cfg.width, cfg.tile_h, cfg.tile_w,
        cfg.max_tris_per_tile, y0=band_y0,
    )
    passes["band"] = (setup, bins_band, band_h, cfg.width, cfg.tile_h,
                      cfg.tile_w, band_y0)
    # Band 1 of the sharded frame's 4 (make_sharded_frame), main and shadow
    # pass, as render_band and shadow_program bin them.
    for k, v in pass_inputs(r, cam, frame.BandSpec(1, 4)).items():
        passes[{"main": "band 1/4", "shadow": "shadow band 1/4"}[k]] = v
    # The rich frame's cascade passes, from a renderer of their own: taking
    # the inputs advances the TAA jitter.
    r_casc, _, _, _ = build_bench_renderer(1920, 1080, 1000, "cuda", rich=True)
    passes.update(cascade_inputs(r_casc, cam))
    del r_casc
    check(all(c in passes for c in CASCADES), "the rich frame has 3 cascades")
    # The standard frame's main pass at the MSAA presets' sample rates; the
    # renderers draw the SSAA frames of phase 4.
    msaa_r = {}
    for preset, size in MSAA_PRESETS.items():
        msaa_r["ssaa", preset] = build_bench_renderer(
            1920, 1080, 1000, "cuda", msaa_resolve="ssaa")[0]
        msaa_r["ssaa", preset].set_msaa_preset(preset)
        passes[f"msaa {preset}"] = pass_inputs(msaa_r["ssaa", preset],
                                               cam)["main"]
        check(passes[f"msaa {preset}"][2:4] == size[::-1],
              f"msaa {preset}: the main pass is not {size}")
    for c in CASCADES:
        shape = (passes[c][1].tri_ids.shape[1], *passes[c][2:6])
        check(shape == (512, 1024, 1024, 32, 128),
              f"{c}: K, size and tiles {shape}")
    max_err = 0.0
    for name, args in passes.items():
        h, w, y0 = args[2], args[3], args[6]
        rects_bad = int((raster_cuda.device_rects(args[0], h, w, y0)
                         != raster.candidate_rects(args[0], h, w, y0)).sum())
        check(rects_bad == 0, f"kernel rectangles != candidate_rects on {name}")
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
              f"rectangles unequal to candidate_rects {rects_bad}, "
              f"covered {int((got.tri_id >= 0).sum())}, max tile count "
              f"{int(args[1].counts.max())}, overflow {int(args[1].overflow)}",
              flush=True)
        check(tid_bad == 0 and depth_bad == 0, f"kernel != plain on {name}")

    # The K-layer peel: (pass, layers, floor).
    floor4 = floor_for(passes)
    peel_cases = [("main", 2, None), ("main", 4, None), ("main", 8, None),
                  ("main", 4, floor4), ("band", 4, None), ("shadow", 2, None),
                  ("msaa x4", 2, None), ("band 1/4", 2, None)]
    max_err_layers = 0.0
    for name, layers, floor in peel_cases:
        args = passes[name]
        kw = dict(y0=args[6], layers=layers, depth_floor=floor)
        got = raster_cuda.rasterize(*args[:6], **kw)
        want = raster.rasterize(*args[:6], **kw)
        tid_bad, depth_bad, err, covered = compare_layers(got, want, layers)
        max_err_layers = max(max_err_layers, err)
        h, w, th, tw = args[2:6]
        print(f"phase3 peel {name}: {w}x{h} tiles {th}x{tw} y0={args[6]} "
              f"layers={layers} floor={floor is not None}: tri_id mismatches "
              f"{tid_bad}, depth mismatches {depth_bad} (all layers), max "
              f"|depth err| {err}, covered per layer {covered}", flush=True)
        check(tid_bad == 0 and depth_bad == 0,
              f"peel kernel != plain on {name}, {layers} layers")
        check(covered[1] > 0, f"peel on {name}: empty second layer")

    # Small scenes with 16x32 tiles, where the rectangles cut most
    # candidates, and seeded random triangles at 1080p whose bins hold
    # near-plane crossers: (name, setup, bins, height, width, tile_h, tile_w).
    extra = []
    for small_glass in (False, True):
        rs, _, scam, _ = build_bench_renderer(192, 128, 64, "cuda",
                                              glass=small_glass)
        ssetup = pass_inputs(rs, scam)["main"][0]
        sbins = binning.bin_triangles(ssetup.bbox, ssetup.valid, 128, 192,
                                      16, 32, 256)
        extra.append(("small glass" if small_glass else "small bench",
                      ssetup, sbins, 128, 192, 16, 32))
    syn = synthetic_setup(cfg.width, cfg.height)
    syn_bins = binning.bin_triangles(syn.bbox, syn.valid, cfg.height,
                                     cfg.width, cfg.tile_h, cfg.tile_w, 256)
    behind = (syn.inv_w <= 0).any(-1)
    in_bins = syn_bins.tri_ids[syn_bins.tri_ids >= 0].long()
    crossers_binned = int(behind[in_bins].sum())
    check(crossers_binned > 0, "no near-plane crosser in the synthetic bins")
    extra.append(("random 1080p", syn, syn_bins, cfg.height, cfg.width,
                  cfg.tile_h, cfg.tile_w))
    for name, esetup, ebins, h, w, th, tw in extra:
        rects_bad = int((raster_cuda.device_rects(esetup, h, w)
                         != raster.candidate_rects(esetup, h, w)).sum())
        check(rects_bad == 0, f"kernel rectangles != candidate_rects on {name}")
        floor_e = raster.rasterize(esetup, ebins, h, w, th, tw,
                                   layers=2).layer(1)[0]
        for layers, floor in ((1, None), (4, None), (4, floor_e)):
            kw = dict(layers=layers, depth_floor=floor)
            got = raster_cuda.rasterize(esetup, ebins, h, w, th, tw, **kw)
            want = raster.rasterize(esetup, ebins, h, w, th, tw, **kw)
            tid_bad, depth_bad, err, covered = compare_layers(got, want,
                                                              layers)
            if layers == 1:
                max_err = max(max_err, err)
            else:
                max_err_layers = max(max_err_layers, err)
            print(f"phase3 {name}: {w}x{h} tiles {th}x{tw} layers={layers} "
                  f"floor={floor is not None}: tri_id mismatches {tid_bad}, "
                  f"depth mismatches {depth_bad} (all layers), max |depth "
                  f"err| {err}, rectangles unequal to candidate_rects "
                  f"{rects_bad}, covered per layer {covered}, max tile count "
                  f"{int(ebins.counts.max())}, overflow {int(ebins.overflow)}"
                  + (f", near-plane crossers in the bins {crossers_binned}"
                     if name.startswith("random") else ""), flush=True)
            check(tid_bad == 0 and depth_bad == 0,
                  f"kernel != plain on {name}, {layers} layers")
            check(covered[0] > 0, f"{name}: nothing covered")

    # B1 on the mega frame's own passes (1,002,528 triangles, two-level
    # binning, 32x128 tiles) at the base caps of 8192 and at the caps the
    # escalation reaches. The plain raster walks all K slots, so it is timed
    # here once (phase 5 does not repeat it at these shapes).
    rm, _, mcam, mega_tris = build_mega_renderer(1920, 1080, "cuda")
    mega = {"base": pass_inputs(rm, mcam)}
    mega_caps = {"base": (rm.config.max_tris_per_tile,
                          rm.config.shadow_max_tris_per_tile)}
    escalated = rm.escalate_tile_capacities(
        int(mega["base"]["main"][1].overflow),
        int(mega["base"]["shadow"][1].overflow))
    check(escalated, "the mega frame's base caps drop nothing")
    mega["escalated"] = pass_inputs(rm, mcam)
    mega_caps["escalated"] = (rm.config.max_tris_per_tile,
                              rm.config.shadow_max_tris_per_tile)
    del rm
    plain_once = {}
    for level in ("base", "escalated"):
        for pas in ("main", "shadow"):
            args = mega[level][pas]
            name = f"mega {pas} K={args[1].tri_ids.shape[1]}"
            passes[name] = args
            h, w, th, tw = args[2:6]
            rects_bad = int((raster_cuda.device_rects(args[0], h, w)
                             != raster.candidate_rects(args[0], h, w)).sum())
            check(rects_bad == 0, f"kernel rectangles != candidate_rects "
                  f"on {name}")
            got = raster_cuda.rasterize(*args)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            want = raster.rasterize(*args)
            end.record()
            end.synchronize()
            plain_once[name] = start.elapsed_time(end)
            tid_bad = int((got.tri_id != want.tri_id).sum())
            depth_bad = int((got.depth != want.depth).sum())
            err = float((got.depth - want.depth).abs().max())
            max_err = max(max_err, err)
            counts = args[1].counts
            print(f"phase3 {name}: {w}x{h} tiles {th}x{tw} (the whole "
                  f"target): tri_id mismatches {tid_bad}, depth mismatches "
                  f"{depth_bad}, max |depth err| {err}, rectangles unequal "
                  f"to candidate_rects {rects_bad}, covered "
                  f"{int((got.tri_id >= 0).sum())}, max tile count "
                  f"{int(counts.max())} (tile {int(counts.argmax())}), "
                  f"candidates {int(counts.sum())}, overflow "
                  f"{int(args[1].overflow)}; plain raster {plain_once[name]:.0f}"
                  " ms", flush=True)
            check(tid_bad == 0 and depth_bad == 0, f"kernel != plain on {name}")
            del got, want
    mega_names = [n for n in passes if n.startswith("mega ")]

    # B1 on example 07's instancing frame (65,536 cubes, 786,432 triangles,
    # two-level binning): its main pass at 8x128 tiles and K=2048, and its
    # shadow pass, as frame 1 computes them (frustum culling only; no depth
    # yet). The renderer is phase 4's.
    t0 = time.perf_counter()
    inst_mgr = bench_scene.instancing_manager()
    inst_host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    r_inst, _, icam, _ = build_instancing_renderer(1920, 1080, "cuda",
                                                   mgr=inst_mgr)
    inst_submit_s = time.perf_counter() - t0
    iargs = (icam.view_matrix(), icam.projection_matrix(), icam.position)
    inst_passes = pass_inputs(r_inst, icam)
    inst_names = []
    for pas in ("main", "shadow"):
        args = inst_passes[pas]
        name = f"instancing {pas} K={args[1].tri_ids.shape[1]}"
        inst_names.append(name)
        passes[name] = args
        h, w, th, tw = args[2:6]
        rects_bad = int((raster_cuda.device_rects(args[0], h, w)
                         != raster.candidate_rects(args[0], h, w)).sum())
        check(rects_bad == 0, f"kernel rectangles != candidate_rects on {name}")
        got = raster_cuda.rasterize(*args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = raster.rasterize(*args)
        end.record()
        end.synchronize()
        plain_once[name] = start.elapsed_time(end)
        tid_bad = int((got.tri_id != want.tri_id).sum())
        depth_bad = int((got.depth != want.depth).sum())
        err = float((got.depth - want.depth).abs().max())
        max_err = max(max_err, err)
        counts = args[1].counts
        print(f"phase3 {name}: {w}x{h} tiles {th}x{tw} (example 07, frame "
              f"1): tri_id mismatches {tid_bad}, depth mismatches "
              f"{depth_bad}, max |depth err| {err}, rectangles unequal to "
              f"candidate_rects {rects_bad}, covered "
              f"{int((got.tri_id >= 0).sum())}, max tile count "
              f"{int(counts.max())} (tile {int(counts.argmax())}), candidates "
              f"{int(counts.sum())}, overflow {int(args[1].overflow)}; plain "
              f"raster {plain_once[name]:.0f} ms", flush=True)
        check(tid_bad == 0 and depth_bad == 0, f"kernel != plain on {name}")
        del got, want
    check(passes[inst_names[0]][1].tri_ids.shape[1] == 2048
          and passes[inst_names[0]][4:6] == (8, 128),
          "example 07's main pass is not 8x128 tiles at K=2048")
    big_names = mega_names + inst_names

    # 4. The slice, through the renderer; count the kernels' launches on
    # each path from 0.
    raster_cuda.rasterize.launches = 0
    raster_cuda.rasterize.layer_launches = 0
    zero_shadow()
    zero_gbuffer()
    zero_shade()
    deltas, outs = [], []
    for _ in range(6):
        before = raster_cuda.rasterize.launches
        outs.append(r.render_frame(view, proj, pos))
        deltas.append(raster_cuda.rasterize.launches - before)
    launches = {"standard": raster_cuda.rasterize.launches}
    shadow_launches = {"standard": shadow_launched()}
    gbuffer_launches = {"standard": gbuffer_launched()}
    shade_launches = {"standard": shade_launched()}
    check(shadow_launches["standard"] == 6, "standard: shadow kernel "
          f"launches {shadow_launches['standard']} in 6 frames")
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
        zero_shadow()
        zero_gbuffer()
        zero_shade()
        one, peel, gouts = [], [], []
        for _ in range(4):
            b1 = raster_cuda.rasterize.launches
            b2 = raster_cuda.rasterize.layer_launches
            gouts.append(rg.render_frame(view, proj, pos))
            one.append(raster_cuda.rasterize.launches - b1)
            peel.append(raster_cuda.rasterize.layer_launches - b2)
        launches[path] = raster_cuda.rasterize.launches
        layer_launches[path] = raster_cuda.rasterize.layer_launches
        shadow_launches[path] = shadow_launched()
        gbuffer_launches[path] = gbuffer_launched()
        shade_launches[path] = shade_launched()
        check(shadow_launches[path] >= 4 and shadow_launches[path] % 4 == 0,
              f"{path}: shadow kernel launches {shadow_launches[path]} in 4 "
              "frames, want the same number a frame, at least one")
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

    # The textured standard frame: the alpha test peels two layers in the
    # shadow pass and the main pass, so only the peel kernel runs.
    # Its samples go through the texture kernel: five maps a frame and the
    # alpha test of the main pass, and of the shadow pass on frame 1.
    rt, _, _, _ = build_bench_renderer(1920, 1080, 1000, "cuda", textured=True)
    raster_cuda.rasterize.launches = 0
    raster_cuda.rasterize.layer_launches = 0
    for k in texture_cuda.launches:
        texture_cuda.launches[k] = 0
    t_one, t_peel, t_outs = launches_per_frame(rt, view, proj, pos, 4)
    launches["textured"] = raster_cuda.rasterize.launches
    layer_launches["textured"] = raster_cuda.rasterize.layer_launches
    tex_launches = {"textured": [texture_cuda.launches["maps"],
                                 texture_cuda.launches["trilinear"]]}
    check(tex_launches["textured"] == [4, 5],
          f"textured: texture launches (maps, trilinear) "
          f"{tex_launches['textured']}, want [4, 5]")
    # Kernels and copies a static frame (torch.profiler), as the
    # benchmark's trace counts its launches.
    t_work = busy_profile(lambda i: rt.render_frame(view, proj, pos), 3)[3]
    timage = rt.read_back().copy()
    tout = t_outs[0]
    check(t_peel == [2, 1, 1, 1], f"textured: peel launches per frame {t_peel}")
    check(t_one == [0, 0, 0, 0], f"textured: one-layer launches {t_one}")
    check(bool(torch.isfinite(tout.color).all()), "textured: non-finite")
    check(int(tout.binning_overflow) == 0 and int(tout.shadow_overflow) == 0,
          "textured: overflow")
    check(all(o.image.equal(tout.image) for o in t_outs[1:]),
          "textured: static frames differ")
    rt_plain, _, _, _ = build_bench_renderer(1920, 1080, 1000, "cuda",
                                             textured=True)
    with mock.patch.object(frame, "rasterize", raster.rasterize):
        rt_plain.render_frame(view, proj, pos)
    tequal = bool((rt_plain.read_back() == timage).all())
    check(tequal, "textured: frame with the kernels != plain-raster frame")
    del rt_plain
    fell = alpha_fallthrough(rt, view, proj, pos)
    check(fell > 0, "textured: the alpha test never took the second layer")
    rt_nocut, _, _, _ = build_bench_renderer(1920, 1080, 1000, "cuda",
                                             textured=True, cutoff=0.0)
    rt_nocut.render_frame(view, proj, pos)
    nocut_psnr = ash_tpu_torch.psnr(timage, rt_nocut.read_back())
    check(nocut_psnr < 40.0, f"textured: the cutouts do not show "
          f"({nocut_psnr:.2f} dB against alpha_cutoff=0)")
    del rt_nocut
    sun = ([-0.5, -1.0, -0.3], [-0.45, -1.0, -0.35])

    def textured_shadow_frame(i):
        rt.shadow_feature.set_light_direction(sun[i % 2])
        rt.render_frame(view, proj, pos)

    # sun[1]: sun[0] is the default light, whose map is cached.
    ts_one, ts_peel, _ = launches_per_frame(
        rt, view, proj, pos, 1, lambda i: textured_shadow_frame(i + 1))
    check(ts_peel == [2] and ts_one == [0],
          f"textured shadow re-render: peel {ts_peel}, one-layer {ts_one}")

    # The lit standard frame: the Forward+ lights add no raster.
    rl, _, _, _ = build_bench_renderer(1920, 1080, 1000, "cuda", lights=32)
    raster_cuda.rasterize.launches = 0
    raster_cuda.rasterize.layer_launches = 0
    lights_cuda.launches["loop"] = 0
    zero_shadow()
    zero_gbuffer()
    zero_shade()
    l_one, l_peel, l_outs = launches_per_frame(rl, view, proj, pos, 6)
    shadow_launches["lit"] = shadow_launched()
    gbuffer_launches["lit"] = gbuffer_launched()
    shade_launches["lit"] = shade_launched()
    check(shadow_launches["lit"] == 6,
          f"lit: shadow kernel launches {shadow_launches['lit']} in 6 frames")
    launches["lit"] = raster_cuda.rasterize.launches
    layer_launches["lit"] = raster_cuda.rasterize.layer_launches
    light_launches = {"lit": lights_cuda.launches["loop"]}
    check(light_launches["lit"] == 6,
          f"lit: light kernel launches {light_launches['lit']} in 6 frames")
    limage = rl.read_back().copy()
    lout = l_outs[0]
    check(l_one == [2, 1, 1, 1, 1, 1], f"lit: one-layer launches {l_one}")
    check(l_peel == [0] * 6, f"lit: peel launches {l_peel}")
    check(bool(torch.isfinite(lout.color).all()), "lit: non-finite")
    check(int(lout.binning_overflow) == 0 and int(lout.shadow_overflow) == 0,
          "lit: overflow")
    check(all(o.image.equal(lout.image) for o in l_outs[1:]),
          "lit: static frames differ")
    rl_plain, _, _, _ = build_bench_renderer(1920, 1080, 1000, "cuda",
                                             lights=32)
    with mock.patch.object(frame, "rasterize", raster.rasterize):
        rl_plain.render_frame(view, proj, pos)
    lequal = bool((rl_plain.read_back() == limage).all())
    check(lequal, "lit: frame with the kernel != plain-raster frame")
    del rl_plain
    lit_psnr = ash_tpu_torch.psnr(limage, image)
    lit_changed = float((limage[..., :3] != image[..., :3]).any(-1).mean())
    lit_most = int(np.abs(limage.astype(int) - image).max())
    check(lit_changed > 0.01 and lit_most > 20,
          f"lit: the lights change {lit_changed:.4f} of the pixels, by up "
          f"to {lit_most} levels")
    most_lights = largest_tile_light_count(rl, view, proj, pos)
    check(most_lights > 0, "lit: no tile has a light")

    # The rich standard frame: HDR post, TAA, three shadow cascades, the 32
    # lights. TAA jitters every frame, so frame N is held against frame N of
    # a renderer on the plain raster.
    rr, _, _, _ = build_bench_renderer(1920, 1080, 1000, "cuda", rich=True)
    raster_cuda.rasterize.launches = 0
    raster_cuda.rasterize.layer_launches = 0
    lights_cuda.launches["loop"] = 0
    zero_bloom()
    zero_shadow()
    zero_gbuffer()
    zero_shade()
    r_one, r_peel, r_outs = launches_per_frame(rr, view, proj, pos, 8)
    shadow_launches["rich"] = shadow_launched()
    gbuffer_launches["rich"] = gbuffer_launched()
    shade_launches["rich"] = shade_launched()
    check(shadow_launches["rich"] == 8,
          f"rich: shadow kernel launches {shadow_launches['rich']} in 8 "
          "frames")
    launches["rich"] = raster_cuda.rasterize.launches
    layer_launches["rich"] = raster_cuda.rasterize.layer_launches
    light_launches["rich"] = lights_cuda.launches["loop"]
    check(light_launches["rich"] == 8,
          f"rich: light kernel launches {light_launches['rich']} in 8 frames")
    bloom_launches = {"rich": bloom_launched()}
    check(bloom_launches["rich"] == 8 * RICH_BLOOM_LAUNCHES,
          f"rich: bloom kernel launches {bloom_launches['rich']} in 8 frames")
    rimage = rr.read_back().copy()
    check(r_one == [4] + [1] * 7, f"rich: one-layer launches {r_one}")
    check(r_peel == [0] * 8, f"rich: peel launches {r_peel}")
    rich_over = [(int(o.binning_overflow), int(o.shadow_overflow))
                 for o in r_outs]
    check(rich_over == [(0, 0)] * 8, f"rich: overflow per frame {rich_over}")
    check(all(bool(torch.isfinite(o.color).all()) for o in r_outs),
          "rich: non-finite colour")
    check(tuple(r_outs[0].shadow_map.shape) == (3, 1024, 1024),
          f"rich: shadow map {tuple(r_outs[0].shadow_map.shape)}")
    check(rimage.shape == (1080, 1920, 4), f"rich: image {rimage.shape}")
    check(r_outs[0].history is not None
          and float(r_outs[0].history.abs().max()) > 0,
          "rich: the TAA history is empty after frame 1")
    jittered = sum(not o.image.equal(r_outs[0].image) for o in r_outs[1:])
    check(jittered > 0, "rich: TAA never changed a static frame")
    rr_plain, _, _, _ = build_bench_renderer(1920, 1080, 1000, "cuda",
                                             rich=True)
    with mock.patch.object(frame, "rasterize", raster.rasterize):
        requal = [bool(rr_plain.render_frame(view, proj, pos).image
                       .equal(r_outs[i].image)) for i in range(4)]
    check(all(requal), f"rich: frame N with the kernel != frame N with the "
          f"plain raster: {requal}")
    del rr_plain
    post_psnr = ash_tpu_torch.psnr(rimage, limage)
    check(post_psnr < 40.0, f"rich: the post chain and the cascades do not "
          f"show ({post_psnr:.2f} dB against the lit frame)")

    def rich_shadow_frame(i):
        rr.shadow_feature.set_light_direction(sun[i % 2])
        rr.render_frame(view, proj, pos)

    rs_one, rs_peel, rs_outs = launches_per_frame(
        rr, view, proj, pos, 2, lambda i: rich_shadow_frame(i + 1))
    check(rs_one == [4, 4] and rs_peel == [0, 0],
          f"rich shadow re-render: one-layer {rs_one}, peel {rs_peel}")
    check(all(int(o.shadow_overflow) == 0 for o in rs_outs),
          "rich shadow re-render: overflow")
    rr.shadow_feature.set_light_direction(sun[0])
    rr.set_taa_enabled(False)
    _, _, off_outs = launches_per_frame(rr, view, proj, pos, 3)
    check(off_outs[1].image.equal(off_outs[2].image),
          "rich with TAA off: static frames differ")
    check(off_outs[2].history is None, "rich with TAA off: a history")
    rr.set_taa_enabled(True)

    # TAA upsampling: the internal raster is 960x540, where a 64x128 tile
    # holds four times the scene, so the tile cap is raised with it.
    r_half, _, _, _ = build_bench_renderer(
        1920, 1080, 1000, "cuda", rich=True, render_scale=0.5,
        max_tris_per_tile=HALF_SCALE_TILE_CAP)
    zero_bloom()
    zero_shadow()
    zero_gbuffer()
    zero_shade()
    h_one, h_peel, h_outs = launches_per_frame(r_half, view, proj, pos, 8)
    bloom_launches["rich 0.5"] = bloom_launched()
    shadow_launches["rich 0.5"] = shadow_launched()
    gbuffer_launches["rich 0.5"] = gbuffer_launched()
    shade_launches["rich 0.5"] = shade_launched()
    check(shadow_launches["rich 0.5"] == 8, "rich at render_scale 0.5: "
          f"shadow kernel launches {shadow_launches['rich 0.5']} in 8 frames")
    check(bloom_launches["rich 0.5"] == 8 * RICH_BLOOM_LAUNCHES,
          f"rich at render_scale 0.5: bloom kernel launches "
          f"{bloom_launches['rich 0.5']} in 8 frames")
    check(h_one == [4] + [1] * 7 and h_peel == [0] * 8,
          f"rich at render_scale 0.5: one-layer {h_one}, peel {h_peel}")
    check(tuple(h_outs[-1].color.shape) == (1080, 1920, 3)
          and tuple(h_outs[-1].depth.shape) == (1080, 1920)
          and r_half.read_back().shape == (1080, 1920, 4),
          "rich at render_scale 0.5: presentation size")
    half_covered = int(h_outs[-1].covered_pixels)
    check(0.2 * covered < half_covered < 0.3 * covered,
          f"rich at render_scale 0.5: {half_covered} internal pixels covered "
          f"against {covered} at the native size")
    half_over = [(int(o.binning_overflow), int(o.shadow_overflow))
                 for o in h_outs]
    check(half_over == [(0, 0)] * 8,
          f"rich at render_scale 0.5: overflow per frame {half_over}")
    native_color = r_outs[7].color.cpu().numpy()
    taau_psnr = ash_tpu_torch.psnr(h_outs[7].color.cpu().numpy(), native_color)
    taau_first = ash_tpu_torch.psnr(h_outs[0].color.cpu().numpy(), native_color)
    check(taau_psnr > taau_first + 0.5,
          f"TAA upsampling gathers no detail: {taau_psnr:.2f} dB after 8 "
          f"frames, {taau_first:.2f} dB after 1")
    check(taau_psnr >= 26.0, f"TAA upsampling at {taau_psnr:.2f} dB against "
          "the native frame after 8 frames, want 26")

    # The animated standard frame (bench.py --animate): every pose is a
    # TRS update and an orbiting camera, so the shadow map re-renders
    # every frame. Beside it, with the same poses: a renderer fed the
    # host-composed matrices, one on the plain raster, and the fast path
    # of submit_render_commands against update_transforms.
    def animated(step_renderer, poses, feed, plain=False):
        """Render the first frame and `poses` poses of step_renderer fed by
        feed(r, ft) -> ([image per frame], [B1 launches per frame],
        [(main, shadow) overflow per frame], renderer)."""
        ra, _, acam, anim = step_renderer
        images, b1, overflow = [], [], []
        ft = 0.0
        ctx = (mock.patch.object(frame, "rasterize", raster.rasterize)
               if plain else contextlib.nullcontext())
        with ctx:
            for i in range(poses + 1):
                if i:
                    ft += 1.0 / 60.0
                    feed(ra, anim, ft)
                aview = bench_scene.orbit_camera(acam, anim["extent"], ft)
                before = raster_cuda.rasterize.launches
                o = ra.render_frame(aview, proj, acam.position)
                b1.append(raster_cuda.rasterize.launches - before)
                overflow.append((int(o.binning_overflow),
                                 int(o.shadow_overflow)))
                images.append(ra.read_back().copy())
        return images, b1, overflow, ra

    def feed_trs(ra, anim, ft):
        ra.update_transforms_trs(*bench_scene.animated_models_trs(anim, ft))

    def feed_trs_matrices(ra, anim, ft):
        t, q, s = bench_scene.animated_models_trs(anim, ft)
        ra.update_transforms(maths.mat4_trs_batch(
            t, q, np.repeat(s[:, None], 3, axis=1)))

    def feed_matrices(ra, anim, ft):
        ra.update_transforms(bench_scene.animated_models(anim, ft))

    def feed_submit(ra, anim, ft):
        m = bench_scene.animated_models(anim, ft)
        ra.submit_render_commands([
            RenderCommand(mesh=0, transform=m[i], material=i + 1)
            for i in range(m.shape[0])])

    def anim_renderer():
        return build_bench_renderer(1920, 1080, 1000, "cuda", animate=True)

    ANIM_POSES = 8
    raster_cuda.rasterize.launches = 0
    raster_cuda.rasterize.layer_launches = 0
    anim_main = anim_renderer()
    a_images, a_b1, a_over, _ = animated(anim_main, ANIM_POSES, feed_trs)
    launches["animated"] = raster_cuda.rasterize.launches
    layer_launches["animated"] = raster_cuda.rasterize.layer_launches
    check(a_b1 == [2] * (ANIM_POSES + 1),
          f"animated: one-layer launches per frame {a_b1}")
    check(layer_launches["animated"] == 0, "animated: the peel ran")
    check(a_over == [(0, 0)] * (ANIM_POSES + 1),
          f"animated: overflow per frame {a_over}")
    a_moving = sum(not np.array_equal(a, b)
                   for a, b in zip(a_images, a_images[1:]))
    check(a_moving == ANIM_POSES, f"animated: {a_moving} of {ANIM_POSES} "
          "poses changed the image")
    m_images = animated(anim_renderer(), ANIM_POSES, feed_trs_matrices)[0]
    trs_equal = [bool(np.array_equal(a, b))
                 for a, b in zip(a_images, m_images)]
    check(all(trs_equal), f"animated: TRS frames != host-composed matrix "
          f"frames: {trs_equal}")
    p_images = animated(anim_renderer(), ANIM_POSES, feed_trs, plain=True)[0]
    a_plain_equal = [bool(np.array_equal(a, b))
                     for a, b in zip(a_images, p_images)]
    check(all(a_plain_equal), f"animated: frame N with the kernel != frame "
          f"N with the plain raster: {a_plain_equal}")
    u_images = animated(anim_renderer(), ANIM_POSES, feed_matrices)[0]
    s_images, _, _, rsub = animated(anim_renderer(), ANIM_POSES, feed_submit)
    sub_builds = rsub._scene_epoch
    check(sub_builds == 1, f"animated: {sub_builds} scene builds through "
          "the resubmits, want 1 (the fast path)")
    sub_equal = [bool(np.array_equal(a, b))
                 for a, b in zip(s_images, u_images)]
    check(all(sub_equal), f"animated: resubmit frames != update_transforms "
          f"frames: {sub_equal}")
    del m_images, p_images, u_images, s_images, rsub

    # The mega frame (bench.py --mega): base caps, then the escalation
    # loop of bench.py:734-748 until nothing drops.
    raster_cuda.rasterize.launches = 0
    raster_cuda.rasterize.layer_launches = 0
    rmega, _, mcam, _ = build_mega_renderer(1920, 1080, "cuda")
    margs = (mcam.view_matrix(), mcam.projection_matrix(), mcam.position)
    mo = rmega.render_frame(*margs)
    mega_base_image = rmega.read_back().copy()
    mega_rounds = [(int(mo.binning_overflow), int(mo.shadow_overflow))]
    mega_b1 = [raster_cuda.rasterize.launches]
    check(mega_rounds[0] != (0, 0), "mega: nothing drops at the base caps")
    mega_changes = []
    for _ in range(4):
        changed = rmega.escalate_tile_capacities(*mega_rounds[-1])
        if not changed:
            break
        mega_changes.append(changed)
        before = raster_cuda.rasterize.launches
        mo = rmega.render_frame(*margs)
        mega_b1.append(raster_cuda.rasterize.launches - before)
        mega_rounds.append((int(mo.binning_overflow),
                            int(mo.shadow_overflow)))
        if mega_rounds[-1] == (0, 0):
            break
    launches["mega"] = raster_cuda.rasterize.launches
    layer_launches["mega"] = raster_cuda.rasterize.layer_launches
    mega_image = rmega.read_back().copy()
    check(mega_rounds[-1] == (0, 0), f"mega: overflow after escalation "
          f"{mega_rounds}")
    check(mega_b1 == [2] * len(mega_rounds), f"mega: one-layer launches "
          f"per frame {mega_b1}")
    check(layer_launches["mega"] == 0, "mega: the peel ran")
    check(bool(torch.isfinite(mo.color).all()), "mega: non-finite colour")
    mega_final_caps = {k: getattr(rmega.config, k) for k in (
        "max_tris_per_tile", "shadow_max_tris_per_tile", "binning_coarse_cap")}
    check((mega_final_caps["max_tris_per_tile"],
           mega_final_caps["shadow_max_tris_per_tile"])
          == mega_caps["escalated"], "mega: phase 3 escalated elsewhere")
    mega_psnr = ash_tpu_torch.psnr(mega_base_image, mega_image)
    mega_covered = int(mo.covered_pixels)
    rmega_plain, _, _, _ = build_mega_renderer(1920, 1080, "cuda",
                                               **mega_final_caps)
    with mock.patch.object(frame, "rasterize", raster.rasterize):
        rmega_plain.render_frame(*margs)
    mega_plain_equal = bool(np.array_equal(rmega_plain.read_back(),
                                           mega_image))
    check(mega_plain_equal, "mega: drop-free frame with the kernel != "
          "plain-raster frame")
    del rmega_plain

    def plain_frames(rend, cams, before=None):
        """rend's images of one frame per camera on the plain raster."""
        images = []
        with mock.patch.object(frame, "rasterize", raster.rasterize):
            for c in cams:
                if before is not None:
                    before()
                rend.render_frame(*c)
                images.append(rend.read_back().copy())
        return images

    def timed_frame(rend, fargs):
        """(outputs, CUDA-event ms) of one frame."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        o = rend.render_frame(*fargs)
        end.record()
        end.synchronize()
        return o, start.elapsed_time(end)

    # Example 07's instancing frame: 65,536 cubes, Hi-Z occlusion culling
    # on. Frame 1 tests against the far plane (frustum only), frame 2 and
    # after against the last frame's depth.
    raster_cuda.rasterize.launches = 0
    raster_cuda.rasterize.layer_launches = 0
    torch.cuda.reset_peak_memory_stats()
    i_one, i_peel, i_outs, i_ms, i_images = [], [], [], [], []
    for _ in range(3):
        b1 = raster_cuda.rasterize.launches
        b2 = raster_cuda.rasterize.layer_launches
        o, ms = timed_frame(r_inst, iargs)
        i_outs.append(o)
        i_ms.append(ms)
        i_images.append(r_inst.read_back().copy())
        i_one.append(raster_cuda.rasterize.launches - b1)
        i_peel.append(raster_cuda.rasterize.layer_launches - b2)
    launches["instancing"] = raster_cuda.rasterize.launches
    layer_launches["instancing"] = raster_cuda.rasterize.layer_launches
    inst_peak = torch.cuda.max_memory_allocated() / 2**20
    i_visible = [int(o.visible_draws) for o in i_outs]
    i_over = [(int(o.binning_overflow), int(o.shadow_overflow)) for o in i_outs]
    check(i_one == [2, 1, 1] and i_peel == [0, 0, 0],
          f"instancing: one-layer launches {i_one}, peel {i_peel}")
    check(i_visible[1] < i_visible[0],
          f"instancing: visible draws per frame {i_visible}")
    inst_hiz = check_hiz_cull("instancing", r_inst, i_outs, iargs)
    check(all(bool(torch.isfinite(o.color).all()) for o in i_outs),
          "instancing: non-finite colour")
    inst_plain = plain_frames(
        build_instancing_renderer(1920, 1080, "cuda", mgr=inst_mgr)[0],
        [iargs, iargs])
    inst_plain_equal = [bool(np.array_equal(a, b))
                        for a, b in zip(inst_plain, i_images)]
    check(all(inst_plain_equal), f"instancing: frame N with the kernel != "
          f"frame N with the plain raster: {inst_plain_equal}")
    del inst_plain
    r_inst_off = build_instancing_renderer(1920, 1080, "cuda", mgr=inst_mgr,
                                           occlusion=False)[0]
    off_out = r_inst_off.render_frame(*iargs)
    inst_off_over = (int(off_out.binning_overflow),
                     int(off_out.shadow_overflow))
    inst_off_diff = np.abs(r_inst_off.read_back().astype(np.int16)
                           - i_images[1].astype(np.int16)).max(-1)
    del r_inst_off, off_out
    # Recorded, not held to the reference test's bar of one level: the
    # frame without culling drops triangles in its fullest tiles, and the
    # reference's Hi-Z test itself culls visible draws (one texel at the
    # rectangle's centre; ROADMAP.md C), which the port reproduces.
    inst_off_pixels = int((inst_off_diff > 1).sum())

    # Example 07's LOD scene: 400 three-level spheres from distance 15 and
    # 30. The shadow map renders inside every frame, under the camera's
    # level mask.
    raster_cuda.rasterize.launches = 0
    raster_cuda.rasterize.layer_launches = 0
    rlod, _ = build_lod_renderer(1920, 1080, "cuda")
    lod_cams = {d: lod_camera(d, 1920, 1080) for d in (15.0, 30.0)}
    lod_args = {d: (c.view_matrix(), c.projection_matrix(), c.position)
                for d, c in lod_cams.items()}
    lod_one, lod_images, lod_maps, lod_stats, lod_over = [], [], [], {}, []
    for d in (15.0, 30.0):
        b1 = raster_cuda.rasterize.launches
        o = rlod.render_frame(*lod_args[d])
        lod_one.append(raster_cuda.rasterize.launches - b1)
        lod_images.append(rlod.read_back().copy())
        lod_maps.append(o.shadow_map.clone())
        lod_over.append((int(o.binning_overflow), int(o.shadow_overflow)))
        lod_stats[d] = rlod.lod_stats(*lod_args[d][:2])
        check(bool(torch.isfinite(o.color).all()), "lod: non-finite colour")
    launches["lod"] = raster_cuda.rasterize.launches
    layer_launches["lod"] = raster_cuda.rasterize.layer_launches
    check(lod_one == [2, 2] and layer_launches["lod"] == 0,
          f"lod: one-layer launches per frame {lod_one}, peel "
          f"{layer_launches['lod']}")
    check(not lod_maps[0].equal(lod_maps[1]),
          "lod: the shadow map did not follow the camera's levels")
    near, far = lod_stats[15.0], lod_stats[30.0]
    check(near.triangles_after > far.triangles_after > 0
          and far.reduction_rate > near.reduction_rate,
          f"lod: triangles {near.triangles_after} near, "
          f"{far.triangles_after} far")
    del lod_maps
    lod_plain = plain_frames(build_lod_renderer(1920, 1080, "cuda")[0],
                             [lod_args[15.0], lod_args[30.0]])
    lod_plain_equal = [bool(np.array_equal(a, b))
                       for a, b in zip(lod_plain, lod_images)]
    check(all(lod_plain_equal), f"lod: frame with the kernel != plain-raster "
          f"frame: {lod_plain_equal}")
    del lod_plain

    # Example 06: the IBL sphere grid at 640x400, HDR on, no shadows.
    raster_cuda.rasterize.launches = 0
    raster_cuda.rasterize.layer_launches = 0
    t0 = time.perf_counter()
    ribl, _, ibl_cam = build_ibl_renderer(640, 400, "cuda")
    torch.cuda.synchronize()
    ibl_build_s = time.perf_counter() - t0
    ibl_args = (ibl_cam.view_matrix(), ibl_cam.projection_matrix(),
                ibl_cam.position)
    ibl_one, _, ibl_outs = launches_per_frame(ribl, *ibl_args, 2)
    launches["ibl"] = raster_cuda.rasterize.launches
    layer_launches["ibl"] = raster_cuda.rasterize.layer_launches
    ibl_image = ribl.read_back().copy()
    check(ibl_one == [1, 1] and layer_launches["ibl"] == 0,
          f"ibl: one-layer launches {ibl_one}")
    check(all(bool(torch.isfinite(o.color).all()) for o in ibl_outs)
          and int(ibl_outs[0].binning_overflow) == 0, "ibl: frame")
    r_noenv = build_ibl_renderer(640, 400, "cuda", environment=False)[0]
    r_noenv.render_frame(*ibl_args)
    ibl_vs_flat = ash_tpu_torch.psnr(ibl_image, r_noenv.read_back())
    check(ibl_vs_flat < 40.0, f"ibl: the environment does not show "
          f"({ibl_vs_flat:.2f} dB against the flat ambient)")
    del r_noenv
    ibl_plain_equal = bool(np.array_equal(
        plain_frames(build_ibl_renderer(640, 400, "cuda")[0], [ibl_args])[0],
        ibl_image))
    check(ibl_plain_equal, "ibl: frame with the kernel != plain-raster frame")

    # bench.py --bf16: the standard frame shaded in bfloat16.
    raster_cuda.rasterize.launches = 0
    raster_cuda.rasterize.layer_launches = 0
    rbf, _, _, _ = build_bench_renderer(1920, 1080, 1000, "cuda",
                                        shade_dtype="bf16")
    bf_one, _, bf_outs = launches_per_frame(rbf, view, proj, pos, 2)
    launches["bf16"] = raster_cuda.rasterize.launches
    layer_launches["bf16"] = raster_cuda.rasterize.layer_launches
    bf_image = rbf.read_back().copy()
    check(bf_one == [2, 1] and layer_launches["bf16"] == 0,
          f"bf16: one-layer launches {bf_one}")
    check(bool(torch.isfinite(bf_outs[0].color).all()), "bf16: non-finite")
    bf_psnr = ash_tpu_torch.psnr(bf_image, image)
    check(bf_psnr >= 40.0 and not np.array_equal(bf_image, image),
          f"bf16: {bf_psnr:.2f} dB against the f32 frame (want >= 40 and "
          "not identical)")
    bf_plain_equal = bool(np.array_equal(plain_frames(build_bench_renderer(
        1920, 1080, 1000, "cuda", shade_dtype="bf16")[0],
        [(view, proj, pos)])[0], bf_image))
    check(bf_plain_equal, "bf16: frame with the kernel != plain-raster frame")

    # The standard frame with Hi-Z occlusion culling.
    raster_cuda.rasterize.launches = 0
    raster_cuda.rasterize.layer_launches = 0
    rocc, _, _, _ = build_bench_renderer(1920, 1080, 1000, "cuda",
                                         occlusion=True)
    occ_one, _, occ_outs = launches_per_frame(rocc, view, proj, pos, 3)
    launches["occlusion"] = raster_cuda.rasterize.launches
    layer_launches["occlusion"] = raster_cuda.rasterize.layer_launches
    occ_hiz = check_hiz_cull("occlusion", rocc, occ_outs, (view, proj, pos))
    occ_image = rocc.read_back().copy()
    occ_visible = [int(o.visible_draws) for o in occ_outs]
    check(occ_one == [2, 1, 1] and layer_launches["occlusion"] == 0,
          f"occlusion: one-layer launches {occ_one}")
    check(occ_visible[0] == int(out.visible_draws)
          and occ_visible[1] <= occ_visible[0],
          f"occlusion: visible draws {occ_visible}, frustum only "
          f"{int(out.visible_draws)}")
    # Recorded: the reference's Hi-Z test culls visible draws of this scene
    # too (ROADMAP.md C); the port reproduces its verdicts.
    occ_diff_px = np.abs(occ_image.astype(np.int16)
                         - image.astype(np.int16)).max(-1)
    occ_diff, occ_pixels = int(occ_diff_px.max()), int((occ_diff_px > 1).sum())
    occ_plain_equal = bool(np.array_equal(plain_frames(build_bench_renderer(
        1920, 1080, 1000, "cuda", occlusion=True)[0],
        [(view, proj, pos)] * 3)[2], occ_image))
    check(occ_plain_equal, "occlusion: frame 3 with the kernel != plain-"
          "raster frame 3")

    # MSAA (A15): the standard frame at x2, x4 and x8 SSAA and at x4 and x8
    # edge resolve. Frame 1 renders the shadow map, so B1 runs [2, 1, 1].
    msaa = {}
    for mode, preset in MSAA_FRAMES:
        path = f"msaa {mode} {preset}"
        rm_ = msaa_r.get((mode, preset))
        if rm_ is None:
            rm_ = msaa_r[mode, preset] = build_bench_renderer(
                1920, 1080, 1000, "cuda", msaa_resolve=mode)[0]
            rm_.set_msaa_preset(preset)
        raster_cuda.rasterize.launches = 0
        raster_cuda.rasterize.layer_launches = 0
        m_one, m_peel, m_outs = launches_per_frame(rm_, view, proj, pos, 3)
        launches[path] = raster_cuda.rasterize.launches
        layer_launches[path] = raster_cuda.rasterize.layer_launches
        m_image = rm_.read_back().copy()
        mo = m_outs[0]
        check(m_one == [2, 1, 1] and m_peel == [0, 0, 0],
              f"{path}: launches one-layer {m_one}, peel {m_peel}")
        check(m_image.shape == (1080, 1920, 4)
              and tuple(mo.depth.shape) == (1080, 1920),
              f"{path}: image {m_image.shape}, depth {tuple(mo.depth.shape)}")
        check(bool(torch.isfinite(mo.color).all()), f"{path}: non-finite")
        check(int(mo.binning_overflow) == 0 and int(mo.shadow_overflow) == 0,
              f"{path}: overflow")
        check(all(o.image.equal(mo.image) for o in m_outs[1:]),
              f"{path}: static frames differ")
        check((mo.msaa_edge_overflow is None) == (mode == "ssaa"),
              f"{path}: msaa_edge_overflow {mo.msaa_edge_overflow}")
        rm_plain = build_bench_renderer(1920, 1080, 1000, "cuda",
                                        msaa_resolve=mode)[0]
        rm_plain.set_msaa_preset(preset)
        m_plain_equal = bool(np.array_equal(
            plain_frames(rm_plain, [(view, proj, pos)])[0], m_image))
        del rm_plain
        check(m_plain_equal, f"{path}: frame with the kernel != plain-raster "
              "frame")
        msaa[path] = dict(
            image=m_image, one=m_one, covered=int(mo.covered_pixels),
            edge_overflow=(None if mo.msaa_edge_overflow is None
                           else int(mo.msaa_edge_overflow)),
            psnr_native=ash_tpu_torch.psnr(m_image, image))
    for preset in ("x4", "x8"):
        msaa[f"msaa edge {preset}"]["psnr_ssaa"] = ash_tpu_torch.psnr(
            msaa[f"msaa edge {preset}"]["image"],
            msaa[f"msaa ssaa {preset}"]["image"])
    # tests/test_edge_msaa.py's 64x64 scenes on the card: edge against SSAA.
    edge_small = {}
    for name, preset, lights, extra in (
            ("x2", "x2", False, {}), ("x4 lights", "x4", True, {}),
            ("x8", "x8", False, {}),
            ("x4 csm", "x4", False, dict(
                shadows_enabled=True, shadow_resolution=256,
                csm=CsmConfig(cascade_count=2, resolution=256),
                shadow_distance=20.0))):
        imgs = {}
        for mode in ("ssaa", "edge"):
            cfg64 = dict(tile_h=8, tile_w=32, max_tris_per_tile=64,
                         shadows_enabled=False, msaa_resolve=mode)
            rs_ = ash_tpu_torch.Renderer(
                ash_tpu_torch.HeadlessSurface(64, 64),
                ash_tpu_torch.RendererConfig(**{**cfg64, **extra}),
                device="cuda")
            rs_.set_mesh(ash_tpu_torch.Mesh.create_cube())
            rs_.set_msaa_preset(preset)
            if lights:
                rs_.add_point_light([1.5, 1.5, 3.0], color=(3, 1, 0),
                                    intensity=5.0, radius=12.0)
            c64 = ash_tpu_torch.Camera.new([3, 2, 4], [0, 0, 0], 1.0)
            o64 = rs_.render_frame(c64.view_matrix(), c64.projection_matrix(),
                                   c64.position)
            imgs[mode] = o64.color.cpu().numpy()
        edge_small[name] = ash_tpu_torch.psnr(imgs["edge"], imgs["ssaa"])
        check(edge_small[name] >= 40.0 and int(o64.msaa_edge_overflow) == 0,
              f"64x64 {name}: edge against SSAA {edge_small[name]:.2f} dB")

    # Diagnostics (A17): example 02's loop (640x480, 30 frames), then the
    # standard frame in overlay mode at a tile cap that drops triangles.
    r02, _ = bench_scene.build_cube_example("cuda")
    for i in range(30):
        r02.render_frame(*bench_scene.cube_example_camera(i))
    ex02 = r02.diagnostics()
    check(ex02.frame_stats.total_frames == 30
          and ex02.frame_stats.frame_time_ms > 0
          and ex02.memory_stats.gpu_used_bytes > 0,
          f"example 02: {ex02.frame_stats} {ex02.memory_stats}")
    del r02
    rov = build_bench_renderer(1920, 1080, 1000, "cuda",
                               max_tris_per_tile=16)[0]
    ov_out = rov.render_frame(view, proj, pos)
    ov_off = rov.read_back().copy()
    ov_dropped = int(ov_out.binning_overflow)
    check(ov_dropped > 0, "overlay frame: the cap of 16 drops nothing")
    rov.set_diagnostics_mode(DiagnosticsMode.OVERLAY_ONLY)
    ov_lines = rov.diagnostics().overlay_lines()
    rov.render_frame(view, proj, pos)
    ov_img = rov.read_back().copy()
    # The CPU composite of the same lines over the frame without
    # diagnostics, and the taint: every pixel of the card's frame.
    ov_want = DiagnosticsOverlay().composite(torch.from_numpy(ov_off.copy()),
                                             ov_lines).numpy()
    ov_want[-8:, -8:, :3] = (255, 0, 255)
    if int(ov_out.shadow_overflow) > 0:
        ov_want[-8:, -16:-8, :3] = (0, 255, 255)
    ov_text_px = int((ov_want != ov_off).any(-1)[:-8].sum())
    check(bool((ov_img[-8:, -8:, :3] == (255, 0, 255)).all()),
          "overlay frame: no magenta block")
    check(ov_text_px > 1000 and np.array_equal(ov_img, ov_want),
          f"overlay frame: {int((ov_img != ov_want).any(-1).sum())} pixels "
          "differ from the frame without diagnostics with the text patch "
          "and the magenta block")
    del rov

    # Surfaces and profiling (A17): a FileStreamSurface takes card frames;
    # profile_passes and frame_cost_analysis run on the standard frame.
    os.makedirs(os.path.join(repo, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(repo, "build")) as tmp:
        stream = os.path.join(tmp, "frames.rgba")
        with ash_tpu_torch.FileStreamSurface(640, 480, stream) as fsurf:
            rfs, _ = bench_scene.build_cube_example("cuda", surface=fsurf)
            for i in range(3):
                rfs.render_frame(*bench_scene.cube_example_camera(i))
            last = rfs.read_back().copy()
        raw = np.fromfile(stream, np.uint8)
    check(raw.size == 3 * 480 * 640 * 4
          and np.array_equal(raw.reshape(3, 480, 640, 4)[2], last),
          f"FileStreamSurface: {raw.size} bytes, last frame equal: "
          f"{np.array_equal(raw[-last.size:].reshape(last.shape), last)}")
    del rfs
    pp = r.profile_passes(view, proj, pos, n=10)
    check(set(pp) == {"Vertex", "ShadowEnd", "Setup", "Binning", "Raster",
                      "GBuffer", "SceneEnd"} and min(pp.values()) > 0,
          f"profile_passes: {pp}")
    fca = r.frame_cost_analysis(view, proj, pos)
    check(fca["flops"] > 0 and fca["bytes_accessed"] > 0
          and {"pass_raster", "pass_shade"} <= set(fca["programs"]),
          f"frame_cost_analysis: {fca}")

    goldens = {}
    for name, scene_fn in golden_scenes.SCENES.items():
        golden = ash_tpu_torch.read_png(
            os.path.join(repo, "tests", "golden", f"{name}.png"))
        goldens[name] = ash_tpu_torch.psnr(scene_fn("cuda").read_back(), golden)
        check(goldens[name] >= 40.0, f"{name} PSNR {goldens[name]:.2f} dB < 40")
    small_psnr = {}
    # (name, options, frames): the rich scene compares its third TAA frame.
    for name, kw, frames in (("small bench", {}, 1),
                             ("small glass", dict(glass=True), 1),
                             ("small textured", dict(textured=True), 1),
                             ("small lit", dict(lights=32), 1),
                             ("small rich", dict(rich=True), 3)):
        rs, _, scam, _ = build_bench_renderer(192, 128, 64, "cuda", **kw)
        rc, _, _, _ = build_bench_renderer(192, 128, 64, "cpu", **kw)
        for small in (rs, rc):
            for _ in range(frames):
                small.render_frame(scam.view_matrix(),
                                   scam.projection_matrix(), scam.position)
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
    print(f"phase4 textured frame: peel launches per frame {t_peel}, "
          f"one-layer launches per frame {t_one}; shadow re-render frame: "
          f"peel {ts_peel}, one-layer {ts_one}; overflow main "
          f"{int(tout.binning_overflow)} shadow {int(tout.shadow_overflow)}; "
          f"covered {int(tout.covered_pixels)}; equal to the plain-raster "
          f"frame: {tequal}; pixels where the alpha test took layer 2: "
          f"{fell}; PSNR against alpha_cutoff=0 {nocut_psnr:.2f} dB; "
          f"texture kernel launches (maps, trilinear) in 4 frames "
          f"{tex_launches['textured']}; kernels and copies a static frame "
          f"{t_work:g} (PR 12's benchmark trace: "
          f"{PR12_TEXTURED_LAUNCHES})", flush=True)
    print(f"phase4 lit frame: one-layer launches per frame {l_one}, peel "
          f"{l_peel}; overflow main {int(lout.binning_overflow)} shadow "
          f"{int(lout.shadow_overflow)}; equal to the plain-raster frame: "
          f"{lequal}; against the unlit frame: PSNR {lit_psnr:.2f} dB, "
          f"{100 * lit_changed:.2f}% of pixels changed, by up to {lit_most} "
          f"levels; largest tile light count {most_lights}; light kernel "
          f"launches in 6 frames {light_launches['lit']}", flush=True)

    print(f"phase4 rich frame: one-layer launches per frame {r_one}, peel "
          f"{r_peel}; shadow re-render frames: one-layer {rs_one}, peel "
          f"{rs_peel}; overflow (main, shadow) per frame {rich_over}; shadow "
          f"map {tuple(r_outs[0].shadow_map.shape)}; covered "
          f"{int(r_outs[0].covered_pixels)}; frame N equal to the "
          f"plain-raster frame N: {requal}; static frames that differ from "
          f"frame 1 under TAA: {jittered} of 7; equal with TAA off: True; "
          f"PSNR against the lit frame {post_psnr:.2f} dB; light kernel "
          f"launches in 8 frames {light_launches['rich']}, bloom kernel "
          f"launches {bloom_launches['rich']}", flush=True)
    print(f"phase4 rich frame at render_scale 0.5: one-layer launches per "
          f"frame {h_one}; tile cap {HALF_SCALE_TILE_CAP}, overflow 0; "
          f"internal pixels covered {half_covered} (native "
          f"{covered}); HDR colour against the native frame 8: "
          f"{taau_psnr:.2f} dB after 8 frames, {taau_first:.2f} dB after 1; "
          f"bloom kernel launches in 8 frames {bloom_launches['rich 0.5']}",
          flush=True)
    print(f"phase4 shadow kernel launches, counted from 0 on each path "
          f"(one a shade call): {shadow_launches}", flush=True)
    check(gbuffer_launches
          == {k: shadow_launches[k] for k in gbuffer_launches},
          f"G-buffer kernel launches {gbuffer_launches}, want one a shade "
          f"call, as the shadow kernel's {shadow_launches}")
    print(f"phase4 G-buffer kernel launches, counted from 0 on each path "
          f"(one a shaded layer): {gbuffer_launches}", flush=True)
    # One shading launch a shaded layer; two on the lit paths (surface and
    # compose, around the light kernel).
    lit_paths = ("lit", "rich", "rich 0.5")
    check(shade_launches == {k: gbuffer_launches[k] * (2 if k in lit_paths
                                                       else 1)
                             for k in shade_launches},
          f"shading kernel launches {shade_launches}, want one a shaded "
          f"layer (two with lights) against the G-buffer kernel's "
          f"{gbuffer_launches}")
    print(f"phase4 shading kernel launches, counted from 0 on each path "
          f"(one a shaded layer, surface and compose with lights): "
          f"{shade_launches}", flush=True)

    print(f"phase4 animated frame: 1920x1080, 1000 cubes, {ANIM_POSES} "
          f"poses of update_transforms_trs + orbit_camera after frame 1: "
          f"one-layer launches per frame {a_b1}, peel 0; overflow (main, "
          f"shadow) per frame {a_over}; frame N equal to the plain-raster "
          f"frame N: {a_plain_equal}; TRS frames equal to "
          f"update_transforms(mat4_trs_batch(...)) frames: {trs_equal}; "
          f"submit_render_commands resubmits: {sub_builds} scene build, "
          f"frames equal to update_transforms frames: {sub_equal}",
          flush=True)
    print(f"phase4 mega frame: 1920x1080, {mega_tris} triangles, two-level "
          f"binning: overflow (main, shadow) per round {mega_rounds}; "
          f"escalations {mega_changes}; final caps {mega_final_caps}; "
          f"one-layer launches per frame {mega_b1}; covered {mega_covered}; "
          f"base-cap image against the drop-free image {mega_psnr:.2f} dB; "
          f"drop-free frame equal to the plain-raster frame: "
          f"{mega_plain_equal}", flush=True)
    print(f"phase4 instancing frame (example 07): 1920x1080, 65,536 cubes, "
          f"{r_inst._scene.num_triangles} triangles, tiles 8x128, K=2048, "
          f"Hi-Z on: InstancingManager {inst_host_s:.2f} s on the host, "
          f"submit {inst_submit_s:.2f} s; frames 1-3: {i_ms} ms (CUDA "
          f"events), visible draws {i_visible} (frame 1 frustum only), "
          f"overflow (main, shadow) {i_over}, one-layer launches {i_one}, "
          f"peel {i_peel}; frame 2's Hi-Z cull on the card / CPU "
          f"{inst_hiz[0]} / {inst_hiz[1]} visible, {inst_hiz[2]} flags "
          f"differ; frame N equal to the plain-raster frame N: "
          f"{inst_plain_equal}; recorded, against occlusion off (overflow "
          f"{inst_off_over}): max diff {int(inst_off_diff.max())}, "
          f"{inst_off_pixels} pixels over 1 level; peak device memory "
          f"{inst_peak:.1f} MiB", flush=True)
    print(f"phase4 lod frame (example 07): 1920x1080, 400 spheres, "
          f"{rlod._scene.num_triangles} triangles: one-layer launches per "
          f"frame {lod_one} (the shadow map follows the camera), overflow "
          f"(main, shadow) {lod_over}; "
          + "; ".join(f"distance {d:g}: per level {st.objects_per_lod[:3]}, "
                      f"culled {st.objects_culled}, triangles "
                      f"{st.triangles_before} -> {st.triangles_after} "
                      f"({100 * st.reduction_rate:.1f}% fewer)"
                      for d, st in lod_stats.items())
          + f"; equal to the plain-raster frames: {lod_plain_equal}",
          flush=True)
    print(f"phase4 ibl frame (example 06): 640x400, 25 spheres, HDR: "
          f"environment and scene built in {ibl_build_s:.2f} s, one-layer "
          f"launches {ibl_one}; PSNR against the flat ambient "
          f"{ibl_vs_flat:.2f} dB; equal to the plain-raster frame: "
          f"{ibl_plain_equal}", flush=True)
    print(f"phase4 bf16 frame (bench.py --bf16): one-layer launches {bf_one}; "
          f"PSNR against the f32 frame {bf_psnr:.2f} dB (not identical); "
          f"equal to the plain-raster frame: {bf_plain_equal}", flush=True)
    for path, m in msaa.items():
        print(f"phase4 {path} frame: 1920x1080, sample rate "
              f"{'x'.join(map(str, MSAA_PRESETS[path.split()[-1]]))}: "
              f"one-layer launches per frame {m['one']}, peel 0; overflow "
              f"0; covered samples {m['covered']}; msaa_edge_overflow "
              f"{m['edge_overflow']}; equal to the plain-raster frame: True; "
              f"PSNR against the 1x frame {m['psnr_native']:.2f} dB"
              + (f", against the SSAA frame {m['psnr_ssaa']:.2f} dB"
                 if "psnr_ssaa" in m else ""), flush=True)
    print("phase4 msaa 64x64 scenes (tests/test_edge_msaa.py) on the card, "
          "edge against SSAA: " + ", ".join(
              f"{k} {v:.2f} dB" for k, v in edge_small.items()), flush=True)
    print(f"phase4 example 02 (640x480, 30 frames): "
          f"{ex02.frame_stats.format_line()} | "
          f"{ex02.memory_stats.format_line()}", flush=True)
    print(f"phase4 overlay frame (standard, max_tris_per_tile 16): overflow "
          f"{ov_dropped}, shadow {int(ov_out.shadow_overflow)}; magenta "
          f"block; text patch {ov_text_px} pixels; "
          f"equal to the frame without diagnostics elsewhere: True",
          flush=True)
    print(f"phase4 surfaces and profiling: FileStreamSurface wrote 3 card "
          f"frames ({raw.size} bytes); profile_passes (ms, n=10) "
          + ", ".join(f"{k} {v:.3f}" for k, v in pp.items())
          + f"; frame_cost_analysis: {fca['flops']:.4g} flops, "
          f"{fca['bytes_accessed']:.4g} bytes, programs "
          f"{len(fca['programs'])}", flush=True)
    print(f"phase4 occlusion frame (standard + Hi-Z): one-layer launches "
          f"{occ_one}; visible draws {occ_visible} (frustum only "
          f"{int(out.visible_draws)}); frame 2's Hi-Z cull on the card / CPU "
          f"{occ_hiz[0]} / {occ_hiz[1]} visible, {occ_hiz[2]} flags differ; "
          f"recorded, against the frustum-only frame: max "
          f"diff {occ_diff}, {occ_pixels} pixels over 1 level; frame 3 "
          f"equal to the plain-raster frame 3: {occ_plain_equal}", flush=True)

    # 5. Times.
    timed = {}
    # B1 on the mega frame's and the instancing frame's passes: the plain
    # raster was timed once in phase 3. Besides the whole launch, the launch
    # with only the heaviest tile's list left: if it takes most of the time,
    # the kernel's time follows the worst tile, not the pairs.
    for name in big_names:
        args = passes[name]
        bins = args[1]
        launch, _, _ = raster_cuda.launcher(*args[:6])
        empty = bins._replace(counts=torch.zeros_like(bins.counts))
        launch_empty, _, _ = raster_cuda.launcher(args[0], empty, *args[2:6])
        worst = int(bins.counts.argmax())
        only = torch.arange(bins.counts.numel(), device=bins.counts.device)
        worst_bins = bins._replace(counts=torch.where(
            only == worst, bins.counts, torch.zeros_like(bins.counts)))
        launch_worst, _, _ = raster_cuda.launcher(args[0], worst_bins,
                                                  *args[2:6])
        row = work(*args[:6])
        row.update(
            wrapper_ms=cuda_ms(lambda: raster_cuda.rasterize(*args[:6]), 10),
            device_ms=statistics.mean([graph_ms(launch), graph_ms(launch)]),
            clear_ms=graph_ms(launch_empty),
            worst_tile_ms=graph_ms(launch_worst),
            worst_tile_count=int(bins.counts[worst]),
            worst_tile_pairs_tested=work(args[0], worst_bins,
                                         *args[2:6])["pairs_tested"],
            plain_ms=plain_once[name], size=f"{args[3]}x{args[2]}")
        row["share_of_bound"] = row["bound_ms"] / row["device_ms"]
        timed[name, 1, False] = row
    # The mega and instancing passes' inputs (1M-triangle setups, bins of
    # up to 32768 slots) are freed before the frames are timed.
    for name in big_names:
        del passes[name]
    del mega, inst_passes, args, bins, empty, worst_bins, launch
    del launch_empty, launch_worst

    mem = {}
    static_ms, mem["standard"] = frame_ms_mem(
        lambda i: r.render_frame(view, proj, pos), 20)

    def shadow_frame(i):
        r.shadow_feature.set_light_direction(sun[i % 2])
        r.render_frame(view, proj, pos)

    shadow_frame_ms, mem["standard shadow re-render"] = frame_ms_mem(
        shadow_frame, 10)
    glass_ms = {}
    for tp, g in glass.items():
        glass_ms[tp], mem[f"glass passes={tp}"] = frame_ms_mem(
            lambda i, rg=g[0]: rg.render_frame(view, proj, pos), 10)
    rt.render_frame(view, proj, pos)  # the cached shadow map again
    textured_ms, mem["textured"] = frame_ms_mem(
        lambda i: rt.render_frame(view, proj, pos), 10)
    textured_shadow_ms, mem["textured shadow re-render"] = frame_ms_mem(
        textured_shadow_frame, 10)
    rt1, _, _, _ = build_bench_renderer(1920, 1080, 1000, "cuda",
                                        textured=True, max_anisotropy=1)
    rt1.render_frame(view, proj, pos)
    textured_aniso1_ms, mem["textured, anisotropy 1"] = frame_ms_mem(
        lambda i: rt1.render_frame(view, proj, pos), 10)
    del rt1
    lit_ms, mem["lit"] = frame_ms_mem(
        lambda i: rl.render_frame(view, proj, pos), 10)
    rr.render_frame(view, proj, pos)  # a history and the cached cascades
    rich_ms, mem["rich"] = frame_ms_mem(
        lambda i: rr.render_frame(view, proj, pos), 10)
    rich_shadow_ms, mem["rich shadow re-render"] = frame_ms_mem(
        rich_shadow_frame, 6)
    rich_half_ms, mem["rich, render_scale 0.5"] = frame_ms_mem(
        lambda i: r_half.render_frame(view, proj, pos), 10)
    # The animated frame: the next pose at t += 1/60 per frame, as bench.py
    # times it; the mega frame at its drop-free caps and at the base caps.
    clock = [1.0]
    ra, _, acam, anim = anim_main

    def animated_frame(i):
        clock[0] += 1.0 / 60.0
        ra.update_transforms_trs(*bench_scene.animated_models_trs(
            anim, clock[0]))
        ra.render_frame(bench_scene.orbit_camera(acam, anim["extent"],
                                                 clock[0]),
                        proj, acam.position)

    animated_frame(0)
    anim_ms, mem["animated"] = frame_ms_spread(animated_frame, 30)
    anim_ops = busy_profile(animated_frame)[3]
    rmega.render_frame(*margs)
    mega_ms, mem["mega, drop-free caps"] = frame_ms_spread(
        lambda i: rmega.render_frame(*margs), 8)
    mega_ops = busy_profile(lambda i: rmega.render_frame(*margs))[3]
    del rmega
    rbase, _, _, _ = build_mega_renderer(1920, 1080, "cuda")
    rbase.render_frame(*margs)
    mega_base_ms, mem["mega, base caps"] = frame_ms_spread(
        lambda i: rbase.render_frame(*margs), 8)
    del rbase
    # The A14 paths: example 07's instancing frame (steady state, after its
    # first three frames) and LOD frames, example 06's IBL frame, the bf16
    # standard frame beside the f32 one, the standard frame with Hi-Z.
    inst_ms, mem["instancing"] = frame_ms_spread(
        lambda i: r_inst.render_frame(*iargs), 5)
    lod_ms = {}
    for d in (15.0, 30.0):
        lod_ms[d], mem[f"lod, distance {d:g}"] = frame_ms_mem(
            lambda i, a=lod_args[d]: rlod.render_frame(*a), 5)
    ibl_ms, mem["ibl"] = frame_ms_mem(lambda i: ribl.render_frame(*ibl_args),
                                      10)
    bf_ms, mem["bf16"] = frame_ms_mem(
        lambda i: rbf.render_frame(view, proj, pos), 10)
    f32_ms = frame_ms(lambda i: r.render_frame(view, proj, pos), 10)
    occ_ms, mem["occlusion"] = frame_ms_mem(
        lambda i: rocc.render_frame(view, proj, pos), 10)
    del r_inst, rlod, ribl, rbf, rocc
    # The MSAA frames (static: the shadow map is cached).
    msaa_ms, msaa_ops = {}, {}
    for mode, preset in MSAA_FRAMES:
        path = f"msaa {mode} {preset}"
        step = (lambda i, rm_=msaa_r[mode, preset]:
                rm_.render_frame(view, proj, pos))
        msaa_ms[path], mem[path] = frame_ms_spread(step, 5)
        msaa_ops[path] = busy_profile(step)[3]
    del msaa_r
    # Each kernel shape of the main path: the wrapper loop, the device time
    # of bare launches (and with every list empty), the plain raster (plain,
    # kernel, kernel, plain) and the work from the inputs.
    for name, layers, with_floor in SHAPES:
        args = passes[name]
        kw = dict(y0=args[6], layers=layers,
                  depth_floor=floor4 if with_floor else None)
        launch, _, _ = raster_cuda.launcher(*args[:6], **kw)
        empty = args[1]._replace(counts=torch.zeros_like(args[1].counts))
        launch_empty, _, _ = raster_cuda.launcher(args[0], empty, *args[2:6],
                                                  **kw)
        wrap, plain, dev = [], [], []
        for order in ("plain", "kernel", "kernel", "plain"):
            if order == "kernel":
                wrap.append(cuda_ms(lambda: raster_cuda.rasterize(
                    *args[:6], **kw), 50))
                dev.append(graph_ms(launch))
            else:
                plain.append(cuda_ms(lambda: raster.rasterize(
                    *args[:6], **kw), 3))
        row = work(*args[:6], args[6], layers, with_floor)
        row.update(wrapper_ms=statistics.mean(wrap),
                   device_ms=statistics.mean(dev),
                   clear_ms=graph_ms(launch_empty),
                   plain_ms=statistics.mean(plain))
        row["share_of_bound"] = row["bound_ms"] / row["device_ms"]
        timed[name, layers, with_floor] = row
    print(f"phase5 times on {card}: static frame {static_ms} ms, frame with "
          f"shadow re-render {shadow_frame_ms} ms (medians of 20 and 10); "
          f"glass frame passes=1 {glass_ms[1]} ms, passes=2 {glass_ms[2]} ms; "
          f"textured frame {textured_ms} ms, with shadow re-render "
          f"{textured_shadow_ms} ms, at anisotropy 1 {textured_aniso1_ms} ms; "
          f"lit frame {lit_ms} ms (medians of 10); rich frame {rich_ms} ms, "
          f"with shadow re-render {rich_shadow_ms} ms (median of 6), at "
          f"render_scale 0.5 {rich_half_ms} ms", flush=True)
    print(f"phase5 A16 times on {card}: animated frame {anim_ms[0]} ms "
          f"(median of 30 poses, min {anim_ms[1]}, max {anim_ms[2]}), "
          f"{anim_ops:g} kernels and copies per frame; mega frame at the "
          f"drop-free caps {mega_ms[0]} ms (median of 8, min {mega_ms[1]}, "
          f"max {mega_ms[2]}), {mega_ops:g} kernels and copies per frame; at "
          f"the base caps {mega_base_ms[0]} ms (median of 8, min "
          f"{mega_base_ms[1]}, max {mega_base_ms[2]})", flush=True)
    print(f"phase5 A14 times on {card}: instancing frame {inst_ms[0]} ms "
          f"(median of 5, min {inst_ms[1]}, max {inst_ms[2]}); lod frame at "
          f"distance 15 {lod_ms[15.0]} ms, at 30 {lod_ms[30.0]} ms (medians "
          f"of 5); ibl frame {ibl_ms} ms; bf16 standard frame {bf_ms} ms "
          f"beside the f32 one {f32_ms} ms; standard frame with Hi-Z "
          f"{occ_ms} ms (medians of 10)", flush=True)
    print(f"phase5 MSAA times on {card}: " + "; ".join(
        f"{path} {msaa_ms[path][0]} ms (median of 5, min {msaa_ms[path][1]}, "
        f"max {msaa_ms[path][2]}), {msaa_ops[path]:g} kernels and copies "
        "per frame" for path in msaa_ms) + f"; the 1x frame {static_ms} ms",
        flush=True)
    print("phase5 peak device memory (MiB): " + ", ".join(
        f"{k} {v:.1f}" for k, v in mem.items()), flush=True)
    for name in big_names:
        row = timed[name, 1, False]
        print(f"phase5 kernel {name} {row['size']}: device {row['device_ms']} ms "
              f"(every list empty: {row['clear_ms']} ms; only the heaviest "
              f"tile's list, {row['worst_tile_count']} candidates, "
              f"{row['worst_tile_pairs_tested']} pairs: "
              f"{row['worst_tile_ms']} ms), wrapper loop {row['wrapper_ms']} "
              f"ms, plain {row['plain_ms']} ms (one call); pairs evaluated "
              f"{row['pairs_tested']} (every candidate at every tile pixel: "
              f"{row['pairs_tile']}, in the bbox: {row['pairs_needed']}); "
              f"bound {row['bound_ms']} ms by {row['bound_by']}, "
              f"{100 * row['share_of_bound']:.1f}% of it", flush=True)
    for (name, layers, with_floor), row in timed.items():
        if name in big_names:
            continue
        h, w = passes[name][2:4]
        print(f"phase5 kernel {name} {w}x{h} layers={layers} "
              f"floor={with_floor}: device {row['device_ms']} ms (every "
              f"list empty: {row['clear_ms']} ms), wrapper loop "
              f"{row['wrapper_ms']} ms, plain {row['plain_ms']} ms; "
              f"pairs evaluated {row['pairs_tested']} (every candidate at "
              f"every tile pixel: {row['pairs_tile']}, in the bbox: "
              f"{row['pairs_needed']}); bound {row['bound_ms']} ms by "
              f"{row['bound_by']}, {100 * row['share_of_bound']:.1f}% of it",
              flush=True)

    # 6. A18 and A16's chunked frame: the sharded frames, the farms, and
    # example 10 chunked; each path's counts from 0.
    sharded = sharded_paths(card, view, proj, pos, launches, layer_launches,
                            mem, light_launches, bloom_launches,
                            shadow_launches)
    farms = farm_paths(card, launches, layer_launches, mem, bloom_launches)
    chunked, chunk_err = chunked_paths(card, launches, layer_launches, mem,
                                       timed)
    max_err = max(max_err, chunk_err)
    chunk_shape = next(k for k in timed if k[0].startswith("example 10"))
    del sharded, farms, chunked
    # 7. The frame loop's host profile, and the LOD scene's banded shadow
    # pass; each path's counts from 0.
    host_profile_phase(card, kind, launches, layer_launches)
    lod_sharded_phase(card, launches, layer_launches)
    benchmark_phase(card, kind)
    # 9. The texture kernel at the textured frame's inputs, its frames
    # against the plain sampler's, the anisotropy-1 path counted from 0.
    tex_rows, tex_err = texture_phase(card, view, proj, pos, tex_launches)
    # 10. The light kernel at the rich and lit frames' inputs, their frames
    # against the plain loop's.
    light_rows, light_err = light_phase(card, view, proj, pos, light_launches,
                                        usage)
    # 11. The bloom kernels at the rich frame's input, its frames against the
    # plain chain's.
    bloom_rows, bloom_err = bloom_phase(card, view, proj, pos, bloom_launches,
                                        usage)
    # 12. The shadow kernel at the frames' shade calls, their frames against
    # the plain PCF's.
    shadow_rows, shadow_err = shadow_phase(card, view, proj, pos,
                                           shadow_launches, usage)
    # 13. The G-buffer kernel at the frames' calls, their frames against
    # the plain fetch's.
    gb_cases, gb_rends, shade_cases = gbuffer_cases(view, proj, pos,
                                                    mega_final_caps)
    gbuffer_rows, gbuffer_err = gbuffer_phase(card, view, proj, pos,
                                              gbuffer_launches, usage,
                                              gb_cases, gb_rends)
    del gb_cases, gb_rends
    # 14. The shading kernels at the same frames' calls, their frames
    # against the plain shade_pbr's.
    shade_rows, shade_err = shade_phase(card, view, proj, pos,
                                        shade_launches, usage, shade_cases)
    del shade_cases
    eager_phases.stop()
    # 15. The benchmark's six cells graphed against eager.
    graph_rows = graph_phase(card, 30)
    print(json.dumps({"graphs": graph_rows, "card": card}))
    # 16. The asynchronous frame loop on renderers with default settings.
    present_rows = present_phase(card, 30)
    print(json.dumps({"present": present_rows, "card": card}))

    foreign = sorted(m for m in sys.modules if m in ("jax", "ash_tpu")
                     or m.startswith(("jax.", "ash_tpu.")))
    check(not foreign, f"the port loaded jax or ash_tpu: {foreign[:5]}")

    def kernel_line(name, replaces, launches_by_path, err, main_shape, shapes):
        main = timed[main_shape]
        return {
            "name": name,
            "route": "cuda",
            "source": "ash_tpu_torch/csrc/raster.cu",
            "replaces": replaces,
            "launches": sum(launches_by_path.values()),
            "launches_by_path": launches_by_path,
            "max_abs_err": err,
            "ms": main["wrapper_ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            # No PyTorch call computes a visibility buffer.
            "library_ms": None,
            "device_ms": main["device_ms"],
            "pairs_tested": main["pairs_tested"],
            "by_shape": {f"{n} layers={k}{' floor' if f else ''}": timed[n, k, f]
                         for n, k, f in shapes},
        }

    # The texture kernel's main shape: the anisotropy-16 frame's five maps
    # in one launch (the sampling of one pass_shade).
    tex_main = tex_rows["aniso 16 maps"]
    texture_line = {
        "name": "texture_sample",
        "route": "cuda",
        "source": "ash_tpu_torch/csrc/texture.cu",
        # jax.numpy, not a TPU kernel: XLA fuses the reference's sampler.
        "replaces": "ash_tpu/ops/shade.py:348",
        "launches": sum(map(sum, tex_launches.values())),
        "launches_by_path": tex_launches,
        "max_abs_err": tex_err,
        "ms": tex_main["device_ms"],
        "plain_ms": tex_main["plain_ms"],
        "bound_ms": tex_main["bound_ms"],
        "bound_by": tex_main["bound_by"],
        # No PyTorch call samples a REPEAT-wrapped mip pool anisotropically.
        "library_ms": None,
        "device_ms": tex_main["device_ms"],
        "wrapper_ms": tex_main["wrapper_ms"],
        "by_shape": tex_rows,
    }
    # The light kernel's main shape: the rich frame's shade call.
    light_main = light_rows["rich"]
    light_line = {
        "name": "light_loop",
        "route": "cuda",
        "source": "ash_tpu_torch/csrc/lights.cu",
        # jax.numpy, not a TPU kernel: the reference's light loop is a
        # lax.fori_loop that XLA fuses.
        "replaces": "ash_tpu/ops/shade.py:558",
        "launches": sum(light_launches.values()),
        "launches_by_path": light_launches,
        "max_abs_err": light_err,
        "ms": light_main["device_ms"],
        "plain_ms": light_main["plain_ms"],
        "bound_ms": light_main["bound_ms"],
        "bound_by": light_main["bound_by"],
        # No PyTorch call walks a Forward+ tile list.
        "library_ms": None,
        "device_ms": light_main["device_ms"],
        "wrapper_ms": light_main["wrapper_ms"],
        "by_shape": light_rows,
    }
    # The bloom kernels' main shape: the rich frame's pass_bloom input.
    bloom_main = bloom_rows["rich frame 1"]
    bloom_line = {
        "name": "bloom",
        "route": "cuda",
        "source": "ash_tpu_torch/csrc/bloom.cu",
        # jax.numpy, not a TPU kernel: XLA fuses the reference's chain.
        "replaces": "ash_tpu/ops/bloom.py:274",
        "launches": sum(bloom_launches.values()),
        "launches_by_path": bloom_launches,
        "max_abs_err": bloom_err,
        "ms": bloom_main["device_ms"],
        "plain_ms": bloom_main["plain_ms"],
        "bound_ms": bloom_main["bound_ms"],
        "bound_by": bloom_main["bound_by"],
        # No PyTorch call computes a Karis-weighted downsample chain.
        "library_ms": None,
        "device_ms": bloom_main["device_ms"],
        "wrapper_ms": bloom_main["wrapper_ms"],
        "by_shape": bloom_rows,
    }
    # The shadow kernel's main shape: the rich frame's shade call (three
    # blended cascades).
    shadow_main = shadow_rows["rich"]
    shadow_line = {
        "name": "shadow_pcf",
        "route": "cuda",
        "source": "ash_tpu_torch/csrc/shadow.cu",
        # jax.numpy, not a TPU kernel: XLA fuses the reference's PCF.
        "replaces": "ash_tpu/ops/shadow.py:46 and :117",
        "launches": sum(shadow_launches.values()),
        "launches_by_path": shadow_launches,
        "max_abs_err": shadow_err,
        "ms": shadow_main["device_ms"],
        "plain_ms": shadow_main["plain_ms"],
        "bound_ms": shadow_main["bound_ms"],
        "bound_by": shadow_main["bound_by"],
        # No PyTorch call takes a white-bordered comparison gather of 16
        # taps.
        "library_ms": None,
        "device_ms": shadow_main["device_ms"],
        "graph_ms": shadow_main["graph_ms"],
        "wrapper_ms": shadow_main["wrapper_ms"],
        "by_shape": shadow_rows,
    }
    # The G-buffer kernel's main shape: the standard frame's call.
    gbuffer_main = gbuffer_rows["standard"]
    gbuffer_line = {
        "name": "gbuffer",
        "route": "cuda",
        "source": "ash_tpu_torch/csrc/gbuffer.cu",
        # jax.numpy, not a TPU kernel: XLA fuses the reference's fetch.
        "replaces": "ash_tpu/ops/shade.py:127",
        "launches": sum(gbuffer_launches.values()),
        "launches_by_path": gbuffer_launches,
        "max_abs_err": gbuffer_err,
        "ms": gbuffer_main["device_ms"],
        "plain_ms": gbuffer_main["plain_ms"],
        "bound_ms": gbuffer_main["bound_ms"],
        "bound_by": gbuffer_main["bound_by"],
        # No PyTorch call interpolates a visibility buffer's attributes.
        "library_ms": None,
        "device_ms": gbuffer_main["device_ms"],
        "graph_ms": gbuffer_main["graph_ms"],
        "wrapper_ms": gbuffer_main["wrapper_ms"],
        "by_shape": gbuffer_rows,
    }
    # The shading kernels' main shape: the standard frame's call (one shade
    # launch).
    shade_main = shade_rows["standard"]
    shade_line = {
        "name": "shade",
        "route": "cuda",
        "source": "ash_tpu_torch/csrc/shade.cu",
        # jax.numpy, not a TPU kernel: XLA fuses the reference's shade_pbr.
        "replaces": "ash_tpu/ops/shade.py:415",
        "launches": sum(shade_launches.values()),
        "launches_by_path": shade_launches,
        "max_abs_err": shade_err,
        "ms": shade_main["device_ms"],
        "plain_ms": shade_main["plain_ms"],
        "bound_ms": shade_main["bound_ms"],
        "bound_by": shade_main["bound_by"],
        # No PyTorch call computes a Cook-Torrance surface shade.
        "library_ms": None,
        "device_ms": shade_main["device_ms"],
        "graph_ms": shade_main["graph_ms"],
        "wrapper_ms": shade_main["wrapper_ms"],
        "by_shape": shade_rows,
    }
    print(json.dumps({"kernels": [
        kernel_line("raster", "ash_tpu/ops/raster_pallas.py:106", launches,
                    max_err, ("main", 1, False),
                    [("main", 1, False), ("shadow", 1, False),
                     *((c, 1, False) for c in CASCADES),
                     ("msaa x4", 1, False), ("msaa x8", 1, False),
                     ("band 1/4", 1, False), ("shadow band 1/4", 1, False),
                     *((n, 1, False) for n in big_names), chunk_shape]),
        kernel_line("raster_layers", "ash_tpu/ops/raster_pallas.py:138",
                    layer_launches, max_err_layers, ("main", 4, False),
                    [("main", 2, False), ("main", 4, False),
                     ("main", 8, False), ("main", 4, True)]),
        texture_line,
        light_line,
        bloom_line,
        shadow_line,
        gbuffer_line,
        shade_line,
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
