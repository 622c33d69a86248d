"""Graphed frames against eager frames on the card (render/compiled.py).

Every test here needs a CUDA device and skips itself without one: run them
on the card with `python3 -m pytest tests/test_torch_graphs_cuda.py -m cuda
-q`. Two fresh renderers of the same small scene (192x128, 64 cubes, 16x32
tiles; standard, animated with TRS every frame, rich, textured, glass with
two passes, two-level binned), one eager (graphs off, the default), one
graphed (set_cuda_graphs(True)), the camera turning 0.05 rad a frame in
every scene so that each frame's inputs differ from the last: frames 0-4
equal bit for bit in every FrameOutputs field, each eager image unlike the
one before, the graphed renderer capturing and replaying every frame it
did not warm up on. Three replayed frames launch each hand kernel as often
by name as three eager ones (torch.profiler, after a warm-up frame; up to
three tries, as a trace can lose a replay's records). A graphed frame's
outputs stay as they were after the next frame. A registered kernel observer, or
graphs off, runs the frame eagerly. CPU tests of the same code:
tests/test_torch_compiled_frame.py.
"""

import collections
import re

import pytest
import torch

from ash_tpu_torch.ops import raster_cuda
from ash_tpu_torch.render import compiled
from ash_tpu_torch.render.bench_scene import (
    animated_models_trs,
    build_bench_renderer,
    orbit_camera,
)

W, H, N = 192, 128, 64
TILES = dict(tile_h=16, tile_w=32)
SCENES = {
    "standard": dict(),
    "animated": dict(animate=True),
    "rich": dict(rich=True),
    "textured": dict(textured=True),
    "glass p=2": dict(glass=True, transparency_passes=2),
    "two-level": dict(two_level_binning=True),
}
# orbit_camera turns 0.02 rad per unit of t.
TURN_T = 2.5


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the graphs capture CUDA kernels)")


def _renderer(kw, graphed):
    r, _, cam, extent = build_bench_renderer(W, H, N, "cuda",
                                             **{**TILES, **kw})
    r.set_cuda_graphs(graphed)
    return r, cam, extent


def _render(r, cam, extent, kw, i):
    """Frame i: the camera on its orbit at 0.05 (i + 1) rad, the cubes spun
    to t = (i + 1) / 60 in the animated scene."""
    ext = extent["extent"] if kw.get("animate") else extent
    view = orbit_camera(cam, ext, TURN_T * (i + 1))
    if kw.get("animate"):
        r.update_transforms_trs(*animated_models_trs(extent, (i + 1) / 60.0))
    return r.render_frame(view, cam.projection_matrix(), cam.position)


def _frames(kw, graphed, frames=5):
    """(outputs, their fields cloned) of frames 0..frames-1 of a fresh
    renderer."""
    r, cam, extent = _renderer(kw, graphed)
    outs = []
    for i in range(frames):
        o = _render(r, cam, extent, kw, i)
        outs.append((o, {k: (v.clone() if isinstance(v, torch.Tensor)
                             else v) for k, v in o._asdict().items()}))
    return outs


def _same(got: dict, want: dict, what: str):
    for k, v in want.items():
        if v is None:
            assert got[k] is None, f"{what}: {k} is not None"
        else:
            assert torch.equal(got[k], v), f"{what}: {k} differs"


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SCENES))
def test_cuda_graphed_frames_equal_eager_frames(name):
    _need_card()
    kw = SCENES[name]
    compiled.reset_stats()
    eager = _frames(kw, graphed=False)
    assert compiled.stats["frame"]["eager"] == {"graphs off": len(eager)}
    for i in range(1, len(eager)):
        assert not torch.equal(eager[i][1]["image"], eager[i - 1][1]["image"])
    compiled.reset_stats()
    graphed = _frames(kw, graphed=True)
    st = compiled.stats["frame"]
    assert st["captures"] >= 1 and set(st["eager"]) <= {"first"}
    assert st["replays"] >= 1
    assert st["replays"] + sum(st["eager"].values()) == len(graphed)
    for i, ((_, g), (_, e)) in enumerate(zip(graphed, eager)):
        _same(g, e, f"{name} frame {i}")


def _kernels(r, cam, extent, kw, first, n=3):
    """{device kernel name: launches} over frames first+1..first+n, after
    frame first, which the profiler runs but keeps nothing of; copies and
    memsets aside."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=n,
                                   repeat=1)) as prof:
        for i in range(first, first + n + 1):
            _render(r, cam, extent, kw, i)
            torch.cuda.synchronize()
            prof.step()
    return collections.Counter({
        e.key: e.count for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation
        and not re.search("memcpy|memset|copy", e.key, re.I)})


_HAND = re.compile(
    r"\b(raster_warp|candidate_rects|shade|compose|gbuffer|shadow_pcf|"
    r"shadow_window|light_tile|light_element|bloom_down|bloom_up|"
    r"texture_maps|texture_trilinear)_kernel\b")
# Profiles taken until the eager and graphed traces agree: a trace can
# lose the records of a whole replay, while a graph launches the same
# nodes at every replay.
_TRIES = 3


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SCENES))
def test_cuda_replays_launch_the_eager_frames_kernels(name):
    _need_card()
    kw = SCENES[name]
    rends = {}
    for graphed in (False, True):
        r, cam, extent = _renderer(kw, graphed)
        for i in range(3):
            _render(r, cam, extent, kw, i)
        rends[graphed] = (r, cam, extent)
    tries = []
    for t in range(_TRIES):
        got = {}
        for graphed, (r, cam, extent) in rends.items():
            compiled.reset_stats()
            got[graphed] = _kernels(r, cam, extent, kw, 3 + 4 * t)
            if graphed:
                assert compiled.stats["frame"]["replays"] == 4
        hand = {g: {k: v for k, v in got[g].items() if _HAND.search(k)}
                for g in got}
        tries.append(hand)
        if hand[True] == hand[False] and hand[True]:
            break
    assert hand[True] == hand[False] and hand[True], (tries, sorted(got[True]))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rich", "animated"])
def test_cuda_graphed_outputs_stay_after_the_next_frame(name):
    _need_card()
    for i, (out, snap) in enumerate(_frames(SCENES[name], graphed=True)):
        _same(out._asdict(), snap, f"{name} frame {i} after the last")


@pytest.mark.cuda
def test_cuda_observers_and_graphs_off_run_eagerly():
    _need_card()
    kw = SCENES["standard"]
    r, cam, extent = _renderer(kw, graphed=True)
    compiled.reset_stats()
    for i in range(3):
        _render(r, cam, extent, kw, i)
    seen = []
    raster_cuda.rasterize.observers.append(lambda *a: seen.append(1))
    try:
        _render(r, cam, extent, kw, 3)
    finally:
        raster_cuda.rasterize.observers.pop()
    assert seen
    r.set_cuda_graphs(False)
    assert not r._graphs["frame"].captured
    _render(r, cam, extent, kw, 4)
    st = compiled.stats["frame"]
    assert st["eager"] == {"first": 1, "observers": 1, "graphs off": 1}
    assert st["captures"] == 1 and st["replays"] == 2
