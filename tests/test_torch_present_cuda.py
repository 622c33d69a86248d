"""The asynchronous frame loop on the card (render/host_copy.py, the
surfaces, Renderer._present and read_back, graphs on by default).

Every test here needs a CUDA device and skips itself without one: run them
on the card with `python3 -m pytest tests/test_torch_present_cuda.py -m
cuda -q`. The small bench scenes of tests/test_torch_graphs_cuda.py
(192x128, 64 cubes, 16x32 tiles), the camera turning every frame. A
renderer built with default settings runs graphed frames and makes no host
sync in a steady frame; its read_back and a FileStreamSurface's stream
equal blocking copies of graphs-off frames; set_cuda_graphs(False) still
runs eager frames; a pinned allocation that fails raises. CPU tests of the
same code: tests/test_torch_present.py. chip_smoke.py phase 16 runs the
same checks on the benchmark's six cells at 1080p.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from ash_tpu_torch.render import FileStreamSurface, compiled, host_copy
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
    "glass p=2": dict(glass=True, transparency_passes=2),
}
TURN_T = 2.5


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (pinned copies, events, graphs)")


def _renderer(kw, graphs=None, surface=None):
    """A bench renderer; graphs None keeps its default."""
    r, _, cam, extent = build_bench_renderer(W, H, N, "cuda",
                                             **{**TILES, **kw})
    if surface is not None:
        r.surface = surface
    if graphs is not None:
        r.set_cuda_graphs(graphs)
    return r, cam, extent


def _render(r, cam, extent, kw, i):
    ext = extent["extent"] if kw.get("animate") else extent
    view = orbit_camera(cam, ext, TURN_T * (i + 1))
    if kw.get("animate"):
        r.update_transforms_trs(*animated_models_trs(extent, (i + 1) / 60.0))
    return r.render_frame(view, cam.projection_matrix(), cam.position)


def _blocking(kw, frames):
    """Frames 0..frames-1 with graphs off, each image copied to the host
    after its frame."""
    r, cam, extent = _renderer(kw, graphs=False)
    return [_render(r, cam, extent, kw, i).image.cpu().numpy()
            for i in range(frames)]


@pytest.mark.cuda
def test_cuda_graphs_on_by_default():
    _need_card()
    r, cam, extent = _renderer({})
    assert all(g.enabled for g in r._graphs.values())
    compiled.reset_stats()
    for i in range(4):
        _render(r, cam, extent, {}, i)
    st = compiled.stats["frame"]
    assert st["eager"] == {"first": 1} and st["captures"] == 1
    assert st["replays"] == 3


@pytest.mark.cuda
def test_cuda_graphs_off_still_runs_eager_frames():
    _need_card()
    r, cam, extent = _renderer({}, graphs=False)
    compiled.reset_stats()
    outs = [_render(r, cam, extent, {}, i).image.cpu().numpy()
            for i in range(3)]
    st = compiled.stats["frame"]
    assert dict(st["eager"]) == {"graphs off": 3}
    assert st["captures"] == 0 and st["replays"] == 0
    assert not r._graphs["frame"].captured
    np.testing.assert_array_equal(r.read_back(), outs[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SCENES))
def test_cuda_steady_graphed_frames_make_no_host_sync(name):
    """From frame 3 on, render_frame (and the TRS update) under the sync
    debug mode's "error", with no readback between frames; then read_back
    equals the blocking path's last frame."""
    _need_card()
    kw = SCENES[name]
    want = _blocking(kw, 12)
    r, cam, extent = _renderer(kw)
    for i in range(3):
        _render(r, cam, extent, kw, i)
    compiled.reset_stats()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(3, 12):
            _render(r, cam, extent, kw, i)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    st = compiled.stats["frame"]
    assert st["replays"] == 9 and not st["eager"] and not st["captures"]
    np.testing.assert_array_equal(r.read_back(), want[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_cuda_file_stream_equals_blocking_copies(tmp_path, depth):
    """A FileStreamSurface's raw stream of 12 graphed frames equals the
    blocking copies of the same frames rendered with graphs off."""
    _need_card()
    kw = SCENES["animated"]
    want = _blocking(kw, 12)
    path = tmp_path / "s.rgba"
    surface = FileStreamSurface(W, H, str(path), max_frames_in_flight=depth)
    r, cam, extent = _renderer(kw, surface=surface)
    written = []
    for i in range(12):
        _render(r, cam, extent, kw, i)
        written.append(surface.written_frames)
    np.testing.assert_array_equal(surface.read_back(), want[-1])
    surface.close()
    assert written == [max(0, i + 2 - depth) for i in range(12)]
    raw = np.fromfile(path, np.uint8).reshape(12, H, W, 4)
    np.testing.assert_array_equal(raw, np.stack(want))


@pytest.mark.cuda
def test_cuda_host_frames_copy_is_pinned_and_ordered():
    _need_card()
    ring = host_copy.HostFrames(2)
    x = torch.arange(H * W * 4, device="cuda").to(torch.uint8).view(H, W, 4)
    slot = ring.copy(x)
    assert slot.host.is_pinned() and slot.event is not None
    x.fill_(7)  # enqueued after the copy: the slot keeps the old values
    slot.wait()
    np.testing.assert_array_equal(slot.pixels(),
                                  (np.arange(H * W * 4) % 256)
                                  .astype(np.uint8).reshape(H, W, 4))


@pytest.mark.cuda
def test_cuda_a_failed_pinned_allocation_raises(tmp_path):
    """No fallback: a surface or an upload whose pinned buffer cannot be
    had raises; nothing copies through pageable memory in its place."""
    _need_card()
    real = torch.empty

    def empty(*a, pin_memory=False, **kw):
        if pin_memory:
            raise RuntimeError("pinned allocation refused")
        return real(*a, **kw)

    x = torch.zeros((H, W, 4), dtype=torch.uint8, device="cuda")
    surface = FileStreamSurface(W, H, str(tmp_path / "s.rgba"))
    with mock.patch.object(torch, "empty", empty):
        with pytest.raises(RuntimeError, match="pinned allocation refused"):
            surface.present(x)
        with pytest.raises(RuntimeError, match="pinned allocation refused"):
            host_copy.Staging(2).upload(
                torch.zeros(4, device="cuda"), [np.ones(4, np.float32)])
    assert surface.presented_frames == 0
    surface.close()
