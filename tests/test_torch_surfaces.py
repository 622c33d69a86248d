"""The display surfaces of ash_tpu_torch: FileStreamSurface, LiveViewSurface
and TerminalSurface (tests/test_surface_stream.py, test_live_view.py and
test_terminal_surface.py's cases on the port, on the CPU).

The terminal encoders and the downscale must give the reference's bytes on
the same frame, and the sinks must hold what the renderer presented. A
failing encoder is not swallowed: the next present or close raises.
"""

import base64
import io
import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from ash_tpu.render import terminal_surface as ref_term
from ash_tpu_torch import Camera, Material, Mesh
from ash_tpu_torch.render import (
    FileStreamSurface,
    LiveViewSurface,
    Renderer,
    RendererConfig,
    TerminalSurface,
)
from ash_tpu_torch.render import terminal_surface as term
from ash_tpu_torch.utils.image import read_png

torch.set_num_threads(1)


def _render_frames(surface, n, shadows=False):
    r = Renderer(surface, RendererConfig(
        tile_h=8, tile_w=32, max_tris_per_tile=32, shadows_enabled=shadows,
        shadow_resolution=64, shadow_tile=32, shadow_max_tris_per_tile=32),
        device="cpu")
    r.set_mesh(Mesh.create_cube())
    r.set_material(Material(color=(0.2, 0.8, 0.3, 1.0)))
    w, h = surface.physical_size()
    cam = Camera.new([2.5, 2.0, 4.0], [0, 0, 0], w / h)
    for _ in range(n):
        r.render_frame(cam.view_matrix(), cam.projection_matrix(),
                       cam.position)
    return r


# -- FileStreamSurface -------------------------------------------------------

def test_png_sequence_sink(tmp_path):
    pattern = str(tmp_path / "frame_{n:03d}.png")
    surface = FileStreamSurface(64, 48, pattern, max_frames_in_flight=2)
    r = _render_frames(surface, 4)
    assert surface.presented_frames == 4
    assert surface.written_frames == 3  # one frame in flight
    surface.flush()
    assert surface.written_frames == 4
    imgs = sorted(os.listdir(tmp_path))
    assert imgs == [f"frame_{i:03d}.png" for i in range(4)]
    img = read_png(str(tmp_path / imgs[-1]))
    np.testing.assert_array_equal(img, r.read_back())
    assert img[..., 1].max() > 60


def test_raw_rgba_stream_sink(tmp_path):
    path = str(tmp_path / "out.rgba")
    with FileStreamSurface(64, 48, path, max_frames_in_flight=1) as surface:
        _render_frames(surface, 3)
    assert os.path.getsize(path) == 3 * 48 * 64 * 4
    raw = np.fromfile(path, np.uint8).reshape(3, 48, 64, 4)
    assert (raw[0] == raw[2]).all()
    assert (raw[..., 3] == 255).all()


def test_readback_still_available(tmp_path):
    surface = FileStreamSurface(64, 48, str(tmp_path / "x_{n}.png"))
    assert surface.read_back() is None
    _render_frames(surface, 1)
    img = surface.read_back()
    assert img is not None and img.shape == (48, 64, 4)
    surface.close()


def test_file_stream_rejects_bad_arguments(tmp_path):
    with pytest.raises(ValueError, match="pattern"):
        FileStreamSurface(8, 8, str(tmp_path / "{m}.png"))
    with pytest.raises(ValueError, match="max_frames_in_flight"):
        FileStreamSurface(8, 8, str(tmp_path / "{n}.png"),
                          max_frames_in_flight=0)


# -- LiveViewSurface ---------------------------------------------------------

def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.headers, r.read()


def _wait_until(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def test_live_view_end_to_end():
    """The renderer presents into the loopback server; /, /frame.png and
    /stats answer."""
    with LiveViewSurface(64, 48, announce=False) as surface:
        r = _render_frames(surface, 3)
        assert surface.presented_frames == 3
        assert _wait_until(lambda: surface.encoded_frames >= 1)
        status, _, body = _get(surface.url)
        assert status == 200 and b"live view" in body
        status, headers, body = _get(surface.url + "frame.png")
        assert status == 200 and headers["Content-Type"] == "image/png"
        from PIL import Image

        img = np.asarray(Image.open(io.BytesIO(body)))
        np.testing.assert_array_equal(img, r.read_back()[..., :3])
        st = json.loads(_get(surface.url + "stats")[2])
        assert st["width"] == 64 and st["presented_frames"] == 3
        assert st["encoded_frames"] >= 1


def test_stream_serves_multipart_frames():
    with LiveViewSurface(32, 24, announce=False, fmt="jpeg") as surface:
        surface.present(np.full((24, 32, 4), 200, np.uint8))
        assert _wait_until(lambda: surface.encoded_frames >= 1)
        req = urllib.request.urlopen(surface.url + "stream", timeout=10)
        assert "multipart/x-mixed-replace" in req.headers["Content-Type"]
        assert req.readline().strip() == b"--ashframe"
        clen = None
        while True:
            h = req.readline().strip()
            if not h:
                break
            if h.lower().startswith(b"content-length:"):
                clen = int(h.split(b":")[1])
        assert clen and req.read(clen)[:2] == b"\xff\xd8"  # JPEG SOI
        req.close()


def test_mailbox_never_blocks_and_drops_stale():
    surface = LiveViewSurface(8, 8, announce=False)
    try:
        t0 = time.monotonic()
        for i in range(64):
            surface.present(np.full((8, 8, 4), i, np.uint8))
        assert time.monotonic() - t0 < 2.0
        assert surface.presented_frames == 64
        # Every frame is encoded or dropped once the encoder is idle.
        assert _wait_until(lambda: surface.dropped_frames
                           + surface.encoded_frames == 64)
        assert surface.dropped_frames > 0
    finally:
        surface.close()


def test_fifo_backpressure_bounded_and_in_order():
    surface = LiveViewSurface(8, 8, announce=False, present_mode="fifo",
                              max_frames_in_flight=2, fmt="png")
    try:
        for i in range(6):
            surface.present(np.full((8, 8, 4), i * 40, np.uint8))
        assert _wait_until(lambda: surface.encoded_frames == 6)
        assert surface.dropped_frames == 0
    finally:
        surface.close()


def test_present_mode_validation():
    with pytest.raises(ValueError):
        LiveViewSurface(8, 8, present_mode="immediate", announce=False)
    with pytest.raises(ValueError):
        LiveViewSurface(0, 8, announce=False)


def test_fifo_present_blocks_at_depth():
    surface = LiveViewSurface(128, 128, announce=False, present_mode="fifo",
                              max_frames_in_flight=1, fmt="png")
    try:
        big = np.random.default_rng(0).integers(0, 255, (128, 128, 4),
                                                dtype=np.uint8)

        def producer():
            for _ in range(4):
                surface.present(big)

        t = threading.Thread(target=producer)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        assert _wait_until(lambda: surface.encoded_frames == 4)
    finally:
        surface.close()


def test_live_view_encoder_failure_is_raised():
    """A frame the encoder cannot encode stops the surface and the next
    present raises; nothing is dropped in silence."""
    surface = LiveViewSurface(8, 8, announce=False, present_mode="fifo")
    surface.present(np.zeros((8, 8, 7), np.uint8))  # no such pixel format
    assert _wait_until(lambda: surface._error is not None)
    with pytest.raises(RuntimeError, match="encoder"):
        surface.present(np.zeros((8, 8, 4), np.uint8))
    with pytest.raises(RuntimeError, match="encoder"):
        surface.close()


# -- TerminalSurface ---------------------------------------------------------

def _checker(h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.zeros((h, w, 3), np.uint8)
    img[..., 0] = ((yy // 4 + xx // 4) % 2) * 255
    img[..., 2] = 255 - img[..., 0]
    return img


def _noise(seed, h, w, c=3):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c),
                                                dtype=np.uint8)


@pytest.mark.parametrize("src,dst", [((4, 4), (2, 2)), ((10, 7), (3, 4)),
                                     ((48, 64), (20, 13)), ((8, 8), (8, 8))])
def test_downscale_equals_the_reference(src, dst):
    img = _noise(1, *src)
    np.testing.assert_array_equal(term._downscale(img, *dst),
                                  ref_term._downscale(img, *dst))


@pytest.mark.parametrize("encoder", ["encode_ansi_halfblock", "encode_kitty",
                                     "encode_sixel"])
@pytest.mark.parametrize("frame", ["checker", "noise", "odd rows", "rgba"])
def test_encoder_bytes_equal_the_reference(encoder, frame):
    img = {"checker": _checker(12, 16), "noise": _noise(2, 12, 16),
           "odd rows": _noise(3, 7, 5), "rgba": _noise(4, 6, 9, 4)}[frame]
    if encoder != "encode_kitty" and img.shape[2] == 4:
        img = img[..., :3]
    assert getattr(term, encoder)(img) == getattr(ref_term, encoder)(img)


def test_kitty_encoding_roundtrip():
    img = _checker(8, 8)
    text = term.encode_kitty(img)
    assert text.startswith("\x1b_Ga=T,f=24,s=8,v=8")
    raw = base64.standard_b64decode(text.split(";", 1)[1].split("\x1b\\")[0])
    np.testing.assert_array_equal(np.frombuffer(raw, np.uint8)
                                  .reshape(8, 8, 3), img)


def test_ansi_and_sixel_structure():
    img = np.zeros((4, 3, 3), np.uint8)
    img[0::2] = (255, 0, 0)
    img[1::2] = (0, 0, 255)
    text = term.encode_ansi_halfblock(img)
    assert "38;2;255;0;0" in text and "48;2;0;0;255" in text
    assert text.count("38;2;255;0;0") == 2
    six = term.encode_sixel(_checker(12, 16))
    assert six.startswith("\x1bPq") and six.endswith("\x1b\\")
    assert "#180" in six and "#5" in six


def test_detect_protocol(monkeypatch):
    monkeypatch.delenv("KITTY_WINDOW_ID", raising=False)
    monkeypatch.delenv("ASH_TERM_SIXEL", raising=False)
    for value, want in (("xterm-256color", "ansi"), ("xterm-kitty", "kitty"),
                        ("foot-sixel", "sixel")):
        monkeypatch.setenv("TERM", value)
        assert term.detect_protocol() == want == ref_term.detect_protocol()


@pytest.mark.parametrize("protocol", ["ansi", "kitty", "sixel"])
def test_frame_text_equals_the_reference(protocol, monkeypatch):
    """What each surface draws for the same frame, fitted to the same
    terminal grid."""
    monkeypatch.setattr(term.shutil, "get_terminal_size",
                        lambda fallback: os.terminal_size((40, 12)))
    monkeypatch.setattr(ref_term.shutil, "get_terminal_size",
                        lambda fallback: os.terminal_size((40, 12)))
    frame = _noise(5, 300, 500, 4)
    got = TerminalSurface(500, 300, protocol=protocol, out=io.StringIO())
    want = ref_term.TerminalSurface(500, 300, protocol=protocol,
                                    out=io.StringIO())
    try:
        assert got._frame_text(frame) == want._frame_text(frame)
    finally:
        got.close()
        want.close()


def test_surface_present_mailbox_draws_newest():
    buf = io.StringIO()
    s = TerminalSurface(16, 8, protocol="ansi", out=buf)
    try:
        for v in (10, 20, 30):
            s.present(np.full((8, 16, 4), v, np.uint8))
        assert _wait_until(lambda: s.encoded_frames >= 1, 5)
        assert s.presented_frames == 3
    finally:
        s.close()
    out = buf.getvalue()
    assert "\x1b[H" in out and "▀" in out


def test_surface_fifo_shows_every_frame():
    buf = io.StringIO()
    s = TerminalSurface(8, 4, protocol="ansi", present_mode="fifo",
                        max_frames_in_flight=2, out=buf)
    try:
        for v in range(5):
            s.present(np.full((4, 8, 4), v * 40, np.uint8))
        assert _wait_until(lambda: s.encoded_frames == 5)
        assert s.dropped_frames == 0
    finally:
        s.close()


def test_renderer_drives_terminal_surface():
    buf = io.StringIO()
    surface = TerminalSurface(64, 48, protocol="ansi", out=buf)
    try:
        _render_frames(surface, 1, shadows=True)
        assert _wait_until(lambda: surface.encoded_frames >= 1, 30)
    finally:
        surface.close()
    assert "▀" in buf.getvalue()


def test_terminal_failure_is_raised():
    """A stream that cannot be written stops the surface, and the next
    present and the close raise."""

    class Broken(io.StringIO):
        def write(self, s):
            raise OSError("terminal gone")

    s = TerminalSurface(8, 4, protocol="ansi", out=Broken())
    s.present(np.zeros((4, 8, 4), np.uint8))
    assert _wait_until(lambda: s._error is not None)
    with pytest.raises(RuntimeError, match="drawing failed"):
        s.present(np.zeros((4, 8, 4), np.uint8))
    with pytest.raises(RuntimeError, match="drawing failed"):
        s.close()
