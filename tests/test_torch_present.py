"""The asynchronous present of ash_tpu_torch on the CPU: the surfaces take
the frame as the renderer holds it (a tensor) or a host numpy array, the
renderer hands over the tensor and reads the image to the host only at
read_back, and what the surfaces write and read back equals the
reference's (ash_tpu.render.surface, live_view, terminal_surface) on the
same frames.

The reference's read_back after a few frames of the small bench scene is
held to the port's by the bar of the frame parity tests
(tests/test_torch_frame.py): PSNR >= 40 dB. Card tests of the same code:
tests/test_torch_present_cuda.py.
"""

import io
import os
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

from ash_tpu.render import surface as ref_surface
from ash_tpu.render import terminal_surface as ref_term
from ash_tpu.utils.image import psnr
from ash_tpu_torch.render import (
    FileStreamSurface,
    HeadlessSurface,
    LiveViewSurface,
    TerminalSurface,
)
from ash_tpu_torch.render import host_copy
from ash_tpu_torch.render import terminal_surface as term
from ash_tpu_torch.render.bench_scene import build_bench_renderer

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
# The frame parity tests' bar against the reference (test_torch_frame.py).
PSNR_MIN_DB = 40.0


def _frames(n, h=12, w=16, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 4), dtype=np.uint8) for _ in range(n)]


def _as(kind, frame):
    """A frame as the port's renderer presents it ("tensor") or as a host
    numpy array."""
    return torch.from_numpy(frame.copy()) if kind == "tensor" else frame.copy()


def _wait_until(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


# -- FileStreamSurface against the reference's --------------------------------

def _stream_bytes(tmp_path, pattern, n):
    if "{n" in pattern:
        return [open(tmp_path / pattern.format(n=i), "rb").read()
                for i in range(n)]
    return open(tmp_path / pattern, "rb").read()


@pytest.mark.parametrize("kind", ["tensor", "numpy"])
@pytest.mark.parametrize("fmt", ["raw", "png"])
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_file_stream_bytes_equal_the_reference(tmp_path, depth, fmt, kind):
    """The same frames presented to both surfaces: the same frames written
    after each present, the same bytes in the end, the same read_back; a
    resize in the middle flushes both and changes the frame size."""
    pattern = "f_{n:02d}.png" if fmt == "png" else "out.rgba"
    frames = _frames(5) + _frames(3, h=6, w=10, seed=4)
    sides = {}
    for side, cls in (("port", FileStreamSurface),
                      ("ref", ref_surface.FileStreamSurface)):
        d = tmp_path / side
        d.mkdir()
        s = cls(16, 12, str(d / pattern), max_frames_in_flight=depth)
        written = []
        for i, f in enumerate(frames):
            if i == 5:
                s.resize(10, 6)
            s.present(_as(kind, f) if side == "port" else f.copy())
            written.append(s.written_frames)
        last = s.read_back()
        s.close()
        sides[side] = (written, last, _stream_bytes(d, pattern, len(frames)))
    assert sides["port"][0] == sides["ref"][0]
    np.testing.assert_array_equal(sides["port"][1], frames[-1])
    np.testing.assert_array_equal(sides["port"][1], sides["ref"][1])
    assert sides["port"][2] == sides["ref"][2]


def test_file_stream_read_back_is_a_copy(tmp_path):
    """read_back's array is the caller's: later frames reuse the surface's
    host buffers, not it."""
    frames = _frames(6)
    s = FileStreamSurface(16, 12, str(tmp_path / "x.rgba"),
                          max_frames_in_flight=2)
    s.present(torch.from_numpy(frames[0]))
    got = s.read_back()
    for f in frames[1:]:
        s.present(torch.from_numpy(f))
    np.testing.assert_array_equal(got, frames[0])
    s.close()
    raw = np.fromfile(tmp_path / "x.rgba", np.uint8).reshape(6, 12, 16, 4)
    np.testing.assert_array_equal(raw, np.stack(frames))


# -- Every surface takes tensors and numpy arrays -----------------------------

@pytest.mark.parametrize("kind", ["tensor", "numpy"])
@pytest.mark.parametrize("surface", ["headless", "file", "live", "terminal"])
def test_surfaces_take_tensors_and_numpy(tmp_path, monkeypatch, surface,
                                         kind):
    """Each surface holds (or draws) what it was given: the headless and
    file surfaces' read_back, the live view's read_back and /frame.png, and
    the terminal's drawing equal the reference surface's on the same
    frames."""
    frames = _frames(4)
    if surface == "headless":
        s = HeadlessSurface(16, 12)
        assert s.read_back() is None
        for f in frames:
            s.present(_as(kind, f))
        np.testing.assert_array_equal(s.read_back(), frames[-1])
        assert s.read_back() is s.read_back()  # one copy a frame
        ref = ref_surface.HeadlessSurface(16, 12)
        ref.present(frames[-1])
        np.testing.assert_array_equal(s.read_back(), ref.read_back())
        assert s.presented_frames == 4
    elif surface == "file":
        with FileStreamSurface(16, 12, str(tmp_path / "f.rgba")) as s:
            for f in frames:
                s.present(_as(kind, f))
            np.testing.assert_array_equal(s.read_back(), frames[-1])
        raw = np.fromfile(tmp_path / "f.rgba", np.uint8)
        np.testing.assert_array_equal(raw.reshape(4, 12, 16, 4),
                                      np.stack(frames))
    elif surface == "live":
        from PIL import Image

        with LiveViewSurface(16, 12, announce=False, present_mode="fifo",
                             fmt="png") as s:
            for f in frames:
                s.present(_as(kind, f))
            assert _wait_until(lambda: s.encoded_frames == 4)
            np.testing.assert_array_equal(s.read_back(), frames[-1])
            with urllib.request.urlopen(s.url + "frame.png",
                                        timeout=10) as resp:
                png = np.asarray(Image.open(io.BytesIO(resp.read())))
            np.testing.assert_array_equal(png, frames[-1][..., :3])
    else:
        for mod in (term, ref_term):
            monkeypatch.setattr(mod.shutil, "get_terminal_size",
                                lambda fallback: os.terminal_size((40, 12)))
        out = {}
        for side, cls in (("port", TerminalSurface),
                          ("ref", ref_term.TerminalSurface)):
            buf = io.StringIO()
            s = cls(16, 12, protocol="ansi", present_mode="fifo", out=buf)
            for f in frames:
                s.present(_as(kind, f) if side == "port" else f.copy())
            assert _wait_until(lambda: s.encoded_frames == 4)
            s.close()
            out[side] = buf.getvalue()
        assert out["port"] == out["ref"] and "\x1b[H" in out["port"]


@pytest.mark.parametrize("surface", ["live", "terminal"])
def test_mailbox_gives_dropped_frames_buffers_back(surface):
    """Mailbox mode drops the frames the encoder cannot keep up with; each
    dropped or encoded frame's host buffer is free again, so the buffers
    stay those of the ring (the last frame's held for read_back)."""
    s = (LiveViewSurface(8, 8, announce=False) if surface == "live"
         else TerminalSurface(8, 8, protocol="ansi", out=io.StringIO()))
    try:
        for i in range(64):
            s.present(torch.full((8, 8, 4), i, dtype=torch.uint8))
        assert _wait_until(lambda: s.dropped_frames + s.encoded_frames == 64)
        assert s.dropped_frames > 0
        held = 1 if surface == "live" else 0
        assert _wait_until(lambda: len(s._slots._ring[1])
                           == s._slots.count - held)
    finally:
        s.close()


def test_live_view_readers_race_the_render_thread():
    """Eight threads read the live view back while the render thread
    presents 300 frames, under a short switch interval: every copy read is
    one whole frame (a buffer reused while read would mix two), and in the
    end each buffer is free once or held by the last frame."""
    import threading

    s = LiveViewSurface(16, 16, announce=False)
    seen, stop = [], threading.Event()

    def reader():
        while not stop.is_set():
            f = s.read_back()
            if f is not None:
                seen.append(bool((f == f[0, 0, 0]).all()))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=reader) for _ in range(8)]
    try:
        for t in threads:
            t.start()
        for i in range(300):
            s.present(torch.full((16, 16, 4), i % 256, dtype=torch.uint8))
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        sys.setswitchinterval(interval)
    try:
        assert not any(t.is_alive() for t in threads)
        assert seen and all(seen)
        assert _wait_until(lambda: s.dropped_frames + s.encoded_frames
                           == 300)
        free = s._slots._ring[1]
        assert len({id(x) for x in free}) == len(free)
        assert all(x.refs == 0 for x in free) and s._last.refs == 1
        assert s._last not in free
        assert int(s.read_back()[0, 0, 0]) == 299 % 256
    finally:
        s.close()


def test_surfaces_refuse_other_frames():
    for s in (HeadlessSurface(4, 4), FileStreamSurface(4, 4, os.devnull)):
        with pytest.raises(TypeError, match="present takes"):
            s.present([[0] * 4] * 4)


# -- The host buffers ---------------------------------------------------------

def test_host_frames_reuse_and_holders():
    ring = host_copy.HostFrames(2)
    a = ring.copy(torch.zeros((2, 3, 4), dtype=torch.uint8))
    b = ring.copy(np.ones((2, 3, 4), np.uint8))
    assert a.host.data_ptr() != b.host.data_ptr() and a.event is None
    ring.retain(a)
    ring.release(a)
    assert ring._ring[1] == []  # a still held once
    c = ring.copy(torch.full((2, 3, 4), 2, dtype=torch.uint8))
    assert c.host.data_ptr() not in (a.host.data_ptr(), b.host.data_ptr())
    ring.release(a)
    d = ring.copy(torch.full((2, 3, 4), 3, dtype=torch.uint8))
    assert d is a and int(d.pixels()[0, 0, 0]) == 3
    assert int(b.pixels()[0, 0, 0]) == 1
    ring.release(b)
    e = ring.copy(torch.zeros((5, 5, 4), dtype=torch.uint8))  # a new shape
    assert e.host.shape == (5, 5, 4) and e.ring is not b.ring
    ring.release(c)  # a slot of the old ring goes back to the old ring
    assert len(ring._ring[1]) == 1


def test_staging_uploads_on_the_cpu():
    dst = torch.full((10,), -1.0)
    st = host_copy.Staging(2)
    st.upload(dst, [np.arange(3, dtype=np.float32),
                    np.full(4, 7, np.float32)])
    assert dst.tolist() == [0, 1, 2, 7, 7, 7, 7, -1, -1, -1]


# -- The renderer -------------------------------------------------------------

class RecordingSurface(HeadlessSurface):
    """A headless surface that keeps every presented frame."""

    def __init__(self, w, h):
        super().__init__(w, h)
        self.frames = []

    def present(self, frame):
        self.frames.append(frame)
        super().present(frame)


def test_render_frame_presents_the_tensor_and_reads_only_at_read_back(
        monkeypatch):
    r, _, cam, _ = build_bench_renderer(64, 48, 8, "cpu")
    surface = RecordingSurface(64, 48)
    r.surface = surface
    reads = []
    for name in ("cpu", "numpy"):
        real = getattr(torch.Tensor, name)

        def read(self, *a, _real=real, _name=name, **kw):
            for i, f in enumerate(surface.frames):
                if self is f:
                    reads.append(i)
            return _real(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, read)
    view, proj = cam.view_matrix(), cam.projection_matrix()
    outs = [r.render_frame(view, proj, cam.position) for _ in range(3)]
    assert len(surface.frames) == 3
    for f, o in zip(surface.frames, outs):
        assert isinstance(f, torch.Tensor) and f is o.image
        assert f.shape == (48, 64, 4) and f.dtype == torch.uint8
    assert reads == []  # nothing read to the host by render_frame
    img = r.read_back()
    assert set(reads) == {2}
    n = len(reads)
    assert r.read_back() is img and len(reads) == n  # one copy a frame
    assert torch.equal(torch.from_numpy(img), outs[-1].image)
    r.render_frame(view, proj, cam.position)
    assert len(reads) == n
    assert r.read_back() is not img and set(reads[n:]) == {3}


def test_read_back_before_any_frame():
    r, _, _, _ = build_bench_renderer(64, 48, 8, "cpu")
    assert r.read_back() is None


def test_read_back_matches_the_reference_after_three_frames():
    """Three frames of the small bench scene at 160x120 (16 cubes), the
    camera turning about the scene: the port's read_back holds the last
    frame, within the frame parity bar of ash_tpu's read_back of the same
    three frames, and unlike the first."""
    sys.path.insert(0, os.path.dirname(TESTS))
    import bench

    r, _, cam, extent = build_bench_renderer(160, 120, 16, "cpu")
    rr, _, _, _ = bench.build_bench_renderer(160, 120, 16, use_pallas=False)
    d = np.asarray(cam.position, np.float32)
    proj = cam.projection_matrix()
    firsts = []
    for i in range(3):
        a = 0.15 * i
        cam.position = np.array([np.cos(a) * d[0] + np.sin(a) * d[2], d[1],
                                 np.cos(a) * d[2] - np.sin(a) * d[0]],
                                np.float32)
        view = cam.view_matrix()
        r.render_frame(view, proj, cam.position)
        rr.render_frame(view, proj, cam.position)
        if i == 0:
            firsts = (r.read_back().copy(), rr.read_back().copy())
    got, want = r.read_back(), rr.read_back()
    assert got.shape == want.shape == (120, 160, 4)
    value = psnr(got, want)
    assert value >= PSNR_MIN_DB, f"PSNR {value:.1f} dB < {PSNR_MIN_DB} dB"
    assert not np.array_equal(got, firsts[0])
    assert psnr(firsts[0], firsts[1]) >= PSNR_MIN_DB
