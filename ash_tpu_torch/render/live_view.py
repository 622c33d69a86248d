"""Live display seam: an HTTP viewer surface for watching renders in real
time (port of ash_tpu/render/live_view.py).

The reference presents through a window and a Vulkan swapchain. On a host
with no window system the window is a network seam: `LiveViewSurface` runs
a `ThreadingHTTPServer` on loopback in a daemon thread, and a browser (or
`curl`) at the printed URL, through an SSH tunnel, becomes the display::

    surface = LiveViewSurface(1920, 1080)   # prints the URL
    r = Renderer(surface, ...)
    while True: r.render_frame(view, proj, eye)

Endpoints:

- ``/``          the HTML page with the live <img> stream and counters;
- ``/stream``    a ``multipart/x-mixed-replace`` JPEG (or PNG) stream;
- ``/frame.png`` the latest frame as one PNG;
- ``/stats``     JSON: presented, encoded and dropped counters, the size.

Present modes, as the swapchain's:

- ``"mailbox"`` (default): `present` stores the frame as the newest and
  never blocks; an encoder thread encodes whatever is newest and frames the
  display cannot keep up with are dropped;
- ``"fifo"``: every frame is encoded in order, and `present` blocks while
  `max_frames_in_flight` encodes are outstanding.

Frames arrive as host numpy arrays (the renderer copies each frame off the
device once). If the encoder fails, the next `present` or `close` raises
its error.
"""

from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np

_PAGE = """<!doctype html><html><head><title>ash_tpu_torch live view</title>
<style>body{margin:0;background:#111;color:#ddd;font:13px monospace}
#bar{padding:6px 10px}img{display:block;max-width:100vw}</style></head>
<body><div id="bar">ash_tpu_torch live view &mdash; <span id="st">...</span></div>
<img src="/stream"><script>
setInterval(async()=>{try{const r=await fetch('/stats');const s=await r.json();
document.getElementById('st').textContent=
`${s.width}x${s.height}  presented ${s.presented_frames}  encoded `+
`${s.encoded_frames}  dropped ${s.dropped_frames}  clients ${s.clients}`;
}catch(e){}},1000);</script></body></html>"""


def _encode(pixels: np.ndarray, fmt: str, quality: int) -> bytes:
    from PIL import Image

    if pixels.shape[-1] == 4:
        pixels = pixels[..., :3]  # browsers want opaque; alpha is coverage
    im = Image.fromarray(pixels)
    buf = io.BytesIO()
    if fmt == "jpeg":
        im.save(buf, "JPEG", quality=quality)
    else:
        im.save(buf, "PNG")
    return buf.getvalue()


class LiveViewSurface:
    """HTTP live-view surface (see module docstring).

    Parameters
    ----------
    width, height: surface extent in pixels (physical_size contract,
        reference surface_provider.rs:21-23).
    port: TCP port; 0 picks a free one (printed + available as ``.url``).
    host: bind address; default loopback (tunnel it; do not expose a raw
        frame stream on an open network).
    present_mode: "mailbox" (default, non-blocking, frame-dropping) or
        "fifo" (every frame, bounded back-pressure) — swapchain.rs:112.
    fmt: "jpeg" (small, fast) or "png" (lossless) stream encoding.
    """

    def __init__(
        self,
        width: int,
        height: int,
        port: int = 0,
        host: str = "127.0.0.1",
        present_mode: str = "mailbox",
        fmt: str = "jpeg",
        quality: int = 85,
        max_frames_in_flight: int = 2,
        announce: bool = True,
    ):
        if width <= 0 or height <= 0:
            raise ValueError(f"bad surface extent {width}x{height}")
        if present_mode not in ("mailbox", "fifo"):
            raise ValueError(f"unknown present_mode {present_mode!r}")
        if fmt not in ("jpeg", "png"):
            raise ValueError(f"unknown fmt {fmt!r}")
        self._size = (int(width), int(height))
        self._mode = present_mode
        self._fmt = fmt
        self._quality = int(quality)
        self._depth = max(int(max_frames_in_flight), 1)

        self._lock = threading.Condition()
        self._pending = []  # fifo: frames awaiting encode; mailbox: [newest]
        self._encoded: Optional[bytes] = None  # latest encoded frame
        self._encoded_seq = 0  # bumps per encode; stream waiters watch it
        self._closing = False
        self._error: Optional[BaseException] = None
        self._last: Optional[np.ndarray] = None
        self.presented_frames = 0
        self.encoded_frames = 0
        self.dropped_frames = 0
        self._clients = 0

        self._encoder = threading.Thread(
            target=self._encode_loop, name="ash-live-encode", daemon=True
        )
        self._server = ThreadingHTTPServer(
            (host, int(port)), self._make_handler()
        )
        self._server.daemon_threads = True
        self._http = threading.Thread(
            target=self._server.serve_forever, name="ash-live-http",
            daemon=True,
        )
        self.url = f"http://{host}:{self._server.server_address[1]}/"
        self._encoder.start()
        self._http.start()
        if announce:
            print(f"ash_tpu_torch live view: {self.url}")

    # --- SurfaceProvider contract -------------------------------------
    def physical_size(self) -> Tuple[int, int]:
        return self._size

    def resize(self, width: int, height: int) -> None:
        self._size = (int(width), int(height))

    def present(self, frame: np.ndarray) -> None:
        """Accept a finished (H, W, 4) uint8 frame on the host.

        Mailbox: replace the pending slot, never block. Fifo: append; block
        while `max_frames_in_flight` frames are already awaiting encode."""
        with self._lock:
            self._raise_encoder_error()
            self.presented_frames += 1
            self._last = frame
            if self._mode == "mailbox":
                if self._pending:
                    self._pending[0] = frame
                    self.dropped_frames += 1
                else:
                    self._pending.append(frame)
            else:
                while len(self._pending) >= self._depth and not self._closing:
                    self._lock.wait(0.1)
                self._raise_encoder_error()
                self._pending.append(frame)
            self._lock.notify_all()

    def read_back(self) -> Optional[np.ndarray]:
        return self._last

    def _raise_encoder_error(self) -> None:
        if self._error is not None:
            raise RuntimeError("live view: the encoder thread failed") \
                from self._error

    # --- encoder thread -------------------------------------------------
    def _encode_loop(self) -> None:
        try:
            while True:
                with self._lock:
                    while not self._pending and not self._closing:
                        self._lock.wait(0.25)
                    if self._closing and not self._pending:
                        return
                    frame = self._pending.pop(0)
                    self._lock.notify_all()  # unblock fifo present()
                data = _encode(frame, self._fmt, self._quality)
                with self._lock:
                    self._encoded = data
                    self._encoded_seq += 1
                    self.encoded_frames += 1
                    self._lock.notify_all()  # wake stream clients
        except BaseException as e:
            # A fifo present() waits on this thread: stop everything and
            # hand the error to the next present() or close().
            with self._lock:
                self._error = e
                self._closing = True
                self._pending.clear()
                self._lock.notify_all()

    # --- HTTP -------------------------------------------------------------
    def _wait_frame(self, after_seq: int, timeout: float = 5.0):
        """Block until a frame newer than `after_seq` exists (or timeout).
        Returns (bytes, seq) — (None, after_seq) on timeout/close."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while (
                self._encoded_seq <= after_seq
                and not self._closing
                and time.monotonic() < deadline
            ):
                self._lock.wait(0.25)
            if self._encoded_seq > after_seq and self._encoded is not None:
                return self._encoded, self._encoded_seq
            return None, after_seq

    def _make_handler(self):
        surface = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet by default
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    self._send(200, "text/html", _PAGE.encode())
                elif self.path == "/stats":
                    with surface._lock:
                        st = {
                            "width": surface._size[0],
                            "height": surface._size[1],
                            "presented_frames": surface.presented_frames,
                            "encoded_frames": surface.encoded_frames,
                            "dropped_frames": surface.dropped_frames,
                            "clients": surface._clients,
                            "format": surface._fmt,
                            "present_mode": surface._mode,
                        }
                    self._send(200, "application/json",
                               json.dumps(st).encode())
                elif self.path == "/frame.png":
                    frame = surface.read_back()
                    if frame is None:
                        self._send(503, "text/plain", b"no frame yet")
                        return
                    self._send(200, "image/png", _encode(frame, "png", 0))
                elif self.path == "/stream":
                    ctype = (
                        "image/jpeg" if surface._fmt == "jpeg"
                        else "image/png"
                    )
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=ashframe",
                    )
                    self.end_headers()
                    with surface._lock:
                        surface._clients += 1
                    seq = 0
                    try:
                        while not surface._closing:
                            data, seq = surface._wait_frame(seq)
                            if data is None:
                                continue
                            self.wfile.write(
                                b"--ashframe\r\n"
                                + f"Content-Type: {ctype}\r\n"
                                  f"Content-Length: {len(data)}"
                                  "\r\n\r\n".encode()
                                + data + b"\r\n"
                            )
                            self.wfile.flush()
                    except (BrokenPipeError, ConnectionResetError):
                        pass  # viewer closed the tab
                    finally:
                        with surface._lock:
                            surface._clients -= 1
                else:
                    self._send(404, "text/plain", b"not found")

        return Handler

    # --- lifecycle ----------------------------------------------------
    def close(self) -> None:
        with self._lock:
            self._closing = True
            self._lock.notify_all()
        self._server.shutdown()
        self._server.server_close()
        self._encoder.join(timeout=5)
        with self._lock:
            self._raise_encoder_error()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
