"""Terminal present surface: frames drawn into the terminal over plain SSH
(port of ash_tpu/render/terminal_surface.py).

`TerminalSurface` keeps the SurfaceProvider contract and draws each
presented frame with, in order of fidelity:

- "kitty": the kitty graphics protocol (base64 RGBA, pixel-exact);
- "sixel": DEC sixel with the 6x6x6 colour cube (216 registers);
- "ansi":  truecolor half-block cells (two pixels per character under the
           upper-half-block glyph), for any 24-bit-colour terminal.

protocol="auto" reads $TERM and $KITTY_WINDOW_ID and falls back to "ansi".
Present modes are the swapchain's, as in LiveViewSurface: "mailbox" (the
default) never blocks and draws the newest frame, "fifo" draws every frame
with bounded back-pressure. Frames arrive as host numpy arrays and are
downscaled on the host to the terminal grid by area averaging. The three
encoders write bytes and escape codes directly, with no third-party
library. If drawing fails, the next `present` or `close` raises its error.
"""

from __future__ import annotations

import base64
import os
import shutil
import sys
import threading
from typing import Optional, Tuple

import numpy as np


def detect_protocol() -> str:
    """Best-effort sniff of the hosting terminal's richest protocol."""
    term = os.environ.get("TERM", "")
    if os.environ.get("KITTY_WINDOW_ID") or "kitty" in term or (
        "ghostty" in term
    ):
        return "kitty"
    if "sixel" in term or os.environ.get("ASH_TERM_SIXEL"):
        return "sixel"
    return "ansi"


def _downscale(px: np.ndarray, w: int, h: int) -> np.ndarray:
    """Area-ish downscale of (H, W, C) u8 to (h, w, C) via index-mean
    pooling (exact area mean when divisible, strided mean otherwise)."""
    H, W = px.shape[:2]
    if (H, W) == (h, w):
        return px
    ys = np.linspace(0, H, h + 1).astype(np.int64)
    xs = np.linspace(0, W, w + 1).astype(np.int64)
    # Mean over each cell's pixel block via summed-area table: exact area
    # averaging at any ratio, fully vectorized.
    sat = np.zeros((H + 1, W + 1, px.shape[2]), np.float64)
    np.cumsum(np.cumsum(px, axis=0), axis=1, out=sat[1:, 1:])
    a = sat[ys[:-1]][:, xs[:-1]]
    b = sat[ys[1:]][:, xs[1:]]
    c = sat[ys[:-1]][:, xs[1:]]
    d = sat[ys[1:]][:, xs[:-1]]
    counts = (
        (ys[1:] - ys[:-1])[:, None] * (xs[1:] - xs[:-1])[None, :]
    ).astype(np.float64)[..., None]
    out = (a + b - c - d) / np.maximum(counts, 1)
    return np.clip(out, 0, 255).astype(np.uint8)


def encode_ansi_halfblock(px: np.ndarray) -> str:
    """(H, W, 3) u8 -> truecolor half-block escape string (H must be even;
    two pixel rows per text row via the upper-half-block glyph)."""
    H, W = px.shape[:2]
    if H % 2:
        px = px[:-1]
        H -= 1
    top = px[0::2]
    bot = px[1::2]
    lines = []
    for y in range(H // 2):
        parts = []
        last = None
        for x in range(W):
            tr, tg, tb = top[y, x]
            br, bg, bb = bot[y, x]
            key = (tr, tg, tb, br, bg, bb)
            if key != last:
                parts.append(
                    f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m"
                )
                last = key
            parts.append("▀")
        parts.append("\x1b[0m")
        lines.append("".join(parts))
    return "\r\n".join(lines)


def encode_kitty(px: np.ndarray) -> str:
    """(H, W, 3/4) u8 -> kitty graphics-protocol escape string (one
    transmit-and-display image, chunked base64)."""
    H, W = px.shape[:2]
    if px.shape[2] == 3:
        fmt = 24
        payload = px.tobytes()
    else:
        fmt = 32
        payload = px.tobytes()
    data = base64.standard_b64encode(payload).decode("ascii")
    chunks = [data[i:i + 4096] for i in range(0, len(data), 4096)] or [""]
    out = []
    first = (
        f"\x1b_Ga=T,f={fmt},s={W},v={H},q=2,"
        f"m={1 if len(chunks) > 1 else 0};{chunks[0]}\x1b\\"
    )
    out.append(first)
    for i, ch in enumerate(chunks[1:]):
        m = 1 if i < len(chunks) - 2 else 0
        out.append(f"\x1b_Gm={m};{ch}\x1b\\")
    return "".join(out)


def encode_sixel(px: np.ndarray) -> str:
    """(H, W, 3) u8 -> sixel escape string using the 6x6x6 color cube
    (216 registers). Vectorized per 6-row band: each used color's bitmask
    column pattern becomes run-length-encoded sixel characters."""
    H, W = px.shape[:2]
    q = (
        (px[..., 0].astype(np.int32) // 43) * 36
        + (px[..., 1].astype(np.int32) // 43) * 6
        + (px[..., 2].astype(np.int32) // 43)
    )  # (H, W) color indices 0..215
    out = ["\x1bPq"]
    # Color registers: sixel wants 0-100 scale.
    for c in range(216):
        r = (c // 36) * 20
        g = (c // 6 % 6) * 20
        b = (c % 6) * 20
        out.append(f"#{c};2;{r};{g};{b}")
    weights = (1 << np.arange(6)).astype(np.int32)
    for y0 in range(0, H, 6):
        band = q[y0:y0 + 6]
        rows = band.shape[0]
        used = np.unique(band)
        for ci, c in enumerate(used):
            mask = (band == c).astype(np.int32)  # (rows, W)
            bits = (mask * weights[:rows, None]).sum(axis=0)  # (W,)
            chars = (bits + 63).astype(np.uint8).tobytes().decode("latin1")
            # Run-length encode: !<n><char> for runs > 3.
            enc = []
            i = 0
            while i < W:
                j = i + 1
                while j < W and chars[j] == chars[i]:
                    j += 1
                n = j - i
                if n > 3:
                    enc.append(f"!{n}{chars[i]}")
                else:
                    enc.append(chars[i] * n)
                i = j
            prefix = "$" if ci else ""  # carriage return between colors
            out.append(f"{prefix}#{c}{''.join(enc)}")
        out.append("-")  # next band
    out.append("\x1b\\")
    return "".join(out)


class TerminalSurface:
    """Render-to-terminal SurfaceProvider (see module docstring).

    Parameters
    ----------
    width, height: RENDER extent in pixels (what the renderer produces).
    protocol: "auto" | "kitty" | "sixel" | "ansi".
    present_mode: "mailbox" (newest frame wins, never blocks) or "fifo"
        (every frame, blocks when the encode queue is full).
    fit_terminal: downscale frames to the current terminal grid (default);
        False draws at native size (kitty/sixel only — ansi always fits).
    out: writable text stream (default sys.stdout).
    """

    def __init__(
        self,
        width: int,
        height: int,
        protocol: str = "auto",
        present_mode: str = "mailbox",
        fit_terminal: bool = True,
        max_frames_in_flight: int = 2,
        out=None,
    ):
        if width <= 0 or height <= 0:
            raise ValueError(f"bad surface extent {width}x{height}")
        if present_mode not in ("mailbox", "fifo"):
            raise ValueError(f"unknown present_mode {present_mode!r}")
        if protocol not in ("auto", "kitty", "sixel", "ansi"):
            raise ValueError(f"unknown protocol {protocol!r}")
        self._size = (int(width), int(height))
        self.protocol = detect_protocol() if protocol == "auto" else protocol
        self._mode = present_mode
        self._fit = fit_terminal
        self._out = out if out is not None else sys.stdout
        self._depth = max(int(max_frames_in_flight), 1)

        self._lock = threading.Condition()
        self._pending = []
        self._closing = False
        self._error: Optional[BaseException] = None
        self.presented_frames = 0
        self.encoded_frames = 0
        self.dropped_frames = 0
        self._wrote_setup = False

        self._encoder = threading.Thread(
            target=self._encode_loop, name="ash-term-encode", daemon=True
        )
        self._encoder.start()

    # --- SurfaceProvider contract -------------------------------------
    def physical_size(self) -> Tuple[int, int]:
        return self._size

    def resize(self, width: int, height: int) -> None:
        self._size = (int(width), int(height))

    def present(self, frame: np.ndarray) -> None:
        with self._lock:
            self._raise_encoder_error()
            if self._closing:
                return
            self.presented_frames += 1
            if self._mode == "mailbox":
                if self._pending:
                    self.dropped_frames += len(self._pending)
                self._pending = [frame]
            else:
                while (
                    len(self._pending) >= self._depth and not self._closing
                ):
                    self._lock.wait(0.1)
                self._pending.append(frame)
            self._lock.notify_all()

    # --- encode/draw loop ---------------------------------------------
    def _target_cells(self) -> Tuple[int, int]:
        cols, rows = shutil.get_terminal_size((100, 40))
        return max(cols - 1, 8), max(rows - 2, 4)

    def _frame_text(self, pixels: np.ndarray) -> str:
        if pixels.shape[-1] == 4:
            pixels = pixels[..., :3]
        if self.protocol == "ansi":
            cols, rows = self._target_cells()
            w = min(cols, pixels.shape[1])
            h = max((min(rows * 2, pixels.shape[0]) // 2) * 2, 2)
            small = _downscale(pixels, w, h)
            return encode_ansi_halfblock(small)
        if self._fit:
            # Assume ~10x20 px cells for pixel protocols.
            cols, rows = self._target_cells()
            max_w, max_h = cols * 10, rows * 20
            H, W = pixels.shape[:2]
            scale = min(max_w / W, max_h / H, 1.0)
            if scale < 1.0:
                pixels = _downscale(
                    pixels, max(int(W * scale), 8), max(int(H * scale), 8)
                )
        if self.protocol == "kitty":
            return encode_kitty(pixels)
        return encode_sixel(pixels)

    def _encode_loop(self) -> None:
        try:
            while True:
                with self._lock:
                    while not self._pending and not self._closing:
                        self._lock.wait(0.25)
                    if self._closing and not self._pending:
                        return
                    frame = self._pending.pop(0)
                    self._lock.notify_all()
                text = self._frame_text(frame)
                if not self._wrote_setup:
                    self._out.write("\x1b[?25l")  # hide cursor
                    self._wrote_setup = True
                self._out.write("\x1b[H")  # cursor home, draw over
                self._out.write(text)
                self._out.flush()
                self.encoded_frames += 1
        except BaseException as e:
            # A fifo present() waits on this thread: stop everything and
            # hand the error to the next present() or close().
            with self._lock:
                self._error = e
                self._closing = True
                self._pending.clear()
                self._lock.notify_all()

    def _raise_encoder_error(self) -> None:
        if self._error is not None:
            raise RuntimeError("terminal surface: drawing failed") \
                from self._error

    def read_back(self) -> Optional[np.ndarray]:
        return None  # frames go to the terminal, not memory

    def close(self) -> None:
        with self._lock:
            self._closing = True
            self._lock.notify_all()
        self._encoder.join(timeout=5.0)
        if self._wrote_setup:
            self._out.write("\x1b[?25h\x1b[0m\n")  # restore cursor
            self._out.flush()
        with self._lock:
            self._raise_encoder_error()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
