"""Image IO + quality metrics (PSNR for golden-frame parity tests)."""

from __future__ import annotations

import numpy as np


def to_u8(img: np.ndarray) -> np.ndarray:
    """float [0,1] -> uint8 with round-to-nearest (matches UNORM stores)."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    return np.clip(np.asarray(img, np.float32) * 255.0 + 0.5, 0, 255).astype(
        np.uint8
    )


def write_png(path: str, img: np.ndarray) -> None:
    """Write (H, W, 3|4) image (uint8 or float [0,1]) to a PNG file."""
    from PIL import Image

    arr = to_u8(img)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    Image.fromarray(arr).save(path)


def read_png(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGBA"))


def psnr(a: np.ndarray, b: np.ndarray, peak: float | None = None) -> float:
    """Peak signal-to-noise ratio in dB.

    `peak=None` infers the scale from the DTYPE: integer inputs use their
    type's full range (255 for uint8), floats use 1.0. An explicit peak is
    always honored. (The previous value-based `max() > 2.0` heuristic
    mis-scored dark u8 frames as catastrophically bad and silently
    overrode explicit peaks on HDR buffers.)"""
    arr_a, arr_b = np.asarray(a), np.asarray(b)
    if peak is None:
        if np.issubdtype(arr_a.dtype, np.integer) or np.issubdtype(
            arr_b.dtype, np.integer
        ):
            peak = float(np.iinfo(
                arr_a.dtype if np.issubdtype(arr_a.dtype, np.integer)
                else arr_b.dtype
            ).max)
        else:
            peak = 1.0
    mse = np.mean(
        (np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2
    )
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))
