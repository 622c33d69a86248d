"""Device policy: the caller names the device, and nothing falls back.

`resolve_device("cuda")` on a machine without CUDA raises instead of
quietly running on the CPU: a frame that silently moved to the host would
report host timings under a GPU's name. The CPU is a first-class device for
the parity tests, but only when asked for by name.

`constant` keeps the small tables a frame reads (a clear colour, a corner
sign table) on their device, made once, so a frame makes no host-to-device
copy and can be captured in a CUDA graph (render/compiled.py).
"""

from __future__ import annotations

import numpy as np
import torch

_CONSTANTS: dict = {}


def constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """torch.tensor(values, dtype=dtype, device=device), made on the first
    call for these values and shared by every later one. The result is
    read-only by contract: no caller may write to it."""
    device = torch.device(device)
    arr = np.asarray(values)
    key = (arr.shape, arr.dtype.str, arr.tobytes(), dtype, device)
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.tensor(values, dtype=dtype, device=device)
    return t


def resolve_device(device) -> torch.device:
    """Validate and normalise a device spec ("cuda", "cuda:0", "cpu", or a
    torch.device). Raises RuntimeError for a CUDA device that is absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the host"
            )
        index = 0 if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {device!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) exist"
            )
        return torch.device("cuda", index)
    if dev.type != "cpu":
        raise RuntimeError(f"unsupported device {device!r}")
    return dev
