"""Build the CUDA sources under ash_tpu_torch/csrc/ at first use, and
call their C entries on PyTorch's current stream.

Each library is compiled by `nvcc` into `build/ash_tpu_torch/` at the root of
the checkout, under a name keyed on a hash of the flags and of every file
under csrc/ (so an edited `.cu` or header rebuilds), and loaded with
`ctypes`. The sources have a plain C interface and include no PyTorch
headers, so a build takes seconds. Nothing here runs at import time: a
machine without CUDA has no `nvcc`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ash_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, into the log
)


def find_nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc or
    `nvcc` on PATH. Raises if none exists."""
    candidates = [
        os.path.join(os.environ[var], "bin", "nvcc")
        for var in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(var)
    ]
    candidates += ["/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for path in candidates:
        if path and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def library_path(name: str) -> pathlib.Path:
    """Where library `name` (built from csrc/<name>.cu) lives for the
    current flags and sources. Every file under csrc/ enters the hash, not
    only <name>.cu, so a changed header never leaves a stale library."""
    if not (CSRC / f"{name}.cu").is_file():
        raise FileNotFoundError(CSRC / f"{name}.cu")
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for path in sorted(p for p in CSRC.rglob("*") if p.is_file()):
        h.update(str(path.relative_to(CSRC)).encode() + b"\0")
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> pathlib.Path:
    """Compile csrc/<name>.cu unless a library for these exact sources
    exists. The compiler's output is kept beside it as `.log`. The library
    is written under a temporary name and renamed into place, so processes
    building at once never load a half-written file."""
    lib = library_path(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load library `name` once per process."""
    return ctypes.CDLL(str(build(name)))


def launch(device: torch.device, entry, *args) -> int:
    """entry(*args, stream) -> its error code: a C entry called on the
    current CUDA stream of `device` (a tensor's, so its index is set). The
    stream comes from PyTorch's raw getter, which its own kernels launch
    with, and not through a Stream object; the runtime, which launches on
    its current device, is switched to `device` only where that is
    another."""
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if torch.cuda.current_device() == device.index:
        return entry(*args, stream)
    with torch.cuda.device(device):
        return entry(*args, stream)
