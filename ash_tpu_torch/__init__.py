"""ash_tpu_torch — the PyTorch + CUDA port of ash_tpu for NVIDIA Hopper.

A second package beside `ash_tpu`, which stays the reference it is tested
against. It imports neither jax nor ash_tpu: the scene API (`Mesh`,
`Material`, `Transform`, `Camera`, `MaterialUniform`, `maths`) is its own
numpy copy in `core/`, as are `errors` and the image helpers in `utils/`.
The renderer runs in PyTorch on the device the caller names, and its
rasterizers are CUDA kernels written for sm_90a (csrc/raster.cu). See
ROADMAP.md for what is ported.
"""

from .core import (
    Camera,
    Material,
    MaterialUniform,
    Mesh,
    Transform,
    maths,
)
from .device import resolve_device
from .render import (
    HeadlessSurface,
    RenderCommand,
    Renderer,
    RendererConfig,
)
from .utils.image import psnr, read_png, write_png

__all__ = [
    "Camera",
    "Material",
    "MaterialUniform",
    "Mesh",
    "Transform",
    "maths",
    "psnr",
    "read_png",
    "write_png",
    "resolve_device",
    "HeadlessSurface",
    "RenderCommand",
    "Renderer",
    "RendererConfig",
]
