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
    MVP,
    Camera,
    Material,
    MaterialDescriptor,
    MaterialProperties,
    MaterialUniform,
    Mesh,
    MeshDescriptor,
    MvpMatrices,
    TextureData,
    Transform,
    VertexArrays,
    maths,
)
from .device import resolve_device
from .errors import AshError, SwapchainOutOfDate
from .render import (
    UNPORTED_NAMES,
    FileStreamSurface,
    HeadlessSurface,
    LiveViewSurface,
    RenderCommand,
    Renderer,
    RendererConfig,
    SurfaceProvider,
)
from .utils.image import psnr, read_png, write_png

__version__ = "0.1.0"

__all__ = [
    "MVP",
    "Camera",
    "Material",
    "MaterialDescriptor",
    "MaterialProperties",
    "MaterialUniform",
    "Mesh",
    "MeshDescriptor",
    "MvpMatrices",
    "TextureData",
    "Transform",
    "VertexArrays",
    "AshError",
    "SwapchainOutOfDate",
    "__version__",
    "maths",
    "psnr",
    "read_png",
    "write_png",
    "resolve_device",
    "FileStreamSurface",
    "HeadlessSurface",
    "LiveViewSurface",
    "RenderCommand",
    "Renderer",
    "RendererConfig",
    "SurfaceProvider",
]


def __getattr__(name):
    # The reference's names that are not ported yet raise, naming their item.
    if name in UNPORTED_NAMES:
        from . import render

        return getattr(render, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
