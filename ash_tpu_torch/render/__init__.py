"""High-level renderer of the port: Renderer, surfaces, scene packing and
the frame pipeline."""

from .csm import CascadedShadowMap, CsmConfig
from .frame import FrameConfig, FrameOutputs, FrameUniforms
from .renderer import RenderCommand, Renderer, RendererConfig
from .scene import DrawItem, SceneBuffers, build_scene, scene_from_numpy
from .shadow_map import ShadowConfig
from .surface import HeadlessSurface, SurfaceProvider
from .temporal_aa import TaaConfig, TemporalAA

__all__ = [
    "CascadedShadowMap",
    "CsmConfig",
    "FrameConfig",
    "FrameOutputs",
    "FrameUniforms",
    "RenderCommand",
    "Renderer",
    "RendererConfig",
    "DrawItem",
    "SceneBuffers",
    "build_scene",
    "scene_from_numpy",
    "ShadowConfig",
    "HeadlessSurface",
    "SurfaceProvider",
    "TaaConfig",
    "TemporalAA",
]

# Names of the reference's render package that are not ported yet, with the
# ROADMAP.md item of each. Importing one raises NotImplementedError.
UNPORTED_NAMES = {
    "MsaaPreset": "A15, MSAA",
    "FileStreamSurface": "A17, surfaces",
    "LiveViewSurface": "A17, surfaces",
    "TerminalSurface": "A17, surfaces",
}


def __getattr__(name):
    if name in UNPORTED_NAMES:
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP.md {UNPORTED_NAMES[name]})")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
