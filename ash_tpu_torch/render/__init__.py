"""High-level renderer of the port: Renderer, surfaces, scene packing and
the frame pipeline."""

from .csm import CascadedShadowMap, CsmConfig
from .frame import FrameConfig, FrameOutputs, FrameUniforms
from .live_view import LiveViewSurface
from .renderer import MsaaPreset, RenderCommand, Renderer, RendererConfig
from .scene import DrawItem, SceneBuffers, build_scene, scene_from_numpy
from .shadow_map import ShadowConfig
from .surface import FileStreamSurface, HeadlessSurface, SurfaceProvider
from .temporal_aa import TaaConfig, TemporalAA
from .terminal_surface import TerminalSurface

__all__ = [
    "CascadedShadowMap",
    "CsmConfig",
    "FrameConfig",
    "FrameOutputs",
    "FrameUniforms",
    "MsaaPreset",
    "RenderCommand",
    "Renderer",
    "RendererConfig",
    "DrawItem",
    "SceneBuffers",
    "build_scene",
    "scene_from_numpy",
    "ShadowConfig",
    "FileStreamSurface",
    "HeadlessSurface",
    "LiveViewSurface",
    "TerminalSurface",
    "SurfaceProvider",
    "TaaConfig",
    "TemporalAA",
]

# Names of the reference's render package that are not ported yet, with the
# ROADMAP.md item of each. Importing one raises NotImplementedError. (None
# is left: chunked geometry, A16, adds no name here.)
UNPORTED_NAMES: dict = {}


def __getattr__(name):
    if name in UNPORTED_NAMES:
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP.md {UNPORTED_NAMES[name]})")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
