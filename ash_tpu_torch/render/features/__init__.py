"""Render features of the port: shadows, lighting, Forward+ light culling
state, the post chain's configs (bloom, tonemapping, post-processing), the
single mesh's auto-rotation and their plugin base."""

from .auto_rotate import AutoRotateFeature
from .bloom import BloomConfig, BloomFeature
from .feature_trait import FeatureFrameContext, FeatureManager, RenderFeature
from .light_culling import GpuLight
from .lighting import (
    DirectionalLight,
    LightingConfig,
    LightingFeature,
    PointLight,
    SpotLight,
)
from .post_processing import PostProcessingConfig, PostProcessingFeature
from .shadows import ShadowFeature
from .tonemapping import TonemapOperator, TonemappingConfig, TonemappingFeature

__all__ = [
    "AutoRotateFeature",
    "BloomConfig",
    "BloomFeature",
    "PostProcessingConfig",
    "PostProcessingFeature",
    "TonemapOperator",
    "TonemappingConfig",
    "TonemappingFeature",
    "FeatureFrameContext",
    "FeatureManager",
    "RenderFeature",
    "GpuLight",
    "DirectionalLight",
    "LightingConfig",
    "LightingFeature",
    "PointLight",
    "SpotLight",
    "ShadowFeature",
]
