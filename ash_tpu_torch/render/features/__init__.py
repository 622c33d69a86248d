"""Render features of the port: shadows, lighting, Forward+ light culling
state and their plugin base."""

from .feature_trait import FeatureFrameContext, FeatureManager, RenderFeature
from .light_culling import GpuLight
from .lighting import (
    DirectionalLight,
    LightingConfig,
    LightingFeature,
    PointLight,
    SpotLight,
)
from .shadows import ShadowFeature

__all__ = [
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
