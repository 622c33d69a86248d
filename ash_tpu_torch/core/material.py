"""Material types (reference: src/renderer/resources/material.rs).

Defaults match the reference exactly: white base color, roughness 0.5,
metallic 0.0, no emissive, occlusion_strength 1.0, normal_scale 1.0
(material.rs:15-27).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass
class Material:
    """PBR material (reference: material.rs:5-27)."""

    name: str = "default"
    color: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    roughness: float = 0.5
    metallic: float = 0.0
    emissive: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)
    occlusion_strength: float = 1.0
    normal_scale: float = 1.0
    # > 0 enables alpha-test (cutout) rendering against the base texture's
    # alpha (glTF alphaMode MASK; the reference carries this through
    # MaterialUniform.alpha_cutoff, uniform.rs:28-39).
    alpha_cutoff: float = 0.0

    @staticmethod
    def with_color(name: str, color) -> "Material":
        """Reference: material.rs:31-41."""
        return Material(name=name, color=tuple(float(c) for c in color))


@dataclasses.dataclass
class MaterialProperties:
    """Surface factors extracted from GLTF materials
    (reference: src/renderer/resources/mesh.rs:44-65)."""

    base_color_factor: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    metallic_factor: float = 0.0
    roughness_factor: float = 0.5
    emissive_factor: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)
    occlusion_strength: float = 1.0
    normal_scale: float = 1.0
    alpha_cutoff: float = 0.0  # glTF alphaMode MASK threshold; 0 = off

    def to_material(self, name: str = "gltf") -> Material:
        return Material(
            name=name,
            color=tuple(self.base_color_factor),
            roughness=self.roughness_factor,
            metallic=self.metallic_factor,
            emissive=tuple(self.emissive_factor),
            occlusion_strength=self.occlusion_strength,
            normal_scale=self.normal_scale,
            alpha_cutoff=self.alpha_cutoff,
        )

    @staticmethod
    def from_material(mat: Material) -> "MaterialProperties":
        return MaterialProperties(
            base_color_factor=tuple(mat.color),
            metallic_factor=mat.metallic,
            roughness_factor=mat.roughness,
            emissive_factor=tuple(mat.emissive),
            occlusion_strength=mat.occlusion_strength,
            normal_scale=mat.normal_scale,
            alpha_cutoff=mat.alpha_cutoff,
        )


@dataclasses.dataclass
class MaterialDescriptor:
    """Material registration payload (reference: mesh.rs:38-41)."""

    material: Material
