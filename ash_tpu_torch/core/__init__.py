"""Core scene API: math, transforms, meshes, materials, textures, uniforms.

The port's own copy of ash_tpu/core (numpy only), so that ash_tpu_torch
imports nothing of ash_tpu. The float operations and their order are the
reference's, so a scene built with either package gives the same arrays.
"""

from . import maths
from .material import Material, MaterialDescriptor, MaterialProperties
from .mesh import Mesh, MeshDescriptor, VertexArrays
from .texture import TextureData
from .transform import MVP, Camera, Transform
from .uniform import MaterialUniform, MvpMatrices

__all__ = [
    "maths",
    "Material",
    "MaterialDescriptor",
    "MaterialProperties",
    "Mesh",
    "MeshDescriptor",
    "VertexArrays",
    "TextureData",
    "MVP",
    "Camera",
    "Transform",
    "MaterialUniform",
    "MvpMatrices",
]
