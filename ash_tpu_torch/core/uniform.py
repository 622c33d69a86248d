"""Per-frame and per-material uniform blocks.

TPU-native re-design of reference src/renderer/resources/uniform.rs. The
reference persistently maps Vulkan UBOs and memcpys these structs every frame
(uniform.rs:230-257); here they are plain pytrees of arrays passed straight
into the jitted frame function — "uniforms" are just kernel arguments.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import maths


@dataclasses.dataclass
class MvpMatrices:
    """Frame uniform block (reference: uniform.rs:11-22, consumed by
    shaders/vert.vert:17-28 and shaders/frag.frag:12-23).

    All matrices (4,4) float32 row-major; vectors are length-4 float32
    (xyz + pad), matching the std140 vec4 layout.
    """

    model: np.ndarray
    view: np.ndarray
    projection: np.ndarray
    view_proj: np.ndarray
    light_space_matrix: np.ndarray
    normal_matrix: np.ndarray
    camera_pos: np.ndarray
    light_direction: np.ndarray
    light_color: np.ndarray
    ambient_color: np.ndarray

    @staticmethod
    def identity() -> "MvpMatrices":
        eye = maths.mat4_identity()
        zero4 = np.zeros(4, np.float32)
        return MvpMatrices(
            model=eye.copy(),
            view=eye.copy(),
            projection=eye.copy(),
            view_proj=eye.copy(),
            light_space_matrix=eye.copy(),
            normal_matrix=eye.copy(),
            camera_pos=zero4.copy(),
            light_direction=zero4.copy(),
            light_color=np.ones(4, np.float32),
            ambient_color=zero4.copy(),
        )

    @staticmethod
    def compute(
        model: np.ndarray,
        view: np.ndarray,
        projection: np.ndarray,
        camera_pos,
        light_direction,
        light_color,
        ambient_color,
        light_space_matrix: np.ndarray | None = None,
    ) -> "MvpMatrices":
        """Assemble the frame block the way render_frame does
        (reference: renderer.rs:1641-1656): view_proj = proj @ view,
        normal_matrix = (model^-1)^T."""

        def v4(v):
            v = np.asarray(v, np.float32).reshape(-1)
            out = np.zeros(4, np.float32)
            out[: v.shape[0]] = v[:4]
            return out

        return MvpMatrices(
            model=np.asarray(model, np.float32),
            view=np.asarray(view, np.float32),
            projection=np.asarray(projection, np.float32),
            view_proj=(projection @ view).astype(np.float32),
            light_space_matrix=(
                np.asarray(light_space_matrix, np.float32)
                if light_space_matrix is not None
                else maths.mat4_identity()
            ),
            normal_matrix=maths.normal_matrix(np.asarray(model, np.float32)),
            camera_pos=v4(camera_pos),
            light_direction=v4(light_direction),
            light_color=v4(light_color),
            ambient_color=v4(ambient_color),
        )


# Fields of the packed per-draw material record, in order. One row of the
# (D, MATERIAL_RECORD_SIZE) float32 scene material table corresponds to one
# reference MaterialUniform (uniform.rs:28-39).
MATERIAL_FIELDS = (
    "base_color_factor",  # 4
    "emissive_factor",  # 4
    "params",  # 4: metallic, roughness, occlusion_strength, normal_scale
    "texture_indices",  # 4: base_color, normal, metallic_roughness, occlusion
    "emissive_index_alpha_cutoff",  # 2 (offsets 16, 17 — no padding;
    # ops/shade.py reads the record at exactly these offsets)
)
MATERIAL_RECORD_SIZE = 18  # 4 + 4 + 4 + 4 + 2


@dataclasses.dataclass
class MaterialUniform:
    """Per-draw material block (reference: uniform.rs:28-39, consumed by
    shaders/frag.frag:25-37). Texture indices use -1 for "no texture"
    (frag.frag:125-127)."""

    base_color_factor: np.ndarray  # (4,) f32
    emissive_factor: np.ndarray  # (4,) f32
    params: np.ndarray  # (4,) f32: metallic, roughness, occlusion, normal_scale
    base_color_index: int = -1
    normal_map_index: int = -1
    metallic_roughness_index: int = -1
    occlusion_index: int = -1
    emissive_index: int = -1
    alpha_cutoff: float = 0.0

    @staticmethod
    def default() -> "MaterialUniform":
        return MaterialUniform(
            base_color_factor=np.ones(4, np.float32),
            emissive_factor=np.array([0, 0, 0, 1], np.float32),
            params=np.array([0.0, 0.5, 1.0, 1.0], np.float32),
        )

    def pack(self) -> np.ndarray:
        """Flatten to a MATERIAL_RECORD_SIZE float32 row for the scene
        material table."""
        return np.concatenate(
            [
                np.asarray(self.base_color_factor, np.float32).reshape(4),
                np.asarray(self.emissive_factor, np.float32).reshape(4),
                np.asarray(self.params, np.float32).reshape(4),
                np.array(
                    [
                        self.base_color_index,
                        self.normal_map_index,
                        self.metallic_roughness_index,
                        self.occlusion_index,
                    ],
                    np.float32,
                ),
                np.array([self.emissive_index, self.alpha_cutoff], np.float32),
            ]
        )
