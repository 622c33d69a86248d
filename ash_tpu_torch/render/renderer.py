"""Renderer — the high-level API object (port of ash_tpu/render/renderer.py,
main path).

The public surface matches the reference: `set_mesh`, `set_material`,
`material_mut`, `register_mesh_handle`, `register_material_handle`,
`submit_render_commands`, `render_frame(view, proj, camera_pos)` and
`read_back`. State is host registries, the packed scene on the device
(rebuilt when the scene changes), the shadow feature, and a cached shadow
map: a static scene under a static light renders its shadow map once.

Every reference option and feature that this port does not run yet raises
NotImplementedError naming its ROADMAP.md item; none is silently ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.material import Material
from ..core.mesh import Mesh
from ..core.transform import Transform
from ..core.uniform import MaterialUniform
from ..device import resolve_device
from ..errors import InvalidOperation
from .features import FeatureFrameContext, FeatureManager, ShadowFeature
from .frame import (
    FrameConfig,
    FrameOutputs,
    FrameUniforms,
    render_frame_program,
    shadow_program,
)
from .scene import BuiltScene, DrawItem, build_models, build_scene
from .surface import SurfaceProvider

# The reference's hardcoded frame lighting (renderer.rs:1647-1649).
FRAME_LIGHT_DIR = np.array([-0.35, -1.0, -0.25], np.float32)
FRAME_LIGHT_COLOR = np.full(3, 1.5, np.float32)
FRAME_AMBIENT = np.full(3, 0.35, np.float32)

# Above this many (padded) triangles the reference switches to two-level
# binning, which is not ported.
DENSE_BINNING_MAX_TRIS = 32768


def _unported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md {item})")


# Reference options the port does not run yet: (default, ROADMAP item).
_UNPORTED_OPTIONS = {
    "csm": (None, "A14, CSM"),
    "render_scale": (1.0, "A13, TAAU"),
    "texture_budget_bytes": (None, "A10, textures"),
    "max_draws_per_chunk": (None, "A16, chunked geometry"),
    "msaa_resolve": ("ssaa", "A15, MSAA"),
}


@dataclasses.dataclass
class RendererConfig:
    """Construction-time knobs (the main-path fields of the reference
    RendererConfig, with its defaults)."""

    tile_h: int = 64
    tile_w: int = 128
    max_tris_per_tile: int = 256
    shadows_enabled: bool = True
    shadow_resolution: int = 2048
    shadow_tile: int = 128
    shadow_tile_h: Optional[int] = None  # None = min(shadow_tile, 32) rows
    shadow_max_tris_per_tile: int = 256
    # None = dense up to DENSE_BINNING_MAX_TRIS, False = always dense;
    # two-level binning (True, or larger scenes on auto) is ROADMAP A16.
    two_level_binning: Optional[bool] = None
    binning_policy: str = "draw_order"  # or "nearest"
    # LOD selection only acts on meshes with LOD chains (ROADMAP A14).
    lod_enabled: bool = True
    shading: str = "pbr"  # "pbr" | "flat"
    clear_color: tuple = (0.0, 0.0, 0.0)
    frustum_culling: bool = True
    csm: Optional[object] = None
    # Peel layers per transparency pass, in [2, 8] (checked at render), and
    # passes of iterated peeling; they act only on scenes with a
    # semi-transparent material (base colour alpha < 1).
    transparency_layers: int = 2
    transparency_passes: int = 1
    render_scale: float = 1.0
    texture_budget_bytes: Optional[int] = None
    max_draws_per_chunk: Optional[int] = None
    msaa_resolve: str = "ssaa"

    def __post_init__(self):
        for name, (default, item) in _UNPORTED_OPTIONS.items():
            if getattr(self, name) != default:
                _unported(f"RendererConfig.{name}={getattr(self, name)!r}", item)
        if self.two_level_binning:
            _unported("two-level binning", "A16")
        if self.binning_policy not in ("draw_order", "nearest"):
            raise ValueError(f"unknown binning_policy {self.binning_policy!r}")
        if self.shading not in ("pbr", "flat"):
            raise ValueError(f"unknown shading {self.shading!r}")


@dataclasses.dataclass
class RenderCommand:
    """One submitted draw."""

    mesh: int  # mesh handle
    transform: np.ndarray  # (4, 4) model matrix
    material: Optional[int] = None  # material handle


class FrameInputs(NamedTuple):
    """Everything one frame's device work reads."""

    config: FrameConfig
    scene: BuiltScene
    uniforms: FrameUniforms


class Renderer:
    def __init__(
        self,
        surface: SurfaceProvider,
        config: Optional[RendererConfig] = None,
        device="cuda",
    ):
        # Never falls back: device="cuda" without CUDA raises.
        self.device = resolve_device(device)
        # The reference runs its f32 products at full precision
        # (precision="highest"); TF32 would keep only 10 mantissa bits.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.surface = surface
        self.config = config or RendererConfig()
        self._width, self._height = surface.physical_size()

        self.mesh_registry: Dict[str, Mesh] = {}
        self.mesh_handles: Dict[int, str] = {}
        self.material_handles: Dict[int, Material] = {}
        self.draw_items: List[DrawItem] = []

        # Single-mesh convenience path.
        self.transform = Transform.identity()
        self._material = Material()
        self._single_mesh_key: Optional[str] = None
        self._single_mat_row: Optional[np.ndarray] = None

        self.feature_manager = FeatureManager()
        self.shadow_feature = ShadowFeature()
        self.feature_manager.add(self.shadow_feature, self)

        self._scene: Optional[BuiltScene] = None
        self._scene_dirty = True
        self._scene_epoch = 0
        self._models: Optional[torch.Tensor] = None  # multi-draw, per scene
        # Whether a multi-draw scene has a semi-transparent material,
        # scanned once per scene build.
        self._scene_blend = False
        # (key, shadow_map, shadow_overflow): reused while the scene, the
        # transforms and the light matrix are unchanged.
        self._shadow_cache: Optional[tuple] = None
        self._last_outputs: Optional[FrameOutputs] = None
        self._last_image: Optional[np.ndarray] = None
        self.frame_count = 0

    # ------------------------------------------------------------------
    # Scene registration
    # ------------------------------------------------------------------

    def _register_mesh(self, mesh: Mesh) -> str:
        if any(
            getattr(mesh, attr) is not None
            for attr in (
                "texture_data", "normal_texture_data",
                "metallic_roughness_texture_data", "occlusion_texture_data",
                "emissive_texture_data",
            )
        ):
            _unported(f"mesh {mesh.name!r}: texture maps", "A10")
        if mesh.lods and self.config.lod_enabled:
            _unported(f"mesh {mesh.name!r}: LOD chains", "A14")
        self.mesh_registry[mesh.name] = mesh
        self._scene_dirty = True
        return mesh.name

    def set_mesh(self, mesh: Mesh) -> None:
        """Single-mesh path: one draw of `mesh` with `self.transform`."""
        self._single_mesh_key = self._register_mesh(mesh)
        self.draw_items = []
        self._scene_dirty = True

    def material_mut(self) -> Material:
        """Mutable material of the single-mesh path (edits apply next frame)."""
        return self._material

    def set_material(self, material: Material) -> None:
        self._material = material

    def register_mesh_handle(self, handle: int, mesh: Mesh) -> None:
        self.mesh_handles[int(handle)] = self._register_mesh(mesh)

    def register_material_handle(self, handle: int, material: Material) -> None:
        self.material_handles[int(handle)] = material

    def submit_render_commands(self, commands: Sequence[RenderCommand]) -> None:
        """Build the draw list. An empty list falls back to the single mesh.
        Every submit rebuilds the packed scene on the next frame (the
        reference's transforms-only fast path is ROADMAP A16)."""
        if not commands and not self.draw_items:
            return  # already on the single-mesh fallback
        items: List[DrawItem] = []
        for cmd in commands:
            key = self.mesh_handles.get(int(cmd.mesh))
            if key is None:
                raise InvalidOperation(f"unknown mesh handle {cmd.mesh}")
            material = (
                self.material_handles.get(int(cmd.material))
                if cmd.material is not None else None
            ) or Material()
            items.append(DrawItem(
                mesh_key=key,
                model=np.asarray(cmd.transform, np.float32),
                material=self._material_uniform(material),
            ))
        self.draw_items = items
        self._scene_dirty = True

    @staticmethod
    def _material_uniform(material: Material) -> MaterialUniform:
        """Packed material with no texture bindings (textures are A10)."""
        return MaterialUniform(
            base_color_factor=np.asarray(material.color, np.float32),
            emissive_factor=np.asarray(material.emissive, np.float32),
            params=np.array(
                [material.metallic, material.roughness,
                 material.occlusion_strength, material.normal_scale],
                np.float32,
            ),
            base_color_index=-1,
            normal_map_index=-1,
            metallic_roughness_index=-1,
            occlusion_index=-1,
            emissive_index=-1,
            alpha_cutoff=material.alpha_cutoff,
        )

    # Reference features on later slices.
    def add_point_light(self, *args, **kwargs):
        _unported("add_point_light", "A12, Forward+ lights")

    def add_spot_light(self, *args, **kwargs):
        _unported("add_spot_light", "A12, Forward+ lights")

    def initialize_hdr(self, *args, **kwargs):
        _unported("initialize_hdr", "A13, post chain")

    def set_taa_enabled(self, *args, **kwargs):
        _unported("set_taa_enabled", "A13, post chain")

    def set_msaa_preset(self, *args, **kwargs):
        _unported("set_msaa_preset", "A15, MSAA")

    def set_occlusion_culling(self, *args, **kwargs):
        _unported("set_occlusion_culling", "A14, Hi-Z occlusion")

    def update_transforms(self, *args, **kwargs):
        _unported("update_transforms", "A16, dynamic scenes")

    def update_transforms_trs(self, *args, **kwargs):
        _unported("update_transforms_trs", "A16, dynamic scenes")

    # ------------------------------------------------------------------
    # Frame loop
    # ------------------------------------------------------------------

    def _current_draw_items(self) -> List[DrawItem]:
        if self.draw_items:
            return self.draw_items
        if self._single_mesh_key is None:
            return []
        mesh = self.mesh_registry[self._single_mesh_key]
        # An untouched default material defers to the mesh's own factors.
        material = self._material
        if material == Material() and mesh.material_properties is not None:
            material = mesh.material_properties.to_material(mesh.name)
        return [DrawItem(
            mesh_key=self._single_mesh_key,
            model=self.transform.model_matrix(),
            material=self._material_uniform(material),
        )]

    def _frame_config(self, alpha_blend: bool) -> FrameConfig:
        c = self.config
        return FrameConfig(
            width=self._width,
            height=self._height,
            tile_h=c.tile_h,
            tile_w=c.tile_w,
            max_tris_per_tile=c.max_tris_per_tile,
            shadow_enabled=c.shadows_enabled,
            shadow_resolution=c.shadow_resolution,
            shadow_tile=c.shadow_tile,
            shadow_tile_h=c.shadow_tile_h,
            shadow_max_tris_per_tile=c.shadow_max_tris_per_tile,
            binning_policy=c.binning_policy,
            shading=c.shading,
            clear_color=tuple(c.clear_color),
            frustum_culling=c.frustum_culling,
            alpha_blend=alpha_blend,
            transparency_layers=c.transparency_layers,
            transparency_passes=c.transparency_passes,
        )

    @staticmethod
    def _blends(items: List[DrawItem]) -> bool:
        """A semi-transparent material (base colour alpha < 1) switches on
        K-layer alpha blending (twice or more the shading cost, so only
        then)."""
        return any(float(it.material.base_color_factor[3]) < 1.0 for it in items)

    def _build_scene(self, items: List[DrawItem]) -> None:
        scene = build_scene(items, self.mesh_registry, self.device)
        if (self.config.two_level_binning is None
                and scene.buffers.num_triangles > DENSE_BINNING_MAX_TRIS):
            _unported(
                f"a scene of {scene.buffers.num_triangles} padded triangles "
                "(two-level binning; set two_level_binning=False to force "
                "dense)", "A16",
            )
        self._scene = scene
        self._scene_dirty = False
        self._scene_epoch += 1
        self._shadow_cache = None
        self._scene_blend = self._blends(items)
        self._single_mat_row = (
            items[0].packed_material() if self._single_mesh_key else None
        )
        self._models = torch.from_numpy(
            build_models(items, scene.buffers.num_draws)
        ).to(self.device)
        # Fit the shadow volume to the scene (a no-op once the app pinned
        # it with set_scene_bounds) and refresh the light matrix.
        self.shadow_feature.auto_fit_bounds(scene.scene_center, scene.scene_radius)
        self.shadow_feature.before_frame(FeatureFrameContext())

    def prepare_frame(self, view, proj, camera_pos) -> FrameInputs:
        """Bring the device scene up to date and upload the frame's
        uniforms; everything render_frame's device work reads."""
        self._width, self._height = self.surface.physical_size()
        items = self._current_draw_items()
        if not items:
            raise InvalidOperation(
                "no mesh: call set_mesh or submit_render_commands first"
            )
        self.feature_manager.before_frame(
            FeatureFrameContext(transform=self.transform)
        )
        if self._scene_dirty or self._scene is None:
            self._build_scene(items)
        elif not self.draw_items:
            # Single-mesh path: material_mut() edits and transform changes
            # land without a scene rebuild.
            row = items[0].packed_material()
            if not np.array_equal(row, self._single_mat_row):
                mats = self._scene.buffers.materials.clone()
                mats[0] = torch.from_numpy(row).to(self.device)
                self._scene = dataclasses.replace(
                    self._scene,
                    buffers=self._scene.buffers._replace(materials=mats),
                )
                self._single_mat_row = row
            self._models = torch.from_numpy(
                build_models(items, self._scene.buffers.num_draws)
            ).to(self.device)

        view = np.asarray(view, np.float32)
        proj = np.asarray(proj, np.float32)
        light_dir = FRAME_LIGHT_DIR / np.linalg.norm(FRAME_LIGHT_DIR)
        # One host->device copy for all per-frame constants.
        host = np.concatenate([
            (proj @ view).astype(np.float32).ravel(),
            np.asarray(camera_pos, np.float32).reshape(3),
            light_dir, FRAME_LIGHT_COLOR, FRAME_AMBIENT,
            np.asarray(self.shadow_feature.light_space_matrix(), np.float32).ravel(),
        ]).astype(np.float32)
        consts = torch.from_numpy(host).to(self.device)
        uni = FrameUniforms(
            view_proj=consts[0:16].view(4, 4),
            camera_pos=consts[16:19],
            light_direction=consts[19:22],
            light_color=consts[22:25],
            ambient_color=consts[25:28],
            light_space_matrix=consts[28:44].view(4, 4),
            models=self._models,
        )
        # The multi-draw scan is cached per scene build; the single mesh is
        # rescanned every frame, so a material_mut() alpha edit blends on
        # the next frame without a rebuild.
        blend = self._scene_blend if self.draw_items else self._blends(items)
        return FrameInputs(self._frame_config(blend), self._scene, uni)

    def _external_shadow(self, inputs: FrameInputs) -> tuple:
        """Render (or reuse) the shadow map. The key covers everything the
        shadow pass reads: the shadow-shaping config, the geometry (scene
        epoch), the transforms (fixed per scene epoch on the multi-draw
        path; the raw matrix on the single-mesh path) and the light
        matrix."""
        mkey = None
        if not self.draw_items:
            mkey = np.ascontiguousarray(self.transform.model_matrix()).tobytes()
        lkey = np.ascontiguousarray(
            self.shadow_feature.light_space_matrix(), dtype=np.float32
        ).tobytes()
        # Blending does not shape the shadow pass.
        cfg = dataclasses.replace(inputs.config, alpha_blend=False)
        key = (cfg, self._scene_epoch, mkey, lkey)
        cache = self._shadow_cache
        if cache is not None and cache[0] == key:
            return cache[1], cache[2]
        sm, sof = shadow_program(
            inputs.config, inputs.scene.buffers, inputs.uniforms.models,
            inputs.uniforms.light_space_matrix,
        )
        self._shadow_cache = (key, sm, sof)
        return sm, sof

    def render_frame(self, view, proj, camera_pos) -> FrameOutputs:
        """Render and present one frame."""
        inputs = self.prepare_frame(view, proj, camera_pos)
        shadow = (
            self._external_shadow(inputs)
            if inputs.config.shadow_enabled else None
        )
        outputs = render_frame_program(
            inputs.config, inputs.scene.buffers, inputs.uniforms, shadow
        )
        self._last_image = outputs.image.cpu().numpy()
        self.surface.present(self._last_image)
        self._last_outputs = outputs
        self.frame_count += 1
        return outputs

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------

    def last_outputs(self) -> Optional[FrameOutputs]:
        return self._last_outputs

    def read_back(self) -> Optional[np.ndarray]:
        """The last frame's (H, W, 4) uint8 image on the host."""
        return self._last_image
