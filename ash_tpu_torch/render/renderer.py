"""Renderer — the high-level API object (port of ash_tpu/render/renderer.py,
main path).

The public surface matches the reference: `set_mesh`, `set_material`,
`material_mut`, `register_mesh_handle`, `register_material_handle`,
`submit_render_commands`, `add_point_light`, `add_spot_light`,
`request_texture_residency`, `render_frame(view, proj, camera_pos)` and
`read_back`. State is host registries, the bindless texture manager (a
mesh's maps get pool indices when it is registered), the packed scene on
the device (rebuilt when the scene changes), the shadow and lighting
features, and a cached shadow map: a static scene under a static light
renders its shadow map once.

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
from ..ops.texture_sample import TexturePool
from .bindless import BindlessTextureManager
from .features import (
    FeatureFrameContext,
    FeatureManager,
    GpuLight,
    LightingFeature,
    PointLight,
    ShadowFeature,
    SpotLight,
)
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
    # Anisotropic filtering taps of textured draws (the reference sampler's
    # 16x; 1 = trilinear only).
    max_anisotropy: int = 16
    render_scale: float = 1.0
    # A byte budget for the texture pool: mip residency is then fitted to
    # it (render/bindless.py); None keeps every mip resident.
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
    pool: Optional[TexturePool]  # the bindless pool, None without textures
    lights: Optional[torch.Tensor]  # (L_pad, 16) packed lights, or None


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

        self.bindless = BindlessTextureManager(
            budget_bytes=self.config.texture_budget_bytes, device=self.device
        )
        self.feature_manager = FeatureManager()
        self.shadow_feature = ShadowFeature()
        self.lighting_feature = LightingFeature()
        self.feature_manager.add(self.shadow_feature, self)
        self.feature_manager.add(self.lighting_feature, self)
        # (lighting_feature.version, packed lights on the device or None).
        self._lights_cache: Optional[tuple] = None

        self._scene: Optional[BuiltScene] = None
        self._scene_dirty = True
        self._scene_epoch = 0
        self._models: Optional[torch.Tensor] = None  # multi-draw, per scene
        # Whether a multi-draw scene has an alpha-cutoff material and a
        # semi-transparent one, scanned once per scene build.
        self._material_flags = (False, False)
        # Bumped when the single mesh's material row changes in place.
        self._materials_epoch = 0
        # (key, shadow_map, shadow_overflow): reused while the scene, the
        # transforms, the materials, the texture pool and the light matrix
        # are unchanged.
        self._shadow_cache: Optional[tuple] = None
        self._last_outputs: Optional[FrameOutputs] = None
        self._last_image: Optional[np.ndarray] = None
        self.frame_count = 0

    # ------------------------------------------------------------------
    # Scene registration
    # ------------------------------------------------------------------

    def _register_mesh(self, mesh: Mesh) -> str:
        """Record the mesh and give each of its texture maps a bindless
        index, with the map's colour space (base colour and emissive are
        sRGB). The indices are written into the Mesh: a mesh registered
        with a second renderer keeps the first one's, so every renderer
        needs meshes of its own."""
        for attr, idx_attr, srgb in (
            ("texture_data", "texture_index", True),
            ("normal_texture_data", "normal_texture_index", False),
            ("metallic_roughness_texture_data",
             "metallic_roughness_texture_index", False),
            ("occlusion_texture_data", "occlusion_texture_index", False),
            ("emissive_texture_data", "emissive_texture_index", True),
        ):
            data = getattr(mesh, attr)
            if data is not None and getattr(mesh, idx_attr) is None:
                data.srgb = srgb
                setattr(mesh, idx_attr, self.bindless.add_sampled_image(data))
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
                material=self._material_uniform(material,
                                                self.mesh_registry[key]),
            ))
        self.draw_items = items
        self._scene_dirty = True

    @staticmethod
    def _material_uniform(material: Material, mesh: Mesh) -> MaterialUniform:
        """Packed material with the mesh's bindless texture indices (-1 for
        a missing map)."""
        def idx(v):
            return -1 if v is None else int(v)

        return MaterialUniform(
            base_color_factor=np.asarray(material.color, np.float32),
            emissive_factor=np.asarray(material.emissive, np.float32),
            params=np.array(
                [material.metallic, material.roughness,
                 material.occlusion_strength, material.normal_scale],
                np.float32,
            ),
            base_color_index=idx(mesh.texture_index),
            normal_map_index=idx(mesh.normal_texture_index),
            metallic_roughness_index=idx(mesh.metallic_roughness_texture_index),
            occlusion_index=idx(mesh.occlusion_texture_index),
            emissive_index=idx(mesh.emissive_texture_index),
            alpha_cutoff=material.alpha_cutoff,
        )

    # ------------------------------------------------------------------
    # Lights and textures
    # ------------------------------------------------------------------

    def add_point_light(self, position, color=(1, 1, 1), intensity=1.0,
                        radius=10.0) -> int:
        """Add a Forward+ point light; returns its index."""
        return self.lighting_feature.add_point_light(PointLight(
            position=np.asarray(position, np.float32),
            color=np.asarray(color, np.float32),
            intensity=float(intensity),
            radius=float(radius),
        ))

    def add_spot_light(self, position, direction, color=(1, 1, 1),
                       intensity=1.0, radius=10.0, inner_cone_angle=0.3,
                       outer_cone_angle=0.5) -> int:
        """Add a Forward+ spot light (cone angles in radians); returns its
        index."""
        return self.lighting_feature.add_spot_light(SpotLight(
            position=np.asarray(position, np.float32),
            direction=np.asarray(direction, np.float32),
            color=np.asarray(color, np.float32),
            intensity=float(intensity),
            radius=float(radius),
            inner_cone_angle=float(inner_cone_angle),
            outer_cone_angle=float(outer_cone_angle),
        ))

    def clear_point_lights(self) -> None:
        self.lighting_feature.clear_point_lights()

    def clear_spot_lights(self) -> None:
        self.lighting_feature.clear_spot_lights()

    def clear_lights(self) -> None:
        self.lighting_feature.clear_lights()

    def request_texture_residency(self, index: int, min_level: int) -> None:
        """Streaming-pool feedback: ask for texture `index`'s mips down to
        `min_level` to be resident (0 = full size). Under a
        texture_budget_bytes the fit may demote other textures instead;
        the restream rewrites the pool's values, not its shapes."""
        self.bindless.request_residency(index, min_level)

    # Reference features on later slices.

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
            material=self._material_uniform(material, mesh),
        )]

    def _frame_config(self, alpha_blend: bool, textured: bool,
                      alpha_test: bool, lights_enabled: bool) -> FrameConfig:
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
            textured=textured,
            max_anisotropy=c.max_anisotropy,
            alpha_test=alpha_test,
            lights_enabled=lights_enabled,
        )

    @staticmethod
    def _material_scan(items: List[DrawItem]) -> tuple:
        """(any alpha cutoff, any semi-transparent material). A cutoff
        switches on the alpha test when a texture pool exists; base colour
        alpha < 1 switches on K-layer alpha blending. Each costs a second
        peel layer or more, so only then."""
        return (
            any(it.material.alpha_cutoff > 0.0 for it in items),
            any(float(it.material.base_color_factor[3]) < 1.0 for it in items),
        )

    def _device_lights(self) -> Optional[torch.Tensor]:
        """The lights packed into a power-of-two bucket of at least 8 rows,
        on the device; repacked only when the lighting feature changes."""
        version = self.lighting_feature.version
        if self._lights_cache is None or self._lights_cache[0] != version:
            gpu = [GpuLight.from_point_light(pl)
                   for pl in self.lighting_feature.point_lights]
            gpu += [GpuLight.from_spot_light(sl)
                    for sl in self.lighting_feature.spot_lights]
            lights = None
            if gpu:
                pad = 8
                while pad < len(gpu):
                    pad *= 2
                rows = np.zeros((pad, 16), np.float32)
                for i, gl in enumerate(gpu):
                    rows[i] = gl.flat()
                lights = torch.from_numpy(rows).to(self.device)
            self._lights_cache = (version, lights)
        return self._lights_cache[1]

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
        self._material_flags = self._material_scan(items)
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
                self._materials_epoch += 1
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
            view.ravel(), proj.ravel(),
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
            view=consts[44:60].view(4, 4),
            projection=consts[60:76].view(4, 4),
        )
        # The multi-draw scan is cached per scene build; the single mesh is
        # rescanned every frame, so a material_mut() alpha edit blends (or
        # alpha-tests) on the next frame without a rebuild.
        any_cutoff, blend = (self._material_flags if self.draw_items
                             else self._material_scan(items))
        pool = self.bindless.pool()
        lights = self._device_lights()
        cfg = self._frame_config(
            blend, textured=pool is not None,
            alpha_test=pool is not None and any_cutoff,
            lights_enabled=lights is not None,
        )
        return FrameInputs(cfg, self._scene, uni, pool, lights)

    def _external_shadow(self, inputs: FrameInputs) -> tuple:
        """Render (or reuse) the shadow map. The key covers everything the
        shadow pass reads: the shadow-shaping config, the geometry (scene
        epoch), the transforms (fixed per scene epoch on the multi-draw
        path; the raw matrix on the single-mesh path), the materials and
        the texture pool (the alpha test samples them) and the light
        matrix."""
        mkey = None
        if not self.draw_items:
            mkey = np.ascontiguousarray(self.transform.model_matrix()).tobytes()
        lkey = np.ascontiguousarray(
            self.shadow_feature.light_space_matrix(), dtype=np.float32
        ).tobytes()
        # Blending and lights do not shape the shadow pass. It reads the
        # materials and the pool only through the alpha test, so only then
        # do their versions key the map: an untextured material edit keeps
        # it.
        cfg = dataclasses.replace(inputs.config, alpha_blend=False,
                                  lights_enabled=False)
        sampled = ((self._materials_epoch, self.bindless.version)
                   if cfg.alpha_test else None)
        key = (cfg, self._scene_epoch, mkey, lkey, sampled)
        cache = self._shadow_cache
        if cache is not None and cache[0] == key:
            return cache[1], cache[2]
        sm, sof = shadow_program(
            inputs.config, inputs.scene.buffers, inputs.uniforms.models,
            inputs.uniforms.light_space_matrix, inputs.pool,
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
            inputs.config, inputs.scene.buffers, inputs.uniforms, shadow,
            inputs.pool, inputs.lights,
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
