"""Renderer — the high-level API object (port of ash_tpu/render/renderer.py).

The public surface matches the reference: `set_mesh`, `set_material`,
`material_mut`, `register_mesh_handle`, `register_mesh_descriptor`,
`register_material_handle`, `submit_render_commands`, the dynamic-scene
updates (`update_transforms`, `update_transforms_trs`, `update_material`),
`escalate_tile_capacities`, `add_point_light`, `add_spot_light`,
`request_texture_residency`, the post-processing setters (`initialize_hdr`,
`set_taa_enabled`, `set_render_scale`, tonemapping, bloom, FXAA),
`set_occlusion_culling`, `set_environment_map` / `clear_environment_map`,
`lod_stats`, the MSAA presets (`set_msaa_preset`), the diagnostics
(`set_diagnostics_mode`, `toggle_diagnostics`, `diagnostics`, the text
overlay and the overflow taint), `request_swapchain_resize` /
`wait_resize`, `frame_cost_analysis`, `profile_passes`,
`render_frame(view, proj, camera_pos)` and `read_back`; a draw list longer
than `max_draws_per_chunk` renders in chunks (`prepare_chunked_frame`). State
is host registries, the bindless texture manager (a mesh's maps get pool indices
when it is registered), the packed scene on the device (rebuilt when the
draw list changes; a resubmit of the same handles only moves the models),
a host mirror of the model matrices (uploaded with the frame's constants
when it changed, or as translation, rotation and scale that the device
composes), the shadow and lighting features, the cascaded shadow map fit
(`RendererConfig.csm`), a cached shadow map (a static scene under a static
light renders its map, or its cascades, once), and the TAA state: the
jitter sequence, last frame's unjittered matrices and models, and the
history image, which stays on the device between frames; the previous
frame's depth for Hi-Z occlusion culling; and the IBL bundle.

Every reference option, method and feature runs (UNPORTED_METHODS here
and render/__init__.py's UNPORTED_NAMES are empty). The reference's
XLA-only knobs are accepted and have no effect.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core import maths
from ..core.material import Material
from ..core.mesh import Mesh, MeshDescriptor
from ..core.texture import TextureData
from ..core.transform import Transform
from ..core.uniform import MATERIAL_RECORD_SIZE, MaterialUniform
from ..device import resolve_device
from ..errors import InvalidOperation
from ..ops.ibl import build_environment
from ..ops.taa import TaaParams
from ..ops.texture_sample import TexturePool
from .bindless import BindlessTextureManager
from .cost_analysis import FrameCost
from .csm import CascadedShadowMap, CsmConfig
from .diagnostics import DeviceProfiler, DiagnosticsState, FrameProfiler
from .diagnostics.overlay import DiagnosticsOverlay
from .features import (
    AutoRotateFeature,
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
    PostParams,
    finalize_frame,
    internal_render_size,
    merge_band_outputs,
    merge_shadows,
    models_from_trs,
    render_band,
    render_frame_program,
    shadow_program,
)
from .lod_system import MAX_LOD_LEVELS, LodStats
from .pass_profiler import profile_passes
from .scene import BuiltScene, DrawItem, build_models, build_scene
from .surface import SurfaceProvider
from .temporal_aa import TaaConfig, TemporalAA

# The reference's hardcoded frame lighting (renderer.rs:1647-1649).
FRAME_LIGHT_DIR = np.array([-0.35, -1.0, -0.25], np.float32)
FRAME_LIGHT_COLOR = np.full(3, 1.5, np.float32)
FRAME_AMBIENT = np.full(3, 0.35, np.float32)


# The reference's XLA compilation, tunnel and debugging knobs: accepted,
# validated as the reference validates them, and without effect here.
XLA_ONLY_OPTIONS = ("debug", "watch_kernels", "use_pallas",
                    "compilation_cache_dir", "pipeline_mode",
                    "cold_compile_effort", "async_resize", "bg_compile",
                    "gbuffer_packed")

# Reference Renderer methods the port does not run yet -> ROADMAP item:
# none is left.
UNPORTED_METHODS: Dict[str, str] = {}

log = logging.getLogger("ash_tpu_torch.renderer")


@dataclasses.dataclass
class RendererConfig:
    """Construction-time knobs: the reference RendererConfig's fields, with
    its names and defaults."""

    tile_h: int = 64
    tile_w: int = 128
    max_tris_per_tile: int = 256
    shadows_enabled: bool = True
    shadow_resolution: int = 2048
    shadow_tile: int = 128
    shadow_tile_h: Optional[int] = None  # None = min(shadow_tile, 32) rows
    shadow_max_tris_per_tile: int = 256
    # None = dense binning up to 32768 padded triangles and two-level above
    # (render/frame.py:_binner); True / False force one. The two-level
    # binner keeps at most binning_coarse_cap triangles per coarse tile.
    two_level_binning: Optional[bool] = None
    binning_coarse_cap: int = 16384
    binning_policy: str = "draw_order"  # or "nearest"
    # LOD selection acts only on scenes with a LOD chain (Mesh.add_lod): a
    # level per draw by screen coverage, and draws below lod_cull_threshold
    # coverage culled.
    lod_enabled: bool = True
    lod_cull_threshold: float = 0.001
    # Cascaded shadow maps: the cascades' count, resolution and blending
    # (render/csm.py); they replace shadow_resolution's single map while
    # shadows_enabled. shadow_distance is the farthest cascade's reach.
    csm: Optional[CsmConfig] = None
    shadow_distance: float = 50.0
    shading: str = "pbr"  # "pbr" | "flat"
    shade_dtype: str = "f32"  # "bf16": the BRDF in bfloat16
    clear_color: tuple = (0.0, 0.0, 0.0)
    debug: bool = False
    frustum_culling: bool = True
    watch_kernels: bool = False
    use_pallas: Optional[bool] = None
    gbuffer_packed: bool = False
    compilation_cache_dir: Optional[str] = None
    # Anisotropic filtering taps of textured draws (the reference sampler's
    # 16x; 1 = trilinear only).
    max_anisotropy: int = 16
    # The MSAA resolve while a preset is on (set_msaa_preset): "ssaa"
    # shades every sample, "edge" each pixel once and the samples of edge
    # pixels through a worklist of msaa_edge_capacity x the pixels
    # (render/frame.py, ops/msaa_edge.py).
    msaa_resolve: str = "ssaa"
    msaa_edge_capacity: float = 0.125
    # Peel layers per transparency pass, in [2, 8] (checked at render), and
    # passes of iterated peeling; they act only on scenes with a
    # semi-transparent material (base colour alpha < 1).
    transparency_layers: int = 2
    transparency_passes: int = 1
    # TAA upsampling: the internal raster size as a fraction of the
    # surface's, in [0.25, 1]; it acts only while the HDR post chain and
    # TAA are on (see Renderer.set_render_scale).
    render_scale: float = 1.0
    # A byte budget for the texture pool: mip residency is then fitted to
    # it (render/bindless.py); None keeps every mip resident.
    texture_budget_bytes: Optional[int] = None
    # Chunked geometry: a draw list longer than this renders in groups of
    # this many draws, each through the frame's raster and shading stage,
    # depth-composited (opaque scenes only; see _render_frame_chunked).
    max_draws_per_chunk: Optional[int] = None
    pipeline_mode: str = "tiered"
    cold_compile_effort: Optional[float] = -1.0
    async_resize: bool = True
    bg_compile: str = "subprocess"

    def __post_init__(self):
        if self.pipeline_mode not in ("tiered", "split", "fused"):
            raise ValueError(f"pipeline_mode {self.pipeline_mode!r} not in "
                             "('tiered', 'split', 'fused')")
        if self.bg_compile not in ("subprocess", "thread"):
            raise ValueError(f"bg_compile {self.bg_compile!r} not in "
                             "('subprocess', 'thread')")
        if self.binning_policy not in ("draw_order", "nearest"):
            raise ValueError(f"unknown binning_policy {self.binning_policy!r}")
        if self.shading not in ("pbr", "flat"):
            raise ValueError(f"unknown shading {self.shading!r}")
        if self.shade_dtype not in ("f32", "bf16"):
            raise ValueError(f"unknown shade_dtype {self.shade_dtype!r}")


class MsaaPreset:
    """MSAA presets: ordered-grid supersampling with a box resolve, or the
    edge-adaptive resolve (RendererConfig.msaa_resolve)."""

    OFF = "off"
    X2 = "x2"
    X4 = "x4"
    X8 = "x8"

    # Per-axis samples (x, y); each preset's count is its name's.
    SCALE = {OFF: (1, 1), X2: (2, 1), X4: (2, 2), X8: (4, 2)}


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
    post: Optional[PostParams] = None  # the post chain's runtime knobs
    taa_params: Optional[TaaParams] = None  # None while TAA is off


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
        self.feature_manager.add(AutoRotateFeature(), self)
        self.feature_manager.add(self.shadow_feature, self)
        self.feature_manager.add(self.lighting_feature, self)
        self.auto_rotate = False  # spins the single mesh's transform
        self.csm_manager = (CascadedShadowMap(self.config.csm)
                            if self.config.csm is not None else None)

        # Post-processing state.
        self.hdr_enabled = False
        self.bloom_enabled_flag = True
        self.tonemapping_enabled = True
        self.tonemapping_operator = "aces"
        self.tonemapping_exposure = 1.0
        self.tonemapping_gamma = 2.2
        self.bloom_intensity = 0.5
        self.bloom_threshold = 0.8
        self.fxaa_enabled = False
        self.msaa = MsaaPreset.OFF
        self.temporal_aa = TemporalAA(TaaConfig(enabled=False))
        self._taa_history: Optional[torch.Tensor] = None  # (H, W, 3), device
        self._render_scale = float(self.config.render_scale)
        # Motion-vector state: last frame's unjittered view-projection
        # (host) and model matrices (device).
        self._prev_view_proj: Optional[np.ndarray] = None
        self._prev_models: Optional[torch.Tensor] = None
        self._unjittered_view_proj: Optional[np.ndarray] = None  # this frame's
        # (lighting_feature.version, packed lights on the device or None).
        self._lights_cache: Optional[tuple] = None
        # Hi-Z occlusion culling: last frame's depth, on the device.
        self.occlusion_culling = False
        self._prev_depth: Optional[torch.Tensor] = None
        # The image-based lighting bundle (ops/ibl.EnvironmentIBL) or None.
        self._ibl = None

        self._scene: Optional[BuiltScene] = None
        # Chunked geometry (config.max_draws_per_chunk): the draw groups,
        # their scenes (groups of equal meshes and materials share one
        # scene's buffers), their models on the device, and last frame's
        # models for TAA. _scene is None while they are set.
        self._chunk_items: Optional[List[List[DrawItem]]] = None
        self._chunk_scenes: Optional[List[BuiltScene]] = None
        self._chunk_models: Optional[List[torch.Tensor]] = None
        self._prev_chunk_models: Optional[List[torch.Tensor]] = None
        self._scene_dirty = True
        self._scene_epoch = 0  # one per scene build
        self._models: Optional[torch.Tensor] = None  # (D_pad, 4, 4), device
        # The multi-draw path's model matrices on the host, (D_pad, 4, 4):
        # authoritative from the scene build on; uploaded with the next
        # frame's constants while _models_dirty. A dense update_transforms
        # defers the write-back to DrawItem.model (_items_models_stale,
        # _sync_item_models). update_transforms_trs instead keeps
        # (t, q, s) padded to D_pad (_trs_host), which the next frame
        # uploads and composes on the device (_trs_pending); the mirror is
        # then stale until _ensure_models_host composes it.
        self._models_host: Optional[np.ndarray] = None
        self._models_dirty = False
        self._trs_host: Optional[tuple] = None
        self._trs_pending = False
        self._trs_stale_host = False
        self._items_models_stale = False
        # Bumped by every transform update: keys the shadow cache.
        self._models_epoch = 0
        # The transforms-only fast path of submit_render_commands: a
        # resubmit whose (mesh handles, material handles, material-registry
        # version) equals the last one only moves the models.
        self._mat_registry_version = 0
        self._submit_sig: Optional[tuple] = None
        self._draw_mat_handles: Optional[List[int]] = None
        # Whether a multi-draw scene has an alpha-cutoff material and a
        # semi-transparent one, scanned per scene build and material update.
        self._material_flags = (False, False)
        # Bumped when a material row changes in place.
        self._materials_epoch = 0
        # (key, shadow_map, shadow_overflow): reused while the scene, the
        # transforms, the materials, the texture pool and the light matrix
        # are unchanged.
        self._shadow_cache: Optional[tuple] = None
        self._last_outputs: Optional[FrameOutputs] = None
        self._last_image: Optional[np.ndarray] = None
        self.frame_count = 0
        # An extent asked for by request_swapchain_resize, adopted on the
        # next frame.
        self._pending_resize: Optional[tuple] = None

        # Diagnostics. The overflow probe holds (frame, the three overflow
        # scalars on the device) for 60 frames before reading them, and
        # only in console mode, so a frame takes no extra host sync.
        self.diagnostics_state = DiagnosticsState()
        self.frame_profiler = FrameProfiler()
        self.device_profiler = DeviceProfiler(device=self.device)
        self.overlay = DiagnosticsOverlay()
        self._overflow_probe: Optional[tuple] = None
        self._start_time = self._last_frame_time = time.perf_counter()

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
        self.mesh_registry[mesh.name] = mesh
        self._scene_dirty = True
        return mesh.name

    def set_mesh(self, mesh: Mesh) -> None:
        """Single-mesh path: one draw of `mesh` with `self.transform`."""
        self._single_mesh_key = self._register_mesh(mesh)
        self.draw_items = []
        self._items_models_stale = False
        self._scene_dirty = True

    def material_mut(self) -> Material:
        """Mutable material of the single-mesh path (edits apply next frame)."""
        return self._material

    def set_material(self, material: Material) -> None:
        self._material = material

    def register_mesh_handle(self, handle: int, mesh: Mesh) -> None:
        self.mesh_handles[int(handle)] = self._register_mesh(mesh)

    def register_mesh_descriptor(self, handle: int, desc: MeshDescriptor) -> None:
        self.register_mesh_handle(handle, Mesh.from_descriptor(desc))

    def register_material_handle(self, handle: int, material: Material) -> None:
        """Edits land when a material is (re-)registered: the registry
        version moves, so the next submit repacks the rows."""
        self.material_handles[int(handle)] = material
        self._mat_registry_version += 1

    def submit_render_commands(self, commands: Sequence[RenderCommand]) -> None:
        """Build the draw list. An empty list falls back to the single mesh.
        A resubmit with the same mesh and material handles, in the same
        order and under the same material-registry version, is a transforms
        update: no scene rebuild, only the models move (update_transforms).
        Anything else rebuilds the packed scene on the next frame."""
        if commands:
            sig = (
                tuple(int(c.mesh) for c in commands),
                tuple(-1 if c.material is None else int(c.material)
                      for c in commands),
                self._mat_registry_version,
            )
            if (sig == self._submit_sig and not self._scene_dirty
                    and (self._scene is not None
                         or self._chunk_scenes is not None)
                    and len(self.draw_items) == len(commands)):
                self.update_transforms(np.stack(
                    [np.asarray(c.transform, np.float32) for c in commands]))
                return
        else:
            sig = None
            if not self.draw_items:
                return  # already on the single-mesh fallback
        items: List[DrawItem] = []
        mat_handles: List[int] = []
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
            mat_handles.append(-1 if cmd.material is None else int(cmd.material))
        self.draw_items = items
        # The new items carry their own transforms: a pending write-back of
        # the old list's mirror must not land on them.
        self._items_models_stale = False
        self._draw_mat_handles = mat_handles
        self._submit_sig = sig
        self._scene_dirty = True

    # ------------------------------------------------------------------
    # Dynamic scenes
    # ------------------------------------------------------------------

    def update_transforms(self, transforms) -> None:
        """Replace the draws' model matrices without a scene rebuild:
        `transforms` is an (N, 4, 4) array in submission order (N = draw
        count) or a {draw index: (4, 4)} dict. Before the first frame it
        only edits the draw items, which the scene build packs."""
        items = self.draw_items
        if not items:
            raise InvalidOperation("update_transforms needs a submitted draw list")
        n = len(items)
        if isinstance(transforms, dict):
            rows = {}
            for i, m in transforms.items():
                i = int(i)
                if not 0 <= i < n:
                    raise InvalidOperation(f"draw index {i} out of range")
                rows[i] = np.asarray(m, np.float32).reshape(4, 4)
        else:
            arr = np.asarray(transforms, np.float32)
            if arr.shape != (n, 4, 4):
                raise InvalidOperation(
                    f"transforms shape {arr.shape} != ({n}, 4, 4)")
        if self._chunk_scenes is not None and not self._scene_dirty:
            # A chunked scene: the items hold the models; every chunk's
            # models go up again.
            if isinstance(transforms, dict):
                for i, m in rows.items():
                    items[i].model = m
            else:
                for i, it in enumerate(items):
                    it.model = arr[i]
            self._upload_chunk_models()
            self._models_epoch += 1
            self._refresh_chunked_bounds()
            return
        if self._scene is None or self._scene_dirty:
            if isinstance(transforms, dict):
                for i, m in rows.items():
                    items[i].model = m
            else:
                for i, it in enumerate(items):
                    it.model = arr[i]
            return
        self._ensure_models_host()  # a TRS update may have left it stale
        self._trs_pending = False  # the matrices are authoritative now
        if isinstance(transforms, dict):
            for i, m in rows.items():
                self._models_host[i] = m
                items[i].model = m
        else:
            self._models_host[:n] = arr
            self._items_models_stale = True
        self._models_moved()

    def update_transforms_trs(self, translations, rotations, scales) -> None:
        """update_transforms for rigid TRS animation: translations (N, 3),
        rotation quaternions (N, 4, xyzw) and scales ((N,) uniform or
        (N, 3)). The frame uploads these 10 floats a draw and composes the
        matrices on the device (frame.models_from_trs) with the float
        operations of core/maths.mat4_trs_batch, so the frame equals
        update_transforms(mat4_trs_batch(t, q, s)) bit for bit."""
        items = self.draw_items
        if not items:
            raise InvalidOperation(
                "update_transforms_trs needs a submitted draw list")
        n = len(items)
        t = np.asarray(translations, np.float32).reshape(n, 3)
        q = np.asarray(rotations, np.float32).reshape(n, 4)
        s = np.asarray(scales, np.float32)
        s = (np.repeat(s.reshape(n, 1), 3, axis=1) if s.size == n
             else s.reshape(n, 3))
        if self._scene is None or self._scene_dirty:
            # Nothing built to upload into: compose on the host.
            self.update_transforms(maths.mat4_trs_batch(t, q, s))
            return
        d_pad = self._scene.buffers.num_draws
        if self._trs_host is None:
            qp = np.zeros((d_pad, 4), np.float32)
            qp[:, 3] = 1.0  # the identity pad, as build_models pads
            self._trs_host = (np.zeros((d_pad, 3), np.float32), qp,
                              np.ones((d_pad, 3), np.float32))
        tp, qp, sp = self._trs_host
        tp[:n], qp[:n], sp[:n] = t, q, s
        self._trs_pending = True
        self._trs_stale_host = True
        self._items_models_stale = True
        self._models_moved()

    def _models_moved(self) -> None:
        """After a transform update of a built scene: upload with the next
        frame, re-key the shadow cache, refit the shadow volume."""
        self._models_dirty = True
        self._models_epoch += 1
        self._refresh_scene_bounds()

    def _ensure_models_host(self) -> None:
        """Compose the host mirror from the TRS mirror where
        update_transforms_trs left it stale (the bounds refit, a later
        matrix update and item write-backs read it)."""
        if self._trs_stale_host:
            self._models_host[...] = maths.mat4_trs_batch(*self._trs_host)
            self._trs_stale_host = False

    def _sync_item_models(self) -> None:
        """Write the mirror back onto the draw items before anything reads
        item.model (a scene rebuild)."""
        if not self._items_models_stale:
            return
        self._ensure_models_host()
        self._items_models_stale = False
        for i, it in enumerate(self.draw_items):
            it.model = self._models_host[i]

    def _refresh_scene_bounds(self) -> None:
        """Refit the auto-fitted shadow volume to the moved draws: the world
        AABB of each draw's local box (centre c, half extents e) under an
        affine M is M c +- |M[:3, :3]| e. Skipped once set_scene_bounds
        pinned the volume."""
        scene = self._scene
        if self.shadow_feature.bounds_pinned or scene.draw_center_host is None:
            return
        self._ensure_models_host()
        m = self._models_host[:len(self.draw_items)]
        c, e = scene.draw_center_host, scene.draw_extents_host
        wc = np.einsum("dij,dj->di", m[:, :3, :3], c) + m[:, :3, 3]
        we = np.einsum("dij,dj->di", np.abs(m[:, :3, :3]), e)
        lo = (wc - we).min(axis=0)
        hi = (wc + we).max(axis=0)
        center = ((lo + hi) * 0.5).astype(np.float32)
        scene.scene_center = center
        scene.scene_radius = max(float(np.linalg.norm(hi - center)), 1e-3)
        self.shadow_feature.auto_fit_bounds(center, scene.scene_radius)

    def update_material(self, handle: int, material: Material) -> None:
        """Re-register material `handle` and rewrite the packed rows of the
        draws that use it, without a scene rebuild: the next frame shades
        with the new factors."""
        handle = int(handle)
        self.register_material_handle(handle, material)
        if not self.draw_items or self._draw_mat_handles is None:
            return
        rows = [i for i, h in enumerate(self._draw_mat_handles) if h == handle]
        if not rows:
            return
        for i in rows:
            it = self.draw_items[i]
            it.material = self._material_uniform(
                material, self.mesh_registry[it.mesh_key])
        if self._chunk_scenes is not None and not self._scene_dirty:
            # The packed rows live in the chunks' scenes, which groups may
            # share: the next frame rebuilds the chunks from the items.
            self._scene_dirty = True
            return
        if self._scene is None or self._scene_dirty:
            return  # the pending build packs the items
        mats = np.zeros((self._scene.buffers.num_draws, MATERIAL_RECORD_SIZE),
                        np.float32)
        mats[:len(self.draw_items)] = np.stack(
            [it.packed_material() for it in self.draw_items])
        self._scene = dataclasses.replace(
            self._scene, buffers=self._scene.buffers._replace(
                materials=torch.from_numpy(mats).to(self.device)))
        self._materials_epoch += 1
        self._material_flags = self._material_scan(self.draw_items)
        # The applied state now matches the bumped registry version, so the
        # next identical submit stays on the fast path.
        if self._submit_sig is not None:
            self._submit_sig = (*self._submit_sig[:2],
                                self._mat_registry_version)

    def escalate_tile_capacities(self, main_overflow: int = 0,
                                 shadow_overflow: int = 0) -> dict:
        """Grow the per-tile binning caps to fit a measured overflow, so the
        next frame drops no triangle: `overflow` is the worst tile's excess
        over its cap, so each cap grows to the next power of two at or
        above cap + overflow. The coarse cap rises to at least twice the
        larger fine cap (a two-level overflow may come from the coarse
        level), and the cached shadow map, which may hold drops, goes.
        Returns {field: new value} for what changed."""
        c = self.config
        changed: dict = {}

        def pow2(n: int) -> int:
            p = 1
            while p < n:
                p *= 2
            return p

        if int(main_overflow) > 0:
            c.max_tris_per_tile = pow2(c.max_tris_per_tile + int(main_overflow))
            changed["max_tris_per_tile"] = c.max_tris_per_tile
        if int(shadow_overflow) > 0:
            c.shadow_max_tris_per_tile = pow2(
                c.shadow_max_tris_per_tile + int(shadow_overflow))
            changed["shadow_max_tris_per_tile"] = c.shadow_max_tris_per_tile
        if changed:
            coarse = max(c.binning_coarse_cap,
                         2 * max(c.max_tris_per_tile, c.shadow_max_tris_per_tile))
            if coarse != c.binning_coarse_cap:
                c.binning_coarse_cap = coarse
                changed["binning_coarse_cap"] = coarse
            self._shadow_cache = None
        return changed

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

    # ------------------------------------------------------------------
    # Post-processing
    # ------------------------------------------------------------------

    def initialize_hdr(self) -> None:
        """Switch on the HDR post chain: the frame goes through TAA (when
        enabled), bloom and the tonemap."""
        self.hdr_enabled = True

    def set_tonemapping_enabled(self, enabled: bool) -> None:
        self.tonemapping_enabled = bool(enabled)

    def set_tonemapping_operator(self, operator: str) -> None:
        self.tonemapping_operator = operator

    def set_tonemapping_exposure(self, exposure: float) -> None:
        self.tonemapping_exposure = max(float(exposure), 0.0)

    def set_tonemapping_gamma(self, gamma: float) -> None:
        self.tonemapping_gamma = max(float(gamma), 0.1)

    def set_bloom_enabled(self, enabled: bool) -> None:
        self.bloom_enabled_flag = bool(enabled)

    def set_bloom_intensity(self, intensity: float) -> None:
        self.bloom_intensity = float(np.clip(intensity, 0.0, 2.0))

    def set_bloom_threshold(self, threshold: float) -> None:
        self.bloom_threshold = float(threshold)

    def set_fxaa_enabled(self, enabled: bool) -> None:
        self.fxaa_enabled = bool(enabled)

    def set_taa_enabled(self, enabled: bool) -> None:
        self.temporal_aa.config.enabled = bool(enabled)
        if not enabled:
            self._taa_history = None

    def reset_taa_history(self) -> None:
        self.temporal_aa.reset_history()
        self._taa_history = None

    def set_render_scale(self, scale: float) -> None:
        """TAA upsampling: raster at `scale` x the surface's size and gather
        the detail back through the jittered TAA history. It acts only
        while the HDR post chain and TAA are on. 1.0 = native."""
        if not 0.25 <= scale <= 1.0:
            raise ValueError(f"render_scale {scale} outside [0.25, 1]")
        self._render_scale = float(scale)
        self._taa_history = None  # its detail is the old scale's

    def _taa_active(self) -> bool:
        return self.hdr_enabled and self.temporal_aa.is_enabled()

    def set_msaa_preset(self, preset: str) -> None:
        """"off", "x2" (2x1 samples), "x4" (2x2) or "x8" (4x2): the frame
        rasters at the sample rate and resolves as
        RendererConfig.msaa_resolve says. Exclusive with render_scale < 1
        (the frame raises)."""
        if preset not in MsaaPreset.SCALE:
            raise ValueError(f"unknown MSAA preset {preset!r}")
        self.msaa = preset

    def msaa_preset(self) -> str:
        return self.msaa

    # ------------------------------------------------------------------
    # Hi-Z occlusion culling, LOD statistics, image-based lighting
    # ------------------------------------------------------------------

    def set_occlusion_culling(self, enabled: bool) -> None:
        """Cull draws hidden behind last frame's depth (a Hi-Z pyramid)."""
        self.occlusion_culling = bool(enabled)
        if not enabled:
            self._prev_depth = None

    def set_environment_map(self, env, mips: int = 5) -> None:
        """Light the scene from an equirectangular radiance map ((H, W, 3)
        float array or TextureData): split-sum IBL replaces the flat
        ambient term. The bundle (GGX-prefiltered mips, irradiance, BRDF
        LUT) is built on the renderer's device."""
        if isinstance(env, TextureData):
            env = env.to_linear_f32()[..., :3]
        self._ibl = build_environment(np.asarray(env, np.float32), mips=mips,
                                      device=self.device)

    def clear_environment_map(self) -> None:
        self._ibl = None

    def lod_stats(self, view, proj) -> LodStats:
        """LodStats of the current scene seen through (view, proj): a host
        mirror of the frame's LOD selection (render/frame.py:lod_tri_mask),
        with no device readback. Triangles before and after selection, the
        culled draws and the draws per level."""
        stats = LodStats()
        scene = self._scene
        if scene is None or not scene.has_lods:
            return stats
        self._sync_item_models()
        items = self._current_draw_items()
        models = build_models(items, len(items))
        vp = (np.asarray(proj, np.float32) @ np.asarray(view, np.float32))
        c4 = np.concatenate(
            [scene.draw_center_host, np.ones((len(items), 1), np.float32)],
            axis=-1)
        cw = np.einsum("dij,dj->di", models, c4)
        wc = (cw @ vp.T)[:, 3]
        scale = np.max(np.linalg.norm(models[:, :3, :3], axis=2), axis=-1)
        radius = np.linalg.norm(scene.draw_extents_host, axis=-1) * scale
        px_r = radius / np.maximum(wc, 1e-8) * (
            0.5 * max(self._width, self._height))
        coverage = np.minimum(
            np.pi * px_r * px_r / (self._width * self._height), 1.0)
        coverage = np.where(wc <= 0.0, 0.0, coverage)
        sel = np.argmax(coverage[:, None] >= scene.lod_thresholds_host, axis=1)
        live = coverage >= self.config.lod_cull_threshold
        lt = scene.lod_level_triangles
        stats.triangles_before = int(lt[:, 0].sum())
        stats.triangles_after = int((lt[np.arange(len(items)), sel] * live).sum())
        stats.objects_culled = int((~live).sum())
        for i in range(MAX_LOD_LEVELS):
            stats.objects_per_lod[i] = int(((sel == i) & live).sum())
        return stats

    # ------------------------------------------------------------------
    # Resize, diagnostics, cost analysis, pass profiling
    # ------------------------------------------------------------------

    def request_swapchain_resize(self, width: int, height: int) -> None:
        """Render the next frame at (width, height). The frame after it
        follows the surface's physical_size again, as the reference does."""
        self._pending_resize = (int(width), int(height))

    def wait_resize(self, timeout: Optional[float] = None) -> bool:
        """True: a resize needs no compile here, so nothing is pending."""
        return True

    def set_diagnostics_mode(self, mode) -> None:
        self.diagnostics_state.mode = mode

    def toggle_diagnostics(self) -> None:
        """The F6 handler: Off -> console -> overlay -> both -> Off."""
        self.diagnostics_state.toggle()

    def diagnostics(self) -> DiagnosticsState:
        return self.diagnostics_state

    def frame_cost_analysis(self, view, proj, camera_pos) -> dict:
        """Render one frame while counting its operations: {"flops",
        "bytes_accessed", "programs"}, bytes and flops summed over every
        aten op the frame ran and the raster launches' tensors, programs
        the pass_* scopes that ran (render/cost_analysis.py). Call after a
        warm-up frame, so the frame counted is a steady one (the shadow
        map cached)."""
        with FrameCost() as cost:
            self.render_frame(view, proj, camera_pos)
        return cost.result()

    def profile_passes(self, view, proj, camera_pos, n: int = 64):
        """ms per stage of the frame, each timed over n runs of its own
        (render/pass_profiler.py); the GpuProfiler readout under the
        reference's scope names. It synchronises the device: use on
        demand."""
        self._sync_item_models()
        return profile_passes(self, view, proj, camera_pos, n=n)

    def _update_diagnostics(self, draw_calls: int, frame_ms: float) -> None:
        """Refresh the diagnostics after a frame. Console mode warns about
        dropped triangles and worklist overflow: it holds the frame's
        overflow scalars on the device and reads them 60 frames later (one
        host sync per 60 frames, none with diagnostics off)."""
        mode = self.diagnostics_state.mode
        if mode.console_enabled:
            self._probe_overflow()
        self.frame_profiler.record(frame_ms)
        fs = self.diagnostics_state.frame_stats
        fs.fps = self.frame_profiler.fps
        fs.frame_time_ms = self.frame_profiler.avg_ms
        fs.frame_time_min_ms = self.frame_profiler.min_ms
        fs.frame_time_max_ms = self.frame_profiler.max_ms
        fs.draw_calls = draw_calls
        fs.triangles = (self._scene.num_triangles if self._scene
                        else sum(c.num_triangles
                                 for c in self._chunk_scenes or ()))
        fs.total_frames = self.frame_count
        ms = self.diagnostics_state.memory_stats
        # Refreshed while diagnostics show, else once per 60 frames.
        if (mode.console_enabled or mode.overlay_enabled
                or self.frame_count % 60 == 1):
            if self.device.type == "cuda":
                ms.gpu_used_bytes = torch.cuda.memory_allocated(self.device)
                if ms.gpu_budget_bytes == 0:
                    ms.gpu_budget_bytes = torch.cuda.mem_get_info(
                        self.device)[1]
            else:
                ms.gpu_used_bytes = self._buffer_bytes()
        ms.allocation_count = len(self._scene.buffers) if self._scene else 0
        ms.buffer_pool = (0, ms.allocation_count, ms.gpu_used_bytes)
        self.diagnostics_state.gpu_timings.passes = (
            self.device_profiler.timings_ms())
        self.diagnostics_state.on_frame()

    def _probe_overflow(self) -> None:
        """Hold a frame's three overflow scalars (frame_count % 60 == 1) and
        warn about them 60 frames later."""
        if self._overflow_probe is None:
            if self._last_outputs is not None and self.frame_count % 60 == 1:
                out = self._last_outputs
                self._overflow_probe = (
                    self.frame_count, out.binning_overflow,
                    out.shadow_overflow, out.msaa_edge_overflow)
        elif self.frame_count - self._overflow_probe[0] >= 60:
            _, main_of, shadow_of, edge_of = self._overflow_probe
            self._overflow_probe = None
            if int(main_of) > 0:
                log.warning(
                    "binning overflow: worst tile exceeded max_tris_per_tile"
                    " (%d) by %d: triangles were dropped; raise"
                    " RendererConfig.max_tris_per_tile",
                    self.config.max_tris_per_tile, int(main_of))
            if shadow_of is not None and int(shadow_of) > 0:
                log.warning(
                    "shadow binning overflow: worst shadow tile exceeded"
                    " shadow_max_tris_per_tile (%d) by %d: shadow triangles"
                    " were dropped (light leaks); raise"
                    " RendererConfig.shadow_max_tris_per_tile",
                    self.config.shadow_max_tris_per_tile, int(shadow_of))
            if edge_of is not None and int(edge_of) > 0:
                log.warning(
                    "edge-MSAA worklist overflow: %d edge pixels past"
                    " msaa_edge_capacity fell back to centre shading (lost"
                    " their AA); raise RendererConfig.msaa_edge_capacity",
                    int(edge_of))

    def _buffer_bytes(self) -> int:
        """Bytes of the scene's buffers, the texture pool and the TAA
        history: the renderer's own state on its device."""
        tensors = [t for t in (self._scene.buffers if self._scene else ())
                   if isinstance(t, torch.Tensor)]
        pool = self.bindless.pool()
        if pool is not None:
            tensors.append(pool.texels)
        if self._taa_history is not None:
            tensors.append(self._taa_history)
        return sum(t.numel() * t.element_size() for t in tensors)

    # The reference's tiered XLA compilation has no counterpart in an eager
    # port: nothing is ever pending and no pipeline is raced.

    @property
    def pipeline_decisions(self) -> dict:
        return {}

    def wait_pipeline_optimization(self, timeout: Optional[float] = None) -> bool:
        return True

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
        cascades, shadow_res, csm_blend = 1, c.shadow_resolution, 0.0
        if c.csm is not None and c.shadows_enabled:
            # With shadows off, csm behaves exactly like no csm: the frame
            # gets the cascade uniforms under the same condition.
            cascades = c.csm.cascade_count
            shadow_res = c.csm.resolution
            if c.csm.blend_cascades:
                csm_blend = c.csm.blend_size
        return FrameConfig(
            width=self._width,
            height=self._height,
            tile_h=c.tile_h,
            tile_w=c.tile_w,
            max_tris_per_tile=c.max_tris_per_tile,
            shadow_enabled=c.shadows_enabled,
            shadow_cascades=cascades,
            csm_blend_size=csm_blend,
            shadow_resolution=shadow_res,
            shadow_tile=c.shadow_tile,
            shadow_tile_h=c.shadow_tile_h,
            shadow_max_tris_per_tile=c.shadow_max_tris_per_tile,
            two_level_binning=c.two_level_binning,
            binning_coarse_cap=c.binning_coarse_cap,
            binning_policy=c.binning_policy,
            shading=c.shading,
            clear_color=tuple(c.clear_color),
            ssaa_x=MsaaPreset.SCALE[self.msaa][0],
            ssaa_y=MsaaPreset.SCALE[self.msaa][1],
            msaa_resolve=c.msaa_resolve,
            msaa_edge_capacity=c.msaa_edge_capacity,
            overflow_taint=self.diagnostics_state.mode.overlay_enabled,
            frustum_culling=c.frustum_culling,
            alpha_blend=alpha_blend,
            transparency_layers=c.transparency_layers,
            transparency_passes=c.transparency_passes,
            textured=textured,
            max_anisotropy=c.max_anisotropy,
            alpha_test=alpha_test,
            lights_enabled=lights_enabled,
            render_scale=self._render_scale if self._taa_active() else 1.0,
            post_enabled=self.hdr_enabled,
            bloom_enabled=self.bloom_enabled_flag,
            tonemap_operator=(self.tonemapping_operator
                              if self.tonemapping_enabled else "none"),
            taa_enabled=self.temporal_aa.is_enabled(),
            fxaa_enabled=self.fxaa_enabled,
            occlusion_culling=self.occlusion_culling,
            lod_enabled=(c.lod_enabled and self._scene is not None
                         and self._scene.has_lods),
            lod_cull_threshold=c.lod_cull_threshold,
            ibl_enabled=self._ibl is not None,
            shade_dtype=c.shade_dtype,
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
        self._sync_item_models()
        scene = build_scene(items, self.mesh_registry, self.device)
        self._scene = scene
        self._chunk_items = self._chunk_scenes = None  # leaving chunked mode
        self._chunk_models = self._prev_chunk_models = None
        self._scene_dirty = False
        self._scene_epoch += 1
        self._shadow_cache = None
        self._material_flags = self._material_scan(items)
        self._single_mat_row = (
            items[0].packed_material() if self._single_mesh_key else None
        )
        self._models_host = build_models(items, scene.buffers.num_draws)
        self._models_dirty = True
        self._trs_host = None
        self._trs_pending = self._trs_stale_host = False
        # Fit the shadow volume to the scene (a no-op once the app pinned
        # it with set_scene_bounds) and refresh the light matrix.
        self.shadow_feature.auto_fit_bounds(scene.scene_center, scene.scene_radius)
        self.shadow_feature.before_frame(FeatureFrameContext())

    def _begin_frame(self) -> List[DrawItem]:
        """Adopt a new extent and run the feature hooks -> the frame's draw
        items."""
        size = self._pending_resize or self.surface.physical_size()
        self._pending_resize = None
        if size != (self._width, self._height):
            # State shaped like the old extent goes with it.
            self._width, self._height = size
            self.reset_taa_history()
            self._prev_depth = None
        items = self._current_draw_items()
        if not items:
            raise InvalidOperation(
                "no mesh: call set_mesh or submit_render_commands first"
            )
        # The feature hooks run after the draw items are read, as in the
        # reference: an auto-rotation step shows in the next frame.
        now = time.perf_counter()
        self.feature_manager.before_frame(FeatureFrameContext(
            delta_time=now - self._last_frame_time,
            elapsed=now - self._start_time,
            auto_rotate=self.auto_rotate,
            transform=self.transform,
        ))
        self._last_frame_time = now
        return items

    def _chunked(self) -> bool:
        """Whether the draw list renders in chunks (max_draws_per_chunk)."""
        cpd = self.config.max_draws_per_chunk
        return cpd is not None and len(self.draw_items) > cpd

    def prepare_frame(self, view, proj, camera_pos) -> FrameInputs:
        """Bring the device scene up to date and upload the frame's
        uniforms and any moved models; everything render_frame's device
        work reads. With TAA on, each call takes the next jitter of the
        sequence."""
        items = self._begin_frame()
        if self._scene_dirty or self._scene is None:
            self._build_scene(items)
        elif not self.draw_items:
            # Single-mesh path: material_mut() edits land without a scene
            # rebuild.
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

        view = np.asarray(view, np.float32)
        proj = np.asarray(proj, np.float32)
        proj_unjittered = proj
        self._unjittered_view_proj = (proj @ view).astype(np.float32)

        # TAA: advance the jitter and perturb the projection.
        taa_params = None
        if self._taa_active():
            self.temporal_aa.begin_frame()
            # The jitter is in internal pixels, so TAAU covers the
            # upscaled grid's sub-pixel positions evenly; the resolve works
            # in presentation pixels, hence j_scale.
            jw, jh = internal_render_size(self._width, self._height,
                                          self._render_scale)
            proj = self.temporal_aa.jitter_projection(proj, jw, jh)
            p = self.temporal_aa.params()
            j_scale = np.array([self._width / jw, self._height / jh],
                               np.float32)
            # Without a history the frame passes through unblended.
            first = self._taa_history is None
            taa_params = TaaParams(
                blend_factor=0.0 if first else float(p["blend_factor"]),
                color_clamp=float(p["color_clamp"]),
                velocity_rejection=float(p["velocity_rejection"]),
                jitter=p["jitter"] * j_scale,
                prev_jitter=p["prev_jitter"] * j_scale,
            )

        light_dir = FRAME_LIGHT_DIR / np.linalg.norm(FRAME_LIGHT_DIR)
        parts = {
            "view_proj": proj @ view,
            "camera_pos": np.asarray(camera_pos, np.float32).reshape(3),
            "light_direction": light_dir,
            "light_color": FRAME_LIGHT_COLOR,
            "ambient_color": FRAME_AMBIENT,
            "light_space_matrix": self.shadow_feature.light_space_matrix(),
            "view": view,
            "projection": proj,
        }
        if self.csm_manager is not None and self.config.shadows_enabled:
            # Fitted from the unjittered projection: the cascades must not
            # wobble with the TAA jitter, and a static camera then hits the
            # fit's value cache and the shadow cache.
            self.csm_manager.update(
                view, proj_unjittered, self.shadow_feature.light_direction,
                self.config.shadow_distance,
            )
            gpu = self.csm_manager.gpu_data()
            count = self.csm_manager.config.cascade_count
            parts["cascade_matrices"] = gpu.light_matrices[:count]
            parts["cascade_splits"] = gpu.split_distances
        if taa_params is not None:
            # On the first TAA frame the current matrices stand in for the
            # previous ones: zero velocity, right for a fresh history.
            parts["prev_view_proj"] = (
                self._prev_view_proj if self._prev_view_proj is not None
                else self._unjittered_view_proj)
        # The models ride in the same copy: every frame on the single-mesh
        # path (its transform may change each frame), after a build or an
        # update on the multi-draw path, as matrices or as TRS.
        if not self.draw_items:
            parts["models"] = build_models(items, self._scene.buffers.num_draws)
        elif self._models_dirty and self._trs_pending:
            parts.update(zip(("trs_t", "trs_q", "trs_s"), self._trs_host))
        elif self._models_dirty:
            parts["models"] = self._models_host
        # One host->device copy for all per-frame constants.
        dev = self._upload(parts)
        if "models" in dev:
            self._models = dev.pop("models")
        elif "trs_t" in dev:
            self._models = models_from_trs(dev.pop("trs_t"), dev.pop("trs_q"),
                                           dev.pop("trs_s"))
        self._models_dirty = False
        prev_models = None
        if taa_params is not None:
            # So do the current models after a change of the draw count.
            prev_models = (
                self._prev_models if self._prev_models is not None
                and self._prev_models.shape == self._models.shape
                else self._models)
        uni = FrameUniforms(models=self._models, prev_models=prev_models, **dev)
        # The multi-draw scan is cached per scene build and material
        # update; the single mesh is rescanned every frame, so a
        # material_mut() alpha edit blends (or alpha-tests) on the next
        # frame without a rebuild.
        any_cutoff, blend = (self._material_flags if self.draw_items
                             else self._material_scan(items))
        pool = self.bindless.pool()
        lights = self._device_lights()
        cfg = self._frame_config(
            blend, textured=pool is not None,
            alpha_test=pool is not None and any_cutoff,
            lights_enabled=lights is not None,
        )
        post = PostParams(
            exposure=np.float32(self.tonemapping_exposure),
            gamma=np.float32(self.tonemapping_gamma),
            bloom_intensity=np.float32(self.bloom_intensity),
            bloom_threshold=np.float32(self.bloom_threshold),
            bloom_soft_knee=np.float32(0.5),
        )
        return FrameInputs(cfg, self._scene, uni, pool, lights, post,
                           taa_params)

    def _upload(self, parts: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """`parts` in one host-to-device copy -> views of it with each
        part's shape."""
        arrays = {k: np.asarray(v, np.float32) for k, v in parts.items()}
        consts = torch.from_numpy(
            np.concatenate([a.ravel() for a in arrays.values()])
        ).to(self.device)
        out, start = {}, 0
        for name, a in arrays.items():
            out[name] = consts[start:start + a.size].view(a.shape)
            start += a.size
        return out

    def _shadow_key(self, cfg: FrameConfig) -> tuple:
        """What the shadow pass reads: the shadow-shaping config, the
        geometry (scene epoch), the transforms (the models epoch on the
        multi-draw path, the raw matrix on the single-mesh path), the
        materials and the texture pool (the alpha test samples them) and
        the light matrix, or with CSM the cascade matrices. Those are fitted
        to the unjittered camera, so the TAA jitter alone keeps the map."""
        if self.draw_items:
            mkey = self._models_epoch
        else:
            mkey = np.ascontiguousarray(self.transform.model_matrix()).tobytes()
        if cfg.shadow_cascades > 1:
            count = self.csm_manager.config.cascade_count
            lkey = self.csm_manager.gpu_data().light_matrices[:count].tobytes()
        else:
            lkey = np.ascontiguousarray(
                self.shadow_feature.light_space_matrix(), dtype=np.float32
            ).tobytes()
        # The fields of the config that shape the shadow pass. It reads the
        # materials and the pool only through the alpha test, so only then
        # do their versions key the map: an untextured material edit keeps
        # it.
        shape = (cfg.shadow_resolution, cfg.shadow_cascades, cfg.shadow_tile,
                 cfg.shadow_rows, cfg.shadow_max_tris_per_tile,
                 cfg.two_level_binning, cfg.binning_coarse_cap,
                 cfg.binning_policy, cfg.textured, cfg.alpha_test)
        sampled = ((self._materials_epoch, self.bindless.version)
                   if cfg.alpha_test else None)
        return (shape, self._scene_epoch, mkey, lkey, sampled)

    def _cached_shadow(self, cfg: FrameConfig, render) -> tuple:
        """The shadow map under _shadow_key: the cached one, or render()'s
        (shadow_map, shadow_overflow), which is then kept."""
        key = self._shadow_key(cfg)
        cache = self._shadow_cache
        if cache is not None and cache[0] == key:
            return cache[1], cache[2]
        self._shadow_cache = None  # free the stale map before the new one
        sm, sof = render()
        self._shadow_cache = (key, sm, sof)
        return sm, sof

    def _external_shadow(self, inputs: FrameInputs) -> tuple:
        """Render (or reuse) the shadow map of the frame's scene."""
        uni = inputs.uniforms
        return self._cached_shadow(inputs.config, lambda: shadow_program(
            inputs.config, inputs.scene.buffers, uni.models,
            uni.light_space_matrix, inputs.pool, uni.cascade_matrices))

    def render_frame(self, view, proj, camera_pos) -> FrameOutputs:
        """Render and present one frame. A LOD scene renders its shadow map
        inside the frame, under the camera's level mask, so the cache is
        not used for it. With occlusion culling the first frame tests
        against a far-plane depth (nothing is known occluded yet) and every
        frame keeps its depth for the next. In an overlay diagnostics mode
        the stats text is blended onto the image on the device before its
        copy to the host."""
        start = time.perf_counter()
        if self._chunked():
            return self._render_frame_chunked(view, proj, camera_pos, start)
        inputs = self.prepare_frame(view, proj, camera_pos)
        cfg = inputs.config
        shadow = (
            self._external_shadow(inputs)
            if cfg.shadow_enabled and not cfg.lod_enabled else None
        )
        prev_depth = None
        if self.occlusion_culling:
            prev_depth = self._prev_depth
            if prev_depth is None:
                prev_depth = torch.ones((self._height, self._width),
                                        dtype=torch.float32,
                                        device=self.device)
        history = None
        if inputs.taa_params is not None:
            history = self._taa_history
            if history is None:  # the first TAA frame blends with weight 0
                history = torch.zeros(
                    (self._height, self._width, 3), dtype=torch.float32,
                    device=self.device)
        outputs = render_frame_program(
            inputs.config, inputs.scene.buffers, inputs.uniforms, shadow,
            inputs.pool, inputs.lights, inputs.post, inputs.taa_params,
            history, prev_depth, self._ibl,
        )
        if outputs.history is not None:
            self._taa_history = outputs.history
        if self.occlusion_culling:
            self._prev_depth = outputs.depth
        self._prev_view_proj = self._unjittered_view_proj
        self._prev_models = inputs.uniforms.models
        return self._present(outputs, start)

    def _present(self, outputs: FrameOutputs, start: float) -> FrameOutputs:
        """Composite the overlay, copy the image to the host (a blocking
        copy: the frame has ended on the device when it returns), present
        it and update the diagnostics."""
        if self.diagnostics_state.mode.overlay_enabled:
            self.overlay.composite(outputs.image,
                                   self.diagnostics_state.overlay_lines())
        self._last_image = outputs.image.cpu().numpy()
        self.surface.present(self._last_image)
        self._last_outputs = outputs
        self.frame_count += 1
        # A frame without a draw list draws the single mesh.
        self._update_diagnostics(len(self.draw_items) or 1,
                                 (time.perf_counter() - start) * 1e3)
        return outputs

    # ------------------------------------------------------------------
    # Chunked geometry
    # ------------------------------------------------------------------

    def _build_chunk_scenes(self, groups: List[List[DrawItem]]) -> list:
        """A BuiltScene per group of draws. Groups with equal (mesh,
        material) sequences share the first one's device buffers, which
        hold nothing that depends on the models (those ride the uniforms),
        so a fleet of instances keeps one copy of the expansion maps; only
        the world box is the group's own, from the shared local bounds with
        build_scene's corner arithmetic."""
        by_sig, scenes = {}, []
        signs = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                          for z in (-1, 1)], np.float32)
        for g in groups:
            sig = tuple((it.mesh_key, it.packed_material().tobytes())
                        for it in g)
            tmpl = by_sig.get(sig)
            if tmpl is None:
                by_sig[sig] = build_scene(g, self.mesh_registry, self.device)
                scenes.append(by_sig[sig])
                continue
            corners = (tmpl.draw_center_host[:, None, :]
                       + tmpl.draw_extents_host[:, None, :] * signs[None])
            models = np.stack([np.asarray(it.model, np.float32) for it in g])
            wc = (np.einsum("dij,dcj->dci", models[:, :3, :3], corners)
                  + models[:, None, :3, 3]).reshape(-1, 3)
            lo = wc.min(axis=0).astype(np.float32)
            hi = wc.max(axis=0).astype(np.float32)
            center = ((lo + hi) * 0.5).astype(np.float32)
            scenes.append(dataclasses.replace(
                tmpl, scene_center=center,
                scene_radius=max(float(np.linalg.norm(hi - center)), 1e-3),
                scene_lo=lo, scene_hi=hi))
        return scenes

    def _upload_chunk_models(self) -> None:
        """Every chunk's (D_pad, 4, 4) models from its items, on the device
        (the previous frame's stay for TAA's motion vectors)."""
        self._chunk_models = [
            torch.from_numpy(build_models(g, s.buffers.num_draws)).to(
                self.device)
            for g, s in zip(self._chunk_items, self._chunk_scenes)]

    def _fit_chunked_bounds(self, lo: np.ndarray, hi: np.ndarray) -> None:
        center = ((lo + hi) * 0.5).astype(np.float32)
        self.shadow_feature.auto_fit_bounds(
            center, max(float(np.linalg.norm(hi - center)), 1e-3))

    def _refresh_chunked_bounds(self) -> None:
        """_refresh_scene_bounds for a chunked scene: the union of every
        chunk's draws' world boxes (the same affine box arithmetic, so the
        volume equals the unchunked scene's), unless set_scene_bounds
        pinned it."""
        if self.shadow_feature.bounds_pinned:
            return
        los, his = [], []
        for g, sc in zip(self._chunk_items, self._chunk_scenes):
            m = np.stack([np.asarray(it.model, np.float32) for it in g])
            c = sc.draw_center_host[:len(g)]
            e = sc.draw_extents_host[:len(g)]
            wc = np.einsum("dij,dj->di", m[:, :3, :3], c) + m[:, :3, 3]
            we = np.einsum("dij,dj->di", np.abs(m[:, :3, :3]), e)
            los.append((wc - we).min(axis=0))
            his.append((wc + we).max(axis=0))
        self._fit_chunked_bounds(np.min(los, axis=0), np.max(his, axis=0))

    def prepare_chunked_frame(self, view, proj, camera_pos) -> List[FrameInputs]:
        """prepare_frame for a draw list longer than max_draws_per_chunk:
        bring the chunks up to date (groups of that many draws, rebuilt
        when the draw list changed) and upload the frame's uniforms once
        -> one FrameInputs per chunk, each with its chunk's scene and
        models. Refuses what the chunked frame cannot composite, with the
        reference's messages."""
        items = self._begin_frame()
        self._sync_item_models()
        if (self.lighting_feature.point_lights
                or self.lighting_feature.spot_lights):
            raise InvalidOperation(
                "chunked geometry does not support Forward+ lights (tile "
                "light culling needs the whole frame's depth)")
        if self.msaa != MsaaPreset.OFF or self._render_scale != 1.0:
            raise InvalidOperation(
                "chunked geometry is exclusive with SSAA/render_scale")
        if self.occlusion_culling:
            raise InvalidOperation(
                "chunked geometry does not support occlusion culling")
        if self.csm_manager is not None:
            raise InvalidOperation(
                "chunked geometry supports the single shadow map only")
        cpd = int(self.config.max_draws_per_chunk)
        if (self._scene_dirty or self._chunk_scenes is None
                or sum(map(len, self._chunk_items)) != len(items)):
            groups = [items[i:i + cpd] for i in range(0, len(items), cpd)]
            scenes = self._build_chunk_scenes(groups)
            if any(sc.has_lods for sc in scenes):
                raise InvalidOperation(
                    "chunked geometry does not support LOD chains")
            self._chunk_items, self._chunk_scenes = groups, scenes
            self._upload_chunk_models()
            self._prev_chunk_models = None
            self._scene = None
            self._scene_dirty = False
            self._scene_epoch += 1
            self._models_epoch += 1
            self._material_flags = self._material_scan(items)
            self._shadow_cache = None
            # The union of the chunks' world boxes is the unchunked scene's
            # box, so the auto-fitted shadow volume, and the image, are the
            # unchunked frame's.
            self._fit_chunked_bounds(
                np.min([sc.scene_lo for sc in scenes], axis=0),
                np.max([sc.scene_hi for sc in scenes], axis=0))
            self.shadow_feature.before_frame(FeatureFrameContext())
        any_cutoff, blend = self._material_flags
        if blend:
            raise InvalidOperation(
                "chunked geometry is opaque-only (alpha blending composites "
                "across the whole scene's depth order)")

        view = np.asarray(view, np.float32)
        proj = np.asarray(proj, np.float32)
        self._unjittered_view_proj = (proj @ view).astype(np.float32)
        taa_params = None
        if self._taa_active():
            self.temporal_aa.begin_frame()
            proj = self.temporal_aa.jitter_projection(proj, self._width,
                                                      self._height)
            p = self.temporal_aa.params()
            taa_params = TaaParams(
                blend_factor=(0.0 if self._taa_history is None
                              else float(p["blend_factor"])),
                color_clamp=float(p["color_clamp"]),
                velocity_rejection=float(p["velocity_rejection"]),
                jitter=p["jitter"], prev_jitter=p["prev_jitter"])
        pool = self.bindless.pool()
        cfg = self._frame_config(False, textured=pool is not None,
                                 alpha_test=pool is not None and any_cutoff,
                                 lights_enabled=False)
        light_dir = FRAME_LIGHT_DIR / np.linalg.norm(FRAME_LIGHT_DIR)
        parts = {
            "view_proj": proj @ view,
            "camera_pos": np.asarray(camera_pos, np.float32).reshape(3),
            "light_direction": light_dir,
            "light_color": FRAME_LIGHT_COLOR,
            "ambient_color": FRAME_AMBIENT,
            "light_space_matrix": self.shadow_feature.light_space_matrix(),
            "view": view,
            "projection": proj,
        }
        if taa_params is not None:
            parts["prev_view_proj"] = (
                self._prev_view_proj if self._prev_view_proj is not None
                else self._unjittered_view_proj)
        base = FrameUniforms(models=None, **self._upload(parts))
        post = PostParams(
            exposure=np.float32(self.tonemapping_exposure),
            gamma=np.float32(self.tonemapping_gamma),
            bloom_intensity=np.float32(self.bloom_intensity),
            bloom_threshold=np.float32(self.bloom_threshold),
            bloom_soft_knee=np.float32(0.5),
        )
        prev = self._prev_chunk_models
        chunks = []
        for ci, (sc, m) in enumerate(zip(self._chunk_scenes,
                                         self._chunk_models)):
            prev_m = None
            if taa_params is not None:
                prev_m = (prev[ci] if prev is not None
                          and prev[ci].shape == m.shape else m)
            chunks.append(FrameInputs(
                cfg, sc, base._replace(models=m, prev_models=prev_m), pool,
                None, post, taa_params))
        return chunks

    def _render_frame_chunked(self, view, proj, camera_pos,
                              start: float) -> FrameOutputs:
        """A draw list longer than max_draws_per_chunk renders in groups of
        that many draws: each group through render_band, the groups
        depth-composited (frame.merge_band_outputs: for opaque geometry the
        winner the unchunked depth test picks), their shadow maps
        min-merged and cached under the unchunked key, and the post chain
        once on the merged frame. It bounds the frame's transient memory by
        a chunk's triangles. The reference fences each chunked frame before
        the next; here the frame already ends in a blocking copy of its
        image (_present), so nothing else waits."""
        chunks = self.prepare_chunked_frame(view, proj, camera_pos)
        first = chunks[0]
        cfg, taa_params = first.config, first.taa_params
        shadow = None
        if cfg.shadow_enabled:
            shadow_pool = first.pool if cfg.alpha_test else None

            def render_shadow():
                acc = None
                for c in chunks:
                    pair = shadow_program(cfg, c.scene.buffers,
                                          c.uniforms.models,
                                          c.uniforms.light_space_matrix,
                                          shadow_pool)
                    acc = pair if acc is None else merge_shadows(acc, pair)
                return acc

            shadow = self._cached_shadow(cfg, render_shadow)
        acc = None
        for c in chunks:
            bo = render_band(cfg, c.scene.buffers, c.uniforms, shadow,
                             c.pool, None, None, self._ibl)
            acc = bo if acc is None else merge_band_outputs(acc, bo)
        history = None
        if taa_params is not None:
            history = self._taa_history
            if history is None:  # the first TAA frame blends with weight 0
                history = torch.zeros(
                    (self._height, self._width, 3), dtype=torch.float32,
                    device=self.device)
        outputs = finalize_frame(cfg, acc, first.post, taa_params, history)
        if outputs.history is not None:
            self._taa_history = outputs.history
        self._prev_view_proj = self._unjittered_view_proj
        self._prev_chunk_models = list(self._chunk_models)
        return self._present(outputs, start)

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------

    def last_outputs(self) -> Optional[FrameOutputs]:
        return self._last_outputs

    def read_back(self) -> Optional[np.ndarray]:
        """The last frame's (H, W, 4) uint8 image on the host."""
        return self._last_image

