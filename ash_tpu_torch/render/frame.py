"""The frame pipeline (port of ash_tpu/render/frame.py).

`render_frame_program` is one `render_frame`: vertex stage -> LOD selection
-> frustum and Hi-Z culling -> back-cull setup -> binning -> raster ->
G-buffer -> Forward+ light culling -> shading -> sRGB encode and RGBA8
pack. LOD selection (lod_enabled) picks one level of each draw's chain by
its screen coverage and masks the other levels' triangles out of every
pass, the shadow pass included; Hi-Z culling (occlusion_culling) tests each
draw's screen rectangle against a max pyramid of the previous frame's
depth. With the HDR post
chain (post_enabled) the main pass leaves linear HDR, and `finalize_frame`
runs TAA (before the tonemap, on motion vectors from the G-buffer), bloom,
the tonemap with gamma in place of the sRGB encode, and FXAA; with
render_scale < 1 the raster and the shading run at an internal size and
the result is upsampled before the TAA blend (TAAU). With supersampling
(ssaa_x, ssaa_y > 1, the MSAA presets) the raster, the light culling and
the shading run at the sample rate and `pass_resolve` box-averages the
colour and min-reduces the depth; msaa_resolve="edge" shades once per
pixel at its centre and only the edge pixels' samples at sample rate
(ops/msaa_edge.py). With overflow_taint (the diagnostics overlay)
`finalize_frame` paints a corner block where binning dropped triangles.
With semi-transparent materials (alpha_blend) the main raster is a K-layer depth
peel, iterated `transparency_passes` times, and every layer is shaded and
composited back to front. With alpha-tested materials and a texture pool
(alpha_test) the raster peels two layers and cut-out pixels fall through to
the second. The shadow pass is its own function, `shadow_program`
(front-cull setup -> binning -> depth-only raster, with the alpha test's
two-layer peel at a 0.1 cutoff; once per cascade with cascaded shadow
maps), so the renderer can cache the map across frames of a static scene.
With a `BandSpec` (parallel/sharded.py) `render_band` and
`shadow_program` render one horizontal band of the frame or of the shadow
map: only the row offsets change (`band_extent`, `shadow_band`).
`merge_band_outputs` and `merge_shadows` composite the renders of draw-list
chunks by depth (the renderer's chunked frame). Every raster goes through
ops/raster_cuda.py:rasterize, and the bloom through
ops/bloom_cuda.py:bloom_pyramid: CUDA kernels on the card.

The functions here run eagerly; asked to, the renderer captures
`render_frame_program` and `shadow_program` as CUDA graphs on the card
(render/compiled.py, the counterpart of the reference's compiled programs),
and the FrameConfig is part of their key. Each stage runs inside a
`torch.profiler.record_function` scope named like the reference's
`pass_*` named scopes, so a profiler trace of an eager frame buckets time
by pass (a graph replay enters no scope).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..device import constant
from ..ops import (binning, bloom_cuda, gbuffer_cuda, geometry, msaa_edge,
                   shade_cuda)
from ..ops.fxaa import fxaa
from ..ops.hiz import build_hiz
from ..ops.occlusion import cull_objects
from ..ops.light_cull import cull_lights
from ..ops.raster import VisibilityBuffer
from ..ops.raster_cuda import rasterize
from ..ops.shade import (
    ShadeUniforms,
    composite_over,
    pixel_alpha,
    resolve_alpha_test,
    shade_flat,
)
from ..ops.taa import TaaParams, taa_resolve
from ..ops.texture_sample import TexturePool
from ..ops.tonemap import tonemap_compose
from .scene import SceneBuffers


class FrameUniforms(NamedTuple):
    """Per-frame inputs (the reference's frame UBO), on the device."""

    view_proj: torch.Tensor  # (4, 4)
    camera_pos: torch.Tensor  # (3,)
    light_direction: torch.Tensor  # (3,)
    light_color: torch.Tensor  # (3,)
    ambient_color: torch.Tensor  # (3,)
    light_space_matrix: torch.Tensor  # (4, 4)
    models: torch.Tensor  # (D, 4, 4) per-draw model matrices
    view: torch.Tensor  # (4, 4), for Forward+ light culling and CSM
    projection: torch.Tensor  # (4, 4)
    # CSM (FrameConfig.shadow_cascades > 1): the cascades' light matrices
    # and far distances (render/csm.py GpuCascadeData).
    cascade_matrices: Optional[torch.Tensor] = None  # (C, 4, 4)
    cascade_splits: Optional[torch.Tensor] = None  # (4,)
    # TAA motion vectors: last frame's unjittered camera and its models.
    prev_view_proj: Optional[torch.Tensor] = None  # (4, 4)
    prev_models: Optional[torch.Tensor] = None  # (D, 4, 4)


@dataclasses.dataclass(frozen=True)
class FrameConfig:
    """Static shape and options of a frame (the ported subset of the
    reference FrameConfig)."""

    width: int
    height: int
    tile_h: int = 64
    tile_w: int = 128
    max_tris_per_tile: int = 256
    shadow_enabled: bool = True
    shadow_resolution: int = 2048
    # Shadow raster tiles: shadow_tile is the width, shadow_tile_h the row
    # count (None = min(shadow_tile, 32)).
    shadow_tile: int = 256
    shadow_tile_h: Optional[int] = None
    shadow_max_tris_per_tile: int = 256
    # Binning: None = two-level above DENSE_BINNING_MAX_TRIS padded
    # triangles, dense below; True / False force one. The two-level binner's
    # coarse tiles keep at most binning_coarse_cap candidates.
    two_level_binning: Optional[bool] = None
    binning_coarse_cap: int = 16384
    # Cascaded shadow maps: 1 = a single map; 2-4 renders one depth map per
    # cascade and shading selects by view distance (render/csm.py).
    shadow_cascades: int = 1
    csm_blend_size: float = 0.0  # > 0 blends neighbouring cascades
    # What an overflowing tile drops: "draw_order" keeps the lowest draw
    # ids, "nearest" keeps the nearest triangles.
    binning_policy: str = "draw_order"
    shading: str = "pbr"  # "pbr" | "flat"
    reinhard: bool = True  # in-shader tonemap; off under the HDR post chain
    clear_color: tuple = (0.0, 0.0, 0.0)
    # HDR post chain: the main pass leaves linear HDR, TAA resolves before
    # the tonemap, and bloom + tonemap + gamma make the LDR image (the gamma
    # replaces the sRGB encode); FXAA runs on the LDR image.
    post_enabled: bool = False
    bloom_enabled: bool = True
    bloom_mips: int = 5
    tonemap_operator: str = "aces"
    taa_enabled: bool = False
    fxaa_enabled: bool = False
    # TAA upsampling: raster and shade at render_scale x the presentation
    # size, upsample bilinearly, and let the jittered TAA history bring the
    # detail back. In [0.25, 1].
    render_scale: float = 1.0
    frustum_culling: bool = False
    # Hi-Z occlusion culling against the previous frame's depth (given to
    # render_frame_program as prev_depth, at the presentation size).
    occlusion_culling: bool = False
    # LOD selection: per draw, the first level of its chain whose coverage
    # threshold holds; draws below lod_cull_threshold coverage are culled.
    lod_enabled: bool = False
    lod_cull_threshold: float = 0.001
    # Image-based lighting from the renderer's environment bundle.
    ibl_enabled: bool = False
    # "bf16" runs the BRDF in bfloat16 (ops/shade.shade_pbr's dtype).
    shade_dtype: str = "f32"
    # Semi-transparent materials: shade every layer of a K-layer depth peel
    # (K = transparency_layers, in [2, 8]) and composite them back to front
    # with SRC_ALPHA blending. The peel sorts per pixel, so the blend is
    # order-independent and exact up to K-1 transparent surfaces over
    # anything. Each extra transparency pass rasterizes the next K surfaces
    # strictly behind the deepest kept one (iterated peeling). pbr only.
    alpha_blend: bool = False
    transparency_layers: int = 2
    transparency_passes: int = 1
    # Texture maps: the pool reaches the shading pass (and the alpha test).
    textured: bool = False
    # Anisotropic filtering taps (1 = trilinear only).
    max_anisotropy: int = 1
    # Alpha test (cutout): rasterize two layers and let cut-out pixels fall
    # through (ops/shade.resolve_alpha_test); the shadow pass uses a fixed
    # 0.1 threshold on textured materials. Needs textured and a pool;
    # alpha_blend takes precedence in the main pass.
    alpha_test: bool = False
    # Forward+ point and spot lights: tiled light culling and a per-pixel
    # loop over the tile's list, each tile walking its own count (at most
    # shaded_lights_per_tile).
    lights_enabled: bool = False
    light_tile_size: int = 16
    max_lights_per_tile: int = 256
    shaded_lights_per_tile: int = 256
    # Supersampling (the MSAA presets: x2 = 2x1, x4 = 2x2, x8 = 4x2
    # samples, ordered grid). "ssaa" shades every sample and box-resolves;
    # "edge" shades each pixel once at its centre and the samples of edge
    # pixels (samples that see different triangles) through a worklist of
    # msaa_edge_capacity x the pixels; pixels past it keep the centre
    # shading and are counted in FrameOutputs.msaa_edge_overflow. "edge"
    # needs pbr shading and excludes alpha blending.
    ssaa_x: int = 1
    ssaa_y: int = 1
    msaa_resolve: str = "ssaa"
    msaa_edge_capacity: float = 0.125
    # The diagnostics overlay's taint: an 8x8 block at the bottom right,
    # magenta where the main pass dropped triangles, and cyan beside it for
    # the shadow pass, decided on the device.
    overflow_taint: bool = False

    @property
    def shadow_rows(self) -> int:
        """Row count of a shadow raster tile."""
        if self.shadow_tile_h is not None:
            return self.shadow_tile_h
        return min(self.shadow_tile, 32)


class PostParams(NamedTuple):
    """Runtime post-processing knobs, float32 on the host."""

    exposure: np.float32
    gamma: np.float32
    bloom_intensity: np.float32
    bloom_threshold: np.float32
    bloom_soft_knee: np.float32

    @staticmethod
    def default() -> "PostParams":
        return PostParams(
            exposure=np.float32(1.0),
            gamma=np.float32(2.2),
            bloom_intensity=np.float32(0.5),
            bloom_threshold=np.float32(0.8),
            bloom_soft_knee=np.float32(0.5),
        )


class FrameOutputs(NamedTuple):
    """One frame's results, in the reference's field order."""

    image: torch.Tensor  # (H, W, 4) uint8
    color: torch.Tensor  # (H, W, 3) float32 (LDR, or HDR after TAA)
    depth: torch.Tensor  # (H, W) float32
    shadow_map: Optional[torch.Tensor]  # (S, S), (C, S, S) or None
    covered_pixels: torch.Tensor  # () int32
    binning_overflow: torch.Tensor  # () int32
    history: Optional[torch.Tensor]  # (H, W, 3) TAA history out
    visible_draws: Optional[torch.Tensor]  # () int32 after culling
    # Dropped shadow triangles leak light, so they are reported like
    # main-pass drops. None when shadows are disabled.
    shadow_overflow: Optional[torch.Tensor] = None  # () int32
    # Edge pixels past the edge-MSAA worklist (they keep their centre
    # shading); None unless msaa_resolve="edge" supersamples.
    msaa_edge_overflow: Optional[torch.Tensor] = None  # () int32


class BandOutputs(NamedTuple):
    """What the raster + shade stage hands to finalize_frame: at the
    internal raster size under TAAU, resolved to the presentation size
    under supersampling."""

    color: torch.Tensor  # (H, W, 3) linear colour, Reinhard-mapped or HDR
    depth: torch.Tensor  # (H, W)
    velocity: Optional[torch.Tensor]  # (H, W, 2) uv motion, with TAA
    shadow_map: Optional[torch.Tensor]
    covered: torch.Tensor  # () int32, covered samples
    overflow: torch.Tensor  # () int32
    shadow_overflow: Optional[torch.Tensor]
    visible_draws: Optional[torch.Tensor]
    msaa_edge_overflow: Optional[torch.Tensor] = None  # () int32


def _srgb_encode(c: torch.Tensor) -> torch.Tensor:
    """Linear -> sRGB (the swapchain's UNORM_SRGB store)."""
    c = c.clamp(0.0, 1.0)
    return torch.where(
        c <= 0.0031308, c * 12.92, 1.055 * torch.pow(c, 1.0 / 2.4) - 0.055
    )


def internal_render_size(width: int, height: int, scale: float):
    """The TAAU internal raster size: even, at least 16 pixels."""
    if scale == 1.0:
        return width, height
    return (
        max(2 * int(round(width * scale / 2)), 16),
        max(2 * int(round(height * scale / 2)), 16),
    )


def ssaa_factors(cfg: FrameConfig):
    """(sx, sy): the supersampling factors, at least 1."""
    return max(int(cfg.ssaa_x), 1), max(int(cfg.ssaa_y), 1)


def raster_size(cfg: FrameConfig):
    """(width, height) of the main pass's raster, light culling and
    shading: the TAAU internal size, or the sample-rate size."""
    scale = float(cfg.render_scale)
    sx, sy = ssaa_factors(cfg)
    if scale != 1.0:
        if sx != 1 or sy != 1:
            raise ValueError("render_scale is exclusive with SSAA")
        if not 0.25 <= scale <= 1.0:
            raise ValueError(f"render_scale {scale} outside [0.25, 1]")
        return internal_render_size(cfg.width, cfg.height, scale)
    return cfg.width * sx, cfg.height * sy


def edge_msaa(cfg: FrameConfig) -> bool:
    """Whether the frame takes the edge-adaptive resolve; raises on the
    reference's invalid combinations."""
    if cfg.msaa_resolve not in ("ssaa", "edge"):
        raise ValueError(f"unknown msaa_resolve {cfg.msaa_resolve!r}")
    sx, sy = ssaa_factors(cfg)
    edge = cfg.msaa_resolve == "edge" and (sx > 1 or sy > 1)
    if edge and cfg.shading != "pbr":
        raise ValueError("msaa_resolve='edge' requires pbr shading")
    if edge and cfg.alpha_blend:
        raise ValueError(
            "msaa_resolve='edge' is exclusive with alpha blending "
            "(K-layer blending already shades every peeled layer; use ssaa)")
    return edge


# Above this many padded triangles the automatic switch picks two-level
# binning (reference frame.py:287-298).
DENSE_BINNING_MAX_TRIS = 32768


def _binner(cfg: FrameConfig, num_tris: int):
    """Dense or two-level binning: a static choice per scene bucket."""
    use_two = (cfg.two_level_binning if cfg.two_level_binning is not None
               else num_tris > DENSE_BINNING_MAX_TRIS)
    if not use_two:
        return binning.bin_triangles
    return functools.partial(binning.bin_triangles_two_level,
                             coarse_cap=cfg.binning_coarse_cap)


def _keep_score(cfg: FrameConfig, setup):
    """Overflow priority for the binner (None = draw order)."""
    if cfg.binning_policy == "nearest":
        return -setup.z_clip.amin(dim=-1)
    return None


class BandSpec(NamedTuple):
    """Screen-space banding: this call renders band `index` of `n`
    horizontal bands of the frame (parallel/sharded.py). None = the full
    frame."""

    index: int
    n: int


def _band_unit(cfg: FrameConfig) -> int:
    """Smallest presentation-row granularity a band may start at: its
    render rows (u * ssaa_y) align to raster tiles and, with Forward+ on,
    to light-culling tiles, so the bands' tile grids are disjoint."""
    sy = ssaa_factors(cfg)[1]
    need = cfg.tile_h
    if cfg.lights_enabled:
        need = need * cfg.light_tile_size // math.gcd(need, cfg.light_tile_size)
    return need // math.gcd(need, sy)


def band_rows(cfg: FrameConfig, n: int) -> int:
    """Presentation rows per band (the height padded up to divide)."""
    u = _band_unit(cfg)
    return -(-cfg.height // (n * u)) * u


def band_render_rows(cfg: FrameConfig, n: int) -> int:
    """Internal rows per band under TAAU (render_scale != 1): the bands
    split the scaled raster rows, padded up to divide and to align with the
    raster and light tile grids (SSAA is exclusive here, so the band unit
    is the render unit)."""
    _, rh = internal_render_size(cfg.width, cfg.height, cfg.render_scale)
    u = _band_unit(cfg)
    return -(-rh // (n * u)) * u


def band_extent(cfg: FrameConfig, band: Optional[BandSpec]):
    """(y0r, render rows, presentation rows) of a band: its first global
    render row and its row counts. At presentation scale 1 a band has
    band_rows rows (times ssaa_y at the sample rate); under TAAU the bands
    split the internal rows."""
    rh = raster_size(cfg)[1]
    if band is None:
        return 0, rh, cfg.height if cfg.render_scale == 1.0 else rh
    if cfg.render_scale == 1.0:
        bhp = band_rows(cfg, band.n)
        bhr = bhp * ssaa_factors(cfg)[1]
    else:
        bhr = bhp = band_render_rows(cfg, band.n)
    return band.index * bhr, bhr, bhp


def shadow_band(cfg: FrameConfig, band: Optional[BandSpec]):
    """(rows, first row) of a band of the shadow map; raises when the map
    does not divide into band.n bands of whole shadow-tile rows."""
    s = cfg.shadow_resolution
    if band is None:
        return s, 0
    if s % (band.n * cfg.shadow_rows) != 0:
        raise ValueError(
            f"shadow_resolution {s} must divide into {band.n} bands"
            f" of {cfg.shadow_rows}-row tiles")
    rows = s // band.n
    return rows, band.index * rows


def shadow_world(scene: SceneBuffers, models: torch.Tensor) -> torch.Tensor:
    """World positions for the shadow pass, computed with the same
    operations as geometry.transform_vertices' world transform."""
    m = models[scene.vert_draw.long()]
    pos = scene.position[scene.vert_uid.long()]
    return geometry.matvec3(m[:, :3, :3], pos) + m[:, :3, 3]


def models_from_trs(t: torch.Tensor, q: torch.Tensor,
                    s: torch.Tensor) -> torch.Tensor:
    """(N, 3) translations, (N, 4) xyzw quaternions and (N, 3) scales ->
    (N, 4, 4) model matrices T * R * S on the device, with the float
    operations of core/maths.mat4_trs_batch in its order, so a frame
    composed here equals one composed on the host bit for bit."""
    x, y, z, w = q.unbind(-1)
    x2, y2, z2 = x + x, y + y, z + z
    xx, yy, zz = x * x2, y * y2, z * z2
    xy, xz, yz = x * y2, x * z2, y * z2
    wx, wy, wz = w * x2, w * y2, w * z2
    r = torch.stack([
        torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], -1),
        torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], -1),
        torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], -1),
    ], -2)  # (N, 3, 3), rows i, columns j
    r = r * s[:, None, :]  # column j scaled by s_j: the * S
    top = torch.cat([r, t[:, :, None]], dim=2)  # (N, 3, 4)
    bottom = constant([0.0, 0.0, 0.0, 1.0], r.dtype, r.device).expand(
        t.shape[0], 1, 4)
    return torch.cat([top, bottom], dim=1)


def shadow_pass_bins(cfg: FrameConfig, scene: SceneBuffers,
                     world: torch.Tensor, light_matrix: torch.Tensor,
                     tri_valid: Optional[torch.Tensor] = None,
                     band: Optional[BandSpec] = None):
    """Front-cull setup and binning of the shadow pass -> (setup, bins),
    over the map's rows of `band` (default: the whole map). `tri_valid`
    (default: the scene's) is the LOD-masked validity."""
    s = cfg.shadow_resolution
    rows, sy0 = shadow_band(cfg, band)
    clip_l = geometry.transform_points(light_matrix, world)
    setup = geometry.triangle_setup(
        clip_l, scene.tri_v,
        scene.tri_valid if tri_valid is None else tri_valid, s, s,
        cull_mode="front",
    )
    bins = _binner(cfg, scene.num_triangles)(
        setup.bbox, setup.valid, rows, s, cfg.shadow_rows, cfg.shadow_tile,
        cfg.shadow_max_tris_per_tile, y0=sy0,
        keep_score=_keep_score(cfg, setup),
    )
    return setup, bins


def shadow_program(cfg: FrameConfig, scene: SceneBuffers,
                   models: torch.Tensor, light_matrix: torch.Tensor,
                   pool: Optional[TexturePool] = None,
                   cascade_matrices: Optional[torch.Tensor] = None,
                   tri_valid: Optional[torch.Tensor] = None,
                   band: Optional[BandSpec] = None):
    """The shadow pass: a depth-only raster of the scene from the light.
    With the alpha test it peels two layers and a textured surface whose
    base alpha is below 0.1 casts no shadow. Returns (shadow_map (S, S),
    shadow_overflow ()); with cfg.shadow_cascades > 1 one pass, and one
    launch of the raster, per cascade matrix: ((C, S, S), the largest
    overflow). `tri_valid` replaces the scene's triangle validity (a LOD
    scene's camera-dependent mask). With `band`, only that band's rows of
    the map: (S / n, S) or (C, S / n, S), and its own overflow."""
    alpha_shadow = cfg.alpha_test and cfg.textured and pool is not None
    s = cfg.shadow_resolution
    rows, sy0 = shadow_band(cfg, band)

    def depth_only(matrix):
        setup, bins = shadow_pass_bins(cfg, scene, world, matrix, tri_valid,
                                       band)
        vis = rasterize(setup, bins, rows, s, cfg.shadow_rows,
                        cfg.shadow_tile, y0=sy0,
                        layers=2 if alpha_shadow else 1)
        if alpha_shadow:
            vis = resolve_alpha_test(
                vis, setup, scene.tri_v, scene.tri_draw, scene.materials,
                scene.uv, pool, cutoff_override=0.1, y0=sy0,
                vert_uid=scene.vert_uid,
            )
        return vis.depth, bins.overflow

    with record_function("pass_shadow"):
        world = shadow_world(scene, models)
        if cfg.shadow_cascades <= 1:
            return depth_only(light_matrix)
        maps, overflows = zip(*(depth_only(cascade_matrices[i])
                                for i in range(cfg.shadow_cascades)))
        return torch.stack(maps), torch.stack(overflows).amax()


def lod_tri_mask(cfg: FrameConfig, scene: SceneBuffers, uni: FrameUniforms):
    """pass_lod: (T,) bool, the triangles of each draw's selected LOD level,
    none of a draw below cfg.lod_cull_threshold screen coverage. Coverage is
    the projected bounding sphere's share of the screen: the world centre's
    clip w, and the local extents' length times the model's largest axis
    scale for the radius. The selected level is the first whose threshold
    the coverage reaches (the last level's is -inf)."""
    with record_function("pass_lod"):
        m, c = uni.models, scene.draw_center
        # The model and view-projection products as explicit sums over j
        # (no TF32 path): the world centre (D, 4), then its clip w.
        cw = ((m[:, :, 0] * c[:, 0:1] + m[:, :, 1] * c[:, 1:2])
              + m[:, :, 2] * c[:, 2:3]) + m[:, :, 3]
        vp = uni.view_proj
        wc = ((cw[:, 0] * vp[3, 0] + cw[:, 1] * vp[3, 1])
              + cw[:, 2] * vp[3, 2]) + cw[:, 3] * vp[3, 3]
        axis_scale = torch.linalg.vector_norm(m[:, :3, :3], dim=2).amax(-1)
        radius = torch.linalg.vector_norm(scene.draw_extents, dim=-1) * axis_scale
        px_r = radius / wc.clamp_min(1e-8) * (0.5 * max(cfg.width, cfg.height))
        coverage = (np.pi * px_r * px_r / (cfg.width * cfg.height)).clamp_max(1.0)
        coverage = torch.where(wc <= 0.0, 0.0, coverage)
        hit = coverage[:, None] >= scene.lod_thresholds  # (D, L)
        # argmax returns the first maximum: the first level that holds.
        sel = hit.to(torch.int32).argmax(dim=1)
        draw_live = coverage >= cfg.lod_cull_threshold
        tri_draw = scene.tri_draw.long()
        return (scene.tri_lod.long() == sel[tri_draw]) & draw_live[tri_draw]


def main_pass_setup(cfg: FrameConfig, scene: SceneBuffers,
                    uni: FrameUniforms,
                    tri_valid: Optional[torch.Tensor] = None,
                    prev_depth: Optional[torch.Tensor] = None):
    """Vertex stage, frustum and Hi-Z culling and back-cull setup of the
    main pass, at the internal raster size -> (verts, setup, visible_draws
    or None). `tri_valid` (default: the scene's) is the LOD-masked
    validity; `prev_depth` is the previous frame's (H, W) depth at the
    presentation size, whose pyramid the Hi-Z test reads when
    cfg.occlusion_culling."""
    rw, rh = raster_size(cfg)
    with record_function("pass_vertex"):
        tv = geometry.transform_vertices(
            uni.models, uni.view_proj, scene.position, scene.normal,
            scene.tangent, scene.vert_draw, vert_uid=scene.vert_uid,
        )
    if tri_valid is None:
        tri_valid = scene.tri_valid
    visible_draws = None
    if cfg.frustum_culling or cfg.occlusion_culling:
        with record_function("pass_cull"):
            pyr = None
            if cfg.occlusion_culling and prev_depth is not None:
                pyr = build_hiz(prev_depth)
            cull = cull_objects(
                scene.draw_center, scene.draw_extents, uni.models,
                scene.draw_enabled, uni.view_proj, pyr, cfg.width, cfg.height,
            )
            tri_valid = tri_valid & cull.visibility.bool()[scene.tri_draw.long()]
            visible_draws = cull.visible_count
    with record_function("pass_setup"):
        setup = geometry.triangle_setup(
            tv.clip, scene.tri_v, tri_valid, rw, rh, cull_mode="back",
        )
    return tv, setup, visible_draws


def main_pass_bins(cfg: FrameConfig, scene: SceneBuffers, uni: FrameUniforms,
                   tri_valid: Optional[torch.Tensor] = None,
                   prev_depth: Optional[torch.Tensor] = None,
                   band: Optional[BandSpec] = None):
    """main_pass_setup and the binning -> (verts, setup, bins,
    visible_draws or None). With `band`, the bins cover that band's rows
    (band_extent); everything before the binning is the whole frame's."""
    tv, setup, visible_draws = main_pass_setup(cfg, scene, uni, tri_valid,
                                               prev_depth)
    y0r, bhr, _ = band_extent(cfg, band)
    with record_function("pass_binning"):
        bins = _binner(cfg, scene.num_triangles)(
            setup.bbox, setup.valid, bhr, raster_size(cfg)[0], cfg.tile_h,
            cfg.tile_w, cfg.max_tris_per_tile, y0=y0r,
            keep_score=_keep_score(cfg, setup),
        )
    return tv, setup, bins, visible_draws


def _concat_vis_layers(a: VisibilityBuffer, b: VisibilityBuffer):
    """Append b's peel layers after a's (b must be strictly deeper:
    produced with depth_floor at a's deepest layer)."""
    layers = [x.layer(i) for x in (a, b) for i in range(x.num_layers)]
    return VisibilityBuffer.from_layers(
        torch.stack([z for z, _ in layers]), torch.stack([t for _, t in layers])
    )


def render_band(
    cfg: FrameConfig,
    scene: SceneBuffers,
    uni: FrameUniforms,
    shadow: Optional[tuple] = None,  # (shadow_map, shadow_overflow)
    pool: Optional[TexturePool] = None,
    lights: Optional[torch.Tensor] = None,  # (L, 16) packed GpuLight rows
    prev_depth: Optional[torch.Tensor] = None,  # (H, W) last frame's depth
    ibl=None,  # ops/ibl.EnvironmentIBL, read when cfg.ibl_enabled
    band: Optional[BandSpec] = None,
) -> BandOutputs:
    """Vertex stage -> LOD -> culling -> raster -> shade over the full
    frame, or over the rows of `band` (band_extent): then only the row
    offsets change, and the vertex stage, LOD and culling (Hi-Z over the
    whole previous depth) are the full frame's. `shadow` is the shadow
    pass's output, the whole map. A shadowed frame without LOD must be
    given it. A LOD frame may be given it (rendered under the level mask,
    as parallel/sharded.py renders it in bands); without it the frame
    renders the whole map here under its own mask. A frame without
    shadows takes none. `pool` is sampled when cfg.textured, `lights` lit
    when cfg.lights_enabled. In band mode the colour, depth and velocity
    cover the band's rows and the scalars are the band's own
    (parallel/sharded.py sums and maxes them)."""
    if not 2 <= cfg.transparency_layers <= 8:
        raise ValueError(
            f"transparency_layers {cfg.transparency_layers} outside [2, 8]"
        )
    if shadow is not None and not cfg.shadow_enabled:
        raise ValueError("shadow map given but cfg.shadow_enabled is False")
    if shadow is None and cfg.shadow_enabled and not cfg.lod_enabled:
        raise ValueError("a shadowed frame without LOD needs its shadow map")
    edge = edge_msaa(cfg)
    sx, sy = ssaa_factors(cfg)
    rw, rh = raster_size(cfg)
    y0r, bhr, bhp = band_extent(cfg, band)
    tri_valid = scene.tri_valid
    if cfg.lod_enabled:
        tri_valid = tri_valid & lod_tri_mask(cfg, scene, uni)
        if cfg.shadow_enabled and shadow is None:
            shadow = shadow_program(cfg, scene, uni.models,
                                    uni.light_space_matrix, pool,
                                    uni.cascade_matrices, tri_valid)
    shadow_map, shadow_overflow = shadow if shadow is not None else (None, None)
    tv, setup, bins, visible_draws = main_pass_bins(cfg, scene, uni,
                                                    tri_valid, prev_depth,
                                                    band)
    blend = cfg.alpha_blend and cfg.shading == "pbr"
    alpha_main = (cfg.alpha_test and cfg.textured and pool is not None
                  and not blend)
    with record_function("pass_raster"):
        peel_layers = (cfg.transparency_layers if blend
                       else 2 if alpha_main else 1)
        vis = rasterize(setup, bins, bhr, rw, cfg.tile_h, cfg.tile_w,
                        y0=y0r, layers=peel_layers)
        if blend:
            # Iterated peel: each pass keeps only surfaces strictly behind
            # the previous pass's deepest kept layer, so appending keeps the
            # nearest-first order.
            for _ in range(cfg.transparency_passes - 1):
                floor, _ = vis.layer(vis.num_layers - 1)
                vis = _concat_vis_layers(vis, rasterize(
                    setup, bins, bhr, rw, cfg.tile_h, cfg.tile_w, y0=y0r,
                    layers=peel_layers, depth_floor=floor,
                ))
        if alpha_main:
            vis = resolve_alpha_test(
                vis, setup, scene.tri_v, scene.tri_draw, scene.materials,
                scene.uv, pool, y0=y0r, vert_uid=scene.vert_uid,
            )

    # Last frame's clip position of every vertex, for the motion vectors:
    # the world transform of the vertex stage under last frame's models.
    prev_clip = None
    if (cfg.taa_enabled and uni.prev_models is not None
            and uni.prev_view_proj is not None):
        with record_function("pass_gbuffer"):
            prev_clip = geometry.transform_points(
                uni.prev_view_proj, shadow_world(scene, uni.prev_models))

    # One G-buffer kernel launch a shaded layer on the card
    # (ops/gbuffer_cuda.py); the plain fetch on the CPU.
    def gbuffer(tri_id, motion=True, **kw):
        with record_function("pass_gbuffer"):
            return gbuffer_cuda.interpolate_gbuffer(
                tri_id, setup, scene.tri_v, scene.tri_draw, tv, scene.uv,
                scene.color, y0=y0r, vert_uid=scene.vert_uid,
                prev_clip=prev_clip if motion else None,
                fb_height=rh, fb_width=rw, **kw,
            )

    # Shared by every shaded layer; made once per device and colour.
    clear = constant(cfg.clear_color, torch.float32, setup.edge.device)

    tile_lights = tile_counts = None
    if cfg.lights_enabled and lights is not None:
        with record_function("pass_light_cull"):
            tl = cull_lights(
                lights, uni.view, torch.linalg.inv_ex(uni.projection).inverse,
                vis.depth, rw, rh,
                max_per_tile=cfg.max_lights_per_tile, tile=cfg.light_tile_size,
                tile_y0=y0r // cfg.light_tile_size,
            )
            # Each tile walks its own count, at most shaded_lights_per_tile
            # slots: no host sync on the card (ops/lights_cuda.py); on the
            # CPU the plain loop's trip count is the largest count (one
            # sync per shaded layer). Slots past a tile's count hold -1.
            tile_lights = tl.indices[:, :, :cfg.shaded_lights_per_tile]
            tile_counts = tl.counts
    tex_pool = pool if cfg.textured else None
    csm = ((uni.cascade_matrices, uni.cascade_splits, uni.view)
           if cfg.shadow_cascades > 1 else None)

    def shade(gbuf, pixel_xy=None, with_alpha=False):
        """The shaded layer's colour, and with `with_alpha` (colour, the
        blend's coverage alpha). PBR goes through ops/shade_cuda.py: on the
        card one surface-shading kernel launch a layer (three with the
        Forward+ lights: surface, the light kernel, compose), the coverage
        alpha without a pool in the same launch; on the CPU the plain
        shade_pbr and pixel_alpha."""
        with record_function("pass_shade"):
            if cfg.shading == "flat":
                color = shade_flat(gbuf, clear_color=clear)
                if not with_alpha:
                    return color
                return color, pixel_alpha(gbuf, scene.materials, tex_pool)
            return shade_cuda.shade_pbr(
                gbuf, scene.materials,
                ShadeUniforms(
                    camera_pos=uni.camera_pos,
                    light_direction=uni.light_direction,
                    light_color=uni.light_color,
                    ambient_color=uni.ambient_color,
                    light_space_matrix=uni.light_space_matrix,
                ),
                shadow_map=shadow_map, pool=tex_pool, clear_color=clear,
                reinhard=cfg.reinhard and not cfg.post_enabled,
                lights=lights if tile_lights is not None else None,
                tile_light_indices=tile_lights,
                tile_light_counts=tile_counts,
                light_tile_size=cfg.light_tile_size,
                max_anisotropy=cfg.max_anisotropy,
                csm=csm, csm_blend_size=cfg.csm_blend_size,
                ibl=ibl if cfg.ibl_enabled else None,
                dtype=(torch.bfloat16 if cfg.shade_dtype == "bf16"
                       else torch.float32),
                pixel_xy=pixel_xy, with_alpha=with_alpha,
            )

    msaa_edge_overflow = None
    dev = setup.edge.device
    if edge:
        # Edge-adaptive MSAA: the centre G-buffer (one point per pixel, uv
        # derivatives stepping one pixel), shaded; then the edge pixels'
        # samples through the worklist, shaded and box-averaged over it.
        with record_function("pass_gbuffer"):
            plan = msaa_edge.classify(vis.tri_id, vis.depth, sy, sx)
        gbuf = gbuffer(plan.primary_tid, deriv_step=(float(sx), float(sy)),
                       pixel_xy=msaa_edge.center_pixel_xy(
                           bhp, cfg.width, sy, sx, y0r, dev))
        color_c = shade(gbuf, pixel_xy=msaa_edge.center_tile_xy(
            bhp, cfg.width, sy, sx, dev))
        velocity = gbuf.velocity
        # A worklist per band, sized by the band's pixels.
        cap = msaa_edge.edge_capacity(bhp * cfg.width,
                                      cfg.msaa_edge_capacity, sx * sy)
        with record_function("pass_gbuffer"):
            wl = msaa_edge.build_worklist(vis.tri_id, plan, cap, sy, sx,
                                          y0r=y0r)
        gbuf_e = gbuffer(wl.tid, motion=False, pixel_xy=(wl.px, wl.py))
        color_e = shade(gbuf_e, pixel_xy=(wl.tile_px, wl.tile_py))
        with record_function("pass_resolve"):
            color = msaa_edge.resolve(color_c, color_e, wl, sx * sy)
            msaa_edge_overflow = (wl.n_edge - cap).clamp_min(0)
    elif not blend:
        gbuf = gbuffer(vis.tri_id)
        color, velocity = shade(gbuf), gbuf.velocity
    else:
        # Shade every peeled layer with the same shadow map, then composite
        # back to front over the clear colour.
        layers = []
        for i in range(vis.num_layers):
            gbuf = gbuffer(vis.layer(i)[1])
            layers.append(shade(gbuf, with_alpha=True))
            if i == 0:
                velocity = gbuf.velocity  # the nearest surface's motion
        with record_function("pass_shade"):
            color = clear.expand_as(layers[0][0])
            for color_l, alpha_l in reversed(layers):
                color = composite_over(color_l, alpha_l, color)
    depth = vis.depth
    if sx > 1 or sy > 1:
        # The resolve: the depth's min; under SSAA also the colour's and
        # the velocity's box mean (the edge path's are per pixel already).
        h, w = bhp, cfg.width
        with record_function("pass_resolve"):
            depth = depth.reshape(h, sy, w, sx).amin((1, 3))
            if not edge:
                color = color.reshape(h, sy, w, sx, 3).mean((1, 3))
                if velocity is not None:
                    velocity = velocity.reshape(h, sy, w, sx, 2).mean((1, 3))
    # Covered samples of the frame's rows only: a band's padding past the
    # frame's last row is cropped away, so it counts nothing (the
    # reference's band counts it; ROADMAP.md C).
    in_frame = vis.tri_id[:max(rh - y0r, 0)]
    return BandOutputs(
        color=color, depth=depth, velocity=velocity, shadow_map=shadow_map,
        covered=(in_frame >= 0).sum(dtype=torch.int32),
        overflow=bins.overflow, shadow_overflow=shadow_overflow,
        visible_draws=visible_draws, msaa_edge_overflow=msaa_edge_overflow,
    )


def _max_or_either(a, b):
    """The larger of two optional scalars (either alone when one is None)."""
    if a is None or b is None:
        return a if b is None else b
    return torch.maximum(a, b)


def merge_band_outputs(a: BandOutputs, b: BandOutputs) -> BandOutputs:
    """Depth-test composite of two opaque chunk renders of the same frame
    (b later in draw order: ties keep a, the submission-order rule of the
    raster's depth test). Shadow maps take their min, overflows their max;
    covered counts, visible draws and edge overflows sum (an overlap
    counts once per chunk)."""
    win_b = b.depth < a.depth
    velocity = None
    if a.velocity is not None and b.velocity is not None:
        velocity = torch.where(win_b[..., None], b.velocity, a.velocity)
    shadow_map = None
    if a.shadow_map is not None and b.shadow_map is not None:
        shadow_map = torch.minimum(a.shadow_map, b.shadow_map)

    def total(x, y):
        return x + y if x is not None and y is not None else None

    return BandOutputs(
        color=torch.where(win_b[..., None], b.color, a.color),
        depth=torch.minimum(a.depth, b.depth),
        velocity=velocity,
        shadow_map=shadow_map,
        covered=a.covered + b.covered,
        overflow=torch.maximum(a.overflow, b.overflow),
        shadow_overflow=_max_or_either(a.shadow_overflow, b.shadow_overflow),
        visible_draws=total(a.visible_draws, b.visible_draws),
        msaa_edge_overflow=total(a.msaa_edge_overflow, b.msaa_edge_overflow),
    )


def merge_shadows(a: tuple, b: tuple) -> tuple:
    """Two chunks' (shadow_map, shadow_overflow) -> the scene's: depth maps
    compose under min, the overflow is the larger."""
    return torch.minimum(a[0], b[0]), torch.maximum(a[1], b[1])


def _resize(img: torch.Tensor, height: int, width: int, mode: str):
    """Upsample an (H, W) or (H, W, C) image to (height, width). "bilinear"
    samples at half-pixel centres with the border clamped; "nearest-exact"
    takes the texel under each target centre."""
    x = img[..., None] if img.dim() == 2 else img
    kw = dict(align_corners=False) if mode == "bilinear" else {}
    y = F.interpolate(x.permute(2, 0, 1)[None], size=(height, width),
                      mode=mode, **kw)[0].permute(1, 2, 0)
    return y[..., 0] if img.dim() == 2 else y.contiguous()


def finalize_frame(
    cfg: FrameConfig,
    bo: BandOutputs,
    post: Optional[PostParams] = None,
    taa_params: Optional[TaaParams] = None,
    history: Optional[torch.Tensor] = None,  # (H, W, 3) last resolved frame
) -> FrameOutputs:
    """The post chain (TAAU upsample -> TAA -> bloom -> tonemap -> FXAA) and
    the RGBA8 pack. Without the post chain the colour is sRGB-encoded: the
    reference presents through an sRGB swapchain, shaders write linear
    colour and the u8 image is encoded."""
    color, velocity, depth = bo.color, bo.velocity, bo.depth
    if cfg.render_scale != 1.0 and color.shape[0] != cfg.height:
        # Upsample before the TAA blend: the jittered projection makes
        # successive internal frames sample other sub-pixel positions, so
        # the full-size history gathers real detail.
        with record_function("pass_taau"):
            color = _resize(color, cfg.height, cfg.width, "bilinear")
            if velocity is not None:
                velocity = _resize(velocity, cfg.height, cfg.width, "bilinear")
            depth = _resize(depth, cfg.height, cfg.width, "nearest-exact")
    new_history = None
    if cfg.post_enabled:
        if cfg.taa_enabled and taa_params is not None and history is not None:
            with record_function("pass_taa"):
                color = taa_resolve(color, history, taa_params,
                                    velocity=velocity)
                new_history = color
        p = post if post is not None else PostParams.default()
        bloom = None
        if cfg.bloom_enabled:
            with record_function("pass_bloom"):
                bloom = bloom_cuda.bloom_pyramid(
                    color, threshold=float(p.bloom_threshold),
                    soft_knee=float(p.bloom_soft_knee),
                    mip_count=cfg.bloom_mips,
                )
        with record_function("pass_tonemap"):
            color = tonemap_compose(
                color, bloom, p.exposure, p.gamma, p.bloom_intensity,
                operator=cfg.tonemap_operator,
            )
        encoded = color  # the tonemap pass applied the gamma
    else:
        encoded = _srgb_encode(color)
    if cfg.fxaa_enabled:
        with record_function("pass_fxaa"):
            encoded = fxaa(encoded)
    with record_function("pass_pack"):
        rgb = (encoded * 255.0 + 0.5).clamp(0.0, 255.0).to(torch.uint8)
        alpha = torch.full(
            (cfg.height, cfg.width, 1), 255, dtype=torch.uint8, device=rgb.device
        )
        image = torch.cat([rgb, alpha], dim=-1)
    if cfg.overflow_taint:
        image = overflow_taint(image, bo.overflow, bo.shadow_overflow)
    return FrameOutputs(
        image=image, color=color, depth=depth, shadow_map=bo.shadow_map,
        covered_pixels=bo.covered, binning_overflow=bo.overflow,
        visible_draws=bo.visible_draws, shadow_overflow=bo.shadow_overflow,
        history=new_history, msaa_edge_overflow=bo.msaa_edge_overflow,
    )


def overflow_taint(image: torch.Tensor, overflow: torch.Tensor,
                   shadow_overflow: Optional[torch.Tensor]) -> torch.Tensor:
    """Paint, in place, the (H, W, 4) u8 image's bottom-right block (8x8 at
    most) magenta where `overflow` > 0 and the block left of it cyan where
    `shadow_overflow` > 0, on the device: no host sync. The text overlay
    sits at the top left."""
    h, w = image.shape[:2]
    blk = max(min(8, h, w // 2), 1)
    paint = constant([[255, 0, 255], [0, 255, 255]], torch.uint8,
                     image.device)
    for i, of in enumerate((overflow, shadow_overflow)):
        if of is None:
            continue
        cols = slice(w - (i + 1) * blk, w - i * blk)
        block = image[h - blk:, cols, :3]
        image[h - blk:, cols, :3] = torch.where(of > 0, paint[i], block)
    return image


def render_frame_program(
    cfg: FrameConfig,
    scene: SceneBuffers,
    uni: FrameUniforms,
    shadow: Optional[tuple] = None,
    pool: Optional[TexturePool] = None,
    lights: Optional[torch.Tensor] = None,
    post: Optional[PostParams] = None,
    taa_params: Optional[TaaParams] = None,
    history: Optional[torch.Tensor] = None,
    prev_depth: Optional[torch.Tensor] = None,
    ibl=None,
) -> FrameOutputs:
    """One frame: render_band + finalize_frame."""
    return finalize_frame(
        cfg, render_band(cfg, scene, uni, shadow, pool, lights, prev_depth,
                         ibl),
        post, taa_params, history,
    )
