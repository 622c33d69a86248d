"""Deferred shading over the visibility buffer (port of ash_tpu/ops/shade.py:
PBR with textures, one directional light with PCF16 shadows from a single
map or cascades, Forward+ point and spot lights, image-based lighting, bf16
shading, the alpha test, motion vectors for TAA, and flat vertex-colour
shading).

Attributes are re-interpolated per pixel from the winning triangle id with
perspective-correct weights, then lit with the reference fragment shader's
Cook-Torrance model: GGX distribution, Smith-Schlick geometry with
k = (r+1)^2/8, Fresnel-Schlick, roughness floored at 0.04, the specular cap
min(spec, 10/max(0.04, F0)), kD = (1-F)(1-metallic), 16-tap PCF on the
geometric normal, ambient times occlusion, emissive, and optional in-shader
Reinhard (off when the HDR post chain follows). With a texture pool the
five maps (base colour, normal, metallic-roughness, occlusion, emissive)
are sampled with anisotropic filtering (ops/texture_cuda.py: a CUDA kernel
on the card), and the normal map goes through the Gram-Schmidt TBN frame.
The Forward+ light loop is ops/lights_cuda.py's (a CUDA kernel on the
card; its plain version and the BRDF terms are in ops/light_loop.py). The
shadow term is ops/shadow_cuda.py's (one CUDA kernel on the card for the
single map and the cascades; its plain version is ops/shadow.py).
`resolve_alpha_test` lets cut-out pixels fall through to the second peel
layer; `pixel_alpha` and `composite_over` blend the shaded layers of a depth
peel. With an environment, split-sum image-based lighting replaces the flat
ambient term (ops/ibl.py); `dtype=torch.bfloat16` runs the BRDF in bf16.
Edge-adaptive MSAA (ops/msaa_edge.py) interpolates and shades at explicit
coordinates (`pixel_xy`, `deriv_step`) in place of the pixel grid.
The frames shade through ops/shade_cuda.py, whose CUDA kernels compute
shade_pbr's f32 flat-ambient path on the card bit for bit; shade_pbr here
is their plain version, and what CPU tensors, bf16 shading and IBL run.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..device import constant
from . import lights_cuda, shadow_cuda
from . import texture_cuda, texture_sample
from .geometry import TransformedVerts, TriangleSetup, _cross
# The BRDF terms and the plain light loop live in ops/light_loop.py, which
# ops/lights_cuda.py imports too; their names stay importable from here.
from .light_loop import (  # noqa: F401
    PI,
    _dot,
    _normalize,
    distribution_ggx,
    fresnel_schlick,
    geometry_schlick_ggx,
    geometry_smith,
    light_slots as _light_slots,
)
from .texture_sample import _norm, map_footprint, sample_footprint


class ShadeUniforms(NamedTuple):
    """Per-frame shading constants."""

    camera_pos: torch.Tensor  # (3,)
    light_direction: torch.Tensor  # (3,) direction the light POINTS
    light_color: torch.Tensor  # (3,)
    ambient_color: torch.Tensor  # (3,)
    light_space_matrix: torch.Tensor  # (4, 4)


def _interp(pw, attr3):
    """Weighted sum of per-vertex attributes: pw (..., 3) x attr3 (..., 3, C)."""
    return (pw[..., :, None] * attr3).sum(-2)


def _pixel_grid(h, w, y0, device):
    """Pixel-centre coordinates of an (h, w) band starting at global row y0."""
    px = torch.arange(w, dtype=torch.int32, device=device).to(torch.float32) + 0.5
    py = (torch.arange(h, dtype=torch.int32, device=device) + y0).to(
        torch.float32
    ) + 0.5
    return px[None, :].expand(h, w), py[:, None].expand(h, w)


def _perspective_weights(edge, px, py):
    """Perspective-correct barycentric weights from homogeneous edge rows:
    lam_i = edge_i . (px, py, 1); w_i = lam_i / sum(lam). The one copy of
    this formula: interpolate_gbuffer and resolve_alpha_test both use it."""
    lam = edge[..., 0] * px[..., None] + edge[..., 1] * py[..., None] + edge[..., 2]
    s = lam.sum(-1, keepdim=True)
    return lam / torch.where(s.abs() < 1e-12, 1.0, s)


class GBuffer(NamedTuple):
    """Interpolated per-pixel attributes."""

    mask: torch.Tensor  # (H, W) bool covered
    world: torch.Tensor  # (H, W, 3)
    normal: torch.Tensor  # (H, W, 3) geometric normal, normalized
    tangent: torch.Tensor  # (H, W, 4)
    uv: torch.Tensor  # (H, W, 2)
    color: torch.Tensor  # (H, W, 3) vertex colour
    front_facing: torch.Tensor  # (H, W) bool
    draw_id: torch.Tensor  # (H, W) int32
    uv_ddx: torch.Tensor  # (H, W, 2) d(uv)/dx, for mip selection
    uv_ddy: torch.Tensor  # (H, W, 2)
    # (H, W, 2) uv motion since the last frame, for TAA; None without it.
    velocity: Optional[torch.Tensor] = None


def interpolate_gbuffer(
    tri_id: torch.Tensor,  # (H, W) int32
    setup: TriangleSetup,
    tri_v: torch.Tensor,  # (T, 3) expanded vertex ids
    tri_draw: torch.Tensor,  # (T,)
    verts: TransformedVerts,
    vert_uv: torch.Tensor,  # (Vu, 2) unique-pool attribute
    vert_color: torch.Tensor,  # (Vu, 3) unique-pool attribute
    y0: int = 0,  # global framebuffer row of this band
    vert_uid: Optional[torch.Tensor] = None,  # (Ve,) -> unique vertex
    prev_clip: Optional[torch.Tensor] = None,  # (Ve, 4) last frame's clip pos
    fb_height: Optional[int] = None,  # the whole framebuffer's size, for
    fb_width: Optional[int] = None,  # the velocity's uv (bands)
    pixel_xy: Optional[tuple] = None,  # (px, py) f32 global render coords
    deriv_step: tuple = (1.0, 1.0),  # the uv derivatives' step, render px
) -> GBuffer:
    """Interpolate the winning triangles' attributes. `tri_id` may have any
    2-D shape when `pixel_xy` gives each element's global render
    coordinates (edge-adaptive MSAA's pixel centres and worklist samples,
    ops/msaa_edge.py); by default they are the (h, w) pixel grid from row
    y0. The uv derivatives step `deriv_step` render pixels: (sx, sy) when
    shading at the centre rate keeps the 1x footprint for mip selection."""
    h, w = tri_id.shape
    mask = tri_id >= 0
    t = tri_id.clamp_min(0).long()
    vids = tri_v.long()[t]  # (H, W, 3) expanded vertex ids
    uids = vert_uid.long()[vids] if vert_uid is not None else vids
    edge = setup.edge[t]  # (H, W, 3, 3)
    px, py = (pixel_xy if pixel_xy is not None
              else _pixel_grid(h, w, y0, tri_id.device))

    pw = _perspective_weights(edge, px, py)
    uv3 = vert_uv[uids]
    uv = _interp(pw, uv3)
    # Analytic screen-space uv derivatives: re-evaluate the projective
    # interpolation deriv_step pixels right and down.
    uv_x = _interp(_perspective_weights(edge, px + deriv_step[0], py), uv3)
    uv_y = _interp(_perspective_weights(edge, px, py + deriv_step[1]), uv3)

    # Motion vectors: interpolate last frame's clip position of this surface
    # point, project it, and take the pixel's own uv minus it.
    velocity = None
    if prev_clip is not None:
        pc = _interp(pw, prev_clip[vids])  # (H, W, 4)
        pc_w = torch.where(pc[..., 3].abs() < 1e-6, 1e-6, pc[..., 3])
        prev_uv = pc[..., :2] / pc_w[..., None] * 0.5 + 0.5
        cur_uv = torch.stack([px / (fb_width if fb_width is not None else w),
                              py / (fb_height if fb_height is not None else h)],
                             -1)
        velocity = torch.where((mask & (pc[..., 3] > 0.0))[..., None],
                               cur_uv - prev_uv, 0.0)
    return GBuffer(
        mask=mask,
        world=_interp(pw, verts.world[vids]),
        normal=_normalize(_interp(pw, verts.normal[vids])),
        tangent=_interp(pw, verts.tangent[vids]),
        uv=uv,
        color=_interp(pw, vert_color[uids]),
        front_facing=setup.det[t] < 0.0,
        draw_id=tri_draw[t],
        uv_ddx=uv_x - uv,
        uv_ddy=uv_y - uv,
        velocity=velocity,
    )


def resolve_alpha_test(
    vis,  # VisibilityBuffer with 2 layers (depth2 / tri_id2 set)
    setup: TriangleSetup,
    tri_v: torch.Tensor,
    tri_draw: torch.Tensor,
    materials: torch.Tensor,  # (D, 18)
    vert_uv: torch.Tensor,  # (Vu, 2) unique-pool attribute
    pool: texture_sample.TexturePool,
    cutoff_override: Optional[float] = None,
    y0: int = 0,
    vert_uid: Optional[torch.Tensor] = None,  # (Ve,) -> unique vertex
):
    """Alpha test (cutout) over a two-layer visibility buffer.

    Samples the nearest surface's base-colour alpha (texture at LOD 0 times
    the factor) at each pixel; where the material's alpha_cutoff rejects
    it, the pixel falls through to the second-nearest layer (a cut-out
    pixel of the second layer would show the background).
    `cutoff_override` applies one threshold to every material with a base
    texture, the shadow pass's semantics (alpha < 0.1 casts no shadow).
    Returns a one-layer VisibilityBuffer.
    """
    from .raster import VisibilityBuffer

    tri_id = vis.tri_id
    h, w = tri_id.shape
    mask = tri_id >= 0
    t = tri_id.clamp_min(0).long()
    vids = tri_v.long()[t]
    px, py = _pixel_grid(h, w, y0, tri_id.device)
    pw = _perspective_weights(setup.edge[t], px, py)
    uids = vert_uid.long()[vids] if vert_uid is not None else vids
    uv = _interp(pw, vert_uv[uids])

    mat = materials[tri_draw.long()[t]]
    base_idx = mat[..., 12].to(torch.int32)
    if cutoff_override is not None:
        cutoff = torch.where(base_idx >= 0, cutoff_override, 0.0)
    else:
        cutoff = mat[..., 17]
    alpha = texture_cuda.sample_trilinear(pool, base_idx, uv, None,
                                          mask=mask)[..., 3]
    alpha = alpha * mat[..., 3]
    discard = mask & (cutoff > 0.0) & (alpha < cutoff)
    return VisibilityBuffer(
        depth=torch.where(discard, vis.depth2, vis.depth),
        tri_id=torch.where(discard, vis.tri_id2, vis.tri_id),
    )


def pixel_alpha(
    gbuf: GBuffer,
    materials: torch.Tensor,  # (D, 18)
    pool: Optional[texture_sample.TexturePool] = None,
) -> torch.Tensor:
    """Per-pixel coverage alpha for blending: the base texture's alpha (at
    LOD 0; 1 untextured) times the base colour factor's, zeroed by the
    material's alpha_cutoff and on background pixels. Opaque materials
    (alpha 1, no cutoff) give exactly 1 on covered pixels."""
    mat = materials[gbuf.draw_id.long()]
    alpha = mat[..., 3]
    if pool is not None:
        base_idx = mat[..., 12].to(torch.int32)
        alpha = texture_cuda.sample_trilinear(
            pool, base_idx, gbuf.uv, None, mask=gbuf.mask)[..., 3] * alpha
    cutoff = mat[..., 17]
    alpha = torch.where((cutoff > 0.0) & (alpha < cutoff), 0.0, alpha)
    return torch.where(gbuf.mask, alpha, 0.0)


def composite_over(
    front_color: torch.Tensor,  # (H, W, 3)
    front_alpha: torch.Tensor,  # (H, W)
    back_color: torch.Tensor,  # (H, W, 3), already composed over the clear
) -> torch.Tensor:
    """SRC_ALPHA / ONE_MINUS_SRC_ALPHA blend (the reference pipeline's
    always-on blend state)."""
    a = front_alpha[..., None]
    return front_color * a + back_color * (1.0 - a)


def _sample_map(pool, index, uv, ddx, ddy, max_aniso: int = 1,
                trips: Optional[int] = None):
    """Sample a map with its analytic LOD and anisotropic filtering;
    index < 0 gives white."""
    return sample_footprint(pool, index, uv,
                            map_footprint(pool, index, ddx, ddy, max_aniso),
                            trips)


def shade_pbr(
    gbuf: GBuffer,
    materials: torch.Tensor,  # (D, 18) packed MaterialUniform rows
    uniforms: ShadeUniforms,
    shadow_map: Optional[torch.Tensor] = None,  # (S, S) or None
    pool: Optional[texture_sample.TexturePool] = None,
    clear_color=(0.0, 0.0, 0.0),
    reinhard: bool = True,
    lights: Optional[torch.Tensor] = None,  # (L, 16) packed GpuLight rows
    tile_light_indices: Optional[torch.Tensor] = None,  # (ty, tx, K) int32
    tile_light_counts: Optional[torch.Tensor] = None,  # (ty, tx) int32
    light_tile_size: int = 16,
    max_anisotropy: int = 1,
    csm: Optional[tuple] = None,  # (matrices (C, 4, 4), splits (4,), view (4, 4))
    csm_blend_size: float = 0.0,
    ibl=None,  # ops/ibl.EnvironmentIBL: replaces the flat ambient term
    dtype: torch.dtype = torch.float32,  # the BRDF's working dtype
    pixel_xy: Optional[tuple] = None,  # (px, py) int32 band-local render
    # coords per element, for the Forward+ tile lookup of a gbuffer that is
    # not the pixel grid (edge-adaptive MSAA, ops/msaa_edge.py)
) -> torch.Tensor:
    """Shade the visibility buffer -> (H, W, 3) f32 colour. With
    reinhard=True the result is the reference main pass's LDR output, with
    False linear HDR for the post chain. With `csm`, shadow_map is the
    (C, S, S) cascade array. With `ibl`, split-sum image-based lighting
    (ops/ibl.ambient_ibl) replaces the flat ambient term, times the same
    occlusion.

    dtype=torch.bfloat16 runs the BRDF and the light loop in bf16, with
    the casts where the reference puts them: the material factors, the
    view and light directions, the texture samples but emissive's, the
    normal frame, the dot products, GGX, Smith and Schlick, the shadow term
    and the per-light colour, attenuation and direction. Positions, the
    PCF lookups, light distances and attenuation, the ambient term and the
    final composite stay f32, and so does the result. PyTorch rounds each
    operation to bf16.

    With a pool, the five maps are sampled through
    ops/texture_cuda.sample_maps: on the card one kernel launch computes
    the five footprints and samples, each pixel running its own tap count
    (no host sync); on the CPU the plain sampler, whose trip count is each
    map's largest tap count (one host sync a map). Uncovered pixels'
    samples are 0. The Forward+ lights go through
    ops/lights_cuda.add_lights: on the card one kernel launch walks each
    covered pixel's own tile count, at most K slots (no host sync); on the
    CPU the plain loop runs min(largest tile count, K) slots (a host sync).
    Without tile_light_counts every one of the K slots is walked; slots
    past a tile's count hold -1 and add nothing. The shadow term goes
    through ops/shadow_cuda.shadow_pcf16 (with the light-space projection
    by uniforms.light_space_matrix) or shadow_pcf16_csm: on the card one
    kernel launch a call, reading the matrices, splits and view on the
    device (no host sync); on the CPU the plain ops/shadow.py."""
    if dtype == torch.float32:
        def cast(x):
            return x
    else:
        def cast(x):
            return x.to(dtype)
    mat = materials[gbuf.draw_id.long()]  # (H, W, 18)
    base_factor = cast(mat[..., 0:4])
    emissive_factor = cast(mat[..., 4:8])

    view_dir = cast(_normalize(uniforms.camera_pos - gbuf.world))
    light_dir = cast(_normalize(-uniforms.light_direction)).expand_as(gbuf.world)

    # The geometric normal with its backface flip; the shadow uses it.
    flip = torch.where(gbuf.front_facing[..., None], 1.0, -1.0).to(dtype)
    n = cast(gbuf.normal) * flip
    normal = n
    metallic = cast(mat[..., 8])
    roughness = cast(mat[..., 9]).clamp_min(0.04)
    base_color = base_factor[..., :3]  # untextured: the base sample is 1
    occlusion = None
    emissive = emissive_factor[..., :3]
    if pool is not None:
        names = ("base", "normal", "mr", "occ", "emis")
        indices = mat[..., 12:17].to(torch.int32)
        idx = dict(zip(names, indices.unbind(-1)))
        # Each sample leaves the dict where it is used, so the ones used up
        # early (base colour, occlusion) are freed there.
        samples = dict(zip(names, texture_cuda.sample_maps(
            pool, indices, gbuf.uv, gbuf.uv_ddx, gbuf.uv_ddy, max_anisotropy,
            gbuf.mask)))

        base_color = cast(samples.pop("base"))[..., :3] * base_factor[..., :3]

        # TBN with a safe fallback tangent, Gram-Schmidt and the backface
        # flip, then normal mapping.
        t_raw = cast(gbuf.tangent[..., :3])
        t_len = torch.linalg.vector_norm(t_raw, dim=-1, keepdim=True)
        t = torch.where(
            t_len > 1e-3, t_raw / t_len.clamp_min(1e-8),
            constant([1.0, 0.0, 0.0], dtype, t_raw.device),
        )
        g = cast(gbuf.normal)
        t = _normalize(t - _dot(t, g)[..., None] * g) * flip
        b = _cross(n, t) * cast(gbuf.tangent[..., 3:4])
        map_sample = cast(samples.pop("normal")[..., :3])
        mn = map_sample * 2.0 - 1.0
        mn = torch.cat([mn[..., :2] * cast(mat[..., 11, None]), mn[..., 2:]], -1)
        mapped = t * mn[..., 0:1] + b * mn[..., 1:2] + n * mn[..., 2:3]
        ok = ((_norm(map_sample) > 1e-3) & (_norm(mapped) > 1e-3)
              & (idx["normal"] >= 0))
        normal = torch.where(ok[..., None], _normalize(mapped), n)

        mr = cast(samples.pop("mr"))
        has_mr = idx["mr"] >= 0
        metallic = torch.where(has_mr, metallic * mr[..., 2], metallic)
        roughness = torch.where(
            has_mr, (roughness * mr[..., 1]).clamp_min(0.04), roughness)

        occ = cast(samples.pop("occ")[..., 0])
        occlusion = torch.where(idx["occ"] >= 0,
                                1.0 + (occ - 1.0) * cast(mat[..., 10]), 1.0)

        # Emissive's sample stays f32, as in the reference.
        es = samples.pop("emis")[..., :3]
        emissive = torch.where((idx["emis"] >= 0)[..., None],
                               emissive * es, emissive)

    ndotl = _dot(normal, light_dir).clamp_min(0.0)
    f0 = (1.0 - metallic[..., None]) * 0.04 + metallic[..., None] * base_color
    half_dir = _normalize(view_dir + light_dir)
    ndotv = _dot(normal, view_dir).clamp_min(0.001)
    ndoth = _dot(normal, half_dir).clamp_min(0.0)
    vdoth = _dot(view_dir, half_dir).clamp_min(0.0)

    d = distribution_ggx(ndoth, roughness)
    g = geometry_smith(ndotv, ndotl, roughness)
    f = fresnel_schlick(vdoth, f0)
    specular = (d * g)[..., None] * f / (4.0 * ndotv * ndotl + 0.001)[..., None]
    specular = torch.minimum(specular, 10.0 / f0.clamp_min(0.04))

    kd = (1.0 - f) * (1.0 - metallic[..., None])
    diffuse = kd * base_color / PI

    # The shadow uses the (flipped) geometric normal, not the mapped one;
    # PCF runs in f32 and its result re-enters the working dtype. On the
    # card one kernel launch (ops/shadow_cuda.py), the single map's
    # light-space projection included.
    if shadow_map is not None and csm is not None:
        matrices, splits, view = csm
        shadow = shadow_cuda.shadow_pcf16_csm(
            shadow_map, matrices, splits, view, gbuf.world, n, light_dir,
            blend_size=csm_blend_size,
        )
    elif shadow_map is not None:
        shadow = shadow_cuda.shadow_pcf16(
            shadow_map, uniforms.light_space_matrix, gbuf.world, n, light_dir)
    else:
        shadow = torch.zeros_like(ndotl)
    shadow = cast(shadow)

    lo = (diffuse + specular) * (
        cast(uniforms.light_color) * (ndotl * (1.0 - shadow))[..., None]
    )
    if lights is not None and tile_light_indices is not None:
        # In place: `lo` is this call's own tensor.
        lo = lights_cuda.add_lights(
            lo, gbuf.mask, gbuf.world, normal, view_dir,
            base_color.contiguous(), metallic.contiguous(), roughness, f0,
            ndotv, lights, tile_light_indices, tile_light_counts,
            light_tile_size,
            None if pixel_xy is None else tuple(c.contiguous() for c in pixel_xy))

    if ibl is not None:
        from .ibl import ambient_ibl

        ambient = ambient_ibl(ibl, normal, view_dir, base_color, metallic,
                              roughness)
    else:
        ambient = uniforms.ambient_color * base_color
    if occlusion is not None:
        ambient = ambient * occlusion[..., None]
    color = ambient + lo + emissive
    if reinhard:
        color = color / (color + 1.0)
    return torch.where(gbuf.mask[..., None], color,
                       clear_tensor(clear_color, color.device))


def shade_flat(gbuf: GBuffer, clear_color=(0.0, 0.0, 0.0)) -> torch.Tensor:
    """Flat vertex-colour shading."""
    return torch.where(gbuf.mask[..., None], gbuf.color,
                       clear_tensor(clear_color, gbuf.color.device))


def clear_tensor(clear_color, device) -> torch.Tensor:
    """The clear colour as an f32 tensor on `device`: a tensor as given
    (converted as torch.as_tensor converts it), a sequence from the shared
    constants, so no frame copies it from the host."""
    if isinstance(clear_color, torch.Tensor):
        return torch.as_tensor(clear_color, dtype=torch.float32, device=device)
    return constant(clear_color, torch.float32, device)
