"""Deferred shading over the visibility buffer (port of ash_tpu/ops/shade.py:
untextured PBR with one directional light and PCF16 shadows, and flat
vertex-colour shading).

Attributes are re-interpolated per pixel from the winning triangle id with
perspective-correct weights, then lit with the reference fragment shader's
Cook-Torrance model: GGX distribution, Smith-Schlick geometry with
k = (r+1)^2/8, Fresnel-Schlick, roughness floored at 0.04, the specular cap
min(spec, 10/max(0.04, F0)), kD = (1-F)(1-metallic), 16-tap PCF on the
geometric normal, flat ambient, emissive, and optional in-shader Reinhard.
`pixel_alpha` and `composite_over` blend the shaded layers of a depth peel
(semi-transparent materials). Textures, point/spot lights, CSM and IBL are
ROADMAP A10, A12 and A14.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import shadow as shadow_ops
from .geometry import TransformedVerts, TriangleSetup, transform_points

PI = 3.14159265359


class ShadeUniforms(NamedTuple):
    """Per-frame shading constants."""

    camera_pos: torch.Tensor  # (3,)
    light_direction: torch.Tensor  # (3,) direction the light POINTS
    light_color: torch.Tensor  # (3,)
    ambient_color: torch.Tensor  # (3,)
    light_space_matrix: torch.Tensor  # (4, 4)


def distribution_ggx(ndoth, roughness):
    a = roughness * roughness
    a2 = a * a
    denom = (ndoth * ndoth) * (a2 - 1.0) + 1.0
    return a2 / (PI * denom * denom)


def geometry_schlick_ggx(ndotx, k):
    return ndotx / (ndotx * (1.0 - k) + k)


def geometry_smith(ndotv, ndotl, roughness):
    r = roughness + 1.0
    k = (r * r) * 0.125
    return geometry_schlick_ggx(ndotv, k) * geometry_schlick_ggx(ndotl, k)


def fresnel_schlick(cos_theta, f0):
    t = (1.0 - cos_theta).clamp(0.0, 1.0)
    t2 = t * t
    t5 = t2 * t2 * t
    return f0 + (1.0 - f0) * t5[..., None]


def _normalize(v, eps=1e-8):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(eps)


def _dot(a, b):
    return (a * b).sum(-1)


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
    lam_i = edge_i . (px, py, 1); w_i = lam_i / sum(lam)."""
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
) -> GBuffer:
    h, w = tri_id.shape
    mask = tri_id >= 0
    t = tri_id.clamp_min(0).long()
    vids = tri_v.long()[t]  # (H, W, 3) expanded vertex ids
    uids = vert_uid.long()[vids] if vert_uid is not None else vids
    edge = setup.edge[t]  # (H, W, 3, 3)
    px, py = _pixel_grid(h, w, y0, tri_id.device)

    pw = _perspective_weights(edge, px, py)
    uv3 = vert_uv[uids]
    uv = _interp(pw, uv3)
    # Analytic screen-space uv derivatives: re-evaluate the projective
    # interpolation one pixel right and one pixel down.
    uv_x = _interp(_perspective_weights(edge, px + 1.0, py), uv3)
    uv_y = _interp(_perspective_weights(edge, px, py + 1.0), uv3)
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
    )


def shade_pbr(
    gbuf: GBuffer,
    materials: torch.Tensor,  # (D, 18) packed MaterialUniform rows
    uniforms: ShadeUniforms,
    shadow_map: Optional[torch.Tensor] = None,  # (S, S) or None
    clear_color=(0.0, 0.0, 0.0),
    reinhard: bool = True,
) -> torch.Tensor:
    """Shade the visibility buffer -> (H, W, 3) f32 colour (untextured).
    With reinhard=True the result is the reference main pass's LDR output."""
    mat = materials[gbuf.draw_id.long()]  # (H, W, 18)
    base_factor = mat[..., 0:4]
    emissive_factor = mat[..., 4:8]
    metallic = mat[..., 8]
    roughness = mat[..., 9].clamp_min(0.04)

    view_dir = _normalize(uniforms.camera_pos - gbuf.world)
    light_dir = _normalize(-uniforms.light_direction).expand_as(gbuf.world)
    base_color = base_factor[..., :3]  # untextured: the base sample is 1

    # TBN's normal with its backface flip (the tangent frame only matters
    # for normal maps, which are ROADMAP A10).
    n = gbuf.normal
    flip = torch.where(gbuf.front_facing[..., None], 1.0, -1.0)
    normal = n * flip
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

    # The shadow uses the (flipped) geometric normal.
    if shadow_map is not None:
        pos_light = transform_points(uniforms.light_space_matrix, gbuf.world)
        shadow = shadow_ops.shadow_pcf16(shadow_map, pos_light, normal, light_dir)
    else:
        shadow = torch.zeros_like(ndotl)

    lo = (diffuse + specular) * (
        uniforms.light_color * (ndotl * (1.0 - shadow))[..., None]
    )
    ambient = uniforms.ambient_color * base_color
    color = ambient + lo + emissive_factor[..., :3]
    if reinhard:
        color = color / (color + 1.0)
    clear = torch.as_tensor(clear_color, dtype=torch.float32, device=color.device)
    return torch.where(gbuf.mask[..., None], color, clear)


def shade_flat(gbuf: GBuffer, clear_color=(0.0, 0.0, 0.0)) -> torch.Tensor:
    """Flat vertex-colour shading."""
    clear = torch.as_tensor(
        clear_color, dtype=torch.float32, device=gbuf.color.device
    )
    return torch.where(gbuf.mask[..., None], gbuf.color, clear)


def pixel_alpha(
    gbuf: GBuffer,
    materials: torch.Tensor,  # (D, 18)
    pool=None,
) -> torch.Tensor:
    """Per-pixel coverage alpha for blending: the base colour factor's
    alpha (the base texture's alpha is 1 untextured), zeroed by the
    material's alpha_cutoff and on background pixels. Opaque materials
    (alpha 1, no cutoff) give exactly 1 on covered pixels."""
    if pool is not None:
        raise NotImplementedError(
            "pixel_alpha with a texture pool is not ported yet (ROADMAP.md A10)"
        )
    mat = materials[gbuf.draw_id.long()]
    alpha = mat[..., 3]
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
