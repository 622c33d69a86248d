"""The Forward+ light loop's plain version and the BRDF terms it shares with
shade_pbr (port of the loop in ash_tpu/ops/shade.py:shade_pbr, a
jax.numpy `lax.fori_loop`).

`light_slots` is the plain version of csrc/lights.cu: ops/lights_cuda.py
runs it for CPU tensors, and the kernel is held to it bit for bit on the
card. ops/shade.py imports the BRDF terms from here, so neither module
imports the other's entry.
"""

from __future__ import annotations

import torch

from .texture_sample import _norm

PI = 3.14159265359


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


def light_slots(lo, world, lights, tile_indices, n_iter, light_tile_size,
                normal, view_dir, base_color, metallic, roughness, f0, ndotv,
                cast=lambda x: x, pixel_xy=None):
    """Add the Forward+ lights to `lo`: each element of the (H, W) grid
    that `world` (H, W, 3) covers walks the first n_iter slots of its
    tile's culled light list, its tile found from `pixel_xy` (band-local
    integer render coordinates) or else from its place in the grid. Point
    lights have a radius-windowed inverse-square falloff, spot lights (type
    1) a smooth cone between their inner and outer angles, directional
    entries (type 2) a constant direction and no falloff. Distances,
    attenuation and the cone run in f32; `cast` takes the colour, the
    attenuation and the direction into the shading dtype for the BRDF.
    Slots holding -1 add nothing."""
    h, w = world.shape[:2]
    dev = world.device
    if pixel_xy is not None:
        px, py = pixel_xy
    else:
        px = torch.arange(w, device=dev)[None, :]
        py = torch.arange(h, device=dev)[:, None]
    t_y = (py // light_tile_size).clamp(0, tile_indices.shape[0] - 1).long()
    t_x = (px // light_tile_size).clamp(0, tile_indices.shape[1] - 1).long()
    for k in range(n_iter):
        lid = tile_indices[:, :, k][t_y, t_x]  # (H, W)
        row = lights[lid.clamp_min(0).long()]  # (H, W, 16)
        lradius = row[..., 3].clamp_min(1e-3)
        lcolor = cast(row[..., 4:7] * row[..., 7:8])  # colour * intensity
        ltype = row[..., 11]  # 0 point, 1 spot, 2 directional
        to_light = row[..., 0:3] - world
        dist = _norm(to_light)
        ldir_pos = to_light / dist.clamp_min(1e-6)[..., None]
        ldir = torch.where((ltype >= 1.5)[..., None],
                           _normalize(-row[..., 8:11]), ldir_pos)
        # Windowed inverse-square attenuation; the powers are products, as
        # the reference's integer powers are.
        q = dist / lradius
        q2 = q * q
        win = (1.0 - q2 * q2).clamp(0.0, 1.0)
        atten = (win * win) / (dist * dist + 1.0)
        cos_angle = _dot(_normalize(row[..., 8:11]), -ldir_pos)
        cos_outer = torch.cos(row[..., 13].clamp_min(1e-3))
        cos_inner = torch.cos(row[..., 12].clamp_min(5e-4))
        spot = ((cos_angle - cos_outer)
                / (cos_inner - cos_outer).clamp_min(1e-4)).clamp(0.0, 1.0)
        atten = cast(torch.where(
            ltype >= 1.5, 1.0,
            torch.where(ltype >= 0.5, atten * spot * spot, atten),
        ))
        ldir = cast(ldir)
        nl = _dot(normal, ldir).clamp_min(0.0)
        half_l = _normalize(view_dir + ldir)
        nh = _dot(normal, half_l).clamp_min(0.0)
        vh = _dot(view_dir, half_l).clamp_min(0.0)
        dd = distribution_ggx(nh, roughness)
        gg = geometry_smith(ndotv, nl, roughness)
        ff = fresnel_schlick(vh, f0)
        spec_l = (dd * gg)[..., None] * ff / (4.0 * ndotv * nl + 0.001)[..., None]
        spec_l = torch.minimum(spec_l, 10.0 / f0.clamp_min(0.04))
        kd_l = (1.0 - ff) * (1.0 - metallic[..., None])
        contrib = (kd_l * base_color / PI + spec_l) * lcolor * (nl * atten)[..., None]
        lo = lo + torch.where((lid >= 0)[..., None], contrib, 0.0)
    return lo
