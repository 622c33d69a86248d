"""Shadow-map sampling: 16-tap PCF from 4 gather quads (port of
ash_tpu/ops/shadow.py), against a single map or a cascade array.

The sampler clamps to a WHITE border: taps outside the map read depth 1.0
and never shadow. The light-space -> [0, 1]^3 mapping keeps the reference
shader's quirk of also remapping z by *0.5 + 0.5, so shadow placement
matches it exactly.
"""

from __future__ import annotations

import torch


def gather_quad(depth_map: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """textureGather on an (S, S) depth map at normalized (u, v): the 2x2
    bilinear footprint, shape (..., 4). Out-of-bounds texels read 1.0."""
    s_y, s_x = depth_map.shape
    x0 = torch.floor(u * s_x - 0.5).to(torch.int64)
    y0 = torch.floor(v * s_y - 0.5).to(torch.int64)
    taps = []
    for dy in (0, 1):
        for dx in (0, 1):
            xi = x0 + dx
            yi = y0 + dy
            inb = (xi >= 0) & (xi < s_x) & (yi >= 0) & (yi < s_y)
            d = depth_map[yi.clamp(0, s_y - 1), xi.clamp(0, s_x - 1)]
            taps.append(torch.where(inb, d, 1.0))
    return torch.stack(taps, dim=-1)


def shadow_pcf16(
    shadow_map: torch.Tensor,  # (S, S) light-space depth
    frag_pos_light: torch.Tensor,  # (..., 4) light-space clip position
    normal: torch.Tensor,  # (..., 3) geometric normal
    light_dir: torch.Tensor,  # (..., 3) or (3,) direction TOWARD the light
) -> torch.Tensor:
    """Fraction of the 16 PCF taps in shadow, 0..1."""
    w = frag_pos_light[..., 3]
    safe_w = torch.where(w.abs() < 1e-8, 1e-8, w)
    proj = frag_pos_light[..., :3] / safe_w[..., None]
    proj = proj * 0.5 + 0.5
    current = proj[..., 2]

    ndl = (normal * light_dir).sum(-1)
    bias = (0.05 * (1.0 - ndl)).clamp_min(0.005)
    compare = (current - bias)[..., None]

    ts = 1.0 / shadow_map.shape[0]
    u, v = proj[..., 0], proj[..., 1]
    shadow = torch.zeros_like(current)
    for ox, oy in ((-1.0, -1.0), (1.0, -1.0), (-1.0, 1.0), (1.0, 1.0)):
        quad = gather_quad(shadow_map, u + ox * ts, v + oy * ts)
        shadow = shadow + (compare > quad).to(torch.float32).sum(-1)
    shadow = shadow / 16.0
    # Beyond the light frustum's far plane: no shadow.
    return torch.where(proj[..., 2] > 1.0, 0.0, shadow)


def _gather_quad_layered(maps: torch.Tensor, layer: torch.Tensor, u, v):
    """textureGather on a (C, S, S) cascade array at a per-pixel layer."""
    _, s_y, s_x = maps.shape
    flat = maps.reshape(-1)
    x0 = torch.floor(u * s_x - 0.5).to(torch.int64)
    y0 = torch.floor(v * s_y - 0.5).to(torch.int64)
    base = layer * (s_y * s_x)
    taps = []
    for dy in (0, 1):
        for dx in (0, 1):
            xi = x0 + dx
            yi = y0 + dy
            inb = (xi >= 0) & (xi < s_x) & (yi >= 0) & (yi < s_y)
            idx = base + yi.clamp(0, s_y - 1) * s_x + xi.clamp(0, s_x - 1)
            taps.append(torch.where(inb, flat[idx], 1.0))
    return torch.stack(taps, dim=-1)


def _pcf16_at_layer(cascade_maps, cascade_matrices, layer, world, bias):
    """16-tap PCF against one per-pixel cascade layer (int64)."""
    mats = cascade_matrices[layer]  # (..., 4, 4)
    # The per-pixel matrix times (world, 1), summed component by component.
    pos_light = (
        (mats[..., :, 0] * world[..., 0:1] + mats[..., :, 1] * world[..., 1:2])
        + mats[..., :, 2] * world[..., 2:3]
    ) + mats[..., :, 3]
    w = pos_light[..., 3]
    proj = pos_light[..., :3] / torch.where(w.abs() < 1e-8, 1e-8, w)[..., None]
    proj = proj * 0.5 + 0.5
    compare = (proj[..., 2] - bias)[..., None]

    ts = 1.0 / cascade_maps.shape[1]
    u, v = proj[..., 0], proj[..., 1]
    shadow = torch.zeros_like(proj[..., 2])
    for ox, oy in ((-1.0, -1.0), (1.0, -1.0), (-1.0, 1.0), (1.0, 1.0)):
        quad = _gather_quad_layered(cascade_maps, layer, u + ox * ts, v + oy * ts)
        shadow = shadow + (compare > quad).to(torch.float32).sum(-1)
    shadow = shadow / 16.0
    return torch.where(proj[..., 2] > 1.0, 0.0, shadow)


def shadow_pcf16_csm(
    cascade_maps: torch.Tensor,  # (C, S, S) per-cascade depth
    cascade_matrices: torch.Tensor,  # (C, 4, 4) light-space matrices
    split_distances: torch.Tensor,  # (>= C,) cascade far distances (view space)
    view: torch.Tensor,  # (4, 4) camera view matrix
    world: torch.Tensor,  # (..., 3) world position
    normal: torch.Tensor,  # (..., 3)
    light_dir: torch.Tensor,  # (..., 3) toward the light
    blend_size: float = 0.0,  # CsmConfig.blend_size; 0 = hard selection
) -> torch.Tensor:
    """Cascaded 16-tap PCF: the cascade is chosen by the view-space distance
    against the splits, sampled with the single map's PCF, and optionally
    blended with the next cascade near its far split."""
    c = cascade_maps.shape[0]
    # Positive distance in front of the camera.
    view_z = -(((view[2, 0] * world[..., 0] + view[2, 1] * world[..., 1])
                + view[2, 2] * world[..., 2]) + view[2, 3])
    layer = (view_z[..., None] > split_distances[:c]).sum(-1).clamp(0, c - 1)

    ndl = (normal * light_dir).sum(-1)
    bias = (0.05 * (1.0 - ndl)).clamp_min(0.005)

    shadow = _pcf16_at_layer(cascade_maps, cascade_matrices, layer, world, bias)
    if blend_size > 0.0 and c > 1:
        # How close view_z is to this cascade's far split, as a fraction of
        # the split distance.
        split = split_distances[layer]
        frac = ((view_z - split * (1.0 - blend_size))
                / (split * blend_size).clamp_min(1e-6)).clamp(0.0, 1.0)
        next_layer = (layer + 1).clamp(0, c - 1)
        shadow_next = _pcf16_at_layer(
            cascade_maps, cascade_matrices, next_layer, world, bias
        )
        blend = torch.where(next_layer > layer, frac, 0.0)
        shadow = shadow * (1.0 - blend) + shadow_next * blend
    return shadow
