"""Image-based lighting (port of ash_tpu/ops/ibl.py): an equirectangular
HDR environment becomes

- an irradiance map (cosine-weighted convolution at a small size, numpy at
  build time) for the diffuse term,
- a prefiltered radiance pyramid for the specular term, mip l for
  roughness l / (mips - 1): the GGX lobe convolved by importance sampling
  (`prefilter_environment_ggx`, the default) or the box-mip chain
  (`prefilter_environment`),
- and the split-sum BRDF LUT (ops/brdf_lut.py):

    specular = prefiltered(R, roughness) * (F0 * scale + bias)
    diffuse  = irradiance(N) * albedo * kD

`build_environment` runs its steps on the device it is given (the card
unless the caller asks for the CPU).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..device import constant, resolve_device
from ..errors import InvalidOperation
from .brdf_lut import _hammersley, brdf_lut
from .geometry import _cross


class EnvironmentIBL(NamedTuple):
    """The IBL bundle on the device (see build_environment)."""

    radiance: torch.Tensor  # (TOTAL, 3) flat prefiltered mips
    table: np.ndarray  # (L, 3) host int64: offset, width, height per mip
    levels: int
    irradiance: torch.Tensor  # (IH, IW, 3) diffuse convolution
    lut: torch.Tensor  # (N, N, 2) split-sum BRDF integration


def _dirs_for_equirect(h: int, w: int) -> np.ndarray:
    """(h, w, 3) unit directions of the equirect texel centres."""
    v = (np.arange(h) + 0.5) / h
    u = (np.arange(w) + 0.5) / w
    theta = v * np.pi  # 0 at the +Y pole
    phi = (u * 2.0 - 1.0) * np.pi
    st = np.sin(theta)[:, None]
    y = np.cos(theta)[:, None] * np.ones((1, w))
    x = st * np.cos(phi)[None, :]
    z = st * np.sin(phi)[None, :]
    return np.stack([x, y, z], axis=-1).astype(np.float32)


def irradiance_map(env: np.ndarray, out_h: int = 16) -> np.ndarray:
    """Cosine-weighted diffuse convolution of an (H, W, 3) equirect
    radiance (numpy, build time) -> (out_h, 2 * out_h, 3)."""
    h, w = env.shape[:2]
    dirs = _dirs_for_equirect(h, w).reshape(-1, 3)
    # Solid angle of each source texel: sin(theta) dtheta dphi.
    v = (np.arange(h) + 0.5) / h
    sa = (np.sin(v * np.pi) * (np.pi / h) * (2 * np.pi / w))
    weights = np.repeat(sa, w).astype(np.float32)
    radiance = env.reshape(-1, 3).astype(np.float32)

    out_w = out_h * 2
    out_dirs = _dirs_for_equirect(out_h, out_w).reshape(-1, 3)
    cos = np.clip(out_dirs @ dirs.T, 0.0, None)  # (O, H*W)
    irr = (cos * weights[None, :]) @ radiance / np.pi
    return irr.reshape(out_h, out_w, 3).astype(np.float32)


def prefilter_environment(env: np.ndarray, mips: int = 5):
    """Radiance pyramid by a box-filter chain (numpy): mip l roughly stands
    for roughness l / (mips - 1)."""
    out = [env.astype(np.float32)]
    cur = env.astype(np.float32)
    for _ in range(1, mips):
        h, w = cur.shape[:2]
        nh, nw = max(h // 2, 1), max(w // 2, 1)
        cur = cur[: nh * 2, : nw * 2].reshape(nh, 2, nw, 2, 3).mean((1, 3))
        out.append(cur)
    return out


def prefilter_environment_ggx(env: np.ndarray, mips: int = 5,
                              samples: int = 64, device="cuda"):
    """Importance-sampled GGX radiance pyramid (split-sum prefiltering):
    mip l is the environment convolved with the GGX lobe of roughness
    l / (mips - 1) under N = V = R. For each output direction N, Hammersley
    GGX half vectors H (a = roughness^2) give light directions
    L = 2 (N.H) H - N, and the radiance average is NdotL-weighted. Mip 0 is
    the environment. Returns the levels as (h, w, 3) tensors on `device`."""
    device = resolve_device(device)
    base = torch.as_tensor(np.asarray(env, np.float32), device=device)
    h0, w0 = env.shape[:2]
    flat = base.reshape(-1, 3)
    out = [base]

    xi = _hammersley(samples, device)  # (S, 2)
    phi = 2.0 * math.pi * xi[:, 0]  # (S,)
    y_axis = torch.tensor([0.0, 1.0, 0.0], device=device)
    x_axis = torch.tensor([1.0, 0.0, 0.0], device=device)

    for level in range(1, mips):
        rough = level / (mips - 1)
        a = rough * rough
        nh = max(h0 >> level, 4)
        nw = max(w0 >> level, 8)
        n = torch.from_numpy(_dirs_for_equirect(nh, nw).reshape(-1, 3)).to(
            device)  # (P, 3)

        # GGX half-vector samples in tangent space, shared by every texel.
        cos_t = torch.sqrt((1.0 - xi[:, 1]) / (1.0 + (a * a - 1.0) * xi[:, 1]))
        sin_t = torch.sqrt((1.0 - cos_t * cos_t).clamp_min(0.0))
        ht = torch.stack([torch.cos(phi) * sin_t, torch.sin(phi) * sin_t,
                          cos_t], -1)  # (S, 3)

        # Per-direction tangent frame.
        up = torch.where((n[:, 1].abs() < 0.999)[:, None], y_axis, x_axis)
        t = _cross(up, n)
        t = t / torch.linalg.vector_norm(t, dim=-1, keepdim=True).clamp_min(1e-8)
        b = _cross(n, t)

        # World half vectors (P, S, 3); V = N, so L = 2 (N.H) H - N.
        hw = (t[:, None] * ht[None, :, 0:1] + b[:, None] * ht[None, :, 1:2]
              + n[:, None] * ht[None, :, 2:3])
        ndoth = (n[:, None] * hw).sum(-1, keepdim=True)
        lw = 2.0 * ndoth * hw - n[:, None]
        ndotl = (n[:, None] * lw).sum(-1).clamp_min(0.0)  # (P, S)

        u, v = _equirect_uv(lw)
        radiance = _bilinear_flat(flat, 0, w0, h0, u, v)  # (P, S, 3)
        wsum = ndotl.sum(-1, keepdim=True).clamp_min(1e-6)
        color = (radiance * ndotl[..., None]).sum(1) / wsum
        out.append(color.reshape(nh, nw, 3))
    return out


def build_environment(
    env: np.ndarray, mips: int = 5, irradiance_size: int = 16,
    lut_size: int = 128, ggx_prefilter: bool = True,
    prefilter_samples: int = 64, device="cuda",
) -> EnvironmentIBL:
    """The IBL bundle of an equirect (H, W, 3) radiance, on `device`.
    ggx_prefilter=True convolves each mip with the GGX lobe; False takes
    the box-mip chain."""
    device = resolve_device(device)
    env = np.asarray(env, np.float32)
    if env.ndim != 3 or env.shape[2] != 3:
        raise InvalidOperation(f"environment map of shape {env.shape}, "
                               "want (H, W, 3)")
    if ggx_prefilter:
        pyramid = prefilter_environment_ggx(env, mips, prefilter_samples,
                                            device)
    else:
        pyramid = [torch.from_numpy(m).to(device)
                   for m in prefilter_environment(env, mips)]
    table = np.zeros((len(pyramid), 3), np.int64)
    off = 0
    for i, m in enumerate(pyramid):
        h, w = m.shape[:2]
        table[i] = (off, w, h)
        off += h * w
    return EnvironmentIBL(
        radiance=torch.cat([m.reshape(-1, 3) for m in pyramid]),
        table=table,
        levels=len(pyramid),
        irradiance=torch.from_numpy(irradiance_map(env, irradiance_size)).to(
            device),
        lut=brdf_lut(lut_size, device=device),
    )


def _equirect_uv(direction: torch.Tensor):
    d = direction / torch.linalg.vector_norm(
        direction, dim=-1, keepdim=True).clamp_min(1e-8)
    u = torch.atan2(d[..., 2], d[..., 0]) / (2.0 * math.pi) + 0.5
    v = torch.arccos(d[..., 1].clamp(-1.0, 1.0)) / math.pi
    return u, v


def _bilinear_flat(flat, off, w, h, u, v):
    """Bilinear sample of a flat equirect level: u wraps (a remainder, so
    a tap left of column 0 reads the last column), v clamps."""
    px = u * w - 0.5
    py = v * h - 0.5
    x0 = torch.floor(px).to(torch.int32)
    y0 = torch.floor(py).to(torch.int32)
    fx = (px - x0)[..., None]
    fy = (py - y0)[..., None]

    def at(xi, yi):
        xw = torch.remainder(xi, w)
        yc = torch.clamp_max(yi.clamp_min(0), h - 1)
        return flat[(off + yc * w + xw).long()]

    top = at(x0, y0) * (1 - fx) + at(x0 + 1, y0) * fx
    bot = at(x0, y0 + 1) * (1 - fx) + at(x0 + 1, y0 + 1) * fx
    return top * (1 - fy) + bot * fy


def sample_radiance(ibl: EnvironmentIBL, direction, lod):
    """Trilinear sample of the prefiltered pyramid along a direction."""
    u, v = _equirect_uv(direction)
    table = constant(ibl.table.astype(np.int32), torch.int32, u.device)
    lod = lod.clamp(0.0, ibl.levels - 1)
    l0 = torch.floor(lod).to(torch.int32)
    l1 = torch.clamp_max(l0 + 1, ibl.levels - 1)
    f = (lod - l0.to(torch.float32))[..., None]

    def level(li):
        e = table[li.long()]
        return _bilinear_flat(ibl.radiance, e[..., 0], e[..., 1], e[..., 2],
                              u, v)

    return level(l0) * (1 - f) + level(l1) * f


def sample_irradiance(ibl: EnvironmentIBL, normal):
    u, v = _equirect_uv(normal)
    ih, iw = ibl.irradiance.shape[:2]
    return _bilinear_flat(ibl.irradiance.reshape(-1, 3), 0, iw, ih, u, v)


def ambient_ibl(
    ibl: EnvironmentIBL,
    normal: torch.Tensor,  # (..., 3)
    view_dir: torch.Tensor,  # (..., 3)
    base_color: torch.Tensor,  # (..., 3)
    metallic: torch.Tensor,  # (...)
    roughness: torch.Tensor,  # (...)
) -> torch.Tensor:
    """Split-sum ambient term (replaces the flat ambient when an
    environment is set)."""
    ndotv = (normal * view_dir).sum(-1).clamp_min(1e-4)
    r = 2.0 * ndotv[..., None] * normal - view_dir

    f0 = (1.0 - metallic[..., None]) * 0.04 + metallic[..., None] * base_color
    lod = roughness * (ibl.levels - 1)
    prefiltered = sample_radiance(ibl, r, lod)

    n = ibl.lut.shape[0]
    xi = (ndotv * n).to(torch.int32).clamp(0, n - 1).long()
    yi = (roughness * n).to(torch.int32).clamp(0, n - 1).long()
    scale_bias = ibl.lut[yi, xi]  # (..., 2)
    specular = prefiltered * (f0 * scale_bias[..., 0:1] + scale_bias[..., 1:2])

    irr = sample_irradiance(ibl, normal)
    kd = (1.0 - f0) * (1.0 - metallic[..., None])
    diffuse = irr * base_color * kd
    return diffuse + specular
