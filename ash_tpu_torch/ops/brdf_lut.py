"""Split-sum environment BRDF LUT (port of ash_tpu/ops/brdf_lut.py, after
the reference's shaders/brdf_lut.frag).

The (NdotV, roughness) -> (scale, bias) integration table of split-sum
image-based lighting: a Hammersley sequence and GGX importance sampling,
1024 samples per texel by default, evaluated for all texels and samples at
once (in row chunks, so the transient stays near 2^22 elements).
"""

from __future__ import annotations

import math

import torch

from ..device import resolve_device

SAMPLE_COUNT = 1024
# Texels x samples evaluated at once by integrate_brdf.
_CHUNK_ELEMENTS = 1 << 22


def _hammersley(n: int, device="cpu") -> torch.Tensor:
    """(n, 2) low-discrepancy points: i / n and the van der Corput radical
    inverse of i (its 32 bits reversed), exact in int64."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    bits = ((i << 16) | (i >> 16)) & 0xFFFFFFFF
    bits = ((bits & 0x55555555) << 1) | ((bits & 0xAAAAAAAA) >> 1)
    bits = ((bits & 0x33333333) << 2) | ((bits & 0xCCCCCCCC) >> 2)
    bits = ((bits & 0x0F0F0F0F) << 4) | ((bits & 0xF0F0F0F0) >> 4)
    bits = ((bits & 0x00FF00FF) << 8) | ((bits & 0xFF00FF00) >> 8)
    radical = bits.to(torch.float32) * 2.3283064365386963e-10
    return torch.stack([i.to(torch.float32) / n, radical], dim=-1)


def _integrate_rows(nv, rough, xi):
    """(scale, bias) for (P, 1) NdotV and roughness rows over the samples."""
    a = rough * rough  # (P, 1)
    phi = 2.0 * math.pi * xi[None, :, 0]  # (1, S)
    cos_t = torch.sqrt(
        (1.0 - xi[None, :, 1]) / (1.0 + (a * a - 1.0) * xi[None, :, 1])
    )  # (P, S)
    sin_t = torch.sqrt((1.0 - cos_t * cos_t).clamp_min(0.0))
    hx = torch.cos(phi) * sin_t
    hy = torch.sin(phi) * sin_t
    hz = cos_t  # N = +Z: the tangent frame is the identity

    vx = torch.sqrt((1.0 - nv * nv).clamp_min(0.0))  # (P, 1)
    vz = nv
    vdh = vx * hx + vz * hz
    # L = normalize(2 (V.H) H - V)
    lx = 2.0 * vdh * hx - vx
    ly = 2.0 * vdh * hy
    lz = 2.0 * vdh * hz - vz
    ln = torch.sqrt((lx * lx + ly * ly + lz * lz).clamp_min(1e-12))
    ndotl = (lz / ln).clamp_min(0.0)
    ndoth = hz.clamp_min(0.0)
    vdoth = vdh.clamp_min(0.0)

    k = (rough * rough) / 2.0  # the IBL remap of Smith's k

    def g1(nd):
        return nd / (nd * (1.0 - k) + k)

    g = g1(nv.clamp_min(0.0)) * g1(ndotl)
    g_vis = torch.where(ndotl > 0.0,
                        g * vdoth / (ndoth * nv).clamp_min(1e-6), 0.0)
    t = 1.0 - vdoth
    t4 = (t * t) * (t * t)
    fc = t * t4  # t ** 5 as the reference's integer power multiplies it
    return ((1.0 - fc) * g_vis).mean(-1), (fc * g_vis).mean(-1)


def integrate_brdf(ndotv, roughness, samples: int = SAMPLE_COUNT):
    """(scale, bias) for NdotV and roughness tensors of one broadcast shape:
    GGX importance sampling with a = roughness^2 around N = +Z, Smith
    geometry with k = roughness^2 / 2, L normalized."""
    ndotv = torch.as_tensor(ndotv, dtype=torch.float32)
    roughness = torch.as_tensor(roughness, dtype=torch.float32,
                                device=ndotv.device)
    nv, rough = torch.broadcast_tensors(ndotv, roughness)
    shape = nv.shape
    nv = nv.reshape(-1, 1).clamp_min(1e-4)
    rough = rough.reshape(-1, 1)
    xi = _hammersley(samples, nv.device)
    rows = max(_CHUNK_ELEMENTS // samples, 1)
    parts = [_integrate_rows(nv[i:i + rows], rough[i:i + rows], xi)
             for i in range(0, nv.shape[0], rows)]
    scale = torch.cat([p[0] for p in parts]).reshape(shape)
    bias = torch.cat([p[1] for p in parts]).reshape(shape)
    return scale, bias


def brdf_lut(size: int = 256, samples: int = SAMPLE_COUNT,
             device="cuda") -> torch.Tensor:
    """(size, size, 2) LUT: x = NdotV, y = roughness, at texel centres."""
    device = resolve_device(device)
    coords = (torch.arange(size, dtype=torch.float32, device=device) + 0.5) / size
    ndotv = coords[None, :].expand(size, size)
    rough = coords[:, None].expand(size, size)
    scale, bias = integrate_brdf(ndotv, rough, samples)
    return torch.stack([scale, bias], dim=-1)
