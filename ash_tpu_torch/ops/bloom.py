"""Bloom pyramid: soft threshold -> Karis downsample chain -> tent upsample
(port of ash_tpu/ops/bloom.py).

- threshold with a soft knee;
- 9-sample downsample with weights 0.25 centre / 0.125 edges / 0.0625
  corners, each sample Karis-weighted by 1 / (1 + luma) and renormalized;
- 9-tap tent upsample / 16.

Chain:
  down[0] = threshold(hdr) at full size
  down[i] = downsample(down[i-1])          i = 1..mips
  up[mips] = down[mips]
  up[i]   = tent(up[i+1]) + down[i]
  bloom   = tent(up[1])                    full size; the tonemap composite
                                           applies the intensity

All sampling is bilinear with CLAMP_TO_EDGE. The public functions take and
return (H, W, 3); inside, the chain is planar (3, H, W), so every tap of a
regular grid is a contiguous slice of an edge-padded image: the 2x
downsample samples at integer + 0.5 source positions (0.5/0.5 lerps of a
2x2 block), the 2x upsample at quarter-texel positions with fractions
0.25/0.75 fixed by the target's parity. A pyramid level of odd size takes
the general bilinear gather instead. The order of the arithmetic is the
reference's, tap by tap.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def to_planar(img: torch.Tensor) -> torch.Tensor:
    """(H, W, C) -> contiguous (C, H, W)."""
    return img.permute(2, 0, 1).contiguous()


def to_interleaved(img: torch.Tensor) -> torch.Tensor:
    """(C, H, W) -> contiguous (H, W, C)."""
    return img.permute(1, 2, 0).contiguous()


def pad_edge(img: torch.Tensor, top: int, bottom: int, left: int, right: int):
    """Edge-replicating pad of the last two axes of a (C, H, W) image."""
    if not (top or bottom or left or right):
        return img
    return F.pad(img[None], (left, right, top, bottom), mode="replicate")[0]


def shift_planar(img: torch.Tensor, oy: int, ox: int) -> torch.Tensor:
    """(C, H, W) shifted by (oy, ox) texels with CLAMP_TO_EDGE: out[y, x] =
    img[clamp(y + oy), clamp(x + ox)]."""
    h, w = img.shape[-2:]
    pt, pb = max(-oy, 0), max(oy, 0)
    pl, pr = max(-ox, 0), max(ox, 0)
    p = pad_edge(img, pt, pb, pl, pr)
    return p[:, pb:pb + h, pr:pr + w]


def shift_clamp(img: torch.Tensor, oy: int, ox: int) -> torch.Tensor:
    """An (H, W, ...) image shifted by integer (oy, ox) texels with
    CLAMP_TO_EDGE: bilinear_clamp at exact integer offsets, without the
    gather."""
    h, w = img.shape[:2]
    rows = (torch.arange(h, device=img.device) + oy).clamp(0, h - 1)
    cols = (torch.arange(w, device=img.device) + ox).clamp(0, w - 1)
    return img[rows][:, cols]


def target_uv(h: int, w: int, device):
    """Texel-centre uv grids of an (h, w) target, each (h, w)."""
    u = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
    v = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
    return u[None, :].expand(h, w), v[:, None].expand(h, w)


def bilinear_planar(img: torch.Tensor, u, v) -> torch.Tensor:
    """Bilinear sample of (C, H, W) at normalized (u, v) grids,
    CLAMP_TO_EDGE -> (C, *u.shape)."""
    c, h, w = img.shape
    px = u * w - 0.5
    py = v * h - 0.5
    x0f = torch.floor(px)
    y0f = torch.floor(py)
    fx = px - x0f
    fy = py - y0f
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    flat = img.reshape(c, h * w)

    def at(xi, yi):
        return flat[:, yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)]

    top = at(x0, y0) * (1 - fx) + at(x0 + 1, y0) * fx
    bot = at(x0, y0 + 1) * (1 - fx) + at(x0 + 1, y0 + 1) * fx
    return top * (1 - fy) + bot * fy


def bilinear_clamp(img: torch.Tensor, u, v) -> torch.Tensor:
    """Bilinear sample of (H, W, C) at normalized (u, v), CLAMP_TO_EDGE ->
    (*u.shape, C)."""
    return torch.movedim(bilinear_planar(to_planar(img), u, v), 0, -1)


def _down_tap(src: torch.Tensor, oy: int, ox: int) -> torch.Tensor:
    """Even-size downsample tap on (C, H, W): bilinear at
    (2x + 0.5 + ox, 2y + 0.5 + oy) with edge clamp, which is the 0.5/0.5
    lerps over an offset 2x2 source block, decimated by two."""
    h, w = src.shape[1:]
    p = pad_edge(src, 1, 2, 1, 2)

    def block(r0, c0):  # src[2y + r0 - 1, 2x + c0 - 1] for every (y, x)
        return p[:, r0:r0 + h:2, c0:c0 + w:2]

    a = block(oy + 1, ox + 1)
    b = block(oy + 1, ox + 2)
    c = block(oy + 2, ox + 1)
    d = block(oy + 2, ox + 2)
    return (a * 0.5 + b * 0.5) * 0.5 + (c * 0.5 + d * 0.5) * 0.5


# Per-parity (source shift, fraction) of a 2x-upsample axis lerp, by tap
# offset m in half source texels: target px = t / 2 - 0.25 + m / 2, for even
# t and for odd t.
_UP_TAB = {
    0: ((-1, 0.75), (0, 0.25)),
    1: ((0, 0.25), (0, 0.75)),
    -1: ((-1, 0.25), (-1, 0.75)),
    2: ((0, 0.75), (1, 0.25)),
    -2: ((-2, 0.75), (-1, 0.25)),
}


def _axis_up2(img: torch.Tensor, m: int, axis: int) -> torch.Tensor:
    """Double `axis` (1 or 2) of a (C, H, W) image by the parity-fixed
    bilinear lerp at half-texel offset m / 2, edge clamped."""
    n = img.shape[axis]
    q = pad_edge(img, 2, 2, 0, 0) if axis == 1 else pad_edge(img, 0, 0, 2, 2)
    outs = [q.narrow(axis, s + 2, n) * (1.0 - f) + q.narrow(axis, s + 3, n) * f
            for s, f in _UP_TAB[m]]
    shape = list(img.shape)
    shape[axis] = 2 * n
    return torch.stack(outs, dim=axis + 1).reshape(shape)


def _up_tap(src: torch.Tensor, my: int, mx: int) -> torch.Tensor:
    """Even-size upsample tap on (C, H, W): bilinear on the 2x target grid
    at a (my, mx) half-source-texel offset, one separable lerp per axis."""
    return _axis_up2(_axis_up2(src, mx, axis=2), my, axis=1)


_DOWN_TAPS = [
    ((0, 0), 0.25),
    ((-1, -1), 0.0625), ((1, -1), 0.0625),
    ((-1, 1), 0.0625), ((1, 1), 0.0625),
    ((-1, 0), 0.125), ((1, 0), 0.125),
    ((0, -1), 0.125), ((0, 1), 0.125),
]


def _downsample_karis(src: torch.Tensor) -> torch.Tensor:
    h, w = src.shape[1:]
    dh, dw = max(h // 2, 1), max(w // 2, 1)
    fast = h % 2 == 0 and w % 2 == 0 and h >= 2 and w >= 2
    if not fast:
        u, v = target_uv(dh, dw, src.device)
        dx, dy = 1.0 / w, 1.0 / h
    accs = None
    wsum = None
    for (ox, oy), wgt in _DOWN_TAPS:
        if fast:
            s = _down_tap(src, oy, ox)
        else:
            s = bilinear_planar(src, u + ox * dx, v + oy * dy)
        r, g, b = s[0], s[1], s[2]
        kw = wgt / (1.0 + (0.2126 * r + 0.7152 * g + 0.0722 * b))
        terms = [r * kw, g * kw, b * kw]
        accs = terms if accs is None else [a + t for a, t in zip(accs, terms)]
        wsum = kw if wsum is None else wsum + kw
    return torch.stack([a / wsum for a in accs])


def _upsample_tent(src: torch.Tensor, dh: int, dw: int,
                   intensity: float = 1.0) -> torch.Tensor:
    h, w = src.shape[1:]
    if dh == 2 * h and dw == 2 * w:
        def tap(my, mx):
            return _up_tap(src, my, mx)

        c = tap(0, 0) * 4.0
        c = c + (tap(-1, -1) + tap(-1, 1) + tap(1, 1) + tap(1, -1)) * 2.0
        c = c + (tap(0, -2) + tap(0, 2) + tap(-2, 0) + tap(2, 0))
        return c / 16.0 * intensity
    u, v = target_uv(dh, dw, src.device)
    dx, dy = 0.5 / w, 0.5 / h  # half a texel of the source

    def at(du, dv):
        return bilinear_planar(src, u + du, v + dv)

    c = bilinear_planar(src, u, v) * 4.0
    c = c + (at(-dx, -dy) + at(dx, -dy) + at(dx, dy) + at(-dx, dy)) * 2.0
    c = c + (at(-2 * dx, 0.0) + at(2 * dx, 0.0) + at(0.0, -2 * dy)
             + at(0.0, 2 * dy))
    return c / 16.0 * intensity


def _contribution(brightness, threshold: float, soft_knee: float):
    soft = brightness - threshold + soft_knee
    soft = soft.clamp(0.0, 2.0 * soft_knee)
    soft = soft * soft / (4.0 * soft_knee + 1e-5)
    contribution = torch.maximum(soft, brightness - threshold)
    return contribution / brightness.clamp_min(1e-5)


def soft_threshold(color: torch.Tensor, threshold: float,
                   soft_knee: float) -> torch.Tensor:
    """Soft-knee brightness threshold. (H, W, 3) in and out."""
    brightness = color.amax(dim=-1, keepdim=True)
    return color * _contribution(brightness, threshold, soft_knee)


def downsample_karis(src: torch.Tensor) -> torch.Tensor:
    """Half-size downsample with Karis firefly suppression. (H, W, 3) in
    and out."""
    return to_interleaved(_downsample_karis(to_planar(src)))


def upsample_tent(src: torch.Tensor, dh: int, dw: int,
                  intensity: float = 1.0) -> torch.Tensor:
    """9-tap tent upsample to (dh, dw). (H, W, 3) in and out."""
    return to_interleaved(_upsample_tent(to_planar(src), dh, dw, intensity))


def bloom_pyramid(
    hdr: torch.Tensor,  # (H, W, 3) linear HDR
    threshold: float = 0.8,
    soft_knee: float = 0.5,
    mip_count: int = 5,
) -> torch.Tensor:
    """The whole bloom chain -> (H, W, 3) bloom buffer, its intensity not
    applied (the tonemap composite multiplies it)."""
    x = to_planar(hdr)
    h, w = x.shape[1:]
    brightness = torch.maximum(x[0], torch.maximum(x[1], x[2]))
    down = [x * _contribution(brightness, threshold, soft_knee)]
    for _ in range(mip_count):
        if min(down[-1].shape[1:]) <= 2:
            break
        down.append(_downsample_karis(down[-1]))

    up = down[-1]
    for i in range(len(down) - 2, 0, -1):
        dh, dw = down[i].shape[1:]
        up = _upsample_tent(up, dh, dw) + down[i]
    return to_interleaved(_upsample_tent(up, h, w))
