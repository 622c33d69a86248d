"""The texture kernel's entry points (ash_tpu_torch/ops/texture_cuda.py) and
its arithmetic, on the CPU; the kernel itself on the card.

- CPU tensors run the plain samplers (ops/texture_sample.py's sample_maps
  and sample_trilinear) bit for bit where the mask holds and 0 elsewhere,
  never load the library and count no launch.
- A numpy float32 mirror of csrc/texture.cu's per-item tap loop (every
  operation in the .cu's order, each element running only its own taps,
  summed in tap order), over the plain footprints, equals the plain sampler
  on the covered elements, bit for bit, over seeded inputs: the five maps
  at anisotropy 1 and 16, uv far outside [0, 1) (REPEAT), index -1
  (white), a streamed pool with min_level, tap counts reaching 16, and the
  alpha test's LOD-0 sample; also over a one-dimensional worklist (the edge
  MSAA resolve's shape).
- The argument checks raise on the wrong dtype, shape, device or layout.
- shade_pbr samples its five maps in one call, and the small textured frame
  renders the same through the entry points as with the plain sampler
  patched in.
- On the card (marked `cuda`, skipped here): the kernel against the plain
  sampler on the same CUDA tensors, bit for bit on covered elements and 0
  elsewhere, on the seeded cases, over them as worklists, and at the 1080p
  textured frame's own inputs; and the rounding
  probes: torch.linalg.vector_norm of a pair against the kernel's
  sqrt(rn(x*x) + rn(y*y)), and the fused footprint's LOD (its norms, log2,
  ceil and clamps) against the plain map_footprint's through a pool whose
  texels give the LOD's fraction exactly.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from ash_tpu_torch.core.texture import mip_chain
from ash_tpu_torch.ops import _build, shade, texture_cuda, texture_sample
from ash_tpu_torch.render import bench_scene

torch.set_num_threads(1)

F = np.float32


def _t(a):
    return torch.from_numpy(np.array(a))


def _pool(streamed=False, device="cpu"):
    """Three seeded textures; streamed: residency from level 1, 2 and 0 in a
    fixed-size arena, as render/bindless.py packs a budgeted pool."""
    rng = np.random.default_rng(21)
    pyramids = [mip_chain(None, rng.random((h, w, 4)).astype(np.float32))
                for h, w in ((64, 64), (32, 128), (13, 7))]
    kw = dict(min_levels=[1, 2, 0], arena_texels=12000) if streamed else {}
    return texture_sample.build_pool(pyramids, device=device, **kw)


def _elements(seed, n=(24, 40), uv_range=(-1.0, 2.0), white=0.2):
    """Seeded (indices (h, w, 5), uv, ddx, ddy, mask) over an (h, w) grid:
    uv derivatives whose axes have ratios up to 1:20 (tap counts reach 16),
    a share `white` of index -1, about 70% of the elements covered."""
    rng = np.random.default_rng(seed)
    shape = n
    angle = rng.uniform(0, 2 * np.pi, shape)
    major = rng.uniform(0.002, 0.2, shape)
    minor = major / rng.uniform(1.0, 20.0, shape)
    ax = np.stack([np.cos(angle), np.sin(angle)], -1)
    perp = np.stack([-np.sin(angle), np.cos(angle)], -1)
    ddx = (ax * major[..., None]).astype(np.float32)
    ddy = (perp * minor[..., None]).astype(np.float32)
    swap = rng.random(shape) < 0.5
    ddx[swap], ddy[swap] = ddy[swap].copy(), ddx[swap].copy()
    uv = rng.uniform(*uv_range, shape + (2,)).astype(np.float32)
    idx = rng.integers(0, 3, shape + (texture_cuda.MAPS,)).astype(np.int32)
    idx[rng.random(idx.shape) < white] = -1
    mask = rng.random(shape) < 0.7
    return idx, uv, ddx, ddy, mask


# name -> (max_anisotropy or None for the alpha test's LOD-0 sample,
#          streamed pool, _elements keywords)
CASES = {
    "aniso1": (1, False, {}),
    "aniso16": (16, False, {}),
    "repeat": (16, False, dict(uv_range=(-3.5, 4.5))),
    "white": (16, False, dict(white=0.6)),
    "streamed": (16, True, {}),
    "lod0": (None, False, dict(uv_range=(-2.0, 3.0))),
}


def _case(name, device="cpu"):
    """-> the entry's arguments as torch tensors: (pool, indices, uv, ddx,
    ddy, max_aniso, mask) for the five maps, (pool, index, uv, None, mask)
    for the alpha test's sample."""
    aniso, streamed, kw = CASES[name]
    pool = _pool(streamed, device)
    idx, uv, ddx, ddy, mask = (_t(a).to(device) for a in _elements(3, **kw))
    if aniso is None:
        return pool, idx[..., 0].contiguous(), uv, None, mask
    return pool, idx, uv, ddx, ddy, aniso, mask


def _worklist(*args):
    """The same elements flattened to one dimension, as a worklist."""
    n = args[-1].numel()

    def flat(t):
        if not isinstance(t, torch.Tensor):
            return t
        return t.reshape((n,) + tuple(t.shape[args[-1].dim():])).contiguous()

    return (args[0], *(flat(t) for t in args[1:]))


def _is_maps(args):
    return len(args) == 7


def _plain(*args):
    """The plain sampler, 0 where the mask does not hold; the maps stacked
    into (5, ..., 4)."""
    if _is_maps(args):
        return torch.stack(texture_sample.sample_maps(*args))
    pool, idx, uv, lod, mask = args
    color = texture_sample.sample_trilinear(pool, idx, uv, lod)
    return torch.where(mask[..., None], color, 0.0)


def _entry(*args):
    if _is_maps(args):
        return torch.stack(texture_cuda.sample_maps(*args))
    return texture_cuda.sample_trilinear(*args)


def _bits(x):
    return x.contiguous().view(torch.int32)


def _assert_equal_where_covered(got, want, mask):
    """Bit for bit on covered elements (every map), 0 elsewhere."""
    assert got.shape == want.shape
    assert torch.equal(_bits(got[..., mask, :]), _bits(want[..., mask, :]))
    assert (got[..., ~mask, :] == 0).all()


def mirror(pool, index, uv, mask, lod=None, n_taps=None, major_uv=None):
    """csrc/texture.cu's per-item loop in numpy float32, operation for
    operation, vectorised over the elements: each element's loop runs while
    i < n_taps, and only its live taps enter its sum, in tap order;
    elements outside the mask are 0."""
    tex = pool.texels.to(torch.float32).numpy()
    table = pool.table.numpy()
    n_tex, max_mips = table.shape[:2]
    last = tex.shape[0] - 1
    shape = tuple(index.shape)
    idx = index.numpy().reshape(-1)
    u, v = (uv.numpy().reshape(-1, 2)[:, k] for k in (0, 1))
    t = np.clip(idx, 0, n_tex - 1)
    levels = pool.levels.numpy()[t]
    max_level = (levels - 1).astype(F)
    floor_level = (pool.min_level.numpy()[t].astype(F)
                   if pool.min_level is not None else np.zeros_like(u))
    lv = lod.numpy().reshape(-1) if lod is not None else np.zeros_like(u)
    lv = np.minimum(np.maximum(lv, floor_level), max_level)
    l0 = np.floor(lv).astype(np.int32)
    l1 = np.minimum(l0 + 1, levels - 1)
    f = lv - l0.astype(F)
    g = F(1) - f
    entries = [table[t, np.clip(lvl, 0, max_mips - 1)] for lvl in (l0, l1)]

    def lerp(a, b, one_minus_t, tt):
        return a * one_minus_t[:, None] + b * tt[:, None]

    def bilinear(entry, pu, pv):
        off, w, h = entry[:, 0], entry[:, 1], entry[:, 2]
        px = pu * w.astype(F) - F(0.5)
        py = pv * h.astype(F) - F(0.5)
        x0 = np.floor(px).astype(np.int32)
        y0 = np.floor(py).astype(np.int32)
        fx = px - x0.astype(F)
        fy = py - y0.astype(F)

        def fetch(xi, yi):
            xw = np.where(w > 0, np.remainder(xi, np.maximum(w, 1)), 0)
            yw = np.where(h > 0, np.remainder(yi, np.maximum(h, 1)), 0)
            return tex[np.clip(off + yw * w + xw, 0, last)]

        gx = F(1) - fx
        top = lerp(fetch(x0, y0), fetch(x0 + 1, y0), gx, fx)
        bot = lerp(fetch(x0, y0 + 1), fetch(x0 + 1, y0 + 1), gx, fx)
        return lerp(top, bot, F(1) - fy, fy)

    def trilinear(pu, pv):
        color = lerp(bilinear(entries[0], pu, pv),
                     bilinear(entries[1], pu, pv), g, f)
        return np.where((idx < 0)[:, None], F(1), color)

    if n_taps is None:
        out = trilinear(u, v)
    else:
        n = n_taps.numpy().reshape(-1)
        mu, mv = (major_uv.numpy().reshape(-1, 2)[:, k] for k in (0, 1))
        rcp = F(1) / n
        acc = np.zeros((n.size, 4), F)
        i = 0
        while True:
            live = F(i) < n
            if not live.any():
                break
            frac = rcp * (F(i) + F(0.5)) - F(0.5)
            tap = trilinear(u + mu * frac, v + mv * frac)
            acc = np.where(live[:, None], acc + tap, acc)
            i += 1
        out = acc / n[:, None]
    out = np.where(mask.numpy().reshape(-1)[:, None], out, F(0))
    return torch.from_numpy(out.astype(F).reshape(shape + (4,)))


def _mirror(*args):
    """The mirror over each map's plain footprint (map_footprint)."""
    if not _is_maps(args):
        pool, idx, uv, lod, mask = args
        return mirror(pool, idx, uv, mask, lod)
    pool, indices, uv, ddx, ddy, aniso, mask = args
    out = []
    for m in range(indices.shape[-1]):
        index = indices[..., m].contiguous()
        fp = texture_sample.map_footprint(pool, index, ddx, ddy, aniso)
        out.append(mirror(pool, index, uv, mask, fp.lod, fp.n_taps,
                          fp.major_uv))
    return torch.stack(out)


@pytest.fixture
def no_library(monkeypatch):
    """Loading (or building) the CUDA library raises."""
    def refuse(name):
        raise AssertionError(f"the CPU path loaded the {name} library")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)


@pytest.mark.parametrize("name", sorted(CASES))
def test_cpu_entry_is_the_plain_sampler(name, no_library):
    args = _case(name)
    counts = dict(texture_cuda.launches)
    got = _entry(*args)
    want = _plain(*args)
    assert torch.equal(_bits(got), _bits(want))
    _assert_equal_where_covered(got, want, args[-1])
    assert texture_cuda.launches == counts


def test_plain_maps_are_map_footprint_then_sample_footprint():
    """The plain sample_maps is, map by map, the footprint and the sample
    that shade_pbr took one map at a time before the maps were fused."""
    pool, indices, uv, ddx, ddy, aniso, mask = _case("aniso16")
    got = texture_sample.sample_maps(pool, indices, uv, ddx, ddy, aniso, mask)
    assert len(got) == texture_cuda.MAPS
    for m in range(texture_cuda.MAPS):
        assert got[m].shape == tuple(mask.shape) + (4,)
        index = indices[..., m].contiguous()
        fp = shade.map_footprint(pool, index, ddx, ddy, aniso)
        want = texture_sample.sample_footprint(pool, index, uv, fp)
        assert torch.equal(_bits(got[m][mask]), _bits(want[mask]))
    assert shade.map_footprint is texture_sample.map_footprint


@pytest.mark.parametrize("name", sorted(CASES))
def test_mirror_of_the_kernel_equals_the_plain_sampler(name):
    args = _case(name)
    mask = args[-1]
    got = _mirror(*args)
    if _is_maps(args) and args[5] == 16:
        taps = [texture_sample.map_footprint(
            args[0], args[1][..., m], args[3], args[4], 16).n_taps[mask].max()
            for m in range(texture_cuda.MAPS)]
        assert float(max(taps)) == 16.0
    want = _plain(*args)
    _assert_equal_where_covered(got, want, mask)
    if name == "white":
        white = (args[1] < 0).movedim(-1, 0) & mask
        assert (got[white] == 1.0).all()
    # The entry point on the CPU: the same bits everywhere, zeros included.
    assert torch.equal(_bits(got), _bits(_entry(*args)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_worklist_mirror_and_entry_equal_the_plain_sampler(name, no_library):
    """The same elements as a one-dimensional worklist (the kernel's rows ==
    1 launch): the mirror, the CPU entry and the grid's result agree."""
    case = _case(name)
    work = _worklist(*case)
    mask = work[-1]
    assert mask.dim() == 1
    got = _mirror(*work)
    want = _plain(*work)
    _assert_equal_where_covered(got, want, mask)
    assert torch.equal(_bits(got), _bits(_entry(*work)))
    grid = _mirror(*case)
    assert torch.equal(_bits(got), _bits(grid.reshape(got.shape)))


def _bad_inputs():
    """name -> (entry, a function of the good inputs giving bad ones)."""
    def with_(**kw):
        return lambda a: {**a, **kw}

    def swap(key, fn):
        return lambda a: {**a, key: fn(a[key])}

    def scalar(a):
        return {**a, **{k: a[k][0, 0] for k in
                        ("indices", "uv", "ddx", "ddy", "mask")}}

    maps = {
        "indices int64": swap("indices", lambda t: t.long()),
        "indices one map": swap("indices", lambda t: t[..., :1].contiguous()),
        "uv float64": swap("uv", lambda t: t.double()),
        "uv shape": swap("uv", lambda t: torch.cat([t, t[..., :1]], -1)),
        "ddx shape": swap("ddx", lambda t: t[:, :-1].contiguous()),
        "ddy float64": swap("ddy", lambda t: t.double()),
        "ddy missing": with_(ddy=None),
        "mask uint8": swap("mask", lambda t: t.to(torch.uint8)),
        "mask missing": with_(mask=None),
        "uv not contiguous": swap(
            "uv", lambda t: t.transpose(0, 1).contiguous().transpose(0, 1)),
        "indices on meta": swap("indices", lambda t: t.to("meta")),
        "uv on meta": swap("uv", lambda t: t.to("meta")),
        "texels float32": swap("pool", lambda p: p._replace(
            texels=p.texels.float())),
        "max_aniso float": with_(max_aniso=16.0),
        "scalar elements": scalar,
    }
    trilinear = {
        "index int64": swap("index", lambda t: t.long()),
        "index five maps": swap(
            "index", lambda t: t[..., None].expand(t.shape + (5,))
            .contiguous()),
        "lod shape": swap("lod", lambda t: t[:, :-1].contiguous()),
        "lod float64": swap("lod", lambda t: t.double()),
    }
    return {**{f"maps {k}": ("maps", f) for k, f in maps.items()},
            **{f"trilinear {k}": ("trilinear", f)
               for k, f in trilinear.items()}}


def _good(entry):
    pool, indices, uv, ddx, ddy, aniso, mask = _case("aniso16")
    if entry == "maps":
        return dict(pool=pool, indices=indices, uv=uv, ddx=ddx, ddy=ddy,
                    max_aniso=aniso, mask=mask)
    return dict(pool=pool, index=indices[..., 0].contiguous(), uv=uv,
                lod=torch.zeros(mask.shape), mask=mask)


@pytest.mark.parametrize("bad", sorted(_bad_inputs()))
def test_argument_checks_raise(bad, no_library):
    entry, make_bad = _bad_inputs()[bad]
    check, sample = {
        "maps": (texture_cuda.check_maps, texture_cuda.sample_maps),
        "trilinear": (texture_cuda.check_trilinear,
                      texture_cuda.sample_trilinear),
    }[entry]
    good = _good(entry)
    check(**good)
    args = make_bad(good)
    with pytest.raises(ValueError, match="texture kernel"):
        check(**args)
    with pytest.raises(ValueError, match="texture kernel"):
        sample(**args)


@pytest.mark.parametrize("entry", ["maps", "trilinear"])
def test_launcher_refuses_the_cpu(entry, no_library):
    good = _good(entry)
    launcher = {"maps": texture_cuda.maps_launcher,
                "trilinear": texture_cuda.launcher}[entry]
    with pytest.raises(ValueError, match="unsupported device cpu"):
        launcher(**good)


def _unmasked_maps(pool, indices, uv, ddx, ddy, max_aniso, mask):
    """The plain five maps with the mask ignored: uncovered elements keep
    the plain values."""
    return tuple(
        texture_sample.sample_footprint(
            pool, indices[..., m], uv,
            texture_sample.map_footprint(pool, indices[..., m], ddx, ddy,
                                         max_aniso))
        for m in range(indices.shape[-1]))


def _plain_entries():
    """The entry points with the plain samplers patched in, as the card's
    frame is checked against them: the mask is ignored, so uncovered
    elements keep the plain values."""
    def trilinear(pool, idx, uv, lod, mask):
        return texture_sample.sample_trilinear(pool, idx, uv, lod)

    return (mock.patch.object(texture_cuda, "sample_maps", _unmasked_maps),
            mock.patch.object(texture_cuda, "sample_trilinear", trilinear))


def _small_textured_frame():
    r, _, cam, _ = bench_scene.build_bench_renderer(96, 64, 16, "cpu",
                                                    textured=True)
    r.render_frame(cam.view_matrix(), cam.projection_matrix(), cam.position)
    return r.read_back().copy(), r.last_outputs().color


def test_textured_frame_through_the_entry_equals_the_plain_sampler():
    """The small textured standard frame (five maps, anisotropy 16, the
    cutout draws alpha-tested in both passes): the entry point's zeros on
    uncovered pixels never reach the image or the colour."""
    image, color = _small_textured_frame()
    maps, trilinear = _plain_entries()
    with maps, trilinear:
        plain_image, plain_color = _small_textured_frame()
    assert np.array_equal(image, plain_image)
    assert torch.equal(_bits(color), _bits(plain_color))


def test_shade_pbr_samples_the_five_maps_in_one_call():
    """The small textured frame's shade_pbr makes one sample_maps call, with
    the five material indices as one (H, W, 5) int32 tensor, and computes
    no footprint of its own."""
    calls = []
    real = texture_cuda.sample_maps

    def record(pool, indices, *rest):
        calls.append(indices)
        return real(pool, indices, *rest)

    def refuse(*args, **kwargs):
        raise AssertionError("shade_pbr computed a footprint")

    with mock.patch.object(texture_cuda, "sample_maps", record), \
            mock.patch.object(shade, "map_footprint", refuse):
        _small_textured_frame()
    assert len(calls) == 1
    assert calls[0].dtype == torch.int32 and calls[0].shape == (64, 96, 5)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


def _kernel_matches_plain(*args):
    """One counted launch against the plain sampler on the same CUDA
    tensors."""
    entry = "maps" if _is_maps(args) else "trilinear"
    before = texture_cuda.launches[entry]
    got = _entry(*args)
    assert texture_cuda.launches[entry] == before + 1
    torch.cuda.synchronize()
    _assert_equal_where_covered(got, _plain(*args), args[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_kernel_matches_plain(name):
    """Kernel and plain sampler on the same CUDA tensors: bit-equal on the
    covered elements, 0 elsewhere; one launch counted."""
    _need_card()
    _kernel_matches_plain(*_case(name, "cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_kernel_matches_plain_on_a_worklist(name):
    """The seeded cases flattened to one dimension (256-thread blocks along
    the row): bit-equal on the covered elements, 0 elsewhere."""
    _need_card()
    _kernel_matches_plain(*_worklist(*_case(name, "cuda")))


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_on_the_textured_frame():
    """The 1080p textured frame's own sampler calls (the five maps at
    anisotropy 16, the alpha test's LOD-0 samples of the main and shadow
    passes), recorded from one frame and replayed through kernel and
    plain."""
    _need_card()
    calls = []
    real_maps, real_tri = texture_cuda.sample_maps, texture_cuda.sample_trilinear

    def maps(*args):
        calls.append(args)
        return real_maps(*args)

    def trilinear(pool, idx, uv, lod, mask):
        calls.append((pool, idx, uv, lod, mask))
        return real_tri(pool, idx, uv, lod, mask)

    r, _, cam, _ = bench_scene.build_bench_renderer(1920, 1080, 1000, "cuda",
                                                    textured=True)
    with mock.patch.object(texture_cuda, "sample_maps", maps), \
            mock.patch.object(texture_cuda, "sample_trilinear", trilinear):
        r.render_frame(cam.view_matrix(), cam.projection_matrix(),
                       cam.position)
    # The shadow and the main pass's alpha tests, then the five maps.
    assert [_is_maps(c) for c in calls] == [False, False, True]
    for args in calls:
        _kernel_matches_plain(*args)


def _probe_pairs(n, seed):
    """n seeded f32 pairs over 2^-40..2^40 in magnitude, a tenth of them
    zeros, denormals, 1e-20, 1e20 and other edge values."""
    rng = np.random.default_rng(seed)

    def one():
        x = rng.standard_normal(n) * np.exp2(rng.uniform(-40, 40, n))
        edge = np.array([0.0, -0.0, 1e-40, -1e-42, 1e-45, 1e-20, -1e-20, 1e20,
                         -1e20, 1.0, 3e-23, 1e19, 2e19, 1e-38])
        pick = rng.random(n) < 0.1
        x[pick] = edge[rng.integers(0, edge.size, pick.sum())]
        return torch.from_numpy(x.astype(np.float32))

    return one(), one()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1080, 1920), (24, 40)])
def test_cuda_vector_norm_of_a_pair_rounds_each_square(shape):
    """torch.linalg.vector_norm over a last dimension of 2 on the card, as
    map_footprint takes it, is sqrt(rn(x*x) + rn(y*y)): what csrc/texture.cu
    computes (no fused multiply-add)."""
    _need_card()
    x, y = (t.reshape(shape).cuda() for t in _probe_pairs(int(np.prod(shape)),
                                                          31))
    got = torch.linalg.vector_norm(torch.stack([x, y], -1), dim=-1)
    assert torch.equal(_bits(got), _bits(torch.sqrt(x * x + y * y)))
    # The probe tells the orders apart: a fused y*y + rn(x*x) (rounded once,
    # through f64, whose rare double rounding does not matter here) differs.
    fused = torch.sqrt((y.double() * y.double() + (x * x).double()).float())
    assert not torch.equal(_bits(got), _bits(fused))


def _lod_pool(levels=13):
    """One texture of `levels` 1x1 levels whose texels code the LOD: level k
    is (k % 2, 1 - k % 2, 0, 0), so a trilinear sample between levels l0
    and l0 + 1 holds the LOD's fraction f exactly in one channel and
    1 - f in the other, whatever the uv. Level 0's size is 1x1, so the
    footprint's axes are the derivatives' own lengths."""
    pyramid = [np.tile(np.array([k % 2, 1 - k % 2, 0, 0], np.float32),
                       (1, 1, 1)) for k in range(levels)]
    return texture_sample.build_pool([pyramid], device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("max_aniso", [1, 16])
def test_cuda_fused_footprint_lod_matches_map_footprint(max_aniso):
    """The fused footprint against map_footprint over about 2 million seeded
    derivative pairs at the 1080p frame's shape: the pool codes the LOD into
    the sample, so any difference in the norms' or log2's rounding, the
    division, ceil or the clamps shows in the bits. Each derivative is one
    probe pair; its LOD is informative for lengths in [1, 4096)."""
    _need_card()
    shape = (1080, 1920)
    n = shape[0] * shape[1]
    rng = np.random.default_rng(41)
    raw = torch.stack(_probe_pairs(n, 37), -1)
    # Most derivatives: the probe pairs' directions at lengths 2^-2..2^13,
    # ddy across them 1 to 45 times shorter (tap counts 1..16); one in
    # twenty of each keeps its probe pair as it is.
    unit = raw / raw.abs().amax(-1, keepdim=True).clamp_min(1e-30)
    length = torch.from_numpy(np.exp2(rng.uniform(-2, 13, n)).astype(F))
    ratio = torch.from_numpy(np.exp2(rng.uniform(0, 5.5, n)).astype(F))
    ddx = unit * length[:, None]
    ddy = torch.stack([-unit[:, 1], unit[:, 0]], -1) * (length / ratio)[:, None]
    # Never both: two overflowing axes make n_taps inf / inf = NaN, for
    # which the plain loop has no trip count.
    pick = rng.random(n)
    ddx = torch.where(_t(pick < 0.05)[:, None], raw, ddx)
    ddy = torch.where(_t(pick > 0.95)[:, None], raw.flip(0), ddy)
    ddx, ddy = ddx.reshape(shape + (2,)), ddy.reshape(shape + (2,))
    pool = _lod_pool()
    indices = torch.zeros(shape + (texture_cuda.MAPS,), dtype=torch.int32)
    indices[..., 4] = -1
    uv = torch.zeros(shape + (2,))
    mask = torch.ones(shape, dtype=torch.bool)
    args = (pool, *(t.cuda().contiguous() for t in (indices, uv, ddx, ddy)),
            max_aniso, mask.cuda())
    _kernel_matches_plain(*args)
    lod = texture_sample.map_footprint(pool, args[1][..., 0], args[3],
                                       args[4], max_aniso).lod
    assert 0.2 < float(((lod > 0) & (lod < 12)).float().mean()) < 1.0
