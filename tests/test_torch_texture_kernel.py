"""The texture kernel's entry point (ash_tpu_torch/ops/texture_cuda.py) and
its arithmetic, on the CPU; the kernel itself on the card.

- CPU tensors run the plain samplers (ops/texture_sample.py's
  sample_footprint and sample_trilinear) bit for bit where the mask holds
  and 0 elsewhere, never load the library and count no launch.
- A numpy float32 mirror of csrc/texture.cu's per-element loop (every
  operation in the .cu's order, each element running only its own taps)
  equals the plain sampler on the covered elements, bit for bit, over
  seeded inputs: anisotropy 1 and 16, uv far outside [0, 1) (REPEAT),
  index -1 (white), a streamed pool with min_level, tap counts reaching 16,
  and the alpha test's LOD-0 sample; also over a one-dimensional worklist
  (the edge MSAA resolve's shape).
- The argument checks raise on the wrong dtype, shape, device or layout.
- The small textured frame renders the same through the entry point as
  with the plain sampler patched in.
- On the card (marked `cuda`, skipped here): the kernel against the plain
  sampler on the same CUDA tensors, bit for bit on covered elements, on the
  seeded cases, over them as worklists and at the 1080p textured frame's
  own inputs.
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
    """Seeded (index, uv, ddx, ddy, mask) over an (h, w) grid: uv
    derivatives whose axes have ratios up to 1:20 (tap counts reach 16), a
    share `white` of index -1, about 70% of the elements covered."""
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
    idx = rng.integers(0, 3, shape).astype(np.int32)
    idx[rng.random(shape) < white] = -1
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
    """-> (pool, index, uv, footprint or None, mask) as torch tensors."""
    aniso, streamed, kw = CASES[name]
    pool = _pool(streamed, device)
    idx, uv, ddx, ddy, mask = (_t(a).to(device) for a in _elements(3, **kw))
    fp = (None if aniso is None
          else shade.map_footprint(pool, idx, ddx, ddy, aniso))
    return pool, idx, uv, fp, mask


def _worklist(pool, idx, uv, fp, mask):
    """The same elements flattened to one dimension, as a worklist."""
    def flat(t, k=()):
        return None if t is None else t.reshape((-1,) + k).contiguous()

    if fp is not None:
        fp = texture_sample.Footprint(flat(fp.lod), flat(fp.n_taps),
                                      flat(fp.major_uv, (2,)))
    return pool, flat(idx), flat(uv, (2,)), fp, flat(mask)


def _plain(pool, idx, uv, fp):
    """The plain sampler; the footprint's loop takes its trip count from
    every element (one host sync)."""
    if fp is None:
        return texture_sample.sample_trilinear(pool, idx, uv, None)
    return texture_sample.sample_footprint(pool, idx, uv, fp)


def _entry(pool, idx, uv, fp, mask):
    if fp is None:
        return texture_cuda.sample_trilinear(pool, idx, uv, None, mask=mask)
    return texture_cuda.sample_footprint(pool, idx, uv, fp, mask=mask)


def _bits(x):
    return x.contiguous().view(torch.int32)


def mirror(pool, index, uv, mask, lod=None, n_taps=None, major_uv=None):
    """csrc/texture.cu's sample_kernel in numpy float32, operation for
    operation, vectorised over the elements: each element's loop runs while
    i < n_taps, and only its live taps enter its sum; elements outside the
    mask are 0."""
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


@pytest.fixture
def no_library(monkeypatch):
    """Loading (or building) the CUDA library raises."""
    def refuse(name):
        raise AssertionError(f"the CPU path loaded the {name} library")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)


@pytest.mark.parametrize("name", sorted(CASES))
def test_cpu_entry_is_the_plain_sampler(name, no_library):
    pool, idx, uv, fp, mask = _case(name)
    counts = dict(texture_cuda.launches)
    got = _entry(pool, idx, uv, fp, mask)
    want = _plain(pool, idx, uv, fp)
    assert torch.equal(_bits(got[mask]), _bits(want[mask]))
    assert (got[~mask] == 0).all()
    assert texture_cuda.launches == counts


def _mirror(pool, idx, uv, fp, mask):
    if fp is None:
        return mirror(pool, idx, uv, mask)
    return mirror(pool, idx, uv, mask, fp.lod, fp.n_taps, fp.major_uv)


@pytest.mark.parametrize("name", sorted(CASES))
def test_mirror_of_the_kernel_equals_the_plain_sampler(name):
    pool, idx, uv, fp, mask = _case(name)
    got = _mirror(pool, idx, uv, fp, mask)
    if fp is not None:
        if CASES[name][0] == 16:
            assert float(fp.n_taps[mask].max()) == 16.0
    want = _plain(pool, idx, uv, fp)
    assert torch.equal(_bits(got[mask]), _bits(want[mask]))
    assert (got[~mask] == 0).all()
    if name == "white":
        assert (got[mask & (idx < 0)] == 1.0).all()
    # The entry point on the CPU: the same bits everywhere, zeros included.
    assert torch.equal(_bits(got), _bits(_entry(pool, idx, uv, fp, mask)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_worklist_mirror_and_entry_equal_the_plain_sampler(name, no_library):
    """The same elements as a one-dimensional worklist (the kernel's rows ==
    1 launch): the mirror, the CPU entry and the grid's result agree."""
    case = _case(name)
    work = _worklist(*case)
    pool, idx, uv, fp, mask = work
    assert idx.dim() == 1
    got = _mirror(*work)
    want = _plain(pool, idx, uv, fp)
    assert torch.equal(_bits(got[mask]), _bits(want[mask]))
    assert (got[~mask] == 0).all()
    assert torch.equal(_bits(got), _bits(_entry(*work)))
    assert torch.equal(_bits(got), _bits(_mirror(*case).reshape(-1, 4)))


def _bad_inputs():
    """name -> a function of the good inputs giving bad ones."""
    def with_(**kw):
        return lambda a: {**a, **kw}

    return {
        "index int64": lambda a: {**a, "index": a["index"].long()},
        "uv float64": lambda a: {**a, "uv": a["uv"].double()},
        "uv shape": lambda a: {**a, "uv": torch.cat([a["uv"], a["uv"][..., :1]],
                                                   -1)},
        "lod shape": lambda a: {**a, "lod": a["lod"][:, :-1]},
        "mask uint8": lambda a: {**a, "mask": a["mask"].to(torch.uint8)},
        "mask missing": with_(mask=None),
        "uv not contiguous": lambda a: {
            **a, "uv": a["uv"].transpose(0, 1).contiguous().transpose(0, 1)},
        "index on meta": lambda a: {**a, "index": a["index"].to("meta")},
        "uv on meta": lambda a: {**a, "uv": a["uv"].to("meta")},
        "n_taps without major_uv": with_(major_uv=None),
        "texels float32": lambda a: {**a, "pool": a["pool"]._replace(
            texels=a["pool"].texels.float())},
        "scalar index": lambda a: {**a, "index": a["index"][0, 0],
                                   "uv": a["uv"][0, 0], "lod": a["lod"][0, 0],
                                   "n_taps": a["n_taps"][0, 0],
                                   "major_uv": a["major_uv"][0, 0],
                                   "mask": a["mask"][0, 0]},
    }


@pytest.mark.parametrize("bad", sorted(_bad_inputs()))
def test_argument_checks_raise(bad, no_library):
    pool, idx, uv, fp, mask = _case("aniso16")
    good = dict(pool=pool, index=idx, uv=uv, lod=fp.lod, n_taps=fp.n_taps,
                major_uv=fp.major_uv, mask=mask)
    texture_cuda.check_inputs(**good)
    args = _bad_inputs()[bad](good)
    with pytest.raises(ValueError, match="texture kernel"):
        texture_cuda.check_inputs(**args)
    fp_bad = texture_sample.Footprint(args["lod"], args["n_taps"],
                                      args["major_uv"])
    with pytest.raises(ValueError, match="texture kernel"):
        texture_cuda.sample_footprint(args["pool"], args["index"], args["uv"],
                                      fp_bad, mask=args["mask"])


def test_launcher_refuses_the_cpu(no_library):
    pool, idx, uv, fp, mask = _case("aniso1")
    with pytest.raises(ValueError, match="unsupported device cpu"):
        texture_cuda.launcher(pool, idx, uv, mask, fp.lod)


def _plain_entries():
    """The entry points with the plain samplers patched in, as the card's
    frame is checked against them: the mask is ignored, so uncovered
    elements keep the plain values."""
    def footprint(pool, index, uv, fp, mask):
        return texture_sample.sample_footprint(pool, index, uv, fp)

    def trilinear(pool, idx, uv, lod, mask):
        return texture_sample.sample_trilinear(pool, idx, uv, lod)

    return (mock.patch.object(texture_cuda, "sample_footprint", footprint),
            mock.patch.object(texture_cuda, "sample_trilinear", trilinear))


def test_textured_frame_through_the_entry_equals_the_plain_sampler():
    """The small textured standard frame (five maps, anisotropy 16, the
    cutout draws alpha-tested in both passes): the entry point's zeros on
    uncovered pixels never reach the image or the colour."""
    def render():
        r, _, cam, _ = bench_scene.build_bench_renderer(96, 64, 16, "cpu",
                                                        textured=True)
        r.render_frame(cam.view_matrix(), cam.projection_matrix(),
                       cam.position)
        return r.read_back().copy(), r.last_outputs().color

    image, color = render()
    footprint, trilinear = _plain_entries()
    with footprint, trilinear:
        plain_image, plain_color = render()
    assert np.array_equal(image, plain_image)
    assert torch.equal(_bits(color), _bits(plain_color))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_kernel_matches_plain(name):
    """Kernel and plain sampler on the same CUDA tensors: bit-equal on the
    covered elements, 0 elsewhere; one launch counted."""
    _need_card()
    _kernel_matches_plain(*_case(name, "cuda"))


def _kernel_matches_plain(pool, idx, uv, fp, mask):
    entry = "trilinear" if fp is None else "footprint"
    before = texture_cuda.launches[entry]
    got = _entry(pool, idx, uv, fp, mask)
    torch.cuda.synchronize()
    assert texture_cuda.launches[entry] == before + 1
    want = _plain(pool, idx, uv, fp)
    assert torch.equal(_bits(got[mask]), _bits(want[mask]))
    assert (got[~mask] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_kernel_matches_plain_on_a_worklist(name):
    """The seeded cases flattened to one dimension (256-thread blocks along
    the row): bit-equal on the covered elements, 0 elsewhere."""
    _need_card()
    _kernel_matches_plain(*_worklist(*_case(name, "cuda")))


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_on_the_textured_frame():
    """The 1080p textured frame's own sampler calls (five maps at anisotropy
    16, the alpha test's LOD-0 samples of the main and shadow passes),
    recorded from one frame and replayed through kernel and plain."""
    _need_card()
    calls = []
    real_fp, real_tri = (texture_cuda.sample_footprint,
                         texture_cuda.sample_trilinear)

    def footprint(pool, index, uv, fp, mask):
        calls.append((pool, index, uv, fp, mask))
        return real_fp(pool, index, uv, fp, mask)

    def trilinear(pool, idx, uv, lod, mask):
        calls.append((pool, idx, uv, None, mask))
        return real_tri(pool, idx, uv, lod, mask)

    r, _, cam, _ = bench_scene.build_bench_renderer(1920, 1080, 1000, "cuda",
                                                    textured=True)
    with mock.patch.object(texture_cuda, "sample_footprint", footprint), \
            mock.patch.object(texture_cuda, "sample_trilinear", trilinear):
        r.render_frame(cam.view_matrix(), cam.projection_matrix(),
                       cam.position)
    assert len(calls) == 7  # 5 maps, the main and the shadow alpha test
    for pool, idx, uv, fp, mask in calls:
        got = _entry(pool, idx, uv, fp, mask)
        want = _plain(pool, idx, uv, fp)
        assert torch.equal(_bits(got[mask]), _bits(want[mask]))
