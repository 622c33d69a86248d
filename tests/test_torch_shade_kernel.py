"""The surface shading's entry point (ash_tpu_torch/ops/shade_cuda.py) on the
CPU; its kernels (csrc/shade.cu) on the card.

The cases start from the shade_pbr calls of small bench frames (96x64, 16
cubes, a seeded scene), recorded from the entry point: the standard frame
(one 2048^2 shadow map, Reinhard), the rich frame (32 lights, three blended
cascades, no Reinhard: the HDR chain follows), the textured frame
(anisotropy 16), the glass frame's four peeled layers (with the blend's
coverage alpha) and lit edge MSAA x4's centres (pixel_xy as expanded views)
and worklist ((cap, 4) samples); from them the standard call without its
shadow map and without Reinhard, the rich call without its lights, the
textured call with the rich frame's lights and with the coverage alpha.
Seeded G-buffers and materials take the inputs to their ends: NaN and
infinite positions, zero normals and tangents, draw ids at both ends,
roughness and metallic 0 and 1, f0 under 0.04, an odd grid.

- On CPU tensors the entry is the plain version (ops/shade.py's shade_pbr,
  and pixel_alpha), bit for bit, never loads the library and counts no
  launch; and both hold to ash_tpu.ops.shade.shade_pbr (and pixel_alpha)
  through JAX on the CPU at the frames' inputs within atol 1e-5 on the
  colour, as tests/test_torch_shade.py holds the plain version (f32
  divisions, and XLA's fused multiply-adds on the CPU, differ from
  PyTorch's in the last bits).
- bf16 shading and image-based lighting take the eager path on either
  device, counted in launches["eager"]; the kernels' check refuses them.
- The argument checks pass every case and every frame's call, and raise on
  the wrong dtype, shape, device, layout and scalar argument.
- The frames make one entry call a shaded layer (glass four, edge MSAA two);
  the pass profiler and the cost analysis go through the entry.
- On the card (marked `cuda`, skipped here): the kernels against the plain
  version on the same CUDA tensors, the colour (and alpha) bit for bit with
  NaN in the same places, over every case, with one launch a call or three
  with lights, counted through `observers`; the 1080p frames' own calls;
  and probes of the card's roundings that the kernels code.
"""

import functools
from unittest import mock

import numpy as np
import pytest
import torch

from ash_tpu_torch.ops import (_build, lights_cuda, shade, shade_cuda,
                               shadow_cuda, texture_cuda)
from ash_tpu_torch.render import bench_scene, cost_analysis, pass_profiler

torch.set_num_threads(1)

ATOL = 1e-5
W, H = 96, 64

# The small bench frames whose calls the cases start from: name ->
# (build_bench_renderer keywords, MSAA preset or None).
FRAMES = {
    "standard": ({}, None),
    "rich": (dict(rich=True), None),
    "textured": (dict(textured=True), None),
    "glass": (dict(glass=True), None),
    "edge x4": (dict(lights=32, msaa_resolve="edge"), "x4"),
}
# The entry calls a frame makes: one a shaded layer (glass peels 4), and
# the edge worklist's.
CALLS_PER_FRAME = {"standard": 1, "rich": 1, "textured": 1, "glass": 4,
                   "edge x4": 2}

# Cases held to the reference through JAX on the CPU.
REFERENCE_CASES = (
    "standard", "standard without shadow", "standard without reinhard",
    "rich", "rich without lights", "textured", "textured with lights",
    "textured with alpha", "glass layer 1", "glass layer 2",
    "edge centres", "edge worklist")
# Cases only the card's bit-for-bit check takes: glass's fourth layer, which
# covers nothing here, and seeded values at the inputs' ends, where XLA's
# fused arithmetic and PyTorch's part.
CARD_CASES = ("glass layer 4", "seeded", "seeded lit", "seeded textured",
              "seeded textured lit", "seeded 67x97 with alpha")
CASES = REFERENCE_CASES + CARD_CASES


def _record(kw, preset, device, width=W, height=H, n=16):
    """Frame 1 of a bench renderer with the entry point wrapped -> its
    shade calls [(args, kwargs)] in call order."""
    r, _, cam, _ = bench_scene.build_bench_renderer(width, height, n, device,
                                                    **kw)
    if preset is not None:
        r.set_msaa_preset(preset)
    calls = []
    real = shade_cuda.shade_pbr

    def entry(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    with mock.patch.object(shade_cuda, "shade_pbr", entry):
        r.render_frame(cam.view_matrix(), cam.projection_matrix(),
                       cam.position)
    return calls


@functools.lru_cache(maxsize=None)
def _frames(device):
    return {name: _record(kw, preset, device)
            for name, (kw, preset) in FRAMES.items()}


def _with(call, **kwargs):
    args, kw = call
    return args, {**kw, **kwargs}


def _lights_of(call):
    kw = call[1]
    return {k: kw[k] for k in ("lights", "tile_light_indices",
                               "tile_light_counts", "light_tile_size")}


def _seeded(base, seed, shape=None, lit=None):
    """A call with `base`'s materials' texture indices, uniforms, shadow
    map and pool, and a seeded G-buffer (of `shape`, default the base's)
    and materials at the inputs' ends; `lit` adds that call's lights."""
    (gbuf, materials, uniforms), kw = base
    rng = np.random.default_rng(seed)
    dev = gbuf.mask.device
    shape = tuple(gbuf.mask.shape) if shape is None else shape
    n = int(np.prod(shape))

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).to(dev)

    world = rng.normal(size=(n, 3)) * 5.0
    world[rng.random(n) < 0.02] = np.nan
    world[rng.random(n) < 0.02, 1] = np.inf
    normal = rng.normal(size=(n, 3))
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    normal[rng.random(n) < 0.05] = 0.0
    tangent = np.concatenate([rng.normal(size=(n, 3)),
                              rng.choice([-1.0, 1.0], (n, 1))], 1)
    tangent[rng.random(n) < 0.05, :3] = 0.0
    tangent[rng.random(n) < 0.02, :3] = 1e-4
    d = materials.shape[0]
    draw = rng.integers(0, d, n)
    draw[:2] = (0, d - 1)
    uv = rng.random((n, 2)) * 4.0 - 2.0
    ddx = rng.normal(size=(n, 2)) * 0.01
    ddy = rng.normal(size=(n, 2)) * 0.01
    new = shade.GBuffer(
        mask=t(rng.random(n) < 0.8, torch.bool).reshape(shape),
        world=t(world).reshape(shape + (3,)),
        normal=t(normal).reshape(shape + (3,)),
        tangent=t(tangent).reshape(shape + (4,)),
        uv=t(uv).reshape(shape + (2,)),
        color=t(rng.random((n, 3))).reshape(shape + (3,)),
        front_facing=t(rng.random(n) < 0.6, torch.bool).reshape(shape),
        draw_id=t(draw, torch.int32).reshape(shape),
        uv_ddx=t(ddx).reshape(shape + (2,)),
        uv_ddy=t(ddy).reshape(shape + (2,)))
    mats = materials.clone()
    m = np.empty((d, 12))
    m[:, 0:4] = rng.random((d, 4))
    m[:, 4:8] = rng.random((d, 4)) * 0.5
    m[:, 8] = rng.choice([0.0, 1.0, 0.5], d)
    m[:, 9] = rng.choice([0.0, 1.0, 0.3], d)
    m[:, 10] = rng.random(d)
    m[:, 11] = rng.random(d) * 2.0
    # f0 under 0.04: metallic 1 over a dark base colour.
    m[0, 0:3], m[0, 8] = 0.01, 1.0
    mats[:, :12] = t(m)
    mats[:, 17] = t(rng.choice([0.0, 0.5], d))
    kw = {**kw, "pixel_xy": None}
    if lit is not None:
        kw.update(_lights_of(lit))
    return (new, mats, uniforms), kw


def _case(name, device="cpu"):
    """-> (args, kwargs) of the entry for case `name` on `device`."""
    frames = _frames(device)
    standard, rich = frames["standard"][0], frames["rich"][0]
    textured = frames["textured"][0]
    seed = CASES.index(name) + 200
    if name == "standard":
        return standard
    if name == "standard without shadow":
        return _with(standard, shadow_map=None)
    if name == "standard without reinhard":
        return _with(standard, reinhard=False)
    if name == "rich":
        return rich
    if name == "rich without lights":
        return _with(rich, lights=None, tile_light_indices=None,
                     tile_light_counts=None)
    if name == "textured":
        return textured
    if name == "textured with lights":
        return _with(textured, **_lights_of(rich))
    if name == "textured with alpha":
        return _with(textured, with_alpha=True)
    if name.startswith("glass layer"):
        return frames["glass"][int(name.split()[-1]) - 1]
    if name == "edge centres":
        return frames["edge x4"][0]
    if name == "edge worklist":
        return frames["edge x4"][1]
    if name == "seeded":
        return _seeded(standard, seed)
    if name == "seeded lit":
        return _seeded(rich, seed, lit=rich)
    if name == "seeded textured":
        return _seeded(textured, seed)
    if name == "seeded textured lit":
        return _seeded(textured, seed, lit=rich)
    if name == "seeded 67x97 with alpha":
        args, kw = _seeded(rich, seed, shape=(67, 97), lit=rich)
        return args, {**kw, "with_alpha": True}
    raise KeyError(name)


def _numpy(t):
    return None if t is None else np.ascontiguousarray(
        t.detach().cpu().float().numpy())


def _reference(args, kw):
    """ash_tpu.ops.shade.shade_pbr (and pixel_alpha) through JAX on the CPU
    at the same inputs -> numpy colour (, alpha)."""
    import jax.numpy as jnp

    from ash_tpu.ops import shade as ref_shade
    from ash_tpu.ops import texture_sample as ref_tex

    gbuf, materials, uniforms = args

    def j(t):
        return None if t is None else jnp.asarray(_numpy(t)) \
            if t.dtype.is_floating_point else jnp.asarray(t.cpu().numpy())

    ref_gbuf = ref_shade.GBuffer(**{f: j(getattr(gbuf, f))
                                    for f in ref_shade.GBuffer._fields})
    ref_uni = ref_shade.ShadeUniforms(**{f: j(getattr(uniforms, f)) for f in
                                         ref_shade.ShadeUniforms._fields})
    pool = kw.get("pool")
    ref_pool = None
    if pool is not None:
        ref_pool = ref_tex.TexturePool(
            texels=jnp.asarray(_numpy(pool.texels)).astype(jnp.bfloat16),
            table=j(pool.table), levels=j(pool.levels),
            min_level=j(pool.min_level))
    clear = kw.get("clear_color", (0.0, 0.0, 0.0))
    if isinstance(clear, torch.Tensor):
        clear = tuple(float(c) for c in clear)
    csm = kw.get("csm")
    pixel_xy = kw.get("pixel_xy")
    color = ref_shade.shade_pbr(
        ref_gbuf, j(materials), ref_uni, shadow_map=j(kw.get("shadow_map")),
        pool=ref_pool, clear_color=clear, reinhard=kw.get("reinhard", True),
        lights=j(kw.get("lights")),
        tile_light_indices=j(kw.get("tile_light_indices")),
        tile_light_counts=j(kw.get("tile_light_counts")),
        light_tile_size=kw.get("light_tile_size", 16),
        csm=None if csm is None else tuple(map(j, csm)),
        csm_blend_size=kw.get("csm_blend_size", 0.0),
        max_anisotropy=kw.get("max_anisotropy", 1),
        pixel_xy=None if pixel_xy is None else tuple(map(j, pixel_xy)))
    if not kw.get("with_alpha"):
        return np.asarray(color)
    return np.asarray(color), np.asarray(
        ref_shade.pixel_alpha(ref_gbuf, j(materials), ref_pool))


@pytest.fixture
def no_library(monkeypatch):
    """Loading (or building) the CUDA library raises."""
    def refuse(name):
        raise AssertionError(f"the CPU path loaded the {name} library")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)


def _same(got, want):
    """Bit for bit where want has a number, NaN where it has NaN."""
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name", CASES)
def test_cpu_entry_is_the_plain_version(name, no_library):
    args, kw = _case(name)
    shade_cuda.check_inputs(*args, **kw)
    before = dict(shade_cuda.launches)
    got = _outputs(shade_cuda.shade_pbr(*args, **kw))
    want = _outputs(shade_cuda.plain(*args, **kw))
    assert shade_cuda.launches == before
    assert len(got) == len(want) == (2 if kw.get("with_alpha") else 1)
    for g, w in zip(got, want):
        _same(g, w)
    color = got[0]
    assert color.shape == args[0].mask.shape + (3,)
    if not name.startswith("seeded"):
        assert bool(torch.isfinite(color).all())


@pytest.mark.parametrize("name", REFERENCE_CASES)
def test_entry_matches_reference(name, no_library):
    """The entry on CPU tensors against ash_tpu through JAX: the colour
    within ATOL (the clear colour exactly where the mask is off), the
    coverage alpha equal."""
    args, kw = _case(name)
    got = _outputs(shade_cuda.shade_pbr(*args, **kw))
    want = _outputs(_reference(args, kw))
    mask = args[0].mask.numpy()
    assert 0 < int(mask.sum()) < mask.size
    color = got[0].numpy()
    np.testing.assert_allclose(color, want[0], atol=ATOL, rtol=0)
    np.testing.assert_array_equal(color[~mask], want[0][~mask])
    if len(got) == 2:
        np.testing.assert_array_equal(got[1].numpy(), want[1])


def test_cases_cover_the_paths():
    """The recorded and derived calls take every path the kernels code."""
    kws = {name: _case(name)[1] for name in REFERENCE_CASES}

    def lit(kw):
        return kw.get("lights") is not None

    assert kws["standard"]["shadow_map"].dim() == 2
    assert kws["standard"]["csm"] is None and kws["standard"]["reinhard"]
    assert kws["standard without shadow"]["shadow_map"] is None
    assert kws["rich"]["csm"] is not None and kws["rich"]["csm_blend_size"] > 0
    assert lit(kws["rich"]) and not kws["rich"]["reinhard"]
    assert not lit(kws["rich without lights"])
    assert kws["textured"]["pool"] is not None
    assert kws["textured"]["max_anisotropy"] == 16
    assert lit(kws["textured with lights"])
    assert kws["glass layer 1"]["with_alpha"]
    assert kws["glass layer 1"]["pool"] is None
    px = kws["edge centres"]["pixel_xy"][0]
    assert lit(kws["edge centres"]) and 0 in px.stride()
    worklist = _case("edge worklist")[0][0]
    assert worklist.mask.dim() == 2 and worklist.mask.shape[1] == 4
    for name, (args, kw) in ((n, _case(n)) for n in CASES):
        assert kw.get("dtype", torch.float32) == torch.float32, name
        assert kw.get("ibl") is None, name
    seeded = _case("seeded textured lit")[0]
    d = seeded[1].shape[0]
    ids = seeded[0].draw_id
    assert bool((ids == 0).any()) and bool((ids == d - 1).any())
    assert not bool(torch.isfinite(seeded[0].world).all())


@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_frames_call_the_entry_once_a_shaded_layer(frame):
    calls = _frames("cpu")[frame]
    assert len(calls) == CALLS_PER_FRAME[frame]
    for args, kw in calls:
        shade_cuda.check_inputs(*args, **kw)
        assert kw["with_alpha"] == (frame == "glass")


@pytest.mark.parametrize("kind", ["bf16", "ibl"])
def test_eager_arguments_take_the_plain_path(kind, no_library):
    """bf16 shading and IBL run the plain version on either device, chosen
    from the arguments and counted; the kernels' check refuses them."""
    args, kw = _case("standard")
    if kind == "bf16":
        kw = {**kw, "dtype": torch.bfloat16}
    else:
        from ash_tpu_torch.ops import ibl

        env = np.random.default_rng(3).random((8, 16, 3)).astype(np.float32)
        env = ibl.build_environment(env, mips=2, irradiance_size=4,
                                    lut_size=8, ggx_prefilter=False,
                                    device="cpu")
        kw = {**kw, "ibl": env}
    assert shade_cuda.eager(kw.get("dtype", torch.float32), kw.get("ibl"))
    with pytest.raises(ValueError, match="eager path"):
        shade_cuda.check_inputs(*args, **kw)
    before = shade_cuda.launches["eager"]
    got = shade_cuda.shade_pbr(*args, **kw)
    assert shade_cuda.launches["eager"] == before + 1
    _same(got, shade.shade_pbr(*args, **{k: v for k, v in kw.items()
                                         if k != "with_alpha"}))


def test_bf16_frame_counts_the_eager_path():
    r, _, cam, _ = bench_scene.build_bench_renderer(W, H, 16, "cpu",
                                                    shade_dtype="bf16")
    before = dict(shade_cuda.launches)
    r.render_frame(cam.view_matrix(), cam.projection_matrix(), cam.position)
    assert shade_cuda.launches["eager"] == before["eager"] + 1
    assert all(shade_cuda.launches[k] == before[k]
               for k in ("shade", "surface", "compose"))


def _bad_inputs():
    """name -> a function of (args, kwargs) that breaks them."""
    def gbuf(field, fn):
        def make(args, kw):
            g, m, u = args
            return (g._replace(**{field: fn(getattr(g, field))}), m, u), kw
        return make

    def mats(fn):
        return lambda args, kw: ((args[0], fn(args[1]), args[2]), kw)

    def uni(field, fn):
        def make(args, kw):
            g, m, u = args
            return (g, m, u._replace(**{field: fn(getattr(u, field))})), kw
        return make

    def key(k, fn):
        return lambda args, kw: (args, {**kw, k: fn(kw.get(k))})

    def meta(t):
        return torch.empty(t.shape, dtype=t.dtype, device="meta")

    def strided(t):
        return torch.cat([t, t], -1)[..., ::2]

    return {
        "mask 1-d": gbuf("mask", lambda t: t.reshape(-1)),
        "mask uint8": gbuf("mask", lambda t: t.to(torch.uint8)),
        "mask empty": gbuf("mask", lambda t: t[:0]),
        "world on another device": gbuf("world", meta),
        "world float64": gbuf("world", lambda t: t.double()),
        "world strided": gbuf("world", strided),
        "normal bf16": gbuf("normal", lambda t: t.to(torch.bfloat16)),
        "front_facing one short": gbuf("front_facing", lambda t: t[1:]),
        "draw_id int64": gbuf("draw_id", lambda t: t.long()),
        "tangent 3 wide": gbuf("tangent", lambda t: t[..., :3].contiguous()),
        "materials 17 wide": mats(lambda t: t[:, :17].contiguous()),
        "materials empty": mats(lambda t: t[:0]),
        "materials float64": mats(lambda t: t.double()),
        "camera_pos float64": uni("camera_pos", lambda t: t.double()),
        "light_color 4 wide": uni("light_color",
                                  lambda t: torch.cat([t, t[:1]])),
        "ambient_color strided": uni("ambient_color", lambda t: torch.cat(
            [t, t])[::2]),
        "clear_color two": key("clear_color", lambda v: (0.0, 0.0)),
        "clear_color float64": key("clear_color", lambda v: torch.zeros(
            3, dtype=torch.float64)),
        "reinhard int": key("reinhard", lambda v: 1),
        "with_alpha None": key("with_alpha", lambda v: None),
        "dtype bf16": key("dtype", lambda v: torch.bfloat16),
    }


BAD = _bad_inputs()


@pytest.mark.parametrize("bad", sorted(BAD))
def test_argument_checks_raise(bad):
    args, kw = _case("textured")
    shade_cuda.check_inputs(*args, **kw)
    args, kw = BAD[bad](args, kw)
    with pytest.raises(ValueError):
        shade_cuda.check_inputs(*args, **kw)


def test_launcher_refuses_the_cpu(no_library):
    args, kw = _case("standard")
    prepared = shade_cuda.prepare(*args, shadow_map=kw["shadow_map"])
    with pytest.raises(ValueError, match="unsupported device"):
        shade_cuda.launcher(*args, prepared)


def test_prepare_makes_the_plain_versions_inputs():
    """The kernels' inputs, made as the plain version makes them: the shadow
    term equals shadow_cuda's on the plain version's own arguments, and the
    samples texture_cuda's."""
    args, kw = _case("textured")
    gbuf, materials, uniforms = args
    calls = {}
    real_pcf, real_maps = shadow_cuda.shadow_pcf16, texture_cuda.sample_maps

    def pcf(*a):
        calls["pcf"] = a
        return real_pcf(*a)

    def maps(*a):
        calls["maps"] = a
        return real_maps(*a)

    with mock.patch.object(shadow_cuda, "shadow_pcf16", pcf), \
            mock.patch.object(texture_cuda, "sample_maps", maps):
        shade.shade_pbr(*args, **{k: v for k, v in kw.items()
                                  if k != "with_alpha"})
        want = dict(calls)
        prepared = shade_cuda.prepare(
            gbuf, materials, uniforms, kw["shadow_map"], kw["pool"],
            kw["clear_color"], kw["max_anisotropy"])
    for a, b in zip(calls["pcf"] + calls["maps"], want["pcf"] + want["maps"]):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    _same(prepared.shadow, real_pcf(*want["pcf"]))
    for got, w in zip(prepared.samples, real_maps(*want["maps"])):
        _same(got, w)


def test_pass_profiler_and_cost_analysis_reach_the_entry(monkeypatch):
    """profile_passes shades through the entry, and the cost analysis
    listens to its launches while it counts."""
    calls = []
    real = shade_cuda.shade_pbr

    def entry(*args, **kwargs):
        calls.append(args[0].mask.shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(shade_cuda, "shade_pbr", entry)
    r, _, cam, _ = bench_scene.build_bench_renderer(W, H, 16, "cpu")
    timings = pass_profiler.profile_passes(
        r, cam.view_matrix(), cam.projection_matrix(), cam.position, 1)
    assert "SceneEnd" in timings and calls and calls[0] == (H, W)
    with cost_analysis.FrameCost() as cost:
        assert cost._kernel_launch in shade_cuda.observers
    assert cost._kernel_launch not in shade_cuda.observers


def test_chip_smoke_names_every_instantiation():
    """Each kernel of csrc/shade.cu gets a distinct name from chip_smoke.py's
    ptxas_usage, the names chip_smoke.py requires."""
    import chip_smoke

    mangled = [f"_ZN12_GLOBAL__N_112shade_kernelILb{t}ELb{s}EEEvNS_4ArgsE"
               for t in (0, 1) for s in (0, 1)]
    mangled.append("_ZN12_GLOBAL__N_114compose_kernelENS_4ArgsE")
    usage = chip_smoke.ptxas_usage("".join(
        f"ptxas info    : Compiling entry function '{m}' for 'sm_90a'\n"
        "ptxas info    : Function properties for x\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 40 registers\n" for m in mangled))
    assert sorted(usage) == chip_smoke.SHADE_INSTANTIATIONS
    assert len(usage) == 5


# -- on the card -----------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


@pytest.fixture
def counted_launches():
    """The shade kernels' and the light kernel's launches, by stage, seen
    through their observers."""
    seen = []

    def shade_launch(inputs, outputs):
        seen.append("shade kernel")

    def light_launch(inputs, outputs):
        seen.append("light kernel")

    shade_cuda.observers.append(shade_launch)
    lights_cuda.observers.append(light_launch)
    yield seen
    shade_cuda.observers.remove(shade_launch)
    lights_cuda.observers.remove(light_launch)


def _kernel_matches_plain(args, kw, seen):
    want = _outputs(shade_cuda.plain(*args, **kw))
    before = dict(shade_cuda.launches)
    del seen[:]
    got = _outputs(shade_cuda.shade_pbr(*args, **kw))
    torch.cuda.synchronize()
    lit = kw.get("lights") is not None
    assert seen == (["shade kernel", "light kernel", "shade kernel"] if lit
                    else ["shade kernel"])
    stages = ("surface", "compose") if lit else ("shade",)
    assert all(shade_cuda.launches[k] == before[k] + (k in stages)
               for k in before)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.is_contiguous()
        _same(g, w)
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_cuda_kernel_matches_plain(name, counted_launches):
    _need_card()
    got, want = _kernel_matches_plain(*_case(name, "cuda"), counted_launches)
    if name.startswith("seeded"):
        assert bool(torch.isnan(want[0]).any())


@pytest.mark.cuda
@pytest.mark.parametrize("frame", ["standard", "rich", "textured", "glass",
                                   "edge x4"])
def test_cuda_kernel_matches_plain_on_the_1080p_frames(frame,
                                                       counted_launches):
    _need_card()
    kw, preset = FRAMES[frame]
    calls = _record(kw, preset, "cuda", 1920, 1080, 1000)
    assert len(calls) == CALLS_PER_FRAME[frame]
    for args, kwargs in calls:
        _kernel_matches_plain(args, kwargs, counted_launches)


def _probe_values(shape, seed):
    """Seeded f32 values of mixed signs and magnitudes, so that the orders
    of a sum round differently."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=shape) * 10.0 ** rng.integers(-3, 4, shape)
    return torch.from_numpy(v.astype(np.float32)).cuda()


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.cuda
def test_cuda_norm_of_a_strided_view():
    """vector_norm over the first three channels of a contiguous (..., 4)
    (the tangent, the normal map's sample) reduces as a contiguous 3-vector
    does: sqrt((x*x + z*z) + y*y)."""
    _need_card()
    v4 = _probe_values((512, 384, 4), 21)
    v = v4[..., :3]
    x, y, z = v.unbind(-1)
    want = torch.sqrt((x * x + z * z) + y * y)
    assert torch.equal(_bits(torch.linalg.vector_norm(v, dim=-1)),
                       _bits(want))
    assert torch.equal(_bits(torch.linalg.vector_norm(v.contiguous(),
                                                      dim=-1)), _bits(want))


@pytest.mark.cuda
def test_cuda_rdiv_is_the_reciprocal_times_the_scalar():
    """10.0 / x is reciprocal(x) * 10.0 (two roundings), and x / PI is x
    times PI's f32 reciprocal; at some x each differs from the IEEE
    quotient."""
    _need_card()
    x = _probe_values((1 << 20,), 22).abs() + 0.04
    got = 10.0 / x
    assert torch.equal(_bits(got), _bits(torch.reciprocal(x) * 10.0))
    assert int((_bits(got) != _bits(torch.full_like(x, 10.0) / x)).sum()) > 0
    pi = shade.PI
    rcp = float(np.float32(1.0) / np.float32(pi))
    assert torch.equal(_bits(x / pi), _bits(x * rcp))
    assert int((_bits(x / pi) != _bits(x / torch.full_like(x, pi))).sum()) > 0


@pytest.mark.cuda
def test_cuda_python_float_chains_round_left_to_right():
    """PI * d * d is (PI * d) * d, each product rounded in f32, as are
    (r * r) * 0.125 and t2 * t2 * t; 1.0 - x is one rounded f32 op."""
    _need_card()
    d = _probe_values((1 << 20,), 23)
    pi = shade.PI
    got = pi * d * d
    left = (d * float(np.float32(pi))) * d
    assert torch.equal(_bits(got), _bits(left))
    assert int((_bits(got) != _bits(pi * (d * d))).sum()) > 0
    assert torch.equal(_bits(1.0 - d), _bits(torch.ones_like(d) - d))


@pytest.mark.cuda
def test_cuda_clamps_and_minimum_keep_nan():
    """clamp_min, clamp and torch.minimum propagate NaN, which the kernel's
    clamps code (fmaxf and fminf alone would drop it)."""
    _need_card()
    x = torch.tensor([float("nan"), -1.0, 0.5, 2.0], device="cuda")
    assert bool(torch.isnan(x.clamp_min(0.04)[0]))
    assert bool(torch.isnan(x.clamp(0.0, 1.0)[0]))
    assert bool(torch.isnan(torch.minimum(x, torch.zeros_like(x))[0]))
    assert bool(torch.isnan(torch.minimum(torch.zeros_like(x), x)[0]))


@pytest.mark.cuda
def test_cuda_index_conversion_truncates():
    """.to(torch.int32) of a texture index truncates towards zero, as the
    kernel's __float2int_rz: -0.5 gives 0 (an index >= 0); NaN gives 0 and
    out-of-range values saturate, as cvt.rzi does."""
    _need_card()
    x = torch.tensor([-0.5, -1.0, 2.9, float("nan"), 3e9, -3e9],
                     device="cuda")
    got = x.to(torch.int32).tolist()
    assert got[:3] == [0, -1, 2]
    assert got[3:] == [0, 2**31 - 1, -2**31]


@pytest.mark.cuda
def test_cuda_dot_of_3_vectors_adds_lanes_0_and_2_first():
    """_dot's (a * b).sum(-1): (p0 + p2) + p1 with each product rounded."""
    _need_card()
    a = _probe_values((512, 384, 3), 24)
    b = _probe_values((512, 384, 3), 25)
    p = a * b
    p0, p1, p2 = p.unbind(-1)
    assert torch.equal(_bits(shade._dot(a, b)), _bits((p0 + p2) + p1))
