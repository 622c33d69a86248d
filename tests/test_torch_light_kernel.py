"""The Forward+ light loop's entry point (ash_tpu_torch/ops/lights_cuda.py)
on the CPU; the kernel itself (csrc/lights.cu) on the card.

- CPU tensors run the plain loop (ops/light_loop.py's light_slots) bit for
  bit, in place, at the trimmed trip count (the largest tile count) and at
  the full slot count alike (the -1 slots add nothing), never load the
  library and count no launch; over seeded point, spot and directional
  rows, with empty tiles, without counts, a band's lists (tile_y0), a tile
  size of 8, per-element `pixel_xy` (clamped past the grid), and bf16.
- shade_pbr hands the loop to the entry once a call, with the counts; the
  frame passes the list cut to shaded_lights_per_tile slots and the counts,
  and the small lit frame with every slot walked (no trip count) equals the
  frame as it renders, by torch.equal.
- shade_pbr's lit result through the entry against ash_tpu's shade_pbr on
  the same numpy inputs (f32, grid and pixel_xy): atol 1e-5 and rtol 1e-3
  (XLA contracts a*b+c on the CPU, the port never does, and a sharp GGX
  peak amplifies the difference; SHADE_RTOL says by how much).
- The argument checks raise on the wrong dtype, shape, device or layout,
  and pass shade_pbr's own calls (f32 and bf16); the CPU entry takes any
  float dtypes, as the plain loop always did.
- On the card (marked `cuda`, skipped here): the kernel against the plain
  loop on the same CUDA tensors, bit for bit on covered elements (torch.equal,
  so +0 and -0 agree), the uncovered ones untouched, over the seeded cases
  and at the 1080p rich and lit frames' own shade calls; and the rounding
  probes that pin what the kernel codes: (a * b).sum(-1) and
  torch.linalg.vector_norm of 3-vectors as (p0 + p2) + p1, summed in f32
  for bf16 inputs too and rounded once,
  x / PI as x times the f32 reciprocal of PI, 10 / x as the reciprocal of x
  times 10, and torch.cos as cosf.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ash_tpu.ops import shade as ref_shade
from ash_tpu_torch.ops import _build, light_cull, light_loop, lights_cuda
from ash_tpu_torch.ops import shade
from ash_tpu_torch.render import bench_scene
from ash_tpu_torch.render.features import light_culling, lighting
from test_torch_lights import _lit_gbuffer, _uniforms

torch.set_num_threads(1)

# Against ash_tpu: XLA contracts a*b+c into FMA on the CPU, the port never
# does, and near a sharp GGX peak the last-bit difference of the
# denominator grows: 1.4e-4 relative at a specular value of 18.6 in the
# grid case here. So 1e-5 absolute, and 1e-3 relative for the highlights.
SHADE_ATOL = 1e-5
SHADE_RTOL = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _light_rows(seed, n=24):
    """Packed point, spot and directional rows (the port's GpuLight)."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        pos = rng.uniform(-5, 5, 3).astype(np.float32)
        color = rng.random(3).astype(np.float32)
        kind = i % 4
        if kind == 1:
            gl = light_culling.GpuLight.from_spot_light(lighting.SpotLight(
                position=pos, direction=rng.normal(size=3).astype(np.float32),
                color=color, intensity=4.0, radius=float(rng.uniform(2, 9)),
                inner_cone_angle=float(rng.uniform(0.1, 0.4)),
                outer_cone_angle=float(rng.uniform(0.45, 0.9))))
        elif kind == 3 and i < 8:
            gl = light_culling.GpuLight.from_directional_light(
                lighting.DirectionalLight(
                    direction=rng.normal(size=3).astype(np.float32)))
        else:
            gl = light_culling.GpuLight.from_point_light(lighting.PointLight(
                position=pos, color=color, intensity=2.5,
                radius=float(rng.uniform(1, 9))))
        rows.append(gl.flat())
    return np.stack(rows)


def _lists(rng, tiles, n_lights, k, stride, empty=0.25):
    """Seeded well-formed tile lists (ty, tx, stride) cut to k slots: each
    tile's count of distinct ascending ids, -1 past it; a share `empty` of
    the tiles has none."""
    ty, tx = tiles
    full = np.full((ty, tx, stride), -1, np.int32)
    counts = rng.integers(1, k + 1, (ty, tx)).astype(np.int32)
    counts[rng.random((ty, tx)) < empty] = 0
    for y in range(ty):
        for x in range(tx):
            ids = np.sort(rng.choice(n_lights, counts[y, x], replace=False))
            full[y, x, :counts[y, x]] = ids
    return full, counts


def _shading_inputs(rng, shape):
    """Seeded G-buffer and BRDF inputs over `shape`, as shade_pbr makes them
    (f32): (mask, world, normal, view_dir, base_color, metallic, roughness,
    f0, ndotv, lo)."""
    def unit(v):
        return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(
            np.float32)

    mask = rng.random(shape) < 0.8
    world = rng.uniform(-4, 4, shape + (3,)).astype(np.float32)
    normal = unit(rng.normal(size=shape + (3,)))
    view = unit(rng.normal(size=shape + (3,)) + normal)
    base = rng.uniform(0.05, 1.0, shape + (3,)).astype(np.float32)
    metallic = rng.random(shape).astype(np.float32)
    rough = rng.uniform(0.04, 1.0, shape).astype(np.float32)
    f0 = ((1 - metallic[..., None]) * np.float32(0.04)
          + metallic[..., None] * base).astype(np.float32)
    ndotv = np.maximum((normal * view).sum(-1), 0.001).astype(np.float32)
    lo = rng.uniform(0, 0.5, shape + (3,)).astype(np.float32)
    return mask, world, normal, view, base, metallic, rough, f0, ndotv, lo


# name -> (grid (rows, cols), tile size, slots K cut from a list of
# `stride`, counts?, pixel_xy?, bf16?)
CASES = {
    "f32": ((40, 56), 16, 12, 16, True, False, False),
    "bf16": ((40, 56), 16, 12, 16, True, False, True),
    "no counts": ((40, 56), 16, 12, 12, False, False, False),
    "tile 8": ((40, 56), 8, 6, 8, True, False, False),
    "pixel_xy": ((24, 40), 16, 12, 16, True, True, False),
    "pixel_xy bf16": ((24, 40), 16, 12, 16, True, True, True),
    "one row": ((1, 300), 16, 9, 9, True, True, False),
}
# Cases that reach the edges of the kernel's paths, with the table's light
# count last: tiles cut by the frame's last row and column, more lights than
# the kernel's table of light terms holds (64: the tile's slots are staged
# instead), more slots than one round, and the element kernel over them.
EXTRA_CASES = {
    "edge tiles": ((33, 47), 16, 12, 16, True, False, False, 24),
    "edge tiles bf16": ((33, 47), 16, 12, 16, True, False, True, 24),
    "many lights": ((40, 56), 16, 12, 16, True, False, False, 100),
    "many lights bf16": ((40, 56), 16, 12, 16, True, False, True, 100),
    "many slots": ((40, 56), 16, 80, 96, True, False, False, 100),
    "many lights pixel_xy": ((24, 40), 16, 12, 16, True, True, False, 100),
}
ALL_CASES = sorted(CASES) + sorted(EXTRA_CASES)
# The light-list grid of the pixel_xy cases (render pixels 64 x 80).
XY_TILES = (4, 5)


def _case(name, device="cpu"):
    """The entry's arguments for case `name` (lo first), and the plain
    loop's n_iter at the trimmed count."""
    if name in CASES:
        shape, tile, k, stride, with_counts, with_xy, bf16 = CASES[name]
        rng = np.random.default_rng(sorted(CASES).index(name) + 40)
        lights = _light_rows(7)
    else:
        (shape, tile, k, stride, with_counts, with_xy, bf16,
         n_lights) = EXTRA_CASES[name]
        rng = np.random.default_rng(sorted(EXTRA_CASES).index(name) + 140)
        lights = _light_rows(7, n_lights)
    if with_xy:
        tiles = XY_TILES
    else:
        tiles = (-(-shape[0] // tile), -(-shape[1] // tile))
    full, counts = _lists(rng, tiles, len(lights), k, stride)
    (mask, world, normal, view, base, metallic, rough, f0, ndotv,
     lo) = _shading_inputs(rng, shape)
    dtype = torch.bfloat16 if bf16 else torch.float32

    def dev(a, dt=None):
        t = _t(a).to(device)
        return t.to(dt) if dt is not None else t

    indices = dev(full)[:, :, :k]
    pixel_xy = None
    if with_xy:
        # Render coordinates of the list grid, a few past each edge (the
        # lookup clamps them to the border tiles).
        h, w = tiles[0] * tile, tiles[1] * tile
        pixel_xy = (dev(rng.integers(-5, w + 5, shape).astype(np.int32)),
                    dev(rng.integers(-5, h + 5, shape).astype(np.int32)))
    args = (dev(lo, dtype), dev(mask), dev(world), dev(normal, dtype),
            dev(view, dtype), dev(base, dtype), dev(metallic, dtype),
            dev(rough, dtype), dev(f0, dtype), dev(ndotv, dtype),
            dev(lights), indices, dev(counts) if with_counts else None,
            tile, pixel_xy)
    n_iter = int(counts.max()) if with_counts else k
    return args, n_iter


def _plain(args, n_iter):
    """The plain loop on the same tensors, into a copy of lo."""
    (lo, mask, world, normal, view, base, metallic, rough, f0, ndotv, lights,
     indices, _, tile, pixel_xy) = args
    dtype = lo.dtype
    cast = (lambda x: x) if dtype == torch.float32 else (
        lambda x: x.to(dtype))
    return light_loop.light_slots(lo.clone(), world, lights, indices, n_iter,
                                  tile, normal, view, base, metallic, rough,
                                  f0, ndotv, cast, pixel_xy)


def _assert_equal_where_covered(got, want, lo_in, mask):
    assert torch.equal(got[mask], want[mask])
    assert torch.equal(got[~mask].view(torch.int16 if got.dtype ==
                                       torch.bfloat16 else torch.int32),
                       lo_in[~mask].view(torch.int16 if got.dtype ==
                                         torch.bfloat16 else torch.int32))


@pytest.fixture
def no_library(monkeypatch):
    """Loading (or building) the CUDA library raises."""
    def refuse(name):
        raise AssertionError(f"the CPU path loaded the {name} library")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)


@pytest.mark.parametrize("name", ALL_CASES)
def test_cpu_entry_is_the_plain_loop(name, no_library):
    """In place, bit for bit the plain loop at the trimmed trip count and at
    every slot, on every element; no launch counted."""
    args, n_iter = _case(name)
    lo = args[0]
    k = args[11].shape[-1]
    trimmed = _plain(args, n_iter)
    full = _plain(args, k)
    before = dict(lights_cuda.launches)
    got = lights_cuda.add_lights(*args)
    assert got is lo
    assert torch.equal(got, trimmed) and torch.equal(got, full)
    assert lights_cuda.launches == before
    # The lights show on some covered elements.
    assert not torch.equal(got, _case(name)[0][0])


def test_empty_lists_add_nothing(no_library):
    args, _ = _case("f32")
    lo_in = args[0].clone()
    empty = torch.zeros_like(args[12])
    got = lights_cuda.add_lights(*args[:12], empty, *args[13:])
    assert torch.equal(got, lo_in)


def test_band_lists_through_the_entry(no_library):
    """A band of 32 rows from tile row 2 of a 96x64 frame: the lists that
    cull_lights builds with tile_y0, walked by the band-local grid."""
    rng = np.random.default_rng(3)
    lights = _t(_light_rows(9, 32))
    cam_view = torch.eye(4)
    cam_view[2, 3] = -8.0
    proj = torch.tensor([[1.2, 0, 0, 0], [0, 1.8, 0, 0],
                         [0, 0, -1.0, -0.2], [0, 0, -1.0, 0]])
    depth = _t(rng.uniform(0.5, 0.99, (32, 96)).astype(np.float32))
    tl = light_cull.cull_lights(lights, cam_view, torch.linalg.inv(proj),
                                depth, 96, 64, tile_y0=2)
    assert int(tl.counts.max()) > 0
    (mask, world, normal, view, base, metallic, rough, f0, ndotv,
     lo) = (_t(a) for a in _shading_inputs(rng, (32, 96)))
    args = (lo, mask, world, normal, view, base, metallic, rough, f0, ndotv,
            lights, tl.indices, tl.counts, 16, None)
    want = _plain(args, int(tl.counts.max()))
    assert torch.equal(lights_cuda.add_lights(*args), want)


def _bad_inputs():
    def swap(i, fn):
        def make(args):
            args = list(args)
            args[i] = fn(args[i])
            return tuple(args)
        return make

    return {
        "lo float64": swap(0, lambda t: t.double()),
        "lo dtype unlike normal": swap(0, lambda t: t.to(torch.bfloat16)),
        "mask uint8": swap(1, lambda t: t.to(torch.uint8)),
        "mask shape": swap(1, lambda t: t[:-1].contiguous()),
        "world bf16": swap(2, lambda t: t.to(torch.bfloat16)),
        "world strided": swap(2, lambda t: t.transpose(0, 1).contiguous()
                              .transpose(0, 1)),
        "normal shape": swap(3, lambda t: t[..., :2].contiguous()),
        "base_color strided": swap(5, lambda t: torch.cat(
            [t, t[..., :1]], -1)[..., :3]),
        "metallic shape": swap(6, lambda t: t[..., None]),
        "ndotv float64": swap(9, lambda t: t.double()),
        "lights width": swap(10, lambda t: t[:, :15].contiguous()),
        "lights float64": swap(10, lambda t: t.double()),
        "indices int64": swap(11, lambda t: t.long()),
        "indices 2-d": swap(11, lambda t: t[:, :, 0]),
        "indices strided tiles": swap(11, lambda t: t.transpose(0, 1)),
        "counts shape": swap(12, lambda t: t[:-1].contiguous()),
        "counts int64": swap(12, lambda t: t.long()),
        "tile size 0": swap(13, lambda t: 0),
        "tile size float": swap(13, lambda t: 16.0),
        "pixel_xy one": swap(14, lambda t: (torch.zeros(40, 56, dtype=torch
                                                        .int32),)),
        "pixel_xy int64": swap(14, lambda t: (
            torch.zeros(40, 56, dtype=torch.int64),) * 2),
    }


@pytest.mark.parametrize("bad", sorted(_bad_inputs()))
def test_argument_checks_raise(bad, no_library):
    args, _ = _case("f32")
    lights_cuda.check_inputs(*args)
    bad_args = _bad_inputs()[bad](args)
    with pytest.raises(ValueError, match="light kernel"):
        lights_cuda.check_inputs(*bad_args)


def test_cpu_entry_takes_float64_as_the_plain_loop(no_library):
    """f64 shading inputs (a caller's f64 uniforms make them) are not the
    kernel's, but the CPU entry runs the plain loop on them as before."""
    args, n_iter = _case("f32")
    args = tuple(a.double() if isinstance(a, torch.Tensor)
                 and a.dtype == torch.float32 and i not in (2, 10) else a
                 for i, a in enumerate(args))
    with pytest.raises(ValueError, match="shading dtype"):
        lights_cuda.check_inputs(*args)
    want = _plain(args, n_iter)
    assert torch.equal(lights_cuda.add_lights(*args), want)


def test_launcher_refuses_the_cpu(no_library):
    args, _ = _case("f32")
    with pytest.raises(ValueError, match="unsupported device cpu"):
        lights_cuda.launcher(*args)


def _small_lit_frame(**cfg):
    r, _, cam, _ = bench_scene.build_bench_renderer(96, 64, 16, "cpu",
                                                    lights=32, **cfg)
    r.render_frame(cam.view_matrix(), cam.projection_matrix(), cam.position)
    return r.read_back().copy(), r.last_outputs().color


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_frame_hands_the_loop_to_the_entry(dtype):
    """The small lit frame's shade_pbr makes one add_lights call with the
    list cut to shaded_lights_per_tile slots and the culling's counts; with
    every slot walked (no trip count, as the card walks) the frame is the
    same, by torch.equal."""
    kw = {} if dtype == "f32" else dict(shade_dtype="bf16")
    calls = []
    real = lights_cuda.add_lights

    def record(*args):
        calls.append(args)
        return real(*args)

    with mock.patch.object(lights_cuda, "add_lights", record):
        image, color = _small_lit_frame(**kw)
    assert len(calls) == 1
    lights_cuda.check_inputs(*calls[0])  # what the card would take
    indices, counts = calls[0][11], calls[0][12]
    # FrameConfig's shaded_lights_per_tile: 256 slots, at most 32 used.
    assert indices.shape[-1] == 256 and counts is not None
    assert indices.dtype == counts.dtype == torch.int32
    assert int(counts.max()) > 0
    assert calls[0][0].dtype == (torch.float32 if dtype == "f32"
                                 else torch.bfloat16)

    def every_slot(lo, mask, world, normal, view, base, metallic, rough, f0,
                   ndotv, lights, indices, counts, tile, pixel_xy=None):
        cast = (lambda x: x) if lo.dtype == torch.float32 else (
            lambda x: x.to(lo.dtype))
        return lo.copy_(light_loop.light_slots(
            lo, world, lights, indices, indices.shape[-1], tile, normal,
            view, base, metallic, rough, f0, ndotv, cast, pixel_xy))

    with mock.patch.object(lights_cuda, "add_lights", every_slot):
        image_all, color_all = _small_lit_frame(**kw)
    assert np.array_equal(image, image_all)
    assert torch.equal(color, color_all)


def test_edge_msaa_frame_passes_pixel_xy():
    """The edge-MSAA lit frame shades its centres and its worklist through
    the entry, each with per-element tile coordinates."""
    calls = []
    real = lights_cuda.add_lights

    def record(*args):
        calls.append(args)
        return real(*args)

    r, _, cam, _ = bench_scene.build_bench_renderer(
        96, 64, 16, "cpu", lights=32, msaa_resolve="edge")
    r.set_msaa_preset("x4")
    with mock.patch.object(lights_cuda, "add_lights", record):
        out = r.render_frame(cam.view_matrix(), cam.projection_matrix(),
                             cam.position)
    assert len(calls) == 2
    for args in calls:
        lights_cuda.check_inputs(*args)
        assert args[14] is not None
        assert all(c.dtype == torch.int32 and c.is_contiguous()
                   for c in args[14])
    assert bool(torch.isfinite(out.color).all())


def _gbuffer_and_lights(seed, shape):
    rng = np.random.default_rng(seed)
    g = _lit_gbuffer(rng, *shape)
    mats = np.zeros((4, 18), np.float32)
    mats[:, 0:4] = rng.uniform(0.3, 1.0, (4, 4))
    mats[:, 8] = rng.random(4)
    mats[:, 9] = rng.uniform(0.0, 1.0, 4)
    mats[:, 10:12] = 1.0
    mats[:, 12:17] = -1.0
    full, counts = _lists(rng, (3, 4), 24, 10, 10)
    return g, mats, _light_rows(11), full, counts, rng


@pytest.mark.parametrize("elements", ["grid", "pixel_xy"])
def test_lit_shading_through_the_entry_matches_reference(elements):
    """shade_pbr with point, spot and directional lights through the entry,
    against ash_tpu's shade_pbr on the same inputs."""
    g, mats, lights, full, counts, rng = _gbuffer_and_lights(5, (40, 56))
    pixel_xy = None
    if elements == "pixel_xy":
        pixel_xy = tuple(rng.integers(-3, hi, (40, 56)).astype(np.int32)
                         for hi in (68, 52))
    want = ref_shade.shade_pbr(
        ref_shade.GBuffer(**{k: jnp.asarray(v) for k, v in g.items()}),
        jnp.asarray(mats), _uniforms(False), lights=jnp.asarray(lights),
        tile_light_indices=jnp.asarray(full),
        tile_light_counts=jnp.asarray(counts), reinhard=False,
        pixel_xy=None if pixel_xy is None else tuple(
            jnp.asarray(c) for c in pixel_xy))
    calls = []
    real = lights_cuda.add_lights

    def record(*args):
        calls.append(args)
        return real(*args)

    with mock.patch.object(lights_cuda, "add_lights", record):
        got = shade.shade_pbr(
            shade.GBuffer(**{k: _t(v) for k, v in g.items()}), _t(mats),
            _uniforms(True), lights=_t(lights),
            tile_light_indices=_t(full), tile_light_counts=_t(counts),
            reinhard=False,
            pixel_xy=None if pixel_xy is None else tuple(
                _t(c) for c in pixel_xy))
    assert len(calls) == 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=SHADE_ATOL, rtol=SHADE_RTOL)
    unlit = shade.shade_pbr(shade.GBuffer(**{k: _t(v) for k, v in g.items()}),
                            _t(mats), _uniforms(True), reinhard=False)
    assert (got - unlit).abs().max() > 0.1


# -- on the card -----------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


def _kernel_matches_plain(args, n_iter):
    """One counted launch against the plain loop on the same CUDA tensors:
    equal on covered elements, the others untouched."""
    lo_in = args[0].clone()
    want = _plain((lo_in.clone(), *args[1:]), n_iter)
    before = lights_cuda.launches["loop"]
    got = lights_cuda.add_lights(*args)
    assert lights_cuda.launches["loop"] == before + 1
    torch.cuda.synchronize()
    _assert_equal_where_covered(got, want, lo_in, args[1])
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("name", ALL_CASES)
def test_cuda_kernel_matches_plain(name):
    _need_card()
    _kernel_matches_plain(*_case(name, "cuda"))


def _recorded_shade_calls(**cfg):
    """The add_lights arguments of one 1080p frame of the bench scene with
    `cfg` (lo copied before the call)."""
    calls = []
    real = lights_cuda.add_lights

    def record(*args):
        calls.append((args[0].clone(), *args[1:]))
        return real(*args)

    r, _, cam, _ = bench_scene.build_bench_renderer(1920, 1080, 1000, "cuda",
                                                    **cfg)
    with mock.patch.object(lights_cuda, "add_lights", record):
        r.render_frame(cam.view_matrix(), cam.projection_matrix(),
                       cam.position)
    return calls


@pytest.mark.cuda
@pytest.mark.parametrize("frame", ["rich", "lit", "lit bf16"])
def test_cuda_kernel_matches_plain_on_the_1080p_frames(frame):
    """The rich and lit 1080p frames' own shade calls, replayed through
    kernel and plain loop."""
    _need_card()
    cfg = {"rich": dict(rich=True), "lit": dict(lights=32),
           "lit bf16": dict(lights=32, shade_dtype="bf16")}[frame]
    calls = _recorded_shade_calls(**cfg)
    assert len(calls) == 1
    args = calls[0]
    assert int(args[12].max()) > 0
    _kernel_matches_plain(args, min(int(args[12].max()), args[11].shape[-1]))


def _probe_vectors(n, seed, dtype=torch.float32):
    """n seeded 3-vectors over 2^-30..2^30 in magnitude, with zeros, signed
    zeros and equal-magnitude components mixed in."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 3)) * np.exp2(rng.uniform(-30, 30, (n, 1)))
    x *= np.exp2(rng.uniform(-8, 8, (n, 3)))
    pick = rng.random((n, 3)) < 0.05
    x[pick] = rng.choice([0.0, -0.0, 1.0, -1.0], pick.sum())
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(1080, 1920), (40, 56)])
def test_cuda_sum_and_norm_of_3_vectors_add_lanes_0_and_2_first(shape, dtype):
    """(a * b).sum(-1) and torch.linalg.vector_norm over a last dimension of
    3 on the card, as the loop takes them, are (p0 + p2) + p1 in f32 (bf16
    inputs too), rounded to the dtype once: what csrc/lights.cu codes. The
    probe tells the orders apart: (p0 + p1) + p2 differs."""
    _need_card()
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    n = int(np.prod(shape))
    a = _probe_vectors(n, 1, dt).reshape(shape + (3,)).cuda()
    b = _probe_vectors(n, 2, dt).reshape(shape + (3,)).cuda()
    p = (a * b).float()
    got = (a * b).sum(-1)
    assert got.dtype == dt
    want = (((p[..., 0] + p[..., 2]) + p[..., 1]) + 0.0).to(dt)
    assert torch.equal(got, want)
    q = a.float() * a.float()
    norm = torch.linalg.vector_norm(a, dim=-1)
    assert norm.dtype == dt
    assert torch.equal(norm, ((q[..., 0] + q[..., 2]) + q[..., 1]).sqrt()
                       .to(dt))
    if dt == torch.float32:  # bf16's last rounding hides most f32 orders
        assert not torch.equal(got, (p[..., 0] + p[..., 1]) + p[..., 2])
        assert not torch.equal(norm, ((q[..., 0] + q[..., 1]) + q[..., 2])
                               .sqrt())


@pytest.mark.cuda
def test_cuda_scalar_division_reciprocal_and_cos():
    """x / PI multiplies by the f32 reciprocal of PI, 10.0 / x is
    reciprocal(x) * 10, in f32 and bf16; torch.cos is cosf (held through the
    spot cases of test_cuda_kernel_matches_plain, which cos feeds)."""
    _need_card()
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(1e-3, 50, 1 << 20).astype(np.float32))
    inv = float(np.float32(1.0) / np.float32(light_loop.PI))
    for dt in (torch.float32, torch.bfloat16):
        xc = x.to(dt).cuda()
        assert torch.equal(xc / light_loop.PI,
                           (xc.float() * inv).to(dt))
        assert torch.equal(10.0 / xc, (1.0 / xc.float()).to(dt).float()
                           .mul(10.0).to(dt))
    xc = x.cuda()
    assert not torch.equal(xc / light_loop.PI, xc / torch.full_like(
        xc, float(np.float32(light_loop.PI))))


@pytest.mark.cuda
def test_cuda_bf16_conversion_is_pytorchs():
    """The kernel's bf16 rounding (__float2bfloat16_rn, widened back) gives
    the bits of tensor.to(torch.bfloat16) on the card: over every kind of
    f32 bit pattern (NaNs, infinities, subnormals, zeros), over ties to even
    either way, and at the edges of the bf16 range."""
    _need_card()
    rng = np.random.default_rng(6)
    bits = rng.integers(0, 2**32, 1 << 20, dtype=np.uint64).astype(np.uint32)
    ties = (rng.integers(0, 2**16, 1 << 12, dtype=np.uint64).astype(np.uint32)
            << 16) | np.uint32(0x8000)
    edges = np.array([0x00000000, 0x80000000, 0x7F800000, 0xFF800000,
                      0x7FC00000, 0xFFC00001, 0x7F800001, 0x00000001,
                      0x80000001, 0x007FFFFF, 0x00008000, 0x00018000,
                      0x7F7FFFFF, 0x7F7F8000, 0x7F7F7FFF, 0xFF7FFFFF,
                      0x3F808000, 0x3F818000, 0x3F80FFFF], np.uint32)
    x = torch.from_numpy(np.concatenate([bits, ties, edges]).view(
        np.float32)).cuda()
    got = lights_cuda.probe_bf16(x)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), x.to(torch.bfloat16).view(
        torch.int16))


def _degenerate(args, seed):
    """`args` (CPU tensors) with pixels and lights outside the bounds under
    which the kernel leaves out a point light that is out of reach
    (csrc/lights.cu, Pixel::tame and Light::tame): roughness 0 and 2,
    NaN, infinite and negative inputs, a long normal, a far position; a
    light with a huge colour, one with a NaN position."""
    (lo, mask, world, normal, view, base, metallic, rough, f0, ndotv, lights,
     indices, counts, tile, pixel_xy) = (a.clone() if isinstance(
         a, torch.Tensor) else a for a in args)
    rng = np.random.default_rng(seed)
    h, w = mask.shape

    def some():
        return torch.from_numpy(rng.random((h, w)) < 0.04)

    rough[some()] = 0.0
    rough[some()] = 2.0
    base[some()] = float("nan")
    f0[some()] = float("inf")
    f0[some()] = -0.5
    metallic[some()] = float("-inf")
    ndotv[some()] = -0.25
    longer = some()
    normal[longer] = normal[longer] * 1.5
    view[some()] = 1e30
    world[some()] = 1e30
    lights[3, 7] = 1e38
    lights[5, 0] = float("nan")
    return (lo, mask, world, normal, view, base, metallic, rough, f0, ndotv,
            lights, indices, counts, tile, pixel_xy)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["f32", "bf16", "pixel_xy"])
def test_cuda_kernel_matches_plain_on_degenerate_inputs(name):
    """Where the plain loop gives a number the kernel gives the same one
    (torch's ==, so +0 and -0 agree), and NaN where it gives NaN; the
    uncovered elements untouched. The out-of-reach pairs the kernel leaves
    out add +-0 in the plain loop."""
    _need_card()
    args, n_iter = _case(name)

    def cuda(a):
        if isinstance(a, torch.Tensor):
            return a.cuda()
        return tuple(c.cuda() for c in a) if isinstance(a, tuple) else a

    args = tuple(cuda(a) for a in _degenerate(args, 21))
    lo_in, mask = args[0].clone(), args[1]
    want = _plain((lo_in.clone(), *args[1:]), n_iter)
    got = lights_cuda.add_lights(*args)
    torch.cuda.synchronize()
    g, w = got[mask].float(), want[mask].float()
    nan = torch.isnan(w)
    assert bool(nan.any()) and bool((~nan).any())
    assert torch.equal(torch.isnan(g), nan)
    assert torch.equal(g[~nan], w[~nan])
    int_view = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got[~mask].view(int_view), lo_in[~mask].view(int_view))
