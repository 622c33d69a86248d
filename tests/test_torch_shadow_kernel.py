"""The shadow term's entry points (ash_tpu_torch/ops/shadow_cuda.py) on the
CPU; the kernel itself (csrc/shadow.cu) on the card.

- CPU tensors run the plain version (the light-space projection, then
  ops/shadow.py's shadow_pcf16; or shadow_pcf16_csm) bit for bit, never
  load the library and count no launch: the single map (square, 257^2 and
  48x64), one to four cascades with and without the blend, f32 and bf16
  normals, grids and worklists, one light direction expanded over the
  elements (as shade_pbr hands it) and one an element.
- The plain version against ash_tpu.ops.shadow through JAX on the CPU at
  the same seeded inputs, the single map with the reference's projection
  (the einsum of ash_tpu/ops/shade.py) included: atol 1e-5, as
  tests/test_torch_shade.py and tests/test_torch_csm.py hold it (XLA
  contracts the matrix product's a*b+c on the CPU, the port never does).
- The argument checks pass shade_pbr's own inputs (f32 and bf16, the single
  map and 2-4 cascades) and raise on the wrong dtype, shape, device,
  stride, cascade count and blend size.
- shade_pbr makes one entry call a shaded layer, with the map's matrix and
  the frame's cascades.
- The kernel's window predicate (csrc/shadow.cu's window_axis, written out
  here as _one_window) against the plain version's own taps: where it
  holds, the 16 texels gather_quad reads are the 4x4 window. The probe of
  both tap paths (shadow_cuda.probe_path) refuses the CPU and unknown
  paths; chip_smoke.py names every instantiation of the kernel.
- On the card (marked `cuda`, skipped here): the kernel against the plain
  version on the same CUDA tensors, bit for bit with NaN in the same
  places, over the seeded cases, texels on the map's border and just
  inside it, w at 0 and below, proj z beyond 1, NaN and infinite
  positions and normals, and the 1080p frames' own shade calls (standard,
  glass, rich with and without the blend, 2 and 4 cascades, bf16, edge
  MSAA x4); the probe of the int64 conversion of floor against
  `.to(torch.int64)`; lookups whose floors rounding brings 1 or 3 apart
  (257^2 and 1000^2 maps), windows on each border and corner, every
  alignment of a window's rows, positions and normals one element off an
  aligned address, and texels equal to the compare value. Every one of
  them also runs the kernel on each of its two tap paths (quad by quad,
  and the window path) through shadow_cuda.probe_path, bit for bit the
  plain version; where the lookups are known, the window path's own
  counts equal _one_window's; the entries take the window path where a
  layer's texels do not outnumber the elements.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from ash_tpu_torch.core.transform import Camera
from ash_tpu_torch.ops import _build, geometry, shade, shadow, shadow_cuda
from ash_tpu_torch.render import bench_scene, csm

torch.set_num_threads(1)

ATOL = 1e-5

# name -> (element shape, cascades (0: the single map), map (rows, cols),
# blend size, bf16 normals, one light direction an element)
CASES = {
    "single": ((24, 40), 0, (32, 32), 0.0, False, False),
    "single bf16": ((24, 40), 0, (32, 32), 0.0, True, False),
    "single 257 worklist": ((700,), 0, (257, 257), 0.0, False, False),
    "single 48x64 per-element light": ((20, 30), 0, (48, 64), 0.0, False,
                                       True),
    "csm 1": ((24, 40), 1, (64, 64), 0.0, False, False),
    "csm 2 blend": ((24, 40), 2, (64, 64), 0.1, False, False),
    "csm 3 blend": ((24, 40), 3, (64, 64), 0.1, False, False),
    "csm 3 hard": ((24, 40), 3, (64, 64), 0.0, False, False),
    "csm 3 blend bf16": ((24, 40), 3, (64, 64), 0.1, True, False),
    "csm 4 blend bf16 worklist": ((150, 4), 4, (100, 100), 0.2, True, False),
    "csm 3 blend 257 per-element light": ((20, 30), 3, (257, 257), 0.1,
                                          False, True),
}


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _case(name, device="cpu"):
    """-> (csm?, the entry's arguments, the blend size) of case `name`:
    seeded positions (some off the map, some beyond its far plane), unit
    normals, seeded maps; cascades fitted to a camera by
    render/csm.py:CascadedShadowMap, positions at view distances 1 to 50."""
    shape, c, (rows, cols), blend, bf16, per_element = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name) + 70)
    light = np.array([-0.5, -1.0, -0.3], np.float32)
    to_light = _unit(-light)
    if c == 0:
        world = rng.uniform(-4, 4, shape + (3,)).astype(np.float32)
        m = np.diag([0.3, 0.3, 0.22, 1.0]).astype(np.float32)
        m[:3, :3] += rng.uniform(-0.03, 0.03, (3, 3))
        m[:3, 3] = rng.uniform(-0.1, 0.1, 3)
        m[2, 3] = 0.1  # z spans beyond 1: the far plane
        m[3, :3] = rng.uniform(-0.01, 0.01, 3)  # a w to divide by
        maps = rng.uniform(0.2, 1.0, (rows, cols)).astype(np.float32)
        mats = m.astype(np.float32)
        extra = ()
    else:
        cam = Camera.new([4.0, 3.0, 9.0], [0, 0, -4], 1.5)
        cam.far = 60.0
        view, proj = cam.view_matrix(), cam.projection_matrix()
        fit = csm.CascadedShadowMap(csm.CsmConfig(cascade_count=c,
                                                  resolution=rows))
        fit.update(view, proj, light, 40.0)
        gpu = fit.gpu_data()
        dist = rng.uniform(1.0, 50.0, shape + (1,))
        ndc = rng.uniform(-0.9, 0.9, shape + (2,))
        view_pos = np.concatenate([ndc[..., :1] * dist / proj[0, 0],
                                   ndc[..., 1:] * dist / proj[1, 1], -dist,
                                   np.ones_like(dist)], -1)
        world = (view_pos @ np.linalg.inv(view).T)[..., :3].astype(np.float32)
        maps = rng.uniform(0.2, 1.0, (c, rows, cols)).astype(np.float32)
        mats = gpu.light_matrices[:c].astype(np.float32)
        extra = (gpu.split_distances.astype(np.float32),
                 view.astype(np.float32))
    normal = _unit(rng.normal(size=shape + (3,)))
    dtype = torch.bfloat16 if bf16 else torch.float32

    def dev(a, dt=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)

    if per_element:
        ld = dev(_unit(to_light + rng.normal(0, 0.1, shape + (3,))), dtype)
    else:
        ld = dev(to_light, dtype).expand(shape + (3,))
    elements = (dev(world), dev(normal, dtype), ld)
    if c == 0:
        return False, (dev(maps), dev(mats), *elements), blend
    return True, (dev(maps), dev(mats), *(dev(a) for a in extra),
                  *elements), blend


def _entry(is_csm, args, blend):
    if is_csm:
        return shadow_cuda.shadow_pcf16_csm(*args, blend_size=blend)
    return shadow_cuda.shadow_pcf16(*args)


def _plain(is_csm, args, blend):
    if is_csm:
        return shadow_cuda.plain_csm(*args, blend_size=blend)
    return shadow_cuda.plain(*args)


def _check(is_csm, args, blend):
    if is_csm:
        return shadow_cuda.check_inputs_csm(*args, blend_size=blend)
    return shadow_cuda.check_inputs(*args)


@pytest.fixture
def no_library(monkeypatch):
    """Loading (or building) the CUDA library raises."""
    def refuse(name):
        raise AssertionError(f"the CPU path loaded the {name} library")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)


@pytest.mark.parametrize("name", sorted(CASES))
def test_cpu_entry_is_the_plain_version(name, no_library):
    """Bit for bit the plain version, shaped like world without its last
    axis, some elements in shadow and some lit; no launch counted."""
    is_csm, args, blend = _case(name)
    _check(is_csm, args, blend)
    before = dict(shadow_cuda.launches)
    got = _entry(is_csm, args, blend)
    want = _plain(is_csm, args, blend)
    assert got.dtype == torch.float32
    assert got.shape == args[-3].shape[:-1]
    assert torch.equal(got, want)
    assert shadow_cuda.launches == before
    assert 0.0 < float(got.mean()) < 1.0
    if blend:
        hard = _plain(is_csm, args, 0.0)
        assert not torch.equal(hard, got)


def test_plain_single_map_is_the_projection_then_the_pcf():
    """plain's projection is geometry.transform_points, as shade_pbr's was
    before the kernel."""
    _, (smap, m, world, normal, ld), _ = _case("single")
    want = shadow.shadow_pcf16(smap, geometry.transform_points(m, world),
                               normal, ld)
    assert torch.equal(shadow_cuda.plain(smap, m, world, normal, ld), want)


@pytest.mark.parametrize("name", [n for n in sorted(CASES)
                                  if not CASES[n][4]])
def test_plain_matches_reference(name):
    """The plain version against ash_tpu.ops.shadow through JAX on the CPU,
    the single map with the reference shader's projection (an einsum of the
    matrix and (world, 1), ash_tpu/ops/shade.py)."""
    import jax.numpy as jnp

    from ash_tpu.ops import shadow as ref_shadow

    is_csm, args, blend = _case(name)
    got = _plain(is_csm, args, blend)
    a = [np.ascontiguousarray(t.numpy()) for t in args]
    if is_csm:
        want = ref_shadow.shadow_pcf16_csm(*(jnp.asarray(x) for x in a),
                                           blend_size=blend)
    else:
        smap, m, world, normal, ld = a
        wp4 = jnp.concatenate([world, np.ones_like(world[..., :1])], -1)
        pos = jnp.einsum("ij,...j->...i", jnp.asarray(m), wp4,
                         preferred_element_type=jnp.float32)
        want = ref_shadow.shadow_pcf16(jnp.asarray(smap), pos,
                                       jnp.asarray(normal), jnp.asarray(ld))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def _bad_inputs():
    """name -> (case, a function of the arguments that breaks them, or of
    the blend size)."""
    def swap(i, fn):
        def make(args):
            args = list(args)
            args[i] = fn(args[i])
            return tuple(args)
        return make

    def meta(t):
        return torch.empty(t.shape, dtype=t.dtype, device="meta")

    return {
        "map float64": ("single", swap(0, lambda t: t.double())),
        "map 3-d for the single map": ("single", swap(0, lambda t: t[None])),
        "map strided": ("single", swap(0, lambda t: t.t())),
        "map empty": ("single", swap(0, lambda t: t[:0])),
        "map on another device": ("single", swap(0, meta)),
        "matrix 3x4": ("single", swap(1, lambda t: t[:3].contiguous())),
        "matrix float64": ("single", swap(1, lambda t: t.double())),
        "world bf16": ("single", swap(2, lambda t: t.to(torch.bfloat16))),
        "world 4 wide": ("single", swap(2, lambda t: torch.cat(
            [t, t[..., :1]], -1))),
        "world strided": ("single", swap(2, lambda t: t.transpose(0, 1)
                                         .contiguous().transpose(0, 1))),
        "world on the meta device": ("single", swap(2, meta)),
        "normal float64": ("single", swap(3, lambda t: t.double())),
        "normal float16": ("single", swap(3, lambda t: t.half())),
        "normal shape": ("single", swap(3, lambda t: t[:-1].contiguous())),
        "normal strided": ("single", swap(3, lambda t: torch.cat(
            [t, t[..., :1]], -1)[..., :3])),
        "light_dir dtype unlike normal": ("single bf16", swap(
            4, lambda t: t.float())),
        "light_dir (1, 3)": ("single", swap(4, lambda t: t[0, :1])),
        "light_dir expanded over a row": ("single", swap(
            4, lambda t: t[0].contiguous().expand_as(t))),
        "light_dir every other float": ("single", swap(
            4, lambda t: torch.cat([t, t], -1)[..., ::2])),
        "light_dir transposed": ("single", swap(
            4, lambda t: t.contiguous().transpose(0, 1).contiguous()
            .transpose(0, 1))),
        "cascades 5": ("csm 3 blend", swap(0, lambda t: torch.cat(
            [t, t[:2]]))),
        "cascades 0": ("csm 3 blend", swap(0, lambda t: t[:0])),
        "cascade matrices unlike the maps": ("csm 3 blend", swap(
            1, lambda t: t[:2].contiguous())),
        "splits fewer than the cascades": ("csm 3 blend", swap(
            2, lambda t: t[:2].contiguous())),
        "splits 2-d": ("csm 3 blend", swap(2, lambda t: t[None])),
        "splits float64": ("csm 3 blend", swap(2, lambda t: t.double())),
        "view 3x3": ("csm 3 blend", swap(3, lambda t: t[:3, :3]
                                         .contiguous())),
        "view transposed": ("csm 3 blend", swap(3, lambda t: t.t())),
        "blend negative": ("csm 3 blend", -0.1),
        "blend NaN": ("csm 3 blend", float("nan")),
        "blend infinite": ("csm 3 blend", float("inf")),
        "blend a tensor": ("csm 3 blend", torch.tensor(0.1)),
        "blend a bool": ("csm 3 blend", True),
    }


@pytest.mark.parametrize("bad", sorted(_bad_inputs()))
def test_argument_checks_raise(bad, no_library):
    case, breaker = _bad_inputs()[bad]
    is_csm, args, blend = _case(case)
    _check(is_csm, args, blend)
    if callable(breaker):
        args = breaker(args)
    else:
        blend = breaker
    with pytest.raises(ValueError, match="shadow kernel"):
        _check(is_csm, args, blend)


def test_probe_path_refuses_the_cpu_and_unknown_paths(no_library):
    for name in ("single", "csm 3 blend"):
        is_csm, args, blend = _case(name)
        kw = {"blend_size": blend} if is_csm else {}
        with pytest.raises(ValueError, match="unsupported device cpu"):
            shadow_cuda.probe_path(1, is_csm, *args, **kw)
        with pytest.raises(ValueError, match="path 2 is not"):
            shadow_cuda.probe_path(2, is_csm, *args, **kw)


def test_chip_smoke_names_every_instantiation():
    """Each instantiation of csrc/shadow.cu's two kernels (quad by quad and
    the window path, SHADOW_KERNELS, each launched by the C entry), as
    nvcc names it in its -Xptxas -v log (C cascades, the blend for C > 1,
    bf16), gets a distinct name from chip_smoke.py's ptxas_usage, and
    those are SHADOW_INSTANTIATIONS, the list its build phase requires."""
    import sys

    sys.path.insert(0, str(_build.CSRC.parents[1]))
    import chip_smoke

    def entry(kernel, args, regs):
        return ("ptxas info    : Compiling entry function "
                f"'_ZN12_GLOBAL__N_1{len(kernel)}{kernel}IL{args}EEvNS_4ArgsE' "
                "for 'sm_90a'\n    0 bytes stack frame, 0 bytes spill "
                "stores, 0 bytes spill loads\nptxas info    : Used "
                f"{regs} registers\n")

    combos = [(c, b, d, k) for c in (1, 2, 3, 4) for b in (0, 1)
              for d in (0, 1) for k in chip_smoke.SHADOW_KERNELS
              if c > 1 or not b]
    usage = chip_smoke.ptxas_usage("".join(
        entry(k, f"i{c}ELb{b}ELb{d}E", 30 + i)
        for i, (c, b, d, k) in enumerate(combos)))
    assert sorted(usage) == chip_smoke.SHADOW_INSTANTIATIONS
    assert len(set(usage.values())) == len(usage) == 28
    source = (_build.CSRC / "shadow.cu").read_text()
    for kernel in chip_smoke.SHADOW_KERNELS:
        assert f"{kernel}<C, BLEND, B><<<" in source


def test_launchers_refuse_the_cpu(no_library):
    for name in ("single", "csm 3 blend"):
        is_csm, args, blend = _case(name)
        with pytest.raises(ValueError, match="unsupported device cpu"):
            if is_csm:
                shadow_cuda.launcher_csm(*args, blend_size=blend)
            else:
                shadow_cuda.launcher(*args)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("cascades", [1, 2, 3, 4])
def test_shade_pbr_hands_the_entries_what_they_take(cascades, dtype):
    """The small bench frame (96x64, 16 cubes) with the single map or 2-4
    blended cascades of 256^2: each shaded layer makes one entry call,
    which check_inputs (check_inputs_csm) passes, with the frame's light_space_matrix (or
    cascade uniforms) and the normal's dtype; the frame equals the one
    rendered with the plain version patched in."""
    calls = []
    real = {"pcf": shadow_cuda.shadow_pcf16,
            "csm": shadow_cuda.shadow_pcf16_csm}

    def record(kind):
        def entry(*args, **kwargs):
            (shadow_cuda.check_inputs if kind == "pcf"
             else shadow_cuda.check_inputs_csm)(*args, **kwargs)
            calls.append((kind, args, kwargs))
            return real[kind](*args, **kwargs)
        return entry

    kw = {} if dtype == "f32" else dict(shade_dtype="bf16")
    if cascades > 1:
        kw.update(csm=csm.CsmConfig(cascade_count=cascades, resolution=256),
                  shadow_distance=40.0)

    def frame(patches):
        r, _, cam, _ = bench_scene.build_bench_renderer(96, 64, 16, "cpu",
                                                        **kw)
        with mock.patch.object(shadow_cuda, "shadow_pcf16", patches[0]), \
                mock.patch.object(shadow_cuda, "shadow_pcf16_csm",
                                  patches[1]):
            r.render_frame(cam.view_matrix(), cam.projection_matrix(),
                           cam.position)
        return r.last_outputs().color

    got = frame((record("pcf"), record("csm")))
    assert [c[0] for c in calls] == ["csm" if cascades > 1 else "pcf"]
    kind, args, kwargs = calls[0]
    want_dtype = torch.float32 if dtype == "f32" else torch.bfloat16
    assert args[-2].dtype == want_dtype
    if kind == "csm":
        assert args[0].shape[0] == cascades
        assert kwargs["blend_size"] == pytest.approx(0.1)
    else:
        assert args[1].shape == (4, 4)
    assert args[-1].stride()[:-1] == (0, 0)  # light_dir expanded
    want = frame((shadow_cuda.plain, shadow_cuda.plain_csm))
    assert torch.equal(got, want)


def test_shade_pbr_without_a_shadow_map_calls_no_entry():
    _, (smap, m, world, normal, ld), _ = _case("single")
    h, w = world.shape[:2]

    def refuse(*args, **kwargs):
        raise AssertionError("an entry was called without a shadow map")

    gbuf = shade.GBuffer(
        mask=torch.ones(h, w, dtype=torch.bool), world=world, normal=normal,
        tangent=torch.zeros(h, w, 4), uv=torch.zeros(h, w, 2),
        color=torch.ones(h, w, 3), front_facing=torch.ones(h, w,
                                                          dtype=torch.bool),
        draw_id=torch.zeros(h, w, dtype=torch.int32),
        uv_ddx=torch.zeros(h, w, 2), uv_ddy=torch.zeros(h, w, 2))
    uni = shade.ShadeUniforms(
        camera_pos=torch.tensor([0.0, 0.0, 9.0]),
        light_direction=torch.tensor([-0.5, -1.0, -0.3]),
        light_color=torch.ones(3), ambient_color=torch.full((3,), 0.1),
        light_space_matrix=m)
    mats = torch.zeros(1, 18)
    mats[0, :4] = 1.0
    with mock.patch.object(shadow_cuda, "shadow_pcf16", refuse), \
            mock.patch.object(shadow_cuda, "shadow_pcf16_csm", refuse):
        unlit = shade.shade_pbr(gbuf, mats, uni)
    lit = shade.shade_pbr(gbuf, mats, uni, shadow_map=smap)
    assert unlit.shape == lit.shape and not torch.equal(unlit, lit)


def _floors(u, v, rows, cols):
    """A lookup's int64 floors at (u, v) as ops/shadow.py's shadow_pcf16
    takes them: (xa, xb, ya, yb), xa and ya those of the quads at -1
    texel, xb and yb at +1."""
    ts = 1.0 / rows

    def floor(c, o, size):
        return torch.floor((c + o * ts) * size - 0.5).to(torch.int64)

    return floor(u, -1.0, cols), floor(u, 1.0, cols), floor(v, -1.0, rows), \
        floor(v, 1.0, rows)


def _one_window(xa, xb, ya, yb, rows, cols):
    """Where a lookup's 16 taps are one 4x4 window inside the (rows, cols)
    map, as the kernel's window_axis tests it (for maps under 2^24 texels
    a side), from its _floors: two apart on both axes, the window at (ya,
    xa) inside the map."""
    return ((xa >= 0) & (xb == xa + 2) & (xb + 1 < cols)
            & (ya >= 0) & (yb == ya + 2) & (yb + 1 < rows))


def _near_texel_edges(size, rng, count=2000):
    """Seeded positions x (u = x * 0.5 + 0.5 under the identity matrix) for
    a map `size` texels wide: those where u * size - 0.5 is a texel edge
    (so the quads at +-1 texel floor next to one), u nudged by up to six
    ulps either way, where rounding can bring two quads' floors 1 or 3
    apart; then `count` uniform ones, some off the map."""
    u = ((np.arange(-4, size + 4) + 0.5) / size).astype(np.float32)
    out, up, down = [u], u, u
    for _ in range(6):
        up, down = np.nextafter(up, np.float32(2)), np.nextafter(
            down, np.float32(-2))
        out += [up, down]
    x = (np.concatenate(out) - np.float32(0.5)) * np.float32(2)
    return np.concatenate([x, rng.uniform(-1.1, 1.1, count).astype(
        np.float32)])


@pytest.mark.parametrize("size", [(257, 257), (1000, 1000), (48, 64),
                                  (61, 67)])
def test_one_window_is_the_plain_versions_taps(size):
    """Wherever _one_window holds (the lookups the kernel's window path
    reads as one window), the 16 texels that ops/shadow.gather_quad reads
    for the four quads are exactly the 4x4 window at (ya, xa); on a map
    whose texels hold their own index. On a square map it holds for most
    lookups on the map, and not where rounding brings two floors 1 or 3
    apart."""
    rows, cols = size
    rng = np.random.default_rng(rows + cols)
    xs = _near_texel_edges(cols, rng)
    ys = _near_texel_edges(rows, rng)
    xs, ys = np.meshgrid(xs, ys[rng.permutation(len(ys))][:64])
    u = torch.from_numpy(xs.ravel()) * 0.5 + 0.5
    v = torch.from_numpy(ys.ravel()) * 0.5 + 0.5
    index = torch.arange(rows * cols, dtype=torch.float32).reshape(rows,
                                                                   cols)
    ts = 1.0 / rows
    taps = torch.cat([shadow.gather_quad(index, u + ox * ts, v + oy * ts)
                      for ox, oy in ((-1.0, -1.0), (1.0, -1.0), (-1.0, 1.0),
                                     (1.0, 1.0))], -1)
    xa, xb, ya, yb = _floors(u, v, rows, cols)
    fast = _one_window(xa, xb, ya, yb, rows, cols)
    r = torch.arange(4)
    window = ((ya[:, None, None] + r[None, :, None]) * cols
              + xa[:, None, None] + r[None, None, :]).reshape(-1, 16)
    assert torch.equal(taps[fast].to(torch.int64).sort(-1).values,
                       window[fast].sort(-1).values)
    inside = (xa >= 0) & (xb + 1 < cols) & (ya >= 0) & (yb + 1 < rows)
    apart = (xb - xa != 2) | (yb - ya != 2)
    assert not bool((fast & apart).any())
    assert torch.equal(fast, inside & ~apart)
    if rows == cols:
        assert float(fast.sum()) > 0.9 * float(inside.sum())
        # The search finds floors 3 apart at both sizes, 1 apart at 1000.
        for d in (1, 3) if rows == 1000 else (3,):
            assert bool((inside & ((xb - xa == d) | (yb - ya == d))).any())
    else:
        # The texel size is 1 / rows on both axes, so the x floors of a
        # map wider than tall are often 3 apart.
        assert bool(fast.any()) and bool((inside & apart).any())


# -- on the card -----------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


def _assert_same(got, want):
    """Bit for bit where the plain version has a number, NaN where it has
    NaN."""
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))


def _probe(path, is_csm, args, blend):
    kw = {"blend_size": blend} if is_csm else {}
    return shadow_cuda.probe_path(path, is_csm, *args, **kw)


def _kernel_matches_plain(is_csm, args, blend):
    """One counted launch against the plain version on the same CUDA
    tensors, and one on each tap path through the probe, which counts no
    launch -> (the entry's result, the plain one, the window path's
    (lookups that reached the taps, those read as windows))."""
    want = _plain(is_csm, args, blend)
    key = "csm" if is_csm else "pcf"
    before = dict(shadow_cuda.launches)
    got = _entry(is_csm, args, blend)
    counts = None
    for path in (0, 1):
        out, taken, reads, windows = _probe(path, is_csm, args, blend)
        torch.cuda.synchronize()
        assert taken == path
        _assert_same(out, want)
        if path == 0:
            assert (reads, windows) == (0, 0)
        else:
            assert 0 <= windows <= reads
            counts = reads, windows
    assert shadow_cuda.launches == {**before, key: before[key] + 1}
    torch.cuda.synchronize()
    _assert_same(got, want)
    return got, want, counts


def _window_counts_are_one_windows(args, rows, cols):
    """The window path's own counts at a single-map _window_case: the
    lookups at or before the far plane, and of them those _one_window
    takes as one window."""
    got, want, (reads, windows) = _kernel_matches_plain(False, args, 0.0)
    world = args[-3]
    reach = ~(world[:, 2] * 0.5 + 0.5 > 1.0)
    one = reach & _one_window(*_lookup_floors(args, rows, cols), rows, cols)
    assert (reads, windows) == (int(reach.sum()), int(one.sum()))
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_kernel_matches_plain(name):
    _need_card()
    _kernel_matches_plain(*_case(name, "cuda"))


def _on_the_border(rows, cols, seed, bf16=False):
    """The single map with the identity as its matrix, so that proj = world
    * 0.5 + 0.5: positions whose quads' taps land on the map's first and
    last texels, just inside and outside them, and on texel boundaries, at
    depths across the map's range."""
    rng = np.random.default_rng(seed)
    ts = 1.0 / rows
    inside = np.arange(0, cols + 1) / cols
    u = np.concatenate([np.arange(-2, 3) * ts, 1.0 + np.arange(-2, 3) * ts,
                        rng.choice(inside, min(len(inside), 200),
                                   replace=False)])
    u = np.concatenate([u, np.nextafter(u, 2.0), np.nextafter(u, -2.0)])
    uu, vv = np.meshgrid(u, u[rng.permutation(len(u))], indexing="ij")
    n = uu.size
    world = np.stack([uu.ravel() * 2 - 1, vv.ravel() * 2 - 1,
                      rng.uniform(-0.2, 1.1, n)], -1).astype(np.float32)
    smap = rng.uniform(0.2, 1.0, (rows, cols)).astype(np.float32)
    normal = _unit(rng.normal(size=(n, 3)))
    dtype = torch.bfloat16 if bf16 else torch.float32
    ld = torch.tensor(_unit(np.array([0.3, 0.9, 0.2])), dtype=dtype,
                      device="cuda").expand(n, 3)
    return (torch.from_numpy(smap).cuda(), torch.eye(4, device="cuda"),
            torch.from_numpy(world).cuda(),
            torch.from_numpy(normal).to("cuda", dtype), ld)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(32, 32), (257, 257), (1000, 1000),
                                  (48, 64)])
def test_cuda_kernel_on_the_maps_border(size):
    _need_card()
    args = _on_the_border(*size, seed=size[0])
    got = _kernel_matches_plain(False, args, 0.0)[0]
    # The border's white taps and the map's both show.
    assert 0.0 < float(got.mean()) < 1.0


def _degenerate(name, seed):
    """Case `name` (CUDA tensors) with NaN and infinite positions and
    normals, huge and tiny positions, and for the single map a matrix whose
    w is z (so w at 0, tiny, and below 0 at the positions' z)."""
    is_csm, args, blend = _case(name, "cuda")
    args = [a.clone() if i < len(args) - 1 else a
            for i, a in enumerate(args)]
    world, normal = args[-3], args[-2]
    rng = np.random.default_rng(seed)
    flat_w, flat_n = world.view(-1, 3), normal.view(-1, 3)
    n = flat_w.shape[0]

    def some(share=0.04):
        return torch.from_numpy(rng.random(n) < share).cuda()

    for value in (float("nan"), float("inf"), float("-inf"), 1e30, -1e30,
                  1e-30):
        flat_w[some(), int(rng.integers(3))] = value
        flat_n[some(), int(rng.integers(3))] = value
    if not is_csm:
        m = args[1]
        m[3] = torch.tensor([0.0, 0.0, 1.0, 0.0], device="cuda")
        z = flat_w[:, 2]
        z[some(0.1)] = 0.0
        z[some(0.1)] = -0.0
        z[some(0.1)] = 1e-9
        z[some(0.1)] = -1e-9
        z[some(0.1)] = -2.0
    return is_csm, tuple(args), blend


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["single", "single bf16", "csm 3 blend",
                                  "csm 4 blend bf16 worklist"])
def test_cuda_kernel_matches_plain_on_degenerate_inputs(name):
    """NaN in the same places (a NaN distance picks layer 0 and a NaN
    blend), the numbers bit for bit; w at 0 takes 1e-8, w below 0 mirrors
    the projection; huge coordinates read the white border."""
    _need_card()
    got, want, _ = _kernel_matches_plain(*_degenerate(name, 5))
    finite = want[~torch.isnan(want)]
    assert finite.numel() > 0
    if "csm" in name:
        assert bool(torch.isnan(want).any())


@pytest.mark.cuda
def test_cuda_floor_to_int64_is_pytorchs():
    """The kernel's conversion of a tap's floor against
    torch.floor(x).to(torch.int64) on the card: saturating, and NaN and
    the infinities sent where PyTorch sends them."""
    _need_card()
    special = [float("nan"), float("inf"), float("-inf"), 0.0, -0.0, -0.5,
               0.5, -1.0, 1e20, -1e20, 2.0**63, -2.0**63, 2.0**62, -2.0**62,
               3e38, -3e38, 2.0**31, -2.0**31 - 1, 1e-45, -1e-45]
    rng = np.random.default_rng(9)
    rand = rng.standard_normal(4096) * np.exp2(rng.uniform(-10, 70, 4096))
    x = torch.tensor(np.concatenate([special, rand]).astype(np.float32),
                     device="cuda")
    got = shadow_cuda.probe_floor(x)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.floor(x).to(torch.int64))


def _recorded_shadow_calls(preset=None, **cfg):
    """The shadow entries' (kind, arguments, blend size) of one 1080p frame
    of the bench scene with `cfg` (and an MSAA preset)."""
    calls = []
    real = {"pcf": shadow_cuda.shadow_pcf16,
            "csm": shadow_cuda.shadow_pcf16_csm}

    def record(kind):
        def entry(*args, blend_size=0.0):
            calls.append((kind == "csm", args, blend_size))
            if kind == "csm":
                return real[kind](*args, blend_size=blend_size)
            return real[kind](*args)
        return entry

    r, _, cam, _ = bench_scene.build_bench_renderer(1920, 1080, 1000, "cuda",
                                                    **cfg)
    if preset is not None:
        r.set_msaa_preset(preset)
    with mock.patch.object(shadow_cuda, "shadow_pcf16", record("pcf")), \
            mock.patch.object(shadow_cuda, "shadow_pcf16_csm", record("csm")):
        r.render_frame(cam.view_matrix(), cam.projection_matrix(),
                       cam.position)
    return calls


# name -> (MSAA preset, build_bench_renderer keywords, shade calls a frame:
# None for one a peel layer)
FRAMES = {
    "standard": (None, dict(), 1),
    "standard bf16": (None, dict(shade_dtype="bf16"), 1),
    "glass": (None, dict(glass=True), None),
    "rich": (None, dict(rich=True), 1),
    "rich hard": (None, dict(rich=True, csm=csm.CsmConfig(
        cascade_count=3, resolution=1024, blend_cascades=False)), 1),
    "rich 2 cascades": (None, dict(rich=True, csm=csm.CsmConfig(
        cascade_count=2, resolution=1024)), 1),
    "rich 4 cascades": (None, dict(rich=True, csm=csm.CsmConfig(
        cascade_count=4, resolution=1024)), 1),
    "rich bf16": (None, dict(rich=True, shade_dtype="bf16"), 1),
    "edge x4": ("x4", dict(msaa_resolve="edge"), 2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_cuda_kernel_matches_plain_on_the_1080p_frames(frame):
    """The 1080p frames' own shade calls, replayed through the kernel and
    the plain version."""
    _need_card()
    preset, cfg, n_calls = FRAMES[frame]
    calls = _recorded_shadow_calls(preset, **cfg)
    assert len(calls) == n_calls if n_calls else len(calls) > 1
    shadows = [_kernel_matches_plain(*call)[0] for call in calls]
    assert 0.0 < float(torch.cat([s.reshape(-1) for s in shadows]).mean()) \
        < 1.0


def _window_case(xs, ys, size, seed, device="cuda", cascades=0, offset=0):
    """(csm?, the entry's arguments, the blend size) at positions (xs, ys)
    under the identity matrix (u = x * 0.5 + 0.5, v = y * 0.5 + 0.5), one
    element each at a seeded depth: a seeded (rows, cols) map, or
    `cascades` of them with identity matrices, the view the identity (the
    distance is -z, which passes some of the splits) and the blend 0.1;
    the maps' first texel `offset` floats past a 16-byte boundary."""
    rows, cols = size
    rng = np.random.default_rng(seed)
    n, c = len(xs), max(cascades, 1)
    if cascades:
        z = rng.uniform(-1.0, 0.0, n)
        depth = rng.uniform(0.0, 0.6, (c, rows, cols))
    else:
        z = rng.uniform(-0.2, 1.1, n)  # proj z beyond 1 too
        depth = rng.uniform(0.2, 1.0, (c, rows, cols))
    store = torch.zeros(offset + c * rows * cols, device=device)
    maps = store[offset:].view(c, rows, cols)
    maps.copy_(torch.from_numpy(depth.astype(np.float32)))
    world = torch.from_numpy(np.stack([xs, ys, z], -1).astype(np.float32))
    normal = torch.from_numpy(_unit(rng.normal(size=(n, 3))))
    ld = torch.tensor(_unit(np.array([0.3, 0.9, 0.2])), device=device)
    elements = (world.to(device), normal.to(device), ld.expand(n, 3))
    eye = torch.eye(4, device=device)
    if not cascades:
        return False, (maps[0], eye, *elements), 0.0
    splits = torch.linspace(1.0 / c, 1.0, c, device=device)
    return True, (maps, eye.expand(c, 4, 4).contiguous(), splits, eye,
                  *elements), 0.1


def _lookup_floors(args, rows, cols):
    """_floors of each element of a _window_case, from its positions."""
    world = args[-3]
    return _floors(world[:, 0] * 0.5 + 0.5, world[:, 1] * 0.5 + 0.5, rows,
                   cols)


def _apart_case(size, cascades, device="cuda"):
    """A _window_case on a (size, size) map with both coordinates of most
    elements near texel edges (_near_texel_edges)."""
    rng = np.random.default_rng(size + cascades)
    xs = _near_texel_edges(size, rng)
    ys = _near_texel_edges(size, rng)[rng.permutation(len(xs))]
    return _window_case(xs, ys, (size, size), size, device, cascades)


@pytest.mark.cuda
@pytest.mark.parametrize("cascades", [0, 3])
@pytest.mark.parametrize("size", [257, 1000])
def test_cuda_kernel_where_quads_floor_apart(size, cascades):
    """Lookups on the map whose x or y floors rounding brings 1 or 3 apart
    (found by search near the texel edges), which the kernel takes quad by
    quad, beside their neighbours that are one window."""
    _need_card()
    is_csm, args, blend = _apart_case(size, cascades)
    xa, xb, ya, yb = _lookup_floors(args, size, size)
    inside = (xa >= 0) & (xb + 1 < size) & (ya >= 0) & (yb + 1 < size)
    apart = (xb - xa != 2) | (yb - ya != 2)
    assert bool((inside & apart).any())
    assert bool(_one_window(xa, xb, ya, yb, size, size).any())
    if is_csm:
        _kernel_matches_plain(is_csm, args, blend)
    else:
        _window_counts_are_one_windows(args, size, size)


def _starts(n):
    """Window starts along an axis of n texels: straddling the first and
    the last texel, touching them from inside, and one in the middle."""
    return np.array([-4, -3, -2, -1, 0, 1, n // 2, n - 5, n - 4, n - 3,
                     n - 2, n - 1, n])


def _windows_at(kx, ky, rows, cols, repeat=4):
    """Positions x, y whose lookups' windows start at (ky, kx): the quad at
    -1 texel floors half a texel from a texel edge, u - 1 / rows = (kx +
    1) / cols (the texel size is 1 / rows on both axes); each `repeat`
    times (at seeded depths)."""
    def coord(k, n):
        return (((k + 1.0) / n + 1.0 / rows - 0.5) * 2).astype(np.float32)

    return (np.repeat(coord(kx.ravel(), cols), repeat),
            np.repeat(coord(ky.ravel(), rows), repeat))


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(32, 32), (61, 67), (257, 257)])
def test_cuda_kernel_windows_on_the_borders_and_corners(size):
    """Windows that straddle each border and each corner of the map, touch
    them from inside, and lie inside, at every pairing of the two axes."""
    _need_card()
    rows, cols = size
    kx, ky = np.meshgrid(_starts(cols), _starts(rows))
    xs, ys = _windows_at(kx, ky, rows, cols)
    args = _window_case(xs, ys, size, rows + cols)[1]
    xa, xb, ya, yb = _lookup_floors(args, rows, cols)
    assert torch.equal(xa.cpu(), torch.from_numpy(np.repeat(kx.ravel(), 4)))
    assert torch.equal(ya.cpu(), torch.from_numpy(np.repeat(ky.ravel(), 4)))
    fast = _one_window(xa, xb, ya, yb, rows, cols)
    assert bool(fast.any()) and not bool(fast.all())
    _window_counts_are_one_windows(args, rows, cols)


@pytest.mark.cuda
@pytest.mark.parametrize("cascades, offset", [(0, 0), (0, 1), (0, 2), (0, 3),
                                              (3, 0), (3, 1)])
def test_cuda_kernel_at_every_row_alignment(cascades, offset):
    """Every window of a 61x61 map (rows 61 texels long, so a row's first
    texel takes every 16-byte alignment), the windows at the map's last
    texels included; the maps 0-3 floats past an aligned address."""
    _need_card()
    s = 61
    kx, ky = np.meshgrid(np.arange(s - 3), np.arange(s - 3))
    xs, ys = _windows_at(kx, ky, s, s, repeat=2)
    is_csm, args, blend = _window_case(xs, ys, (s, s), offset, "cuda",
                                       cascades, offset)
    assert args[0].data_ptr() % 16 == 4 * offset
    xa, xb, ya, yb = _lookup_floors(args, s, s)
    assert bool(_one_window(xa, xb, ya, yb, s, s).all())
    if is_csm:
        # Every lookup, the blend's too, is one window.
        reads, windows = _kernel_matches_plain(is_csm, args, blend)[2]
        assert reads >= len(xs) and windows == reads
    else:
        _window_counts_are_one_windows(args, s, s)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["single 257 worklist",
                                  "csm 4 blend bf16 worklist",
                                  "single 48x64 per-element light",
                                  "csm 3 blend 257 per-element light"])
def test_cuda_kernel_on_unaligned_elements(name):
    """A worklist whose positions, normals (and directions, one an
    element) start one element past an aligned address, of a length that
    is not a multiple of the block."""
    _need_card()
    is_csm, args, blend = _case(name, "cuda")
    *head, world, normal, ld = args

    def shifted(t):
        flat = t.reshape(-1, 3)
        store = torch.empty((flat.shape[0] + 1, 3), dtype=t.dtype,
                            device=t.device)
        store[1:] = flat
        return store[1:]

    world, normal = shifted(world), shifted(normal)
    n = world.shape[0]
    ld = shifted(ld) if ld.stride(0) else ld.reshape(-1, 3)[0].expand(n, 3)
    assert n % 128 != 0 and world.data_ptr() % 16 != 0
    assert normal.data_ptr() % 16 != 0
    _kernel_matches_plain(is_csm, (*head, world, normal, ld), blend)


def _tie_case(cascades, device="cuda"):
    """A _window_case whose lookups' compare values are texel values: each
    element at proj z 0.25 or 0.5 with its normal along the light (the
    bias at its floor of 0.005), the maps drawn from those two compare
    values and their f32 neighbours."""
    s = 64
    kx, ky = np.meshgrid(np.arange(0, s - 3, 3), np.arange(0, s - 3, 3))
    xs, ys = _windows_at(kx, ky, s, s, repeat=2)
    is_csm, args, blend = _window_case(xs, ys, (s, s), 3, device, cascades)
    n = len(xs)
    rng = np.random.default_rng(31)
    world, normal, ld = args[-3], args[-2], args[-1]
    world[:, 2] = torch.from_numpy(rng.choice(
        np.array([-0.5, 0.0], np.float32), n)).to(device)
    normal.copy_(ld)
    ties = np.float32([0.25, 0.5]) - np.float32(0.005)
    values = np.concatenate([ties, np.nextafter(ties, np.float32(0)),
                             np.nextafter(ties, np.float32(1))])
    maps = args[0]
    maps.copy_(torch.from_numpy(rng.choice(values, maps.shape)).to(device))
    return is_csm, args, blend


@pytest.mark.cuda
@pytest.mark.parametrize("cascades", [0, 3])
def test_cuda_kernel_where_taps_equal_the_compare(cascades):
    """A tap is in shadow only where compare > texel: the texels equal to
    a lookup's compare value count as lit, on both paths."""
    _need_card()
    is_csm, args, blend = _tie_case(cascades)
    if is_csm:
        got = _kernel_matches_plain(is_csm, args, blend)[0]
    else:
        got = _window_counts_are_one_windows(args, 64, 64)[0]
    assert 0.0 < float(got.mean()) < 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("cascades", [0, 3])
def test_cuda_window_path_where_texels_do_not_outnumber_elements(cascades):
    """The entries' path (the probe at -1): the window path where a
    layer's texels are at most the launch's elements, quad by quad where
    they are more; a launch either side of that line on a 61x61 map."""
    _need_card()
    s = 61
    rng = np.random.default_rng(cascades)
    for n, path in ((s * s - 1, 0), (s * s, 1)):
        xs, ys = rng.uniform(-1.1, 1.1, (2, n)).astype(np.float32)
        is_csm, args, blend = _window_case(xs, ys, (s, s), n, "cuda",
                                           cascades)
        out, taken, reads, windows = _probe(-1, is_csm, args, blend)
        torch.cuda.synchronize()
        assert taken == path
        assert (reads > 0) == (path == 1) and windows <= reads
        _assert_same(out, _plain(is_csm, args, blend))
