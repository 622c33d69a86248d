"""Textures: ash_tpu_torch's texture pool, sampler, bindless manager and
textured shading against ash_tpu on the CPU, on the same seeded inputs.

Tolerances, each stated where it is used:
- `build_pool`: bit for bit (bf16 texels compared as int16 patterns).
- `sample_trilinear`: atol 1e-6 (XLA fuses the bilinear lerps into FMA).
- `_sample_map` at anisotropy 1 and 16: atol 1e-5 where both sides choose
  the same tap count; pixels whose n_taps = ceil(major / minor) lands on
  the other side of an integer (norms that differ in the last bit) are
  counted and held under 0.5%.
- The bindless manager's residency plans: equal.
- Textured `shade_pbr` with all five maps: atol 1e-5.
The six tests of tests/test_texture_streaming.py run on the port below.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ash_tpu.core.texture import TextureData as RefTextureData
from ash_tpu.core.texture import mip_chain as ref_mip_chain
from ash_tpu.ops import shade as ref_shade
from ash_tpu.ops import texture_sample as ref_ts
from ash_tpu.render.bindless import BindlessTextureManager as RefManager
from ash_tpu_torch import Camera, Material, Mesh, Renderer, RendererConfig
from ash_tpu_torch.core.texture import TextureData, mip_chain
from ash_tpu_torch.errors import ResourceCreationError
from ash_tpu_torch.ops import shade, texture_sample
from ash_tpu_torch.render import HeadlessSurface
from ash_tpu_torch.render.bindless import BindlessTextureManager

torch.set_num_threads(1)

SAMPLE_ATOL = 1e-6
MAP_ATOL = 1e-5
SHADE_ATOL = 1e-5
MAX_FLIP_SHARE = 0.005


def _t(a):
    return torch.from_numpy(np.array(a))


def _pyramids(seed, sizes):
    """Seeded random linear RGBA mip chains of the given (h, w) sizes."""
    rng = np.random.default_rng(seed)
    return [mip_chain(None, rng.random((h, w, 4)).astype(np.float32))
            for h, w in sizes]


def _pools(pyramids, **kw):
    """The same pyramids packed by both packages -> (reference, port)."""
    return (ref_ts.build_pool(pyramids, **kw),
            texture_sample.build_pool(pyramids, device="cpu", **kw))


POOL_CASES = {
    "odd_sizes": (((13, 7), (5, 9), (1, 1), (16, 16)), {}),
    "min_levels": (((13, 7), (32, 32), (8, 4)), dict(min_levels=[1, 3, 9])),
    "arena": (((13, 7), (32, 32)), dict(min_levels=[0, 2],
                                        arena_texels=1500)),
    "empty": ((), {}),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_build_pool_bit_for_bit(case):
    sizes, kw = POOL_CASES[case]
    ref, got = _pools(_pyramids(1, sizes), **kw)
    want_bits = np.asarray(ref.texels).view(np.int16)
    assert got.texels.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.texels.view(torch.int16).numpy(),
                                  want_bits)
    np.testing.assert_array_equal(got.table.numpy(), np.asarray(ref.table))
    np.testing.assert_array_equal(got.levels.numpy(), np.asarray(ref.levels))
    assert (got.min_level is None) == (ref.min_level is None)
    if ref.min_level is not None:
        np.testing.assert_array_equal(got.min_level.numpy(),
                                      np.asarray(ref.min_level))


@pytest.mark.parametrize("build", [
    lambda: texture_sample.build_pool(_pyramids(3, [(8, 8)])),
    lambda: BindlessTextureManager(budget_bytes=None),
], ids=["build_pool", "BindlessTextureManager"])
def test_texture_pool_defaults_to_the_card(build, monkeypatch):
    """Without a device the pool and its manager go to the card, and never
    fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        build()


def test_build_pool_arena_overflow_raises():
    with pytest.raises(ValueError, match="arena"):
        texture_sample.build_pool(_pyramids(2, [(16, 16)]), arena_texels=100,
                                  device="cpu")


@pytest.mark.parametrize("streamed", [False, True])
def test_sample_trilinear_matches_reference(streamed):
    """uv far outside [0, 1) (REPEAT with negative coordinates), fractional
    and out-of-range LODs, index -1 (white) and, streamed, LOD clamped up
    to min_level."""
    kw = dict(min_levels=[2, 0, 1]) if streamed else {}
    ref_pool, pool = _pools(_pyramids(3, [(16, 8), (32, 32), (7, 13)]), **kw)
    rng = np.random.default_rng(4)
    n = 4000
    idx = rng.integers(-1, 3, n).astype(np.int32)
    uv = rng.uniform(-2.5, 3.5, (n, 2)).astype(np.float32)
    lod = rng.uniform(-1.0, 7.0, n).astype(np.float32)
    for lod_arg in (lod, None):
        want = ref_ts.sample_trilinear(
            ref_pool, jnp.asarray(idx), jnp.asarray(uv),
            None if lod_arg is None else jnp.asarray(lod_arg))
        got = texture_sample.sample_trilinear(
            pool, _t(idx), _t(uv), None if lod_arg is None else _t(lod_arg))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=SAMPLE_ATOL, rtol=0)
    assert (got.numpy()[idx < 0] == 1.0).all()


def _ref_n_taps(ref_pool, idx, ddx, ddy, max_aniso):
    """The reference's tap count, with its own operations."""
    base = ref_pool.table[jnp.maximum(idx, 0), 0]
    tw, th = base[..., 1].astype(jnp.float32), base[..., 2].astype(jnp.float32)
    lu = jnp.linalg.norm(jnp.stack([ddx[..., 0] * tw, ddx[..., 1] * th], -1),
                         axis=-1)
    lv = jnp.linalg.norm(jnp.stack([ddy[..., 0] * tw, ddy[..., 1] * th], -1),
                         axis=-1)
    rho_max = jnp.maximum(jnp.maximum(lu, lv), 1e-8)
    rho_min = jnp.maximum(jnp.minimum(lu, lv), 1e-8)
    return np.asarray(jnp.clip(jnp.ceil(rho_max / rho_min), 1.0,
                               float(max_aniso)))


def _footprints(seed, n=3000):
    """Seeded uv derivatives whose axes have ratios up to 1:20."""
    rng = np.random.default_rng(seed)
    angle = rng.uniform(0, 2 * np.pi, n)
    major = rng.uniform(0.002, 0.2, n)
    minor = major / rng.uniform(1.0, 20.0, n)
    ax = np.stack([np.cos(angle), np.sin(angle)], -1)
    perp = np.stack([-np.sin(angle), np.cos(angle)], -1)
    ddx = (ax * major[:, None]).astype(np.float32)
    ddy = (perp * minor[:, None]).astype(np.float32)
    swap = rng.random(n) < 0.5  # either axis can be the major one
    ddx[swap], ddy[swap] = ddy[swap].copy(), ddx[swap].copy()
    uv = rng.uniform(-1.0, 2.0, (n, 2)).astype(np.float32)
    idx = rng.integers(-1, 3, n).astype(np.int32)
    return idx, uv, ddx, ddy


@pytest.mark.parametrize("max_aniso", [1, 16])
def test_sample_map_matches_reference(max_aniso):
    ref_pool, pool = _pools(_pyramids(5, [(64, 64), (32, 128), (16, 16)]))
    idx, uv, ddx, ddy = _footprints(6)
    args = [jnp.asarray(a) for a in (idx, uv, ddx, ddy)]
    want = np.asarray(ref_shade._sample_map(ref_pool, *args, max_aniso))
    got = shade._sample_map(pool, *(_t(a) for a in (idx, uv, ddx, ddy)),
                            max_aniso).numpy()
    same = np.ones(len(idx), bool)
    if max_aniso > 1:
        fp = shade.map_footprint(pool, _t(idx), _t(ddx), _t(ddy), max_aniso)
        ref_taps = _ref_n_taps(ref_pool, *args[:1], *args[2:], max_aniso)
        same = fp.n_taps.numpy() == ref_taps
        assert ref_taps.max() == max_aniso  # the 1:20 ratios reach the cap
        assert (~same).mean() <= MAX_FLIP_SHARE, int((~same).sum())
    np.testing.assert_allclose(got[same], want[same], atol=MAP_ATOL, rtol=0)


def test_sample_map_trip_count_beyond_the_largest_tap_count_is_exact():
    """Taps past a pixel's n_taps add exactly 0: any trip count at or above
    the largest n_taps gives the same bits."""
    _, pool = _pools(_pyramids(7, [(64, 64), (16, 32), (8, 8)]))
    idx, uv, ddx, ddy = (_t(a) for a in _footprints(8, 500))
    fp = shade.map_footprint(pool, idx, ddx, ddy, 16)
    largest = int(fp.n_taps.max())
    a = shade.sample_footprint(pool, idx, uv, fp)
    b = shade.sample_footprint(pool, idx, uv, fp, trips=largest + 5)
    assert torch.equal(a, b)


def _textures(seed, sizes):
    rng = np.random.default_rng(seed)
    out = []
    for h, w in sizes:
        px = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
        out.append(px)
    return out


def _managers(budget, sizes, seed=9):
    ref, port = RefManager(budget_bytes=budget), BindlessTextureManager(
        budget_bytes=budget, device="cpu")
    for px in _textures(seed, sizes):
        h, w = px.shape[:2]
        assert (ref.add_sampled_image(RefTextureData(w, h, px))
                == port.add_sampled_image(TextureData(w, h, px)))
    return ref, port


RESIDENCY_CASES = {
    "unbudgeted": (None, [(64, 64), (16, 16)], []),
    "demotes_largest": (64 * 64 * 8 * 2, [(128, 128), (16, 16), (64, 32)], []),
    "requests": ((64 * 64 + 32 * 32 + 1024) * 8,
                 [(64, 64), (64, 64), (32, 32)], [(1, 0), (0, 0), (2, 3)]),
}


@pytest.mark.parametrize("case", sorted(RESIDENCY_CASES))
def test_residency_plans_equal(case):
    budget, sizes, requests = RESIDENCY_CASES[case]
    ref, port = _managers(budget, sizes)
    for step in [None] + requests:
        if step is not None:
            ref.request_residency(*step)
            port.request_residency(*step)
        assert port._fit_residency() == ref._fit_residency()
        rp, pp = ref.pool(), port.pool()
        np.testing.assert_array_equal(pp.table.numpy(), np.asarray(rp.table))
        np.testing.assert_array_equal(
            pp.texels.view(torch.int16).numpy(),
            np.asarray(rp.texels).view(np.int16))
        assert port.stats() == ref.stats()
        assert port.version == ref.version
        assert port.restream_count == ref.restream_count


def test_texture_decode_matches_reference():
    (px,) = _textures(10, [(9, 5)])
    for srgb in (True, False):
        a = TextureData(5, 9, px, srgb=srgb).to_linear_f32()
        b = RefTextureData(5, 9, px, srgb=srgb).to_linear_f32()
        np.testing.assert_array_equal(a, b)
        for x, y in zip(mip_chain(None, a), ref_mip_chain(None, b)):
            np.testing.assert_array_equal(x, y)


# -- tests/test_texture_streaming.py on the port ---------------------------

def _checker(size):
    return TextureData.checkerboard(size=size, cell=max(size // 8, 1))


def test_unbudgeted_pool_fully_resident():
    mgr = BindlessTextureManager(device="cpu")
    mgr.add_sampled_image(_checker(64))
    pool = mgr.pool()
    assert pool.min_level is None
    s = mgr.stats()
    assert s["resident_bytes"] == s["bytes"]


def test_budget_demotes_largest_textures():
    mgr = BindlessTextureManager(budget_bytes=64 * 64 * 8 * 2, device="cpu")
    big = mgr.add_sampled_image(_checker(128))
    small = mgr.add_sampled_image(_checker(16))
    pool = mgr.pool()
    mins = pool.min_level.numpy()
    assert mins[big] >= 1, "finest mip of the big texture demoted"
    assert mins[small] == 0, "small texture untouched"
    s = mgr.stats()
    assert s["resident_bytes"] <= s["budget_bytes"]
    assert pool.texels.shape[0] == s["budget_bytes"] // 8  # the arena


def test_sampling_clamps_to_resident_mip():
    """With mip 0 not resident a LOD-0 sample returns mip 1's content: a
    1 px checker's mip 1 is uniform grey."""
    tex = TextureData.checkerboard(size=16, cell=1)
    mgr = BindlessTextureManager(budget_bytes=10 * 10 * 8, device="cpu")
    idx = mgr.add_sampled_image(tex)
    pool = mgr.pool()
    assert int(pool.min_level[idx]) >= 1
    uv = torch.tensor([[3.5 / 16, 3.5 / 16]])
    out = texture_sample.sample_trilinear(pool, torch.tensor([idx]), uv)[0]
    full = BindlessTextureManager(device="cpu")
    fidx = full.add_sampled_image(tex)
    ref = texture_sample.sample_trilinear(full.pool(), torch.tensor([fidx]),
                                          uv)[0]
    assert not np.allclose(out[:3].numpy(), ref[:3].numpy(), atol=1e-3)


def test_restream_keeps_shapes_and_promotes():
    budget = (64 * 64 + 32 * 32 + 1024) * 8
    mgr = BindlessTextureManager(budget_bytes=budget, device="cpu")
    a = mgr.add_sampled_image(_checker(64))
    b = mgr.add_sampled_image(_checker(64))
    p0 = mgr.pool()
    shapes0 = (p0.texels.shape, p0.table.shape, p0.min_level.shape)
    mins0 = p0.min_level.numpy().copy()
    demoted = a if mins0[a] > 0 else b
    mgr.request_residency(demoted, 0)
    p1 = mgr.pool()
    assert (p1.texels.shape, p1.table.shape, p1.min_level.shape) == shapes0
    mins1 = p1.min_level.numpy()
    assert mins1[demoted] == 0, "promotion honoured"
    assert mins1[b if demoted == a else a] > 0, "the other one pushed down"
    assert mgr.restream_count == 1


def test_budget_too_small_raises():
    mgr = BindlessTextureManager(budget_bytes=8, device="cpu")  # one texel
    mgr.add_sampled_image(_checker(16))
    mgr.add_sampled_image(_checker(16))
    with pytest.raises(ResourceCreationError):
        mgr.pool()


def test_renderer_end_to_end_with_budget():
    """A textured frame under a budget that demotes mips renders; a
    residency request restreams without changing the pool's shapes, and
    re-renders nothing of the geometry."""
    surface = HeadlessSurface(96, 64)
    r = Renderer(
        surface,
        RendererConfig(tile_h=8, tile_w=32, max_tris_per_tile=32,
                       shadows_enabled=False,
                       texture_budget_bytes=48 * 48 * 8),
        device="cpu",
    )
    mesh = Mesh.create_named_cube("StreamCube")
    mesh.texture_data = _checker(64)
    r.set_mesh(mesh)
    r.set_material(Material(color=(1, 1, 1, 1)))
    cam = Camera.new([2.5, 2, 4], [0, 0, 0], 1.5)
    out = r.render_frame(cam.view_matrix(), cam.projection_matrix(),
                         cam.position)
    img0 = out.color.numpy()
    assert img0.max() > 0.05
    stats = r.bindless.stats()
    assert stats["resident_bytes"] <= stats["budget_bytes"]
    shapes = r.bindless.pool().texels.shape
    r.request_texture_residency(0, 1)
    out = r.render_frame(cam.view_matrix(), cam.projection_matrix(),
                         cam.position)
    assert out.color.shape == img0.shape
    assert r.bindless.pool().texels.shape == shapes
    assert r.bindless.restream_count == 1


# -- textured shading --------------------------------------------------------

def _textured_gbuffer(rng, h=24, w=40, draws=6):
    """A random but plausible G-buffer: unit normals, tangents with a
    handedness, uv anywhere, derivatives with footprint ratios up to 1:20."""
    normal = rng.normal(size=(h, w, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    tangent = rng.normal(size=(h, w, 4)).astype(np.float32)
    tangent[..., 3] = np.where(rng.random((h, w)) < 0.5, -1.0, 1.0)
    tangent[:3, :, :3] = 0.0  # the fallback tangent
    _, uv, ddx, ddy = _footprints(12, h * w)
    return dict(
        mask=rng.random((h, w)) < 0.8,
        world=rng.uniform(-2, 2, (h, w, 3)).astype(np.float32),
        normal=normal, tangent=tangent, uv=uv.reshape(h, w, 2),
        color=rng.random((h, w, 3)).astype(np.float32),
        front_facing=rng.random((h, w)) < 0.7,
        draw_id=rng.integers(0, draws, (h, w)).astype(np.int32),
        uv_ddx=ddx.reshape(h, w, 2), uv_ddy=ddy.reshape(h, w, 2),
    )


def _textured_materials(rng, draws=6, textures=5):
    """Rows with every map bound on most draws, one draw untextured, and
    some maps missing."""
    mats = np.zeros((draws, 18), np.float32)
    mats[:, 0:4] = rng.uniform(0.3, 1.0, (draws, 4))
    mats[:, 4:7] = rng.uniform(0.0, 0.5, (draws, 3))
    mats[:, 8] = rng.random(draws)
    mats[:, 9] = rng.uniform(0.0, 1.0, draws)
    mats[:, 10] = rng.uniform(0.2, 1.0, draws)  # occlusion strength
    mats[:, 11] = rng.uniform(0.5, 1.5, draws)  # normal scale
    mats[:, 12:17] = rng.integers(0, textures, (draws, 5))
    mats[0, 12:17] = -1.0
    mats[1, [13, 16]] = -1.0
    mats[:, 17] = [0.0, 0.5, 0.0, 0.3, 0.0, 0.0]
    return mats


def _shade_uniforms(port):
    vals = dict(
        camera_pos=np.array([3.0, 2.0, 4.0], np.float32),
        light_direction=np.array([-0.35, -1.0, -0.25], np.float32)
        / np.float32(np.linalg.norm([-0.35, -1.0, -0.25])),
        light_color=np.full(3, 1.5, np.float32),
        ambient_color=np.full(3, 0.35, np.float32),
        light_space_matrix=np.eye(4, dtype=np.float32),
    )
    if port:
        return shade.ShadeUniforms(**{k: _t(v) for k, v in vals.items()})
    return ref_shade.ShadeUniforms(**{k: jnp.asarray(v)
                                      for k, v in vals.items()})


@pytest.mark.parametrize("max_aniso", [1, 16])
def test_textured_shade_pbr_matches_reference(max_aniso):
    """All five maps through shade_pbr. The fixture's derivatives are
    continuous random values, so no tap count lands on an integer edge
    (checked)."""
    rng = np.random.default_rng(13)
    g = _textured_gbuffer(rng)
    mats = _textured_materials(rng)
    sizes = [(64, 64), (32, 16), (16, 16), (8, 32), (4, 4)]
    maps = []
    for px in _textures(14, sizes):
        h, w = px.shape[:2]
        maps.append(mip_chain(None, TextureData(w, h, px).to_linear_f32()))
    ref_pool, pool = _pools(maps)
    want = ref_shade.shade_pbr(
        ref_shade.GBuffer(**{k: jnp.asarray(v) for k, v in g.items()}),
        jnp.asarray(mats), _shade_uniforms(False), pool=ref_pool,
        clear_color=(0.1, 0.2, 0.3), max_anisotropy=max_aniso,
    )
    gbuf = shade.GBuffer(**{k: _t(v) for k, v in g.items()})
    got = shade.shade_pbr(gbuf, _t(mats), _shade_uniforms(True), pool=pool,
                          clear_color=(0.1, 0.2, 0.3),
                          max_anisotropy=max_aniso)
    for col in range(12, 17):
        idx = _t(mats[:, col].astype(np.int32))[gbuf.draw_id.long()]
        fp = shade.map_footprint(pool, idx, gbuf.uv_ddx, gbuf.uv_ddy,
                                 max_aniso)
        if fp.n_taps is not None:
            ref_taps = _ref_n_taps(ref_pool, jnp.asarray(idx.numpy()),
                                   jnp.asarray(g["uv_ddx"]),
                                   jnp.asarray(g["uv_ddy"]), max_aniso)
            np.testing.assert_array_equal(fp.n_taps.numpy(), ref_taps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=SHADE_ATOL, rtol=0)
    assert np.isfinite(got.numpy()).all()
    # The maps matter: the same G-buffer without the pool differs.
    plain = shade.shade_pbr(gbuf, _t(mats), _shade_uniforms(True),
                            clear_color=(0.1, 0.2, 0.3))
    assert (got - plain).abs().max() > 0.05


def test_textured_golden_renders_without_ash_tpu():
    """The textured golden in a fresh interpreter (other tests of this
    process load jax and ash_tpu) loads neither."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "from ash_tpu_torch.render import golden_scenes\n"
        "img = golden_scenes.scene_textured('cpu').read_back()\n"
        "assert img.shape == (128, 192, 4) and img[..., :3].any()\n"
        "print(sorted(m for m in sys.modules if m == 'jax' or m == 'ash_tpu'"
        " or m.startswith(('jax.', 'ash_tpu.'))))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=repo),
                         cwd=repo, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
