"""Screen bands (A18) on ash_tpu_torch, on the CPU.

The port's make_sharded_frame over a mesh of `["cpu"] * n` (one process,
one device repeated) against the port's own single-device frame on the same
inputs, in the cases of tests/test_parallel.py: shadows, no shadows, a
height that does not divide, textures with Forward+ lights and the HDR post
chain, TAA with motion vectors, CSM with the alpha test, frustum and Hi-Z
culling with LOD over two frames, LOD at a far camera, edge MSAA, and TAAU
at render_scale 0.5 and 0.3; at n = 2, 4 and 8. A LOD scene's shadow pass
runs in bands (a raster of S/n rows a band, none of S) and gives the single
frame's map, also in the (2 x 2) farm. Then the band helpers against
ash_tpu's over a grid of configs, the public surface against the
reference's, and make_sharded_frame on the rich and the LOD examples
against ash_tpu's own over JAX's 8 virtual CPU devices.

Tolerances:

- inside the port: the u8 image within 1 LSB of the single frame (the
  reference tests' own bar, tests/test_parallel.py:33-47; measured: equal
  bit for bit), the scalars equal, the shadow map, depth and history bit
  for bit;
- the band helpers: equal integers;
- against ash_tpu (the port's frame is eager torch, the reference's one
  XLA program on the CPU that contracts a*b + c into FMA): the u8 image
  within 1 LSB, the scalars equal, the gathered shadow map within the
  raster tests' depth tolerance (1e-5, tests/test_torch_raster.py) but
  for at most 0.5% of its texels (-s prints the measured numbers).
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ash_tpu.parallel as ref_parallel
import ash_tpu_torch.parallel as parallel
from ash_tpu.render import frame as ref_frame
from ash_tpu_torch.core import Camera
from ash_tpu_torch.ops.taa import TaaParams
from ash_tpu_torch.parallel import make_sharded_frame, render_mesh
from ash_tpu_torch.render import bench_scene, frame
from ash_tpu_torch.render.frame import FrameConfig, PostParams

torch.set_num_threads(1)

DEPTH_ATOL = 1e-5
MAX_FLIPS = 0.005


@pytest.fixture(scope="module")
def example():
    return bench_scene.example_scene(n_cubes=6, device="cpu")


@pytest.fixture(scope="module")
def rich_example():
    return bench_scene.example_scene(n_cubes=6, rich=True, device="cpu")


@pytest.fixture(scope="module")
def lod_example():
    return bench_scene.example_scene(n_cubes=6, rich=True, lod=True,
                                     device="cpu")


def mesh(n):
    return render_mesh(devices=["cpu"] * n)


def _config(h=128, w=128, shadows=True, **kw):
    return FrameConfig(
        width=w, height=h, tile_h=8, tile_w=128, max_tris_per_tile=32,
        shadow_enabled=shadows, shadow_resolution=128, shadow_tile=16,
        shadow_max_tris_per_tile=32, **kw,
    )


def single(cfg, scene, uni, pool=None, post=None, taa=None, history=None,
           lights=None, prev_depth=None):
    """The port's single-device frame, its shadow map rendered here as the
    renderer renders it."""
    shadow = None
    if cfg.shadow_enabled and not cfg.lod_enabled:
        shadow = frame.shadow_program(cfg, scene, uni.models,
                                      uni.light_space_matrix, pool,
                                      uni.cascade_matrices)
    return frame.render_frame_program(cfg, scene, uni, shadow, pool, lights,
                                      post, taa, history, prev_depth)


def assert_images_match(got, want):
    d = np.abs(np.asarray(got).astype(np.int16)
               - np.asarray(want).astype(np.int16))
    print(f"measured: largest u8 difference {d.max()}, "
          f"{int((d.max(-1) > 0).sum())} pixels differ")
    assert d.max() <= 1, (f"sharded image diverges: max diff {d.max()}, "
                          f"{int((d > 1).sum())} values beyond 1 LSB")


def assert_same_frame(got, want):
    assert got.image.shape == want.image.shape
    assert_images_match(got.image, want.image)
    for f in ("covered_pixels", "binning_overflow", "shadow_overflow",
              "visible_draws", "msaa_edge_overflow"):
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if g is not None:
            assert int(g) == int(w), f"{f}: {int(g)} != {int(w)}"
    for f in ("shadow_map", "history", "depth"):
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if g is not None:
            assert torch.equal(g, w), f"{f} differs"


def _taa(blend=0.9):
    return TaaParams(blend_factor=np.float32(blend),
                     color_clamp=np.float32(1.0),
                     velocity_rejection=np.float32(1.0),
                     jitter=np.zeros(2, np.float32),
                     prev_jitter=np.zeros(2, np.float32))


def _moving(uni):
    """Last frame's matrices: the same models, a slightly moved camera."""
    shift = torch.eye(4)
    shift[0, 3] = 0.05
    return uni._replace(prev_view_proj=uni.view_proj @ shift,
                        prev_models=uni.models)


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_matches_single_device(example, n):
    scene, uni = example
    cfg = _config()
    got = make_sharded_frame(cfg, mesh(n))(scene, uni)
    assert_same_frame(got, single(cfg, scene, uni))
    assert int(got.covered_pixels) > 0


def test_sharded_no_shadows(example):
    scene, uni = example
    cfg = _config(shadows=False)
    got = make_sharded_frame(cfg, mesh(4))(scene, uni)
    assert got.shadow_map is None and got.shadow_overflow is None
    assert_same_frame(got, single(cfg, scene, uni))


def test_sharded_nondivisible_height(example):
    """100 rows over 8 bands of 16: padded to 128, then cropped."""
    scene, uni = example
    cfg = _config(h=100, shadows=False)
    assert frame.band_rows(cfg, 8) == 16
    got = make_sharded_frame(cfg, mesh(8))(scene, uni)
    assert got.image.shape == (100, 128, 4) and got.depth.shape == (100, 128)
    assert_same_frame(got, single(cfg, scene, uni))


def test_sharded_full_features_matches_single(rich_example):
    """Textures, Forward+ point lights, the HDR post chain with bloom."""
    scene, uni, extras = rich_example
    cfg = _config(textured=True, lights_enabled=True, post_enabled=True,
                  bloom_mips=3, reinhard=False)
    post = PostParams.default()
    got = make_sharded_frame(cfg, mesh(8))(
        scene, uni, pool=extras["pool"], post=post, lights=extras["lights"])
    assert_same_frame(got, single(cfg, scene, uni, extras["pool"], post,
                                  lights=extras["lights"]))


def test_sharded_taa_velocity_matches_single(rich_example):
    """Velocity interpolated per band; the resolve runs on the assembled
    frame."""
    scene, uni, _ = rich_example
    cfg = _config(shadows=False, post_enabled=True, taa_enabled=True,
                  bloom_enabled=False, reinhard=False)
    uni = _moving(uni)
    history = torch.full((cfg.height, cfg.width, 3), 0.25)
    post = PostParams.default()
    got = make_sharded_frame(cfg, mesh(8))(scene, uni, post=post,
                                           taa_params=_taa(),
                                           history=history)
    want = single(cfg, scene, uni, post=post, taa=_taa(), history=history)
    assert got.history is not None
    assert_same_frame(got, want)


def test_sharded_csm_alpha(rich_example):
    """Two cascades and the alpha test through the band path: each cascade
    renders in bands, one B1 call a cascade a band."""
    scene, uni, extras = rich_example
    cfg = _config(textured=True, alpha_test=True, shadow_cascades=2)
    lsm = uni.light_space_matrix
    uni = uni._replace(
        cascade_matrices=torch.stack(
            [lsm, lsm @ torch.diag(torch.tensor([0.5, 0.5, 1.0, 1.0]))]),
        cascade_splits=torch.tensor([5.0, 50.0, 0.0, 0.0]))
    got = make_sharded_frame(cfg, mesh(8))(scene, uni, pool=extras["pool"])
    assert got.shadow_map.shape == (2, 128, 128)
    assert_same_frame(got, single(cfg, scene, uni, extras["pool"]))


def test_sharded_culling_lod_matches_single(lod_example):
    """Frustum and Hi-Z culling with LOD over two frames: frame 1's depth is
    frame 2's previous depth, so the Hi-Z hand-off crosses the bands."""
    scene, uni, extras = lod_example
    cfg = _config(textured=True, lights_enabled=True, frustum_culling=True,
                  occlusion_culling=True, lod_enabled=True)
    pool, lights = extras["pool"], extras["lights"]
    far = torch.ones((cfg.height, cfg.width))
    fn = make_sharded_frame(cfg, mesh(8))
    got1 = fn(scene, uni, pool=pool, lights=lights, prev_depth=far)
    want1 = single(cfg, scene, uni, pool, lights=lights, prev_depth=far)
    assert_same_frame(got1, want1)
    got2 = fn(scene, uni, pool=pool, lights=lights, prev_depth=got1.depth)
    want2 = single(cfg, scene, uni, pool, lights=lights,
                   prev_depth=want1.depth)
    assert_same_frame(got2, want2)
    assert int(got2.visible_draws) > 0


def test_sharded_lod_selects_coarser_level(lod_example):
    """A far camera selects coarser levels in every band: the LOD frame
    differs from the LOD-off frame and equals its single-device frame."""
    scene, uni, _ = lod_example
    cam = Camera.new([12.0, 9.0, 16.0], [0, 0, 0], 1.0)
    view, proj = cam.view_matrix(), cam.projection_matrix()
    uni = uni._replace(
        view_proj=torch.from_numpy((proj @ view).astype(np.float32)),
        view=torch.from_numpy(view.astype(np.float32)),
        projection=torch.from_numpy(proj.astype(np.float32)),
        camera_pos=torch.from_numpy(np.asarray(cam.position, np.float32)))
    cfg_on = _config(lod_enabled=True)
    on = single(cfg_on, scene, uni)
    off = single(_config(), scene, uni)
    assert_same_frame(make_sharded_frame(cfg_on, mesh(8))(scene, uni), on)
    assert not torch.equal(on.image, off.image)


def _shadow_rasters(monkeypatch, cfg):
    """Spy on the frame's raster: the row count of every shadow-pass call
    (the shadow tiles' width tells them from the main pass's)."""
    assert cfg.shadow_tile != cfg.tile_w
    rows = []
    real = frame.rasterize

    def spy(setup, bins, height, width, tile_h, tile_w, *a, **kw):
        if tile_w == cfg.shadow_tile:
            rows.append(height)
        return real(setup, bins, height, width, tile_h, tile_w, *a, **kw)

    monkeypatch.setattr(frame, "rasterize", spy)
    return rows


def test_sharded_lod_shadow_renders_in_bands(lod_example, monkeypatch):
    """A LOD frame over 4 bands renders the shadow map only in bands: one
    raster of S/4 rows a band and none of S, where the single frame renders
    the whole map once."""
    scene, uni, _ = lod_example
    cfg = _config(lod_enabled=True)
    s = cfg.shadow_resolution
    rows = _shadow_rasters(monkeypatch, cfg)
    make_sharded_frame(cfg, mesh(4))(scene, uni)
    assert rows == [s // 4] * 4
    rows.clear()
    single(cfg, scene, uni)
    assert rows == [s]


@pytest.mark.parametrize("case", ["lod", "csm_alpha", "culling"])
def test_sharded_lod_banded_shadow_matches_single(lod_example, case):
    """The banded LOD shadow pass gives the single frame's image, gathered
    map and scalars bit for bit: the plain LOD frame; two cascades with the
    alpha test (a two-layer peel a cascade a band); frustum and Hi-Z
    culling with textures and lights."""
    scene, uni, extras = lod_example
    pool, lights, prev_depth = None, None, None
    if case == "lod":
        cfg = _config(lod_enabled=True)
    elif case == "csm_alpha":
        cfg = _config(lod_enabled=True, textured=True, alpha_test=True,
                      shadow_cascades=2)
        lsm = uni.light_space_matrix
        uni = uni._replace(
            cascade_matrices=torch.stack(
                [lsm, lsm @ torch.diag(torch.tensor([0.5, 0.5, 1.0, 1.0]))]),
            cascade_splits=torch.tensor([5.0, 50.0, 0.0, 0.0]))
        pool = extras["pool"]
    else:
        cfg = _config(lod_enabled=True, textured=True, lights_enabled=True,
                      frustum_culling=True, occlusion_culling=True)
        pool, lights = extras["pool"], extras["lights"]
        prev_depth = torch.ones((cfg.height, cfg.width))
    got = make_sharded_frame(cfg, mesh(4))(scene, uni, pool=pool,
                                           lights=lights,
                                           prev_depth=prev_depth)
    want = single(cfg, scene, uni, pool, lights=lights,
                  prev_depth=prev_depth)
    assert_same_frame(got, want)
    assert torch.equal(got.image, want.image)
    assert int(got.covered_pixels) > 0


def test_banded_farm_lod_matches_sequential(lod_example):
    """The (2 x 2) farm on the LOD example: each frame's bands render their
    rows of the map under the frame's own level mask, and each frame equals
    the frame rendered alone."""
    from ash_tpu_torch.parallel import (batch_uniforms,
                                        make_frame_parallel_banded)

    scene, uni, _ = lod_example
    cfg = dataclasses.replace(_config(lod_enabled=True),
                              max_tris_per_tile=128,
                              shadow_max_tris_per_tile=128)
    # A nearer camera selects finer levels: frame 1's map has more
    # triangles than frame 0's.
    near = Camera.new([4.0, 3.0, 5.0], [0, 0, 0], 1.0)
    view, proj = near.view_matrix(), near.projection_matrix()
    unis = [uni, uni._replace(
        view_proj=torch.from_numpy((proj @ view).astype(np.float32)),
        view=torch.from_numpy(view.astype(np.float32)),
        projection=torch.from_numpy(proj.astype(np.float32)),
        camera_pos=torch.from_numpy(np.asarray(near.position, np.float32)))]
    m = render_mesh(devices=[["cpu"] * 2] * 2, axis=("fp", "sp"))
    out = make_frame_parallel_banded(cfg, m)(scene, batch_uniforms(unis))
    for i, u in enumerate(unis):
        want = single(cfg, scene, u)
        assert torch.equal(out.image[i], want.image), f"frame {i}"
        assert torch.equal(out.shadow_map[i], want.shadow_map), f"frame {i}"
        assert int(out.covered_pixels[i]) == int(want.covered_pixels)
        assert int(out.shadow_overflow[i]) == int(want.shadow_overflow) == 0
    assert not torch.equal(out.shadow_map[0], out.shadow_map[1])


def test_sharded_edge_msaa_matches_single(example):
    """Edge MSAA: a worklist per band, the overflow summed."""
    scene, uni = example
    cfg = _config(shadows=False, ssaa_x=2, ssaa_y=2, msaa_resolve="edge")
    got = make_sharded_frame(cfg, mesh(4))(scene, uni)
    want = single(cfg, scene, uni)
    assert_same_frame(got, want)
    assert int(got.msaa_edge_overflow) == 0


@pytest.mark.parametrize("scale", [0.5, 0.3])
def test_sharded_render_scale_taau_matches_single(rich_example, scale):
    """TAAU: the bands split the internal rows (0.3: 38 rows padded to 8
    bands of 8); the upsample and the TAA blend run on the assembled
    frame."""
    scene, uni, _ = rich_example
    cfg = _config(shadows=False, post_enabled=True, taa_enabled=True,
                  bloom_enabled=False, reinhard=False, render_scale=scale)
    uni = _moving(uni)
    history = torch.full((cfg.height, cfg.width, 3), 0.25)
    post = PostParams.default()
    got = make_sharded_frame(cfg, mesh(8))(scene, uni, post=post,
                                           taa_params=_taa(),
                                           history=history)
    assert got.image.shape == (cfg.height, cfg.width, 4)
    assert_same_frame(got, single(cfg, scene, uni, post=post, taa=_taa(),
                                  history=history))


def test_example05_sharded_equals_single():
    """examples/05_multichip.py on the port: 12 cubes, 512 x max(16 n, 384),
    the shadow map in 16-row tiles per band, over 8 bands."""
    cfg = bench_scene.example05_config(8)
    scene, uni = bench_scene.example_scene(n_cubes=12, device="cpu")
    got = make_sharded_frame(cfg, mesh(8))(scene, uni)
    assert got.image.shape == (384, 512, 4)
    assert_same_frame(got, single(cfg, scene, uni))


def test_shadow_bands_must_divide(example):
    """The reference's refusal: a map that does not split into n bands of
    whole shadow-tile rows (128 rows, 32-row tiles, 8 bands)."""
    scene, uni = example
    cfg = dataclasses.replace(_config(), shadow_tile=128)
    with pytest.raises(ValueError, match="must divide into 8 bands"):
        make_sharded_frame(cfg, mesh(8))(scene, uni)
    # A LOD scene's map is banded too, so it is refused the same way.
    lod_scene, lod_uni = bench_scene.example_scene(n_cubes=2, lod=True,
                                                   device="cpu")
    lod_cfg = dataclasses.replace(cfg, lod_enabled=True)
    with pytest.raises(ValueError, match="must divide into 8 bands"):
        make_sharded_frame(lod_cfg, mesh(8))(lod_scene, lod_uni)


def test_band_helpers_match_reference():
    """_band_unit, band_rows and band_render_rows against ash_tpu's, integer
    for integer, over tile heights, light tiles, SSAA rows, heights, TAAU
    scales and band counts."""
    checked = 0
    for tile_h in (8, 16, 24, 64):
        for lights, lt in ((False, 16), (True, 16), (True, 24)):
            for sy in (1, 2):
                for h in (64, 100, 1080):
                    for scale in (1.0, 0.5, 0.3):
                        if scale != 1.0 and sy != 1:
                            continue
                        kw = dict(width=96, height=h, tile_h=tile_h,
                                  lights_enabled=lights, light_tile_size=lt,
                                  ssaa_y=sy, render_scale=scale)
                        pc = FrameConfig(**kw)
                        rc = ref_frame.FrameConfig(**kw)
                        assert frame._band_unit(pc) == ref_frame._band_unit(rc)
                        for n in (1, 2, 3, 4, 8):
                            assert (frame.band_rows(pc, n)
                                    == ref_frame.band_rows(rc, n)), kw
                            assert (frame.band_render_rows(pc, n)
                                    == ref_frame.band_render_rows(rc, n)), kw
                            checked += 1
    assert checked > 300


def test_parallel_surface_matches_reference():
    """ash_tpu_torch.parallel exports the reference's names with the
    reference's parameters (render_mesh adds `devices` after them), and the
    functions they return take the reference's arguments."""
    assert parallel.__all__ == ref_parallel.__all__

    def params(fn):
        return [(p.name, p.default) for p in
                inspect.signature(fn).parameters.values()]

    for name in ref_parallel.__all__:
        want = params(getattr(ref_parallel, name))
        got = params(getattr(parallel, name))
        assert got[:len(want)] == want, name
        assert len(got) == len(want) + (name == "render_mesh"), name
    assert params(parallel.render_mesh)[-1] == ("devices", None)
    cfg = _config()
    ref_cfg = ref_frame.FrameConfig(**dataclasses.asdict(cfg))
    ref_mesh = ref_parallel.render_mesh(2)
    for name, m in (("make_sharded_frame", mesh(2)),
                    ("make_frame_parallel", render_mesh(devices=["cpu"] * 2,
                                                        axis="fp"))):
        got = getattr(parallel, name)(cfg, m)
        want = getattr(ref_parallel, name)(
            ref_cfg, jax.sharding.Mesh(ref_mesh.devices, m.axis_names))
        assert params(got) == params(want), name


def test_render_mesh_devices():
    """A named mesh of torch devices; an explicit list may repeat one. With
    no list it takes the CUDA devices and raises where there are none, as
    a CUDA device named in a list does."""
    m = render_mesh(4, devices=["cpu"] * 8)
    assert m.shape == {"sp": 4}
    assert all(d == torch.device("cpu") for d in m.devices)
    m2 = render_mesh(devices=[["cpu"] * 2] * 3, axis=("fp", "sp"))
    assert m2.shape == {"fp": 3, "sp": 2}
    with pytest.raises(ValueError):
        render_mesh(3, devices=["cpu"] * 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            render_mesh()
        with pytest.raises(RuntimeError, match="cuda"):
            render_mesh(devices=["cuda:0"] * 4)


@pytest.fixture(scope="module")
def rich_reference():
    """ash_tpu's sharded rich frame over JAX's 8 virtual CPU devices, and
    the config it ran."""
    import __graft_entry__ as ge

    scene, uni, extras = ge._example_scene(n_cubes=6, rich=True)
    kw = dict(textured=True, lights_enabled=True, post_enabled=True,
              bloom_mips=3, reinhard=False)
    ref_cfg = ref_frame.FrameConfig(**dataclasses.asdict(_config(**kw)))
    out = ref_parallel.make_sharded_frame(ref_cfg, ref_parallel.render_mesh(8))(
        scene, jax.tree.map(jnp.asarray, uni), pool=extras["pool"],
        post=ref_frame.PostParams.default(),
        lights=jnp.asarray(extras["lights"]))
    return kw, jax.tree.map(np.asarray, out)


def test_sharded_rich_matches_ash_tpu(rich_example, rich_reference):
    """make_sharded_frame against ash_tpu's on the rich example (textures,
    lights, bloom, shadows) over 8 bands, on the same inputs: the port's
    example scene equals __graft_entry__._example_scene's array for
    array."""
    import __graft_entry__ as ge

    scene, uni, extras = rich_example
    rscene, runi, rextras = ge._example_scene(n_cubes=6, rich=True)
    for f in scene._fields:
        np.testing.assert_array_equal(getattr(scene, f).numpy(),
                                      np.asarray(getattr(rscene, f)), f)
    for f in uni._fields:
        if getattr(runi, f) is not None:
            np.testing.assert_array_equal(
                getattr(uni, f).numpy(),
                np.asarray(getattr(runi, f), np.float32), f)
    np.testing.assert_array_equal(extras["lights"].numpy(), rextras["lights"])
    kw, ref = rich_reference
    got = make_sharded_frame(_config(**kw), mesh(8))(
        scene, uni, pool=extras["pool"], post=PostParams.default(),
        lights=extras["lights"])
    assert_images_match(got.image.numpy(), ref.image)
    for f in ("covered_pixels", "binning_overflow", "shadow_overflow"):
        assert int(getattr(got, f)) == int(getattr(ref, f)), f
    err = np.abs(got.shadow_map.numpy() - ref.shadow_map)
    flips = float((err > DEPTH_ATOL).mean())
    print(f"measured shadow map against ash_tpu: max abs err {err.max():.3e}, "
          f"{100 * flips:.3f}% of texels over {DEPTH_ATOL}")
    assert flips <= MAX_FLIPS


def test_sharded_lod_matches_ash_tpu(lod_example):
    """make_sharded_frame on the LOD example (textures, lights, bloom,
    shadows, the level mask in every pass) over 8 bands against ash_tpu's
    over JAX's 8 virtual CPU devices, whose bands also render their rows of
    the map under the mask. The tolerances of the rich case above: the u8
    image within 1 LSB, the scalars equal, the gathered map within 1e-5 but
    for at most 0.5% of its texels. The sphere's small triangles amplify
    the reference's FMA contraction in the setup (ROADMAP.md C, PR 7), so
    more texels pass 1e-5 than in the rich case (measured 0.165%, and
    0.122% over the rich case's largest error, 1.61e-5); the port's
    banded map is its single frame's bit for bit (the tests above)."""
    import __graft_entry__ as ge

    scene, uni, extras = lod_example
    rscene, runi, rextras = ge._example_scene(n_cubes=6, rich=True, lod=True)
    for f in scene._fields:
        np.testing.assert_array_equal(getattr(scene, f).numpy(),
                                      np.asarray(getattr(rscene, f)), f)
    kw = dict(textured=True, lights_enabled=True, post_enabled=True,
              bloom_mips=3, reinhard=False, lod_enabled=True)
    ref_cfg = ref_frame.FrameConfig(**dataclasses.asdict(_config(**kw)))
    ref = ref_parallel.make_sharded_frame(ref_cfg, ref_parallel.render_mesh(8))(
        rscene, jax.tree.map(jnp.asarray, runi), pool=rextras["pool"],
        post=ref_frame.PostParams.default(),
        lights=jnp.asarray(rextras["lights"]))
    ref = jax.tree.map(np.asarray, ref)
    got = make_sharded_frame(_config(**kw), mesh(8))(
        scene, uni, pool=extras["pool"], post=PostParams.default(),
        lights=extras["lights"])
    assert_images_match(got.image.numpy(), ref.image)
    for f in ("covered_pixels", "binning_overflow", "shadow_overflow"):
        assert int(getattr(got, f)) == int(getattr(ref, f)), f
    err = np.abs(got.shadow_map.numpy() - ref.shadow_map)
    flips = float((err > DEPTH_ATOL).mean())
    print(f"measured LOD shadow map against ash_tpu: max abs err "
          f"{err.max():.3e}, {100 * flips:.3f}% of texels over {DEPTH_ATOL}, "
          f"{100 * float((err > 1.61e-5).mean()):.3f}% over 1.61e-5")
    assert flips <= MAX_FLIPS
