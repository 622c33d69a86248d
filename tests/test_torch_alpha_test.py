"""The alpha test (cutout materials): ash_tpu_torch against ash_tpu on the
CPU.

- `resolve_alpha_test` on a shared two-layer visibility buffer (the
  reference's own raster of 8 cubes with both faces kept), with the
  material cutoffs and with the shadow pass's 0.1 override: exact.
- `pixel_alpha` with a texture pool: atol 1e-6.
- The scenes of tests/test_alpha_test.py (a cutout quad over a backdrop,
  with and without the cutoff), with and without shadows, rendered by both
  renderers from the same recipe: u8 images at PSNR >= 40 dB and equal
  covered pixels; the reference's own checks on the port's image.
- The small textured standard frame (192x128, 64 cubes, five maps, the
  cutout mesh alpha-tested in both passes) and a textured glTF quad: PSNR
  >= 40 dB.
- Which rasters a textured frame runs, and when the alpha-tested shadow map
  is rendered again.
"""

import dataclasses

import numpy as np
import pytest
import torch

import ash_tpu.core as ref_core
import ash_tpu.render as ref_render
import ash_tpu_torch
import ash_tpu_torch.core as port_core
from ash_tpu.core import gltf as ref_gltf
from ash_tpu.ops import binning as ref_bin
from ash_tpu.ops import geometry as ref_geo
from ash_tpu.ops import raster as ref_raster
from ash_tpu.ops import shade as ref_shade
from ash_tpu.ops import texture_sample as ref_ts
from ash_tpu.utils.image import psnr
from ash_tpu_torch.core import gltf
from ash_tpu_torch.ops import geometry, raster, shade, texture_sample
from ash_tpu_torch.render import bench_scene, frame
from test_gltf import build_quad_glb

torch.set_num_threads(1)

MIN_PSNR = 40.0
ALPHA_ATOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _cutout_pixels(size=32, cell=8):
    """A checkerboard alpha: opaque red and fully transparent cells."""
    yy, xx = np.mgrid[0:size, 0:size]
    solid = ((yy // cell + xx // cell) % 2).astype(np.uint8)
    px = np.zeros((size, size, 4), np.uint8)
    px[..., 0] = 255
    px[..., 3] = solid * 255
    return px


def _alpha_pools():
    """Two textures (a cutout checker and a gradient alpha) in both
    packages' pools."""
    yy, xx = np.mgrid[0:16, 0:16]
    grad = np.zeros((16, 16, 4), np.uint8)
    grad[..., 1] = 200
    grad[..., 3] = (xx * 16 + yy).astype(np.uint8)
    maps = []
    for px in (_cutout_pixels(), grad):
        h, w = px.shape[:2]
        data = port_core.TextureData(w, h, px)
        maps.append(port_core.texture.mip_chain(None, data.to_linear_f32()))
    return (ref_ts.build_pool(maps),
            texture_sample.build_pool(maps, device="cpu"))


@pytest.fixture(scope="module")
def two_layers():
    """The reference's two-layer raster of 8 cubes (no culling, so back
    faces form the second layer) with the inputs resolve_alpha_test reads."""
    import jax.numpy as jnp

    rng = np.random.default_rng(31)
    n, w, h = 8, 96, 64
    cube = ref_core.Mesh.create_cube()
    models = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    models[:, :3, 3] = rng.uniform(-1.5, 1.5, (n, 3))
    cam = ref_core.Camera.new([3.0, 2.0, 4.0], [0, 0, 0], w / h)
    vp = (cam.projection_matrix() @ cam.view_matrix()).astype(np.float32)
    vert_uid = np.tile(np.arange(24, dtype=np.int32), n)
    tv = ref_geo.transform_vertices(
        jnp.asarray(models), jnp.asarray(vp),
        jnp.asarray(cube.vertices.position), jnp.asarray(cube.vertices.normal),
        jnp.asarray(cube.vertices.tangent),
        jnp.repeat(jnp.arange(n, dtype=jnp.int32), 24),
        vert_uid=jnp.asarray(vert_uid),
    )
    tri_v = (cube.triangle_indices[None] + 24 * np.arange(n)[:, None, None])
    tri_v = tri_v.reshape(-1, 3).astype(np.int32)
    setup = ref_geo.triangle_setup(tv.clip, jnp.asarray(tri_v),
                                   jnp.ones(12 * n, bool), w, h,
                                   cull_mode="none")
    bins = ref_bin.bin_triangles(setup.bbox, setup.valid, h, w, 16, 32, 128)
    vis = ref_raster.rasterize(setup, bins, h, w, 16, 32, layers=2)
    mats = np.zeros((n, 18), np.float32)
    mats[:, 0:4] = 1.0
    mats[:, 3] = [1.0, 0.9, 1.0, 0.6, 1.0, 1.0, 0.8, 1.0]
    mats[:, 12:17] = -1.0
    mats[:, 12] = [0, 1, -1, 0, 1, 0, -1, 1]  # base texture
    mats[:, 17] = [0.5, 0.3, 0.5, 0.0, 0.7, 0.2, 0.0, 0.5]  # cutoff
    return dict(vis=vis, setup=setup, tri_v=tri_v,
                tri_draw=np.repeat(np.arange(n, dtype=np.int32), 12),
                uv=cube.vertices.uv, vert_uid=vert_uid, mats=mats)


@pytest.mark.parametrize("override", [None, 0.1])
def test_resolve_alpha_test_matches_reference(two_layers, override):
    import jax.numpy as jnp

    f = two_layers
    ref_pool, pool = _alpha_pools()
    want = ref_shade.resolve_alpha_test(
        f["vis"], f["setup"], jnp.asarray(f["tri_v"]),
        jnp.asarray(f["tri_draw"]), jnp.asarray(f["mats"]),
        jnp.asarray(f["uv"]), ref_pool, cutoff_override=override,
        vert_uid=jnp.asarray(f["vert_uid"]),
    )
    vis = raster.VisibilityBuffer(*(None if x is None else _t(x)
                                    for x in f["vis"]))
    got = shade.resolve_alpha_test(
        vis, geometry.TriangleSetup(*(_t(x) for x in f["setup"])),
        _t(f["tri_v"]), _t(f["tri_draw"]), _t(f["mats"]), _t(f["uv"]), pool,
        cutoff_override=override, vert_uid=_t(f["vert_uid"]),
    )
    np.testing.assert_array_equal(got.tri_id.numpy(), np.asarray(want.tri_id))
    np.testing.assert_array_equal(got.depth.numpy(), np.asarray(want.depth))
    fell = (got.tri_id != vis.tri_id).sum()
    assert int(fell) > 50  # the cutouts fall through to the second layer
    assert got.depth2 is None


def test_pixel_alpha_with_pool_matches_reference():
    import jax.numpy as jnp

    rng = np.random.default_rng(32)
    h, w, draws = 24, 40, 6
    g = dict(
        mask=rng.random((h, w)) < 0.8,
        world=rng.random((h, w, 3)).astype(np.float32),
        normal=rng.random((h, w, 3)).astype(np.float32),
        tangent=rng.random((h, w, 4)).astype(np.float32),
        uv=rng.uniform(-1, 2, (h, w, 2)).astype(np.float32),
        color=rng.random((h, w, 3)).astype(np.float32),
        front_facing=rng.random((h, w)) < 0.5,
        draw_id=rng.integers(0, draws, (h, w)).astype(np.int32),
        uv_ddx=rng.random((h, w, 2)).astype(np.float32),
        uv_ddy=rng.random((h, w, 2)).astype(np.float32),
    )
    mats = np.zeros((draws, 18), np.float32)
    mats[:, 3] = [1.0, 0.5, 0.8, 1.0, 0.7, 0.3]
    mats[:, 12] = [0, 1, -1, 1, 0, 0]
    mats[:, 17] = [0.5, 0.0, 0.3, 0.4, 0.0, 0.2]
    ref_pool, pool = _alpha_pools()
    want = ref_shade.pixel_alpha(
        ref_shade.GBuffer(**{k: jnp.asarray(v) for k, v in g.items()}),
        jnp.asarray(mats), ref_pool)
    got = shade.pixel_alpha(shade.GBuffer(**{k: _t(v) for k, v in g.items()}),
                            _t(mats), pool)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ALPHA_ATOL, rtol=0)
    a = got.numpy()
    assert (a[~g["mask"]] == 0.0).all()
    assert ((a > 0) & (a < 1)).any() and (a[g["mask"]] == 0).any()


# -- frames through both renderers -----------------------------------------

def _renderer(port, size, **cfg):
    if port:
        return ash_tpu_torch.Renderer(
            ash_tpu_torch.HeadlessSurface(*size),
            ash_tpu_torch.RendererConfig(**cfg), device="cpu")
    return ref_render.Renderer(ref_render.HeadlessSurface(*size),
                               ref_render.RendererConfig(use_pallas=False,
                                                         **cfg))


def _frame(r, cam):
    out = r.render_frame(cam.view_matrix(), cam.projection_matrix(),
                         cam.position)
    return np.array(r.read_back()), out


def _cutout_scene(port, cutoff, shadows):
    """tests/test_alpha_test.py's scene: a cutout quad over a blue
    backdrop, the camera above looking down."""
    core = port_core if port else ref_core
    cmd = ash_tpu_torch.RenderCommand if port else ref_render.RenderCommand
    shadow_cfg = (dict(shadow_resolution=128, shadow_tile=64,
                       shadow_max_tris_per_tile=32) if shadows
                  else dict(shadows_enabled=False))
    r = _renderer(port, (96, 96), tile_h=8, tile_w=32, max_tris_per_tile=32,
                  **shadow_cfg)
    quad = core.Mesh.create_plane("cutout", size=1.5)
    quad.texture_data = core.TextureData(32, 32, _cutout_pixels())
    r.register_mesh_handle(0, quad)
    r.register_mesh_handle(1, core.Mesh.create_plane("backdrop", size=4.0))
    r.register_material_handle(
        1, core.Material(color=(1, 0, 0, 1),
                         alpha_cutoff=0.5 if cutoff else 0.0))
    r.register_material_handle(2, core.Material(color=(0.0, 0.0, 1.0, 1.0)))
    front = np.eye(4, dtype=np.float32)
    front[:3, 3] = [0, 1.0, 0]
    r.submit_render_commands([
        cmd(mesh=0, transform=front, material=1),
        cmd(mesh=1, transform=np.eye(4, dtype=np.float32), material=2),
    ])
    if shadows:
        r.shadow_feature.set_scene_bounds([0, 0, 0], 3.0)
    return _frame(r, core.Camera.new([0, 4.0, 0.01], [0, 0, 0], 1.0))


@pytest.mark.parametrize("shadows", [False, True])
@pytest.mark.parametrize("cutoff", [True, False])
def test_cutout_scene_matches_reference(cutoff, shadows):
    image, out = _cutout_scene(True, cutoff, shadows)
    ref_image, ref_out = _cutout_scene(False, cutoff, shadows)
    value = psnr(image, ref_image)
    assert value >= MIN_PSNR, f"PSNR {value:.1f} dB < {MIN_PSNR} dB"
    assert int(out.covered_pixels) == int(ref_out.covered_pixels)
    # The reference's own checks (tests/test_alpha_test.py).
    center = image[20:76, 20:76]
    reds = (center[..., 0] > 100) & (center[..., 2] < 100)
    blues = (center[..., 2] > 100) & (center[..., 0] < 100)
    if cutoff:
        assert reds.mean() > 0.15 and blues.mean() > 0.15
    else:
        assert (image[30:66, 30:66, 2] > 100).mean() < 0.02


def test_cutouts_cast_no_shadow():
    """The shadow pass's alpha test: with the cutoff the backdrop under the
    quad's holes is lit, without it the whole quad shades it."""
    lit, _ = _cutout_scene(True, True, True)
    shaded, _ = _cutout_scene(True, False, True)
    unshadowed, _ = _cutout_scene(True, True, False)
    assert psnr(lit, shaded) < MIN_PSNR
    assert psnr(lit, unshadowed) < MIN_PSNR


def _textured_bench(port, n=64):
    draws, extent = bench_scene.bench_draws(n, textured=True)
    r = _renderer(port, (192, 128), **bench_scene.bench_config(128))
    cmd = ash_tpu_torch.RenderCommand if port else ref_render.RenderCommand
    core = port_core if port else ref_core
    meshes = bench_scene.bench_meshes(core)
    for handle, mesh in enumerate(meshes):
        r.register_mesh_handle(handle, mesh)
    commands = []
    for i, (m, mat) in enumerate(draws):
        r.register_material_handle(
            i + 1, core.Material(**dataclasses.asdict(mat)))
        commands.append(cmd(mesh=i % len(meshes), transform=m,
                            material=i + 1))
    r.submit_render_commands(commands)
    r.shadow_feature.set_scene_bounds([0, 0, 0], extent)
    return r, bench_scene.bench_camera(192, 128, extent)


def test_textured_bench_recipe():
    """Four meshes with five 256x256 maps each; the cutout mesh's draws
    (i % 4 == 1) alone carry alpha_cutoff 0.5; transforms and the seed-7
    materials are the standard frame's."""
    maps = bench_scene.bench_texture_maps()
    assert len(maps) == 4 and all(len(m) == 5 for m in maps)
    assert all(px.shape == (256, 256, 4) and px.dtype == np.uint8
               for m in maps for px in m)
    alpha = maps[bench_scene.CUTOUT_MESH][0][..., 3]
    assert set(np.unique(alpha)) == {0, 255}
    assert all((m[0][..., 3] == 255).all() for i, m in enumerate(maps)
               if i != bench_scene.CUTOUT_MESH)
    plain, _ = bench_scene.bench_draws(64)
    tex, _ = bench_scene.bench_draws(64, textured=True)
    for i, ((m0, mat0), (m1, mat1)) in enumerate(zip(plain, tex)):
        np.testing.assert_array_equal(m0, m1)
        assert mat1.alpha_cutoff == (0.5 if i % 4 == 1 else 0.0)
        assert dataclasses.replace(mat1, alpha_cutoff=0.0) == mat0


def test_small_textured_bench_matches_reference():
    r, cam = _textured_bench(True)
    rr, rcam = _textured_bench(False)
    image, got = _frame(r, cam)
    ref_image, ref = _frame(rr, rcam)
    value = psnr(image, ref_image)
    assert value >= MIN_PSNR, f"PSNR {value:.1f} dB < {MIN_PSNR} dB"
    assert int(got.binning_overflow) == int(ref.binning_overflow)
    assert int(got.shadow_overflow) == int(ref.shadow_overflow)
    assert int(got.visible_draws) == int(ref.visible_draws)
    covered, ref_covered = int(got.covered_pixels), int(ref.covered_pixels)
    assert covered > 0
    assert abs(covered - ref_covered) <= 0.001 * ref_covered


def test_textured_gltf_quad_matches_reference():
    """A glTF quad with a base-colour texture (the 03_model_loading
    config), through both renderers."""
    images = []
    for port in (True, False):
        core = port_core if port else ref_core
        mesh = (gltf if port else ref_gltf).load_glb_mesh(build_quad_glb())
        r = _renderer(port, (64, 64), tile_h=8, tile_w=32,
                      max_tris_per_tile=16, shadows_enabled=False)
        r.set_mesh(mesh)
        images.append(_frame(r, core.Camera.new([0, 0, 3], [0, 0, 0], 1.0))[0])
        assert mesh.texture_index == 0
    value = psnr(*images)
    assert value >= MIN_PSNR, f"PSNR {value:.1f} dB < {MIN_PSNR} dB"
    c = images[0][32, 32]
    assert c[0] > 60 and c[0] > c[2] * 1.5, c


@pytest.fixture
def raster_calls(monkeypatch):
    """Record the frame's raster calls as (rows, layers)."""
    calls = []
    real = frame.rasterize

    def recording(setup, bins, height, width, *args, **kwargs):
        calls.append((height, kwargs.get("layers", 1)))
        return real(setup, bins, height, width, *args, **kwargs)

    monkeypatch.setattr(frame, "rasterize", recording)
    return calls


def test_textured_frame_peels_two_layers_in_both_passes(raster_calls):
    r, _, cam, _ = bench_scene.build_bench_renderer(192, 128, 27, "cpu",
                                                    textured=True)
    first = _frame(r, cam)[0]
    assert raster_calls == [(256, 2), (128, 2)]  # shadow, then main
    assert _frame(r, cam)[0].tobytes() == first.tobytes()
    assert raster_calls[2:] == [(128, 2)]  # the cached shadow map
    # A restream changes what the shadow pass samples: it renders again.
    r.request_texture_residency(0, 1)
    _frame(r, cam)
    assert raster_calls[3:] == [(256, 2), (128, 2)]


def test_textures_without_a_cutoff_keep_one_layer(raster_calls):
    surface = ash_tpu_torch.HeadlessSurface(64, 48)
    r = ash_tpu_torch.Renderer(
        surface, ash_tpu_torch.RendererConfig(
            tile_h=8, tile_w=32, max_tris_per_tile=32, shadow_resolution=128,
            shadow_tile=64, shadow_max_tris_per_tile=32), device="cpu")
    mesh = port_core.Mesh.create_named_cube("tex")
    mesh.texture_data = port_core.TextureData(32, 32, _cutout_pixels())
    r.set_mesh(mesh)
    cam = port_core.Camera.new([3.0, 2.2, 4.0], [0, 0, 0], 64 / 48)
    holes = _frame(r, cam)[0]
    assert raster_calls == [(128, 1), (48, 1)]
    # A cutoff on the single mesh's material alpha-tests the next frame:
    # both passes peel, and the shadow map is rendered again.
    r.material_mut().alpha_cutoff = 0.5
    cut = _frame(r, cam)[0]
    assert raster_calls[2:] == [(128, 2), (48, 2)]
    assert psnr(cut, holes) < MIN_PSNR
    # Another material edit under the alpha test renders the map again.
    r.material_mut().color = (0.5, 0.9, 0.5, 1.0)
    _frame(r, cam)
    assert raster_calls[4:] == [(128, 2), (48, 2)]
    _frame(r, cam)
    assert raster_calls[6:] == [(48, 2)]
