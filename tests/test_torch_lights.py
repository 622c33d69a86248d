"""Forward+ lights: ash_tpu_torch's light culling, light packing, the
shading pass's light loop and the lit frame against ash_tpu on the CPU.

- `cull_lights`: masks, indices and counts exact, both sides fed the same
  inverse projection (f32, from numpy); full frame and a band of tile rows,
  a frame size that is not a multiple of the tile, and a per-tile cap that
  truncates. The tile planes it builds: atol 1e-5 relative to their size.
- `pack_tile_buffer`: equal. The GpuLight packing: bit for bit.
- `shade_pbr`'s light loop: atol 1e-5.
- The small lit standard frame (192x128, 64 cubes, bench.py's 32 lights)
  and point and spot lights over a cube, through both renderers: PSNR >= 40
  dB. The golden `glass_and_lights` is held to its PNG by
  tests/test_torch_frame.py::test_golden_psnr.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ash_tpu.core as ref_core
import ash_tpu.render as ref_render
import ash_tpu_torch
import ash_tpu_torch.core as port_core
from ash_tpu.ops import light_cull as ref_lc
from ash_tpu.ops import shade as ref_shade
from ash_tpu.render.features import light_culling as ref_lcf
from ash_tpu.render.features import lighting as ref_lighting
from ash_tpu.utils.image import psnr
from ash_tpu_torch.ops import light_cull, shade
from ash_tpu_torch.render import bench_scene, frame
from ash_tpu_torch.render.features import light_culling, lighting

torch.set_num_threads(1)

MIN_PSNR = 40.0
PLANE_RTOL = 1e-5
SHADE_ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _lights(seed, n=40):
    """Packed point, spot and directional rows, a few of them disabled."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        pos = rng.uniform(-6, 6, 3).astype(np.float32)
        color = rng.random(3).astype(np.float32)
        kind = i % 5
        if kind == 3:
            gl = ref_lcf.GpuLight.from_spot_light(ref_lighting.SpotLight(
                position=pos, direction=rng.normal(size=3).astype(np.float32),
                color=color, intensity=3.0, radius=float(rng.uniform(2, 8)),
                inner_cone_angle=0.3, outer_cone_angle=0.6))
        elif kind == 4 and i < 10:
            gl = ref_lcf.GpuLight.from_directional_light(
                ref_lighting.DirectionalLight())
        else:
            gl = ref_lcf.GpuLight.from_point_light(ref_lighting.PointLight(
                position=pos, color=color, intensity=2.0,
                radius=float(rng.uniform(1, 8))))
        row = gl.flat()
        if i % 7 == 6:
            row[15] = 0.0  # disabled
        rows.append(row)
    return np.stack(rows)


def _camera(w, h):
    cam = ref_core.Camera.new([6.0, 4.0, 8.0], [0, 0, 0], w / h)
    view = np.asarray(cam.view_matrix(), np.float32)
    proj = np.asarray(cam.projection_matrix(), np.float32)
    return view, proj, np.linalg.inv(proj).astype(np.float32)


def _depth(seed, w, h):
    """Depth in the camera's range, with background (1.0) regions."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.9, 0.999, (h, w)).astype(np.float32)
    d[: h // 3, : w // 2] = 1.0
    return d


CULL_CASES = {
    "frame": (96, 64, 256, 0),
    "odd_size": (100, 70, 256, 0),
    "band": (96, 32, 256, 2),
    "cap": (96, 64, 4, 0),
}


@pytest.mark.parametrize("case", sorted(CULL_CASES))
def test_cull_lights_matches_reference(case):
    w, h, cap, tile_y0 = CULL_CASES[case]
    lights = _lights(1)
    view, _, inv = _camera(96, 64)
    depth = _depth(2, w, h)
    want = ref_lc.cull_lights(jnp.asarray(lights), jnp.asarray(view),
                              jnp.asarray(inv), jnp.asarray(depth), 96, 64,
                              max_per_tile=cap, tile_y0=tile_y0)
    got = light_cull.cull_lights(_t(lights), _t(view), _t(inv), _t(depth),
                                 96, 64, max_per_tile=cap, tile_y0=tile_y0)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    assert got.indices.dtype == torch.int32 and got.counts.dtype == torch.int32
    counts = got.mask.sum(-1).numpy()
    assert 0 < counts.max() and (counts < len(lights)).all()
    np.testing.assert_array_equal(light_cull.pack_tile_buffer(got).numpy(),
                                  np.asarray(ref_lc.pack_tile_buffer(want)))


def test_tile_planes_match_reference():
    _, _, inv = _camera(96, 64)
    dmin, dmax = ref_lc.tile_depth_bounds(jnp.asarray(_depth(3, 100, 70)))
    got_bounds = light_cull.tile_depth_bounds(_t(_depth(3, 100, 70)))
    np.testing.assert_array_equal(got_bounds[0].numpy(), np.asarray(dmin))
    np.testing.assert_array_equal(got_bounds[1].numpy(), np.asarray(dmax))
    want = np.asarray(ref_lc.tile_frustum_planes(jnp.asarray(inv), 100, 70,
                                                 dmin, dmax))
    got = light_cull.tile_frustum_planes(_t(inv), 100, 70,
                                         *got_bounds).numpy()
    assert got.shape == want.shape == (5, 7, 6, 4)
    scale = np.abs(want).max(-1, keepdims=True)
    np.testing.assert_allclose(got / scale, want / scale, atol=PLANE_RTOL,
                               rtol=0)


def test_gpu_light_packing_bit_for_bit():
    rng = np.random.default_rng(4)
    pos = rng.normal(size=3).astype(np.float32)
    d = rng.normal(size=3).astype(np.float32)
    pairs = [
        (light_culling.GpuLight.from_point_light(lighting.PointLight(
            position=pos, color=np.array([0.2, 0.5, 1.0], np.float32),
            intensity=2.5, radius=7.0)),
         ref_lcf.GpuLight.from_point_light(ref_lighting.PointLight(
             position=pos, color=np.array([0.2, 0.5, 1.0], np.float32),
             intensity=2.5, radius=7.0))),
        (light_culling.GpuLight.from_spot_light(lighting.SpotLight(
            position=pos, direction=d, intensity=4.0, radius=9.0,
            inner_cone_angle=0.25, outer_cone_angle=0.7)),
         ref_lcf.GpuLight.from_spot_light(ref_lighting.SpotLight(
             position=pos, direction=d, intensity=4.0, radius=9.0,
             inner_cone_angle=0.25, outer_cone_angle=0.7))),
        (light_culling.GpuLight.from_directional_light(
            lighting.DirectionalLight()),
         ref_lcf.GpuLight.from_directional_light(
             ref_lighting.DirectionalLight())),
    ]
    for port, ref in pairs:
        assert port.flat().dtype == np.float32
        np.testing.assert_array_equal(port.flat().view(np.int32),
                                      ref.flat().view(np.int32))


def _lit_gbuffer(rng, h=32, w=48, draws=4):
    normal = rng.normal(size=(h, w, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    return dict(
        mask=rng.random((h, w)) < 0.85,
        world=rng.uniform(-4, 4, (h, w, 3)).astype(np.float32),
        normal=normal,
        tangent=rng.normal(size=(h, w, 4)).astype(np.float32),
        uv=rng.random((h, w, 2)).astype(np.float32),
        color=rng.random((h, w, 3)).astype(np.float32),
        front_facing=rng.random((h, w)) < 0.7,
        draw_id=rng.integers(0, draws, (h, w)).astype(np.int32),
        uv_ddx=rng.random((h, w, 2)).astype(np.float32) * 0.01,
        uv_ddy=rng.random((h, w, 2)).astype(np.float32) * 0.01,
    )


def _uniforms(port):
    vals = dict(
        camera_pos=np.array([6.0, 4.0, 8.0], np.float32),
        light_direction=np.array([-0.35, -1.0, -0.25], np.float32)
        / np.float32(np.linalg.norm([-0.35, -1.0, -0.25])),
        light_color=np.full(3, 1.5, np.float32),
        ambient_color=np.full(3, 0.35, np.float32),
        light_space_matrix=np.eye(4, dtype=np.float32),
    )
    cls = shade.ShadeUniforms if port else ref_shade.ShadeUniforms
    return cls(**{k: (_t(v) if port else jnp.asarray(v))
                  for k, v in vals.items()})


def test_light_loop_matches_reference():
    rng = np.random.default_rng(5)
    g = _lit_gbuffer(rng)
    mats = np.zeros((4, 18), np.float32)
    mats[:, 0:4] = rng.uniform(0.3, 1.0, (4, 4))
    mats[:, 8] = rng.random(4)
    mats[:, 9] = rng.uniform(0.0, 1.0, 4)
    mats[:, 10:12] = 1.0
    mats[:, 12:17] = -1.0
    lights = _lights(6, 24)
    view, _, inv = _camera(48, 32)
    tl = ref_lc.cull_lights(jnp.asarray(lights), jnp.asarray(view),
                            jnp.asarray(inv), jnp.asarray(_depth(7, 48, 32)),
                            48, 32)
    want = ref_shade.shade_pbr(
        ref_shade.GBuffer(**{k: jnp.asarray(v) for k, v in g.items()}),
        jnp.asarray(mats), _uniforms(False), lights=jnp.asarray(lights),
        tile_light_indices=tl.indices, tile_light_counts=tl.counts,
        reinhard=False,
    )
    gbuf = shade.GBuffer(**{k: _t(v) for k, v in g.items()})
    idx, counts = _t(tl.indices), _t(tl.counts)
    got = shade.shade_pbr(gbuf, _t(mats), _uniforms(True), lights=_t(lights),
                          tile_light_indices=idx, tile_light_counts=counts,
                          reinhard=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=SHADE_ATOL, rtol=0)
    # Every slot (no counts) and the frame's trimmed list give the same bits.
    n = int(counts.max())
    every = shade.shade_pbr(gbuf, _t(mats), _uniforms(True),
                            lights=_t(lights), tile_light_indices=idx,
                            reinhard=False)
    trimmed = shade.shade_pbr(gbuf, _t(mats), _uniforms(True),
                              lights=_t(lights),
                              tile_light_indices=idx[:, :, :n],
                              reinhard=False)
    assert torch.equal(got, every) and torch.equal(got, trimmed)
    unlit = shade.shade_pbr(gbuf, _t(mats), _uniforms(True), reinhard=False)
    assert (got - unlit).abs().max() > 0.1


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


def _lit_bench(port, lights=32):
    if port:
        r, _, cam, _ = bench_scene.build_bench_renderer(192, 128, 64, "cpu",
                                                        lights=lights)
        return r, cam
    draws, extent = bench_scene.bench_draws(64)
    r = _renderer(False, (192, 128), **bench_scene.bench_config(128))
    r.register_mesh_handle(0, ref_core.Mesh.create_cube())
    commands = []
    for i, (m, mat) in enumerate(draws):
        r.register_material_handle(i + 1, ref_core.Material(
            color=mat.color, metallic=mat.metallic, roughness=mat.roughness))
        commands.append(ref_render.RenderCommand(mesh=0, transform=m,
                                                 material=i + 1))
    r.submit_render_commands(commands)
    r.shadow_feature.set_scene_bounds([0, 0, 0], extent)
    for pos, color in bench_scene.bench_lights(lights):
        r.add_point_light(pos, color=color, intensity=2.0, radius=6.0)
    return r, bench_scene.bench_camera(192, 128, extent)


def test_bench_lights_are_bench_py_lights():
    rng = np.random.default_rng(11)
    for pos, color in bench_scene.bench_lights(32):
        assert pos == (rng.random(3) * 20 - 10).tolist()
        assert color == rng.random(3).tolist()


def test_small_lit_bench_matches_reference():
    image, got = _frame(*_lit_bench(True))
    ref_image, ref = _frame(*_lit_bench(False))
    value = psnr(image, ref_image)
    assert value >= MIN_PSNR, f"PSNR {value:.1f} dB < {MIN_PSNR} dB"
    assert int(got.covered_pixels) == int(ref.covered_pixels)
    assert int(got.binning_overflow) == int(ref.binning_overflow)
    # The lights show. bench.py's lights sit inside the grid, so most of
    # what they light is hidden: they change about a ninth of this frame's
    # pixels, by up to 47 levels (PSNR 47.7 dB against the unlit frame).
    unlit, _ = _frame(*_lit_bench(True, lights=0))
    changed = (image[..., :3] != unlit[..., :3]).any(-1)
    assert changed.mean() > 0.05
    assert np.abs(image.astype(int) - unlit).max() > 20


def _spot_scene(port):
    core = port_core if port else ref_core
    r = _renderer(port, (96, 64), tile_h=8, tile_w=32, max_tris_per_tile=32,
                  shadow_resolution=128, shadow_tile=64,
                  shadow_max_tris_per_tile=32)
    r.set_mesh(core.Mesh.create_cube())
    r.set_material(core.Material(color=(0.8, 0.8, 0.8, 1.0), roughness=0.5))
    r.add_point_light([1.5, 1.5, 1.5], color=(1.0, 0.3, 0.2), intensity=5,
                      radius=6)
    r.add_spot_light([-2, 2, 2], direction=[1, -1, -1], color=(0.2, 0.4, 1.0),
                     intensity=8, radius=10, inner_cone_angle=0.2,
                     outer_cone_angle=0.4)
    return _frame(r, core.Camera.new([3.0, 2.2, 4.0], [0, 0, 0], 1.5))


def test_point_and_spot_lights_match_reference():
    image, out = _spot_scene(True)
    ref_image, _ = _spot_scene(False)
    value = psnr(image, ref_image)
    assert value >= MIN_PSNR, f"PSNR {value:.1f} dB < {MIN_PSNR} dB"
    assert np.isfinite(out.color.numpy()).all()


@pytest.fixture
def raster_calls(monkeypatch):
    calls = []
    real = frame.rasterize

    def recording(setup, bins, height, width, *args, **kwargs):
        calls.append((height, kwargs.get("layers", 1)))
        return real(setup, bins, height, width, *args, **kwargs)

    monkeypatch.setattr(frame, "rasterize", recording)
    return calls


def test_lit_frame_keeps_the_standard_rasters(raster_calls):
    r, _, cam, _ = bench_scene.build_bench_renderer(192, 128, 27, "cpu",
                                                    lights=32)
    _frame(r, cam)
    _frame(r, cam)
    assert raster_calls == [(256, 1), (128, 1), (128, 1)]


def test_light_packing_is_cached_on_the_feature_version():
    r = ash_tpu_torch.Renderer(ash_tpu_torch.HeadlessSurface(16, 16),
                               device="cpu")
    assert r._device_lights() is None
    for i in range(3):
        assert r.add_point_light([i, 0, 0]) == i
    packed = r._device_lights()
    assert packed.shape == (8, 16)  # a power-of-two bucket of >= 8 rows
    assert r._device_lights() is packed
    assert r.add_spot_light([0, 1, 0], [0, -1, 0]) == 0
    for i in range(6):
        r.add_point_light([0, 0, i])
    grown = r._device_lights()
    assert grown.shape == (16, 16)
    assert float(grown[9, 11]) == 1.0  # the spot light, after 9 points
    r.clear_point_lights()
    assert r._device_lights().shape == (8, 16)
    r.clear_lights()
    assert r._device_lights() is None
