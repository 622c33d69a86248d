"""Cascaded shadow maps and the rich frame: ash_tpu_torch's cascade fit,
cascaded PCF, cascade shadow pass and the small rich scene against ash_tpu
on the CPU.

Tolerances (ROADMAP.md section C has what was measured):

- `CsmConfig`'s presets, `CascadedShadowMap` (`calculate_splits`,
  `frustum_corners`, `update`, `gpu_data`, `light_matrix`) on seeded
  cameras: bit for bit (host numpy on both sides);
- `shadow_pcf16_csm` on seeded positions and seeded cascade maps, blend
  sizes 0 and 0.1: atol 1e-5 (a fraction of 16 taps, so any flipped tap
  would show as 0.0625);
- whole frames through both renderers (the ground and two cubes of
  tests/test_csm_render.py with 3 cascades, with blending, with shadows
  off; the small rich scene, 192x128 and 64 cubes with HDR post, TAA, three
  256^2 cascades and 32 lights, over three frames): u8 PSNR >= 40 dB, equal
  overflow counts, and the cascade maps within atol 1e-4 but for at most
  0.2% of the texels (silhouette texels where the two rasters' edge
  functions, equal up to their last bits, disagree on coverage).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ash_tpu.core as ref_core
import ash_tpu.render as ref_render
import ash_tpu_torch.core as port_core
import ash_tpu_torch.render as port_render
from ash_tpu.ops import shadow as ref_shadow
from ash_tpu.render import csm as ref_csm
from ash_tpu.utils.image import psnr
from ash_tpu_torch.ops import shadow
from ash_tpu_torch.render import bench_scene, csm, frame

torch.set_num_threads(1)

ATOL = 1e-5
MAP_ATOL = 1e-4
MAP_FLIPS = 0.002
MIN_PSNR = 40.0
TESTS = os.path.dirname(os.path.abspath(__file__))


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# The host fit, bit for bit
# ---------------------------------------------------------------------------


def test_csm_config_presets():
    import dataclasses

    for name in ("high_quality", "performance"):
        assert (dataclasses.asdict(getattr(csm.CsmConfig, name)())
                == dataclasses.asdict(getattr(ref_csm.CsmConfig, name)()))
    assert (dataclasses.asdict(csm.CsmConfig())
            == dataclasses.asdict(ref_csm.CsmConfig()))
    assert csm.MAX_CASCADES == ref_csm.MAX_CASCADES == 4


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_cascade_fit_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    kw = dict(cascade_count=int(rng.integers(1, 5)),
              resolution=int(rng.choice([256, 1024, 2048])),
              split_lambda=float(rng.uniform(0.3, 0.9)))
    got = csm.CascadedShadowMap(csm.CsmConfig(**kw))
    want = ref_csm.CascadedShadowMap(ref_csm.CsmConfig(**kw))
    np.testing.assert_array_equal(got.calculate_splits(0.1, 80.0),
                                  want.calculate_splits(0.1, 80.0))
    for _ in range(3):
        eye = rng.uniform(-10, 10, 3)
        cam = port_core.Camera.new(eye, rng.uniform(-2, 2, 3), 16 / 9)
        cam.far = float(rng.uniform(40, 200))
        view, proj = cam.view_matrix(), cam.projection_matrix()
        light = rng.normal(size=3).astype(np.float32)
        distance = float(rng.uniform(20, 100))
        np.testing.assert_array_equal(
            got.frustum_corners(view, proj, 0.1, 7.5),
            want.frustum_corners(view, proj, 0.1, 7.5))
        got.update(view, proj, light, distance)
        want.update(view, proj, light, distance)
        g, w = got.gpu_data(), want.gpu_data()
        np.testing.assert_array_equal(g.light_matrices, w.light_matrices)
        np.testing.assert_array_equal(g.split_distances, w.split_distances)
        np.testing.assert_array_equal(g.params, w.params)
        assert g.light_matrices.dtype == np.float32
        # Unused cascades' splits are the largest float.
        assert (g.split_distances[kw["cascade_count"]:]
                == np.finfo(np.float32).max).all()
        for c in range(-1, 5):
            np.testing.assert_array_equal(got.light_matrix(c),
                                          want.light_matrix(c))
    # The value cache: the same inputs re-fit nothing.
    first = got.cascades[0]
    got.update(view, proj, light, distance)
    assert got.cascades[0] is first
    got.update(view, proj, light, distance + 1.0)
    assert got.cascades[0] is not first


# ---------------------------------------------------------------------------
# Cascaded PCF
# ---------------------------------------------------------------------------


def _csm_inputs(seed=6, h=40, w=56, cascades=3, s=64):
    """Seeded world positions in front of a camera, unit normals, cascade
    maps, and cascade matrices fitted to that camera."""
    rng = np.random.default_rng(seed)
    cam = port_core.Camera.new([4.0, 3.0, 9.0], [0, 0, -4], w / h)
    cam.far = 60.0
    view, proj = cam.view_matrix(), cam.projection_matrix()
    fit = csm.CascadedShadowMap(csm.CsmConfig(cascade_count=cascades,
                                              resolution=s))
    light = np.array([-0.5, -1.0, -0.3], np.float32)
    fit.update(view, proj, light, 40.0)
    gpu = fit.gpu_data()
    # Points at view distances from 1 to 50: they span every cascade and
    # reach beyond the last split.
    dist = rng.uniform(1.0, 50.0, (h, w, 1))
    ndc = rng.uniform(-0.9, 0.9, (h, w, 2))
    inv_view = np.linalg.inv(view)
    p00, p11 = proj[0, 0], proj[1, 1]
    view_pos = np.concatenate([ndc[..., :1] * dist / p00,
                               ndc[..., 1:] * dist / p11, -dist,
                               np.ones_like(dist)], -1)
    world = (view_pos @ inv_view.T)[..., :3].astype(np.float32)
    normal = rng.normal(size=(h, w, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    maps = rng.uniform(0.2, 1.0, (cascades, s, s)).astype(np.float32)
    to_light = (-light / np.linalg.norm(light)).astype(np.float32)
    return (maps, gpu.light_matrices[:cascades], gpu.split_distances,
            view.astype(np.float32), world, normal, to_light)


@pytest.mark.parametrize("blend_size", [0.0, 0.1])
@pytest.mark.parametrize("cascades", [2, 3, 4])
def test_shadow_pcf16_csm_matches_reference(blend_size, cascades):
    args = _csm_inputs(cascades=cascades)
    want = ref_shadow.shadow_pcf16_csm(*(jnp.asarray(a) for a in args),
                                       blend_size=blend_size)
    got = shadow.shadow_pcf16_csm(*(_t(a) for a in args),
                                  blend_size=blend_size)
    err = float(np.abs(got.numpy() - np.asarray(want)).max())
    print(f"measured shadow_pcf16_csm cascades={cascades} "
          f"blend={blend_size}: max abs err {err:.3e}")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert 0.0 < float(got.mean()) < 1.0
    if blend_size:
        hard = shadow.shadow_pcf16_csm(*(_t(a) for a in args), blend_size=0.0)
        assert not torch.equal(hard, got)


def test_csm_cascade_blending_smooths_boundary():
    """tests/test_csm_render.py's three points straddling the first split."""
    maps = torch.stack([torch.full((32, 32), 0.3), torch.ones(32, 32)])
    mats = torch.stack([torch.eye(4), torch.eye(4)])
    splits = torch.tensor([10.0, 40.0, 1e9, 1e9])
    world = torch.tensor([[0.0, 0.0, -9.0], [0.0, 0.0, -9.9], [0.0, 0.0, -11.0]])
    up = torch.tensor([0.0, 0.0, 1.0]).expand(3, 3)
    rmaps = jnp.stack([jnp.full((32, 32), 0.3), jnp.ones((32, 32))])
    for blend in (0.0, 0.2):
        got = shadow.shadow_pcf16_csm(maps, mats, splits, torch.eye(4), world,
                                      up, up, blend_size=blend)
        want = ref_shadow.shadow_pcf16_csm(
            rmaps, jnp.stack([jnp.eye(4)] * 2), jnp.asarray(splits.numpy()),
            jnp.eye(4), jnp.asarray(world.numpy()), jnp.asarray(up.numpy()),
            jnp.asarray(up.numpy()), blend_size=blend)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# ---------------------------------------------------------------------------
# Whole frames through both renderers
# ---------------------------------------------------------------------------


def _ground_and_cubes(render, core, csm_mod, w, h, csm_kw=None, **cfg):
    """tests/test_csm_render.py's scene: a ground plane and two cubes at
    different distances."""
    surface = render.HeadlessSurface(w, h)
    kw = dict(tile_h=8, tile_w=32, max_tris_per_tile=32, shadow_tile=32,
              shadow_max_tris_per_tile=32)
    kw.update(cfg)
    if csm_kw is not None:
        kw["csm"] = csm_mod.CsmConfig(**csm_kw)
    device = {"device": "cpu"} if render is port_render else {}
    r = render.Renderer(surface, render.RendererConfig(**kw), **device)
    r.register_mesh_handle(0, core.Mesh.create_cube())
    r.register_mesh_handle(1, core.Mesh.create_plane(size=30.0))
    r.register_material_handle(1, core.Material(color=(0.7, 0.7, 0.7, 1.0)))
    commands = []
    for mesh, pos in ((1, [0, -0.01, 0]), (0, [0, 1.0, 0]), (0, [0, 1.0, -18.0])):
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = pos
        commands.append(render.RenderCommand(mesh=mesh, transform=m, material=1))
    r.submit_render_commands(commands)
    return r, surface


def _render_both(w, h, eye, target, far=None, csm_kw=None, **cfg):
    outs = []
    for render, core, csm_mod in ((port_render, port_core, csm),
                                  (ref_render, ref_core, ref_csm)):
        r, surface = _ground_and_cubes(render, core, csm_mod, w, h, csm_kw,
                                       **cfg)
        cam = core.Camera.new(eye, target, w / h)
        if far is not None:
            cam.far = far
        out = r.render_frame(cam.view_matrix(), cam.projection_matrix(),
                             cam.position)
        outs.append((out, np.asarray(surface.read_back())))
    return outs


def _assert_psnr(got, want, what):
    value = psnr(got, want)
    differing = int((got != want).any(-1).sum())
    print(f"measured {what}: PSNR {value:.2f} dB, {differing} pixels differ")
    assert value >= MIN_PSNR, f"{what}: PSNR {value:.2f} dB < {MIN_PSNR}"


def _assert_maps_match(got, want, what):
    """Cascade depth maps: light-space depth within MAP_ATOL, but for the
    texels on a silhouette where the two rasters disagree on coverage (the
    edge functions differ in the last bits), at most MAP_FLIPS of the map."""
    err = np.abs(got - want)
    flips = float((err > MAP_ATOL).mean())
    print(f"measured {what} cascade maps: {100 * flips:.3f}% of texels over "
          f"{MAP_ATOL}, median abs err {np.median(err):.3e}, "
          f"{100 * float((err > ATOL).mean()):.3f}% over {ATOL}")
    assert flips <= MAP_FLIPS, f"{what}: {flips:.4%} of texels differ"


@pytest.mark.parametrize("blend", [False, True])
def test_csm_renders_cascade_array(blend):
    (out, img), (rout, rimg) = _render_both(
        128, 96, [6, 5, 10], [0, 0, -5], far=60.0,
        csm_kw=dict(cascade_count=3, resolution=128, blend_cascades=blend),
        shadow_distance=40.0)
    sm = out.shadow_map.numpy()
    assert sm.shape == (3, 128, 128)
    nonempty = [(sm[c] < 1.0).mean() > 0.001 for c in range(3)]
    assert sum(nonempty) >= 2, f"too many empty cascades: {nonempty}"
    assert (img[..., :3].sum(-1) > 0).mean() > 0.3
    _assert_maps_match(sm, np.asarray(rout.shadow_map), "ground and cubes")
    assert int(out.shadow_overflow) == int(rout.shadow_overflow)
    _assert_psnr(img, rimg, f"ground and cubes, 3 cascades, blend={blend}")


def test_csm_vs_single_map_similar_output():
    (_, single), _ = _render_both(96, 64, [5, 4, 8], [0, 0, 0],
                                  shadow_resolution=128)
    (_, cascaded), (_, ref_cascaded) = _render_both(
        96, 64, [5, 4, 8], [0, 0, 0],
        csm_kw=dict(cascade_count=2, resolution=128), shadow_distance=30.0)
    diff = np.abs(single.astype(np.float32) - cascaded)[..., :3].max(-1)
    close = (diff < 60).mean()
    assert close > 0.85, f"only {close:.2%} pixels close"
    assert not np.array_equal(single, cascaded)
    _assert_psnr(cascaded, ref_cascaded, "ground and cubes, 2 cascades")


def test_csm_with_shadows_disabled_renders():
    """csm with shadows off behaves exactly like no csm."""
    (out, img), (_, rimg) = _render_both(
        64, 48, [6, 5, 10], [0, 0, -5],
        csm_kw=dict(cascade_count=3, resolution=64), shadows_enabled=False,
        tile_w=64)
    assert out.shadow_map is None and out.shadow_overflow is None
    assert (img[..., :3].sum(-1) > 0).mean() > 0.3
    (_, plain), _ = _render_both(64, 48, [6, 5, 10], [0, 0, -5],
                                 shadows_enabled=False, tile_w=64)
    np.testing.assert_array_equal(img, plain)
    _assert_psnr(img, rimg, "ground and cubes, csm with shadows off")


@pytest.fixture
def raster_calls(monkeypatch):
    """Count the frame's calls of the raster entry point."""
    calls = []
    real = frame.rasterize

    def counting(setup, bins, height, width, *args, **kwargs):
        calls.append((height, width))
        return real(setup, bins, height, width, *args, **kwargs)

    monkeypatch.setattr(frame, "rasterize", counting)
    return calls


def test_cascades_render_once_for_a_static_scene(raster_calls):
    """One raster per cascade, then the cached maps: the TAA jitter changes
    the projection every frame, but the cascades are fitted to the
    unjittered camera. A new light direction renders all of them again."""
    r, _, cam, _ = bench_scene.build_bench_renderer(192, 128, 27, "cpu",
                                                    rich=True)
    args = (cam.view_matrix(), cam.projection_matrix(), cam.position)
    first = r.render_frame(*args)
    assert first.shadow_map.shape == (3, 256, 256)
    assert raster_calls == [(256, 256)] * 3 + [(128, 192)]
    second = r.render_frame(*args)
    assert raster_calls[4:] == [(128, 192)]
    assert second.shadow_map is first.shadow_map
    assert not torch.equal(first.image, second.image)  # another jitter
    r.shadow_feature.set_light_direction([0.2, -1.0, -0.4])
    r.render_frame(*args)
    assert raster_calls[5:] == [(256, 256)] * 3 + [(128, 192)]
    r.set_taa_enabled(False)
    a = r.render_frame(*args).image
    b = r.render_frame(*args).image
    assert torch.equal(a, b)  # without TAA, static frames are equal


def test_small_rich_scene_matches_reference():
    """bench.py --rich at the small size over three frames."""
    sys.path.insert(0, os.path.dirname(TESTS))
    import bench

    r, _, cam, _ = bench_scene.build_bench_renderer(192, 128, 64, "cpu",
                                                    rich=True)
    over = bench_scene.rich_overrides(128)
    over["csm"] = ref_csm.CsmConfig(cascade_count=over["csm"][0],
                                    resolution=over["csm"][1])
    rr, _, rcam, _ = bench.build_bench_renderer(192, 128, 64,
                                                use_pallas=False, **over)
    rr.initialize_hdr()
    rr.set_taa_enabled(True)
    for pos, color in bench_scene.bench_lights(bench_scene.RICH_LIGHTS):
        rr.add_point_light(pos, color=color, intensity=2.0, radius=6.0)
    cfg = r.prepare_frame(cam.view_matrix(), cam.projection_matrix(),
                          cam.position).config
    r.reset_taa_history()  # prepare_frame took a jitter
    assert (cfg.post_enabled and cfg.taa_enabled and cfg.lights_enabled
            and cfg.shadow_cascades == 3 and cfg.shadow_resolution == 256
            and cfg.shadow_max_tris_per_tile == 512
            and cfg.csm_blend_size == 0.1)
    for i in range(3):
        got = r.render_frame(cam.view_matrix(), cam.projection_matrix(),
                             cam.position)
        ref = rr.render_frame(rcam.view_matrix(), rcam.projection_matrix(),
                              rcam.position)
        _assert_psnr(r.read_back(), np.asarray(ref.image),
                     f"small rich scene, frame {i + 1}")
        assert int(got.binning_overflow) == int(ref.binning_overflow) == 0
        assert int(got.shadow_overflow) == int(ref.shadow_overflow) == 0
        assert int(got.visible_draws) == int(ref.visible_draws)
        assert int(got.covered_pixels) == int(ref.covered_pixels)
    _assert_maps_match(got.shadow_map.numpy(), np.asarray(ref.shadow_map),
                       "small rich scene")
