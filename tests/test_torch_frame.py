"""The slice end to end: ash_tpu_torch.Renderer on the CPU.

- The seven golden scenes reach PSNR >= 40 dB against the
  committed PNGs, the bar the reference is held to (tests/test_golden.py).
- The small bench scene (bench.py's smoke config: 192x128, 64 cubes)
  reaches >= 40 dB against ash_tpu's CPU render of the same scene, with
  equal overflow counts and covered pixels within 0.1%.
- Both passes go through the raster entry point, and a static scene
  renders its shadow map once.
"""

import os
import sys

import numpy as np
import pytest
import torch

from ash_tpu.utils.image import psnr, read_png
from ash_tpu_torch import Camera, Material, Mesh, Renderer, RendererConfig
from ash_tpu_torch.errors import InvalidOperation
from ash_tpu_torch.render import HeadlessSurface, frame, golden_scenes
from ash_tpu_torch.render.bench_scene import build_bench_renderer

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(TESTS, "golden")


@pytest.mark.parametrize("name", sorted(golden_scenes.SCENES))
def test_golden_psnr(name):
    golden = read_png(os.path.join(GOLDEN_DIR, f"{name}.png"))
    fresh = golden_scenes.SCENES[name]("cpu").read_back()
    assert fresh.shape == golden.shape and fresh.dtype == np.uint8
    value = psnr(fresh, golden)
    assert value >= 40.0, f"{name}: PSNR {value:.1f} dB < 40 dB"


def test_small_bench_scene_matches_reference():
    sys.path.insert(0, os.path.dirname(TESTS))
    import bench

    r, _, cam, _ = build_bench_renderer(192, 128, 64, "cpu")
    got = r.render_frame(cam.view_matrix(), cam.projection_matrix(), cam.position)
    rr, _, rcam, _ = bench.build_bench_renderer(192, 128, 64, use_pallas=False)
    ref = rr.render_frame(rcam.view_matrix(), rcam.projection_matrix(),
                          rcam.position)
    value = psnr(r.read_back(), np.asarray(ref.image))
    assert value >= 40.0, f"PSNR {value:.1f} dB < 40 dB"
    assert int(got.binning_overflow) == int(ref.binning_overflow)
    assert int(got.shadow_overflow) == int(ref.shadow_overflow)
    assert int(got.visible_draws) == int(ref.visible_draws)
    covered, ref_covered = int(got.covered_pixels), int(ref.covered_pixels)
    assert covered > 0
    assert abs(covered - ref_covered) <= 0.001 * ref_covered


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


def _render(r, cam):
    r.render_frame(cam.view_matrix(), cam.projection_matrix(), cam.position)
    return r.read_back().copy()


def test_static_scene_renders_its_shadow_map_once(raster_calls):
    r, _, cam, _ = build_bench_renderer(192, 128, 27, "cpu")
    first = _render(r, cam)
    assert raster_calls == [(256, 256), (128, 192)]  # shadow, then main
    second = _render(r, cam)
    assert raster_calls[2:] == [(128, 192)]  # the cached shadow map
    np.testing.assert_array_equal(first, second)
    r.shadow_feature.set_light_direction([0.2, -1.0, -0.4])
    moved = _render(r, cam)
    assert raster_calls[3:] == [(256, 256), (128, 192)]
    assert not np.array_equal(first, moved)


def test_taa_jitter_keeps_the_shadow_map(raster_calls):
    """The single map's key is the light matrix, so a new jitter alone
    renders only the main pass; every frame has another jitter."""
    r, _, cam, _ = build_bench_renderer(192, 128, 27, "cpu")
    r.initialize_hdr()
    r.set_taa_enabled(True)
    frames = [_render(r, cam) for _ in range(3)]
    assert raster_calls == [(256, 256), (128, 192), (128, 192), (128, 192)]
    assert not np.array_equal(frames[0], frames[1])
    r.set_taa_enabled(False)
    assert np.array_equal(_render(r, cam), _render(r, cam))


@pytest.mark.parametrize("scale,size", [(0.5, (64, 96)), (0.7, (90, 134))])
def test_taau_rasters_at_the_internal_size(raster_calls, scale, size):
    r, _, cam, _ = build_bench_renderer(192, 128, 27, "cpu",
                                        render_scale=scale)
    r.initialize_hdr()
    r.set_taa_enabled(True)
    out = r.render_frame(cam.view_matrix(), cam.projection_matrix(),
                         cam.position)
    assert raster_calls == [(256, 256), size]
    assert out.image.shape == (128, 192, 4) and out.depth.shape == (128, 192)
    assert out.history.shape == (128, 192, 3)


def test_resize_under_taa_starts_a_new_history():
    r, _, cam, _ = build_bench_renderer(192, 128, 27, "cpu")
    r.initialize_hdr()
    r.set_taa_enabled(True)
    _render(r, cam)
    r.surface.resize(96, 64)
    resized = _render(r, cam)
    assert resized.shape == (64, 96, 4)
    assert r.last_outputs().history.shape == (64, 96, 3)


def _cube_renderer():
    r = Renderer(
        HeadlessSurface(64, 48),
        RendererConfig(tile_h=8, tile_w=32, max_tris_per_tile=32,
                       shadow_resolution=128, shadow_tile=64,
                       shadow_max_tris_per_tile=32),
        device="cpu",
    )
    r.set_mesh(Mesh.create_cube())
    return r, Camera.new([3.0, 2.2, 4.0], [0, 0, 0], 64 / 48)


def test_single_mesh_edits_apply_next_frame(raster_calls):
    r, cam = _cube_renderer()
    _render(r, cam)
    r.material_mut().color = (0.1, 0.9, 0.3, 1.0)
    edited = _render(r, cam)
    assert len(raster_calls) == 3  # a material edit keeps the shadow map
    fresh, _ = _cube_renderer()
    fresh.set_material(Material(color=(0.1, 0.9, 0.3, 1.0)))
    np.testing.assert_array_equal(edited, _render(fresh, cam))

    r.transform.position = np.array([0.3, 0.0, 0.0], np.float32)
    _render(r, cam)
    assert len(raster_calls) == 7  # a moved mesh re-renders its shadow


def test_surface_resize_applies_next_frame():
    r, cam = _cube_renderer()
    first = _render(r, cam)
    r.surface.resize(40, 24)
    resized = _render(r, cam)
    assert first.shape == (48, 64, 4) and resized.shape == (24, 40, 4)
    assert (resized[..., :3] > 0).any()


def test_empty_renderer_raises():
    r = Renderer(HeadlessSurface(16, 16), device="cpu")
    with pytest.raises(InvalidOperation):
        r.render_frame(np.eye(4), np.eye(4), np.zeros(3))
