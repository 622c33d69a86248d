"""Alpha blending through the K-layer depth peel: ash_tpu_torch against
ash_tpu on the CPU.

- `pixel_alpha` and `composite_over` against the reference's on the same
  inputs.
- The scenes of tests/test_alpha_blend.py (front alpha 1, 0.5 and 0; three
  panes over a floor at K=2 and K=4; a transparent cube over the clear
  colour) and the iterated peel of tests/test_deep_transparency.py (6 panes
  over a floor, K=4, passes 1 and 2), rendered by both renderers from the
  same recipe and held at the reference's own bars: atol 2e-3 at the probe
  pixel and PSNR >= 40 dB per image. The port's iterated peel is also held
  to the f64 back-to-front oracle built from its own isolated panes.
- The small glass bench scene (192x128, 64 cubes, every fourth one alpha
  0.5): >= 40 dB, equal overflow and visible draws, covered pixels within
  0.1%.
- Which rasters a frame runs: opaque scenes stay on one layer, a blended
  frame peels K layers once per transparency pass, a single-mesh alpha edit
  blends on the next frame, and a layer count outside [2, 8] raises.
"""

import dataclasses

import numpy as np
import pytest
import torch

import ash_tpu.core as ref_core
import ash_tpu.render as ref_render
import ash_tpu_torch
import ash_tpu_torch.core as port_core
from ash_tpu.ops import shade as ref_shade
from ash_tpu.utils.image import psnr
from ash_tpu_torch.ops import shade
from ash_tpu_torch.render import bench_scene, frame

torch.set_num_threads(1)

PX = (32, 32)  # the probe pixel of the reference's tests
PROBE_ATOL = 2e-3
MIN_PSNR = 40.0


def _core(port):
    """Each renderer is handed its own package's scene classes."""
    return port_core if port else ref_core


def _renderer(port, size, **cfg):
    if port:
        surface = ash_tpu_torch.HeadlessSurface(*size)
        return ash_tpu_torch.Renderer(
            surface, ash_tpu_torch.RendererConfig(**cfg), device="cpu"
        )
    surface = ref_render.HeadlessSurface(*size)
    return ref_render.Renderer(
        surface, ref_render.RendererConfig(use_pallas=False, **cfg)
    )


def _frame(r, cam):
    """-> (f64 colour, u8 image, outputs) of one frame."""
    out = r.render_frame(cam.view_matrix(), cam.projection_matrix(),
                         cam.position)
    return (np.asarray(out.color, np.float64), np.array(r.read_back()), out)


def _panes(port, colors, heights, eye, max_tris=32, size=(64, 64), **cfg):
    """Horizontal 1.5-unit quads at `heights` under a top-down camera."""
    r = _renderer(port, size, tile_h=8, tile_w=32, max_tris_per_tile=max_tris,
                  shadows_enabled=False, **cfg)
    cmd = ash_tpu_torch.RenderCommand if port else ref_render.RenderCommand
    core = _core(port)
    r.register_mesh_handle(0, core.Mesh.create_plane("quad", size=1.5))
    commands = []
    for i, (col, y) in enumerate(zip(colors, heights)):
        r.register_material_handle(i + 1, core.Material(color=tuple(col)))
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = [0, y, 0]
        commands.append(cmd(mesh=0, transform=m, material=i + 1))
    r.submit_render_commands(commands)
    return _frame(r, core.Camera.new(list(eye), [0, 0, 0], size[0] / size[1]))


def _blend_scene(port, front_alpha):
    return _panes(port, [(1, 0, 0, front_alpha), (0, 0, 1, 1.0)], [1.0, 0.0],
                  (0, 4, 0.01))


def _stack_scene(port, layers):
    colors = [(1, 0, 0, 0.5), (0, 1, 0, 0.5), (0, 0, 1, 0.5), (1, 1, 1, 1.0)]
    return _panes(port, colors, [1.5 - 0.5 * i for i in range(4)],
                  (0, 4.5, 0.01), transparency_layers=layers)


DEEP_ALPHAS = [0.3] * 6


def _deep_colors(alphas):
    rng = np.random.default_rng(42)
    return [(*rng.random(3).tolist(), a) for a in alphas]


def _deep_base_height(alphas):
    return 2.0 - 0.15 * len(alphas) - 0.3


def _deep_scene(port, alphas, layers, passes):
    colors = _deep_colors(alphas) + [(1, 1, 1, 1.0)]
    heights = [2.0 - 0.15 * i for i in range(len(alphas))]
    heights.append(_deep_base_height(alphas))
    return _panes(port, colors, heights, (0, 6.0, 0.01), max_tris=64,
                  transparency_layers=layers, transparency_passes=passes)


def _cube_over_background(port):
    r = _renderer(port, (48, 48), tile_h=8, tile_w=32, max_tris_per_tile=32,
                  shadows_enabled=False)
    core = _core(port)
    r.set_mesh(core.Mesh.create_cube())
    r.set_material(core.Material(color=(0.0, 1.0, 0.0, 0.4)))
    return _frame(r, core.Camera.new([0, 0, 5], [0, 0, 0], 1.0))


SCENES = {
    "front_alpha_1": lambda port: _blend_scene(port, 1.0),
    "front_alpha_0.5": lambda port: _blend_scene(port, 0.5),
    "front_alpha_0": lambda port: _blend_scene(port, 0.0),
    "stack_k2": lambda port: _stack_scene(port, 2),
    "stack_k4": lambda port: _stack_scene(port, 4),
    "deep_k4_passes1": lambda port: _deep_scene(port, DEEP_ALPHAS, 4, 1),
    "deep_k4_passes2": lambda port: _deep_scene(port, DEEP_ALPHAS, 4, 2),
    "cube_over_background": _cube_over_background,
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_blend_scene_matches_reference(name):
    color, image, out = SCENES[name](True)
    ref_color, ref_image, ref_out = SCENES[name](False)
    probe = PX if color.shape[0] > PX[0] * 1.5 else (24, 24)
    np.testing.assert_allclose(color[probe], ref_color[probe],
                               atol=PROBE_ATOL, rtol=0)
    assert np.isfinite(color).all()
    value = psnr(image, ref_image)
    assert value >= MIN_PSNR, f"{name}: PSNR {value:.1f} dB < {MIN_PSNR} dB"
    assert int(out.covered_pixels) == int(ref_out.covered_pixels)


def test_front_alpha_blends_with_the_back():
    """The reference's own checks (tests/test_alpha_blend.py) on the port."""
    s = _blend_scene(True, 1.0)[0][PX]
    c = _blend_scene(True, 0.5)[0][PX]
    clear = _blend_scene(True, 0.0)[0][PX]
    assert s[0] > s[2] * 2, s
    assert c[2] > s[2] + 0.02 and c[0] < s[0] - 0.02, (c, s)
    assert clear[2] > clear[0] * 2, clear
    k4, k2 = _stack_scene(True, 4)[0][PX], _stack_scene(True, 2)[0][PX]
    assert (k4 > 0.01).all(), k4
    assert not np.allclose(k4, k2, atol=5e-3), (k4, k2)


def _solo(port_color_of, alphas, i):
    """Pane i alone and opaque: its shaded colour at the probe pixel."""
    col = (*_deep_colors(alphas)[i][:3], 1.0)
    return port_color_of([col], [2.0 - 0.15 * i])


def test_iterated_peel_matches_the_oracle():
    """tests/test_deep_transparency.py's iterated peel on the port: K=4
    with two passes composites 6 panes over a floor exactly (f64
    back-to-front oracle from the port's own isolated surfaces), where one
    pass measurably errs."""
    def color_of(colors, heights):
        return _panes(True, colors, heights, (0, 6.0, 0.01),
                      max_tris=64)[0][PX]

    want = color_of([(1, 1, 1, 1.0)], [_deep_base_height(DEEP_ALPHAS)])
    for i in range(len(DEEP_ALPHAS) - 1, -1, -1):
        a = DEEP_ALPHAS[i]
        want = a * _solo(color_of, DEEP_ALPHAS, i) + (1.0 - a) * want
    err1 = np.abs(_deep_scene(True, DEEP_ALPHAS, 4, 1)[0][PX] - want).max()
    err2 = np.abs(_deep_scene(True, DEEP_ALPHAS, 4, 2)[0][PX] - want).max()
    assert err1 > 1e-4, f"single pass unexpectedly exact ({err1})"
    assert err2 < PROBE_ATOL, f"iterated peel not exact: {err2} ({err1})"


def _glass_bench(port, passes=1):
    draws, extent = bench_scene.bench_draws(64, glass=True)
    cfg = bench_scene.bench_config(128, glass=True, transparency_passes=passes)
    r = _renderer(port, (192, 128), **cfg)
    cmd = ash_tpu_torch.RenderCommand if port else ref_render.RenderCommand
    core = _core(port)
    r.register_mesh_handle(0, core.Mesh.create_cube())
    commands = []
    for i, (m, mat) in enumerate(draws):
        # bench_draws builds the port's Materials; the reference gets its
        # own class with the same fields.
        r.register_material_handle(
            i + 1, core.Material(**dataclasses.asdict(mat)))
        commands.append(cmd(mesh=0, transform=m, material=i + 1))
    r.submit_render_commands(commands)
    r.shadow_feature.set_scene_bounds([0, 0, 0], extent)
    return r, bench_scene.bench_camera(192, 128, extent)


def test_glass_bench_recipe():
    """Every fourth draw is glass; the rest of the standard frame's
    materials and transforms are unchanged."""
    opaque, ext = bench_scene.bench_draws(64)
    glass, gext = bench_scene.bench_draws(64, glass=True)
    assert ext == gext and len(glass) == 64
    for i, ((m0, mat0), (m1, mat1)) in enumerate(zip(opaque, glass)):
        np.testing.assert_array_equal(m0, m1)
        assert mat1.color[:3] == mat0.color[:3] and mat0.color[3] == 1.0
        assert mat1.color[3] == (0.5 if i % 4 == 0 else 1.0)
        assert (mat1.metallic, mat1.roughness) == (mat0.metallic,
                                                   mat0.roughness)


def test_small_glass_bench_matches_reference():
    r, cam = _glass_bench(True)
    rr, rcam = _glass_bench(False)
    _, image, got = _frame(r, cam)
    _, ref_image, ref = _frame(rr, rcam)
    value = psnr(image, ref_image)
    assert value >= MIN_PSNR, f"PSNR {value:.1f} dB < {MIN_PSNR} dB"
    assert int(got.binning_overflow) == int(ref.binning_overflow)
    assert int(got.shadow_overflow) == int(ref.shadow_overflow)
    assert int(got.visible_draws) == int(ref.visible_draws)
    covered, ref_covered = int(got.covered_pixels), int(ref.covered_pixels)
    assert covered > 0
    assert abs(covered - ref_covered) <= 0.001 * ref_covered


@pytest.fixture
def raster_calls(monkeypatch):
    """Record the frame's raster calls as (rows, layers, has_floor)."""
    calls = []
    real = frame.rasterize

    def recording(setup, bins, height, width, *args, **kwargs):
        calls.append((height, kwargs.get("layers", 1),
                      kwargs.get("depth_floor") is not None))
        return real(setup, bins, height, width, *args, **kwargs)

    monkeypatch.setattr(frame, "rasterize", recording)
    return calls


@pytest.mark.parametrize("passes", [1, 2])
def test_glass_frame_peels_once_per_pass(raster_calls, passes):
    r, cam = _glass_bench(True, passes)
    first = _frame(r, cam)[1]
    main = [(128, 4, False)] + [(128, 4, True)] * (passes - 1)
    assert raster_calls == [(256, 1, False)] + main  # shadow, then the peel
    assert _frame(r, cam)[1].tobytes() == first.tobytes()
    assert raster_calls[1 + passes:] == main  # the cached shadow map


def test_opaque_frame_keeps_one_layer(raster_calls):
    r, _, cam, _ = bench_scene.build_bench_renderer(
        192, 128, 27, "cpu", transparency_layers=8, transparency_passes=3
    )
    _frame(r, cam)
    assert raster_calls == [(256, 1, False), (128, 1, False)]


def _cube_renderer():
    r = _renderer(True, (64, 48), tile_h=8, tile_w=32, max_tris_per_tile=32,
                  shadow_resolution=128, shadow_tile=64,
                  shadow_max_tris_per_tile=32)
    r.set_mesh(port_core.Mesh.create_cube())
    return r, port_core.Camera.new([3.0, 2.2, 4.0], [0, 0, 0], 64 / 48)


def test_single_mesh_alpha_edit_blends_next_frame(raster_calls):
    r, cam = _cube_renderer()
    opaque = _frame(r, cam)[1]
    assert raster_calls == [(128, 1, False), (48, 1, False)]
    r.material_mut().color = (0.2, 0.6, 0.9, 0.4)
    blended = _frame(r, cam)[1]
    # The default two layers, and the shadow map is kept.
    assert raster_calls[2:] == [(48, 2, False)]
    fresh, _ = _cube_renderer()
    fresh.set_material(port_core.Material(color=(0.2, 0.6, 0.9, 0.4)))
    assert _frame(fresh, cam)[1].tobytes() == blended.tobytes()
    assert blended.tobytes() != opaque.tobytes()
    r.material_mut().color = (0.2, 0.6, 0.9, 1.0)
    _frame(r, cam)
    assert raster_calls[-1] == (48, 1, False)


@pytest.mark.parametrize("layers", [1, 9])
def test_transparency_layers_outside_range_raise_at_render(layers):
    r = _renderer(True, (32, 32), shadows_enabled=False,
                  transparency_layers=layers)
    r.set_mesh(port_core.Mesh.create_cube())
    cam = port_core.Camera.new([3.0, 2.0, 4.0], [0, 0, 0], 1.0)
    with pytest.raises(ValueError, match=r"outside \[2, 8\]"):
        _frame(r, cam)


def _random_gbuffer(rng, h=24, w=40, draws=6):
    draw_id = rng.integers(0, draws, (h, w)).astype(np.int32)
    mask = rng.random((h, w)) < 0.7
    fields = dict(mask=mask, draw_id=draw_id)
    shapes = dict(world=3, normal=3, tangent=4, uv=2, color=3, uv_ddx=2,
                  uv_ddy=2)
    for name, c in shapes.items():
        fields[name] = rng.random((h, w, c)).astype(np.float32)
    fields["front_facing"] = rng.random((h, w)) < 0.5
    return fields


def test_pixel_alpha_matches_reference():
    rng = np.random.default_rng(11)
    g = _random_gbuffer(rng)
    mats = rng.random((6, 18)).astype(np.float32)
    mats[:, 3] = [1.0, 0.5, 0.2, 0.0, 0.7, 0.05]  # base colour alpha
    mats[:, 17] = [0.0, 0.0, 0.3, 0.0, 0.5, 0.1]  # alpha cutoff
    want = ref_shade.pixel_alpha(
        ref_shade.GBuffer(**{k: np.asarray(v) for k, v in g.items()}), mats
    )
    got = shade.pixel_alpha(
        shade.GBuffer(**{k: torch.from_numpy(v) for k, v in g.items()}),
        torch.from_numpy(mats),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # Cut out (alpha 0.2 < 0.3) and background pixels are 0; opaque is 1.
    a = got.numpy()
    assert (a[~g["mask"]] == 0.0).all()
    assert (a[g["mask"] & (g["draw_id"] == 2)] == 0.0).all()
    assert (a[g["mask"] & (g["draw_id"] == 0)] == 1.0).all()


def test_composite_over_matches_reference():
    rng = np.random.default_rng(12)
    front = rng.random((24, 40, 3)).astype(np.float32)
    alpha = rng.random((24, 40)).astype(np.float32)
    back = rng.random((24, 40, 3)).astype(np.float32)
    want = ref_shade.composite_over(front, alpha, back)
    got = shade.composite_over(*(torch.from_numpy(x)
                                 for x in (front, alpha, back)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
