"""TAA and TAA upsampling: ash_tpu_torch's resolve, jitter bookkeeping,
upsampling and the renderer's TAA state against ash_tpu on the CPU.

Tolerances (ROADMAP.md section C has what was measured):

- `rgb_to_ycocg`, `ycocg_to_rgb`, `clip_aabb`, `taa_resolve` (with and
  without a velocity buffer, each switch on and off, a history that lies
  partly off screen): atol 1e-5 + rtol 1e-5; the inverse tonemap c / (1 - c)
  amplifies a last-bit difference where a clamped history channel nears 1,
  so the tolerance is relative;
- the TAAU resize against `jax.image.resize` at ratios 0.5 and 0.7: bilinear
  atol 1e-5 + rtol 1e-5, nearest equal;
- `HaltonSequence`, `TemporalAA` (jitter_projection, params, reset): bit for
  bit;
- whole frames through both renderers (a static cube, a panning camera, a
  moving mesh, render_scale 0.5 and 0.7 over 8 frames): u8 PSNR >= 40 dB,
  and the bars of tests/test_taau.py and tests/test_taa_velocity.py on the
  port's own frames.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ash_tpu.core as ref_core
import ash_tpu.render as ref_render
import ash_tpu_torch.core as port_core
import ash_tpu_torch.render as port_render
from ash_tpu.ops import taa as ref_taa
from ash_tpu.render import temporal_aa as ref_temporal
from ash_tpu.utils.image import psnr
from ash_tpu_torch.core import maths
from ash_tpu_torch.ops import taa
from ash_tpu_torch.render import frame, temporal_aa

torch.set_num_threads(1)

ATOL = 1e-5
RTOL = 1e-5
MIN_PSNR = 40.0


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_close(got, want, what, atol=ATOL, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, f"{what}: {got.shape} != {want.shape}"
    err = np.abs(got - want)
    over = err - (atol + rtol * np.abs(want))
    print(f"measured {what}: max abs err {err.max():.3e}, "
          f"max err over tolerance {over.max():.3e}")
    assert (over <= 0).all(), (
        f"{what}: max abs err {err.max():.3e}, {int((over > 0).sum())} "
        f"elements over atol {atol} + rtol {rtol}")


def _hdr(seed, h, w, peak=8.0):
    rng = np.random.default_rng(seed)
    img = rng.random((h, w, 3)) * 0.9
    hot = rng.random((h, w, 1)) < 0.1
    return np.where(hot, img * peak / 0.9, img).astype(np.float32)


def test_ycocg_pair():
    x = _hdr(1, 24, 32)
    got = taa.rgb_to_ycocg(_t(x))
    _assert_close(got, ref_taa.rgb_to_ycocg(jnp.asarray(x)), "rgb_to_ycocg")
    back = taa.ycocg_to_rgb(got)
    _assert_close(back, ref_taa.ycocg_to_rgb(jnp.asarray(got.numpy())),
                  "ycocg_to_rgb")
    np.testing.assert_allclose(back.numpy(), x, atol=1e-5)


def test_clip_aabb():
    rng = np.random.default_rng(2)
    lo = rng.uniform(-0.5, 0.2, (40, 50, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.0, 0.6, (40, 50, 3)).astype(np.float32)
    hist = rng.uniform(-1.0, 1.5, (40, 50, 3)).astype(np.float32)
    got = taa.clip_aabb(_t(lo), _t(hi), _t(hist))
    want = ref_taa.clip_aabb(jnp.asarray(lo), jnp.asarray(hi),
                             jnp.asarray(hist))
    assert (np.asarray(want) != hist).any() and (np.asarray(want) == hist).any()
    _assert_close(got, want, "clip_aabb")


def _resolve_inputs(h=48, w=64):
    rng = np.random.default_rng(3)
    current = _hdr(4, h, w)
    # A history near the current frame, so the clamp clips some pixels and
    # passes others; a few channels far above it.
    history = (current * rng.uniform(0.5, 1.6, (h, w, 3))).astype(np.float32)
    # Velocities: mostly small, a band under 1e-4 (the jitter fallback) and
    # a band that sends the history fetch off screen.
    velocity = rng.normal(0, 0.01, (h, w, 2)).astype(np.float32)
    velocity[: h // 4] *= 1e-4
    velocity[:, : w // 8, 0] = 0.3
    return current, history, velocity


@pytest.mark.parametrize("with_velocity", [False, True])
@pytest.mark.parametrize("color_clamp", [0.0, 1.0])
@pytest.mark.parametrize("velocity_rejection", [0.0, 1.0])
def test_taa_resolve(with_velocity, color_clamp, velocity_rejection):
    current, history, velocity = _resolve_inputs()
    jitter = np.array([0.25, -0.125], np.float32)
    prev_jitter = np.array([-0.3, 0.4], np.float32)
    want = ref_taa.taa_resolve(
        jnp.asarray(current), jnp.asarray(history),
        ref_taa.TaaParams(np.float32(0.9), np.float32(color_clamp),
                          np.float32(velocity_rejection), jitter, prev_jitter),
        velocity=jnp.asarray(velocity) if with_velocity else None)
    got = taa.taa_resolve(
        _t(current), _t(history),
        taa.TaaParams(0.9, color_clamp, velocity_rejection, jitter,
                      prev_jitter),
        velocity=_t(velocity) if with_velocity else None)
    if with_velocity:
        # Off-screen history: the current frame comes through unblended.
        np.testing.assert_array_equal(got.numpy()[:, :8], current[:, :8])
    _assert_close(got, want, f"taa_resolve velocity={with_velocity} "
                  f"clamp={color_clamp} rejection={velocity_rejection}")


def test_taa_resolve_first_frame_passes_the_current_frame():
    current, _, _ = _resolve_inputs()
    zero = np.zeros(2, np.float32)
    got = taa.taa_resolve(_t(current), torch.zeros(48, 64, 3),
                          taa.TaaParams(0.0, 1.0, 1.0, zero, zero))
    np.testing.assert_array_equal(got.numpy(), current)


# 192x128 at render_scale 0.5 and 0.7: internal 96x64 and 134x90.
@pytest.mark.parametrize("scale", [0.5, 0.7])
def test_taau_resize_matches_jax_image_resize(scale):
    w, h = frame.internal_render_size(192, 128, scale)
    assert (w, h) == {0.5: (96, 64), 0.7: (134, 90)}[scale]
    rng = np.random.default_rng(5)
    color = _hdr(6, h, w)
    velocity = rng.normal(0, 0.01, (h, w, 2)).astype(np.float32)
    depth = rng.random((h, w)).astype(np.float32)
    _assert_close(frame._resize(_t(color), 128, 192, "bilinear"),
                  jax.image.resize(jnp.asarray(color), (128, 192, 3),
                                   "bilinear"),
                  f"resize bilinear colour, scale {scale}")
    _assert_close(frame._resize(_t(velocity), 128, 192, "bilinear"),
                  jax.image.resize(jnp.asarray(velocity), (128, 192, 2),
                                   "bilinear"),
                  f"resize bilinear velocity, scale {scale}")
    np.testing.assert_array_equal(
        frame._resize(_t(depth), 128, 192, "nearest-exact").numpy(),
        np.asarray(jax.image.resize(jnp.asarray(depth), (128, 192),
                                    "nearest")))


def test_internal_render_size_matches_reference():
    from ash_tpu.render import frame as ref_frame

    for w, h, s in [(1920, 1080, 0.5), (1920, 1080, 0.75), (128, 96, 0.5),
                    (192, 128, 0.7), (40, 24, 0.25), (640, 480, 1.0)]:
        assert (frame.internal_render_size(w, h, s)
                == ref_frame.internal_render_size(w, h, s))


# ---------------------------------------------------------------------------
# Host copies, bit for bit
# ---------------------------------------------------------------------------


def test_halton_sequence_bit_for_bit():
    got, want = temporal_aa.HaltonSequence(), ref_temporal.HaltonSequence()
    jitters = []
    for _ in range(40):
        j = got.next_jitter()
        np.testing.assert_array_equal(j, want.next_jitter())
        assert j.dtype == np.float32
        jitters.append(j)
    # Index mod 16: the sequence repeats.
    np.testing.assert_array_equal(jitters[0], jitters[16])
    assert not np.array_equal(jitters[0], jitters[1])
    got.reset()
    np.testing.assert_array_equal(got.next_jitter(), jitters[0])


@pytest.mark.parametrize("kind", ["perspective", "orthographic"])
def test_jitter_projection_bit_for_bit(kind):
    proj = (maths.perspective_rh(np.deg2rad(60), 16 / 9, 0.1, 100.0)
            if kind == "perspective"
            else maths.orthographic_rh(-1, 1, -1, 1, 0.1, 10.0))
    got = temporal_aa.TemporalAA(temporal_aa.TaaConfig(jitter_scale=0.8))
    want = ref_temporal.TemporalAA(ref_temporal.TaaConfig(jitter_scale=0.8))
    for _ in range(5):
        got.begin_frame()
        want.begin_frame()
        pj = got.jitter_projection(proj, 1920, 1080)
        np.testing.assert_array_equal(
            pj, want.jitter_projection(proj, 1920, 1080))
        assert not np.array_equal(pj, proj)
        gp, wp = got.params(), want.params()
        assert gp.keys() == wp.keys()
        for k in gp:
            np.testing.assert_array_equal(gp[k], wp[k])
    # The shift in NDC is 2 * jitter / screen at every depth.
    expect = got.current_jitter * np.array([2.0 / 1920, 2.0 / 1080])
    for z in (-0.5, -5.0):
        v = np.array([0.3, -0.2, z, 1.0], np.float32)
        a, b = proj @ v, pj @ v
        np.testing.assert_allclose(b[:2] / b[3] - a[:2] / a[3], expect,
                                   atol=1e-6)
    got.reset_history()
    assert got.halton.index == 0 and not got.current_jitter.any()
    off = temporal_aa.TemporalAA(temporal_aa.TaaConfig(enabled=False))
    off.begin_frame()
    assert off.jitter_projection(proj, 64, 64) is proj and not off.is_enabled()


# ---------------------------------------------------------------------------
# Whole frames through both renderers
# ---------------------------------------------------------------------------


def _cube(render, core, w, h, color, scale=1.0, taa_on=True, **kw):
    surface = render.HeadlessSurface(w, h)
    r = render.Renderer(
        surface,
        render.RendererConfig(tile_h=8, tile_w=32, max_tris_per_tile=32,
                              shadows_enabled=False, render_scale=scale),
        **kw)
    r.set_mesh(core.Mesh.create_cube())
    r.set_material(core.Material(color=color, roughness=0.4))
    r.initialize_hdr()
    if taa_on:
        r.set_taa_enabled(True)
    return r, surface


def _pair(w, h, color, scale=1.0):
    return (_cube(port_render, port_core, w, h, color, scale, device="cpu"),
            _cube(ref_render, ref_core, w, h, color, scale))


def _assert_psnr(got, want, what):
    value = psnr(got, want)
    differing = int((np.asarray(got) != np.asarray(want)).any(-1).sum())
    print(f"measured {what}: PSNR {value:.2f} dB, {differing} pixels differ")
    assert value >= MIN_PSNR, f"{what}: PSNR {value:.2f} dB < {MIN_PSNR}"


def _args(core, eye, target, aspect):
    cam = core.Camera.new(eye, target, aspect)
    return cam.view_matrix(), cam.projection_matrix(), cam.position


def test_static_scene_takes_the_reference_jitters():
    (port, psurf), (ref, rsurf) = _pair(96, 64, (0.9, 0.4, 0.2, 1.0))
    for i in range(3):
        out = port.render_frame(*_args(port_core, [0, 0, 5], [0, 0, 0], 1.5))
        ref.render_frame(*_args(ref_core, [0, 0, 5], [0, 0, 0], 1.5))
        np.testing.assert_array_equal(port.temporal_aa.current_jitter,
                                      ref.temporal_aa.current_jitter)
        assert out.history is not None and out.history is port._taa_history
        _assert_psnr(psurf.read_back(), np.asarray(rsurf.read_back()),
                     f"static cube with TAA, frame {i + 1}")
    assert port.temporal_aa.halton.index == 3


def test_camera_motion_keeps_history_aligned():
    (port, psurf), (ref, rsurf) = _pair(96, 64, (0.9, 0.4, 0.2, 1.0))
    for i in range(8):
        eye, target = [0.04 * i, 0, 5], [0.04 * i, 0, 0]
        port.render_frame(*_args(port_core, eye, target, 1.5))
        ref.render_frame(*_args(ref_core, eye, target, 1.5))
    taa_img = psurf.read_back()
    _assert_psnr(taa_img, np.asarray(rsurf.read_back()),
                 "panning camera with TAA, frame 8")
    # Against the same final camera without TAA: no smearing.
    truth_r, truth_s = _cube(port_render, port_core, 96, 64,
                             (0.9, 0.4, 0.2, 1.0), taa_on=False, device="cpu")
    truth_r.render_frame(*_args(port_core, [0.28, 0, 5], [0.28, 0, 0], 1.5))
    err = np.abs(taa_img[..., :3].astype(np.float32)
                 - truth_s.read_back()[..., :3]).mean()
    assert err < 12.0, f"TAA under camera motion drifted: mean err {err}"


def test_object_motion_velocity():
    (port, psurf), (ref, rsurf) = _pair(96, 64, (0.9, 0.4, 0.2, 1.0))
    for i, x in enumerate((0.0, 0.4, 0.8)):
        port.transform.position = np.array([x, 0, 0], np.float32)
        ref.transform.position = np.array([x, 0, 0], np.float32)
        port.render_frame(*_args(port_core, [0, 0, 5], [0, 0, 0], 1.5))
        ref.render_frame(*_args(ref_core, [0, 0, 5], [0, 0, 0], 1.5))
        _assert_psnr(psurf.read_back(), np.asarray(rsurf.read_back()),
                     f"moving cube with TAA, frame {i + 1}")


def test_moving_mesh_has_velocity_at_its_pixels():
    port, _ = _cube(port_render, port_core, 96, 64, (0.9, 0.4, 0.2, 1.0),
                    device="cpu")
    args = _args(port_core, [0, 0, 5], [0, 0, 0], 1.5)
    port.render_frame(*args)
    port.transform.position = np.array([0.4, 0, 0], np.float32)
    inputs = port.prepare_frame(*args)
    band = frame.render_band(inputs.config, inputs.scene.buffers,
                             inputs.uniforms)
    covered = (band.depth < 1.0).numpy()
    vx = band.velocity.numpy()[..., 0]
    # 0.4 units to the right, seen from 4.5 (the front face) to 5.5 away.
    expect = 0.4 * float(args[1][0, 0]) / 2.0 / 5.0
    assert 0.8 * expect < float(vx[covered].mean()) < 1.25 * expect
    assert (vx[~covered] == 0).all()


@pytest.mark.parametrize("scale", [0.5, 0.7])
def test_taau_matches_reference_over_8_frames(scale):
    (port, psurf), (ref, rsurf) = _pair(128, 96, (0.8, 0.3, 0.2, 1.0), scale)
    for _ in range(8):
        out = port.render_frame(
            *_args(port_core, [2.6, 1.9, 3.6], [0, 0, 0], 128 / 96))
        rout = ref.render_frame(
            *_args(ref_core, [2.6, 1.9, 3.6], [0, 0, 0], 128 / 96))
    assert out.color.shape == (96, 128, 3) and out.depth.shape == (96, 128)
    assert psurf.read_back().shape == (96, 128, 4)
    assert int(out.covered_pixels) == int(rout.covered_pixels)
    _assert_close(out.color, rout.color, f"TAAU colour, scale {scale}",
                  atol=1e-4, rtol=1e-4)
    _assert_psnr(psurf.read_back(), np.asarray(rsurf.read_back()),
                 f"TAAU at scale {scale}, frame 8")


def _port_taau(scale, frames):
    r, _ = _cube(port_render, port_core, 128, 96, (0.8, 0.3, 0.2, 1.0), scale,
                 device="cpu")
    for _ in range(frames):
        out = r.render_frame(
            *_args(port_core, [2.6, 1.9, 3.6], [0, 0, 0], 128 / 96))
    return out.color.numpy()


def test_taau_converges_to_native():
    native = _port_taau(1.0, 8)
    value = psnr(_port_taau(0.5, 8), native)
    first = psnr(_port_taau(0.5, 1), native)
    print(f"measured TAAU against native: {value:.2f} dB after 8 frames, "
          f"{first:.2f} dB after 1")
    assert value >= 26.0, f"TAAU vs native PSNR {value:.1f} dB"
    assert psnr(_port_taau(0.5, 10), native) > first + 0.5


def test_render_scale_requires_taa():
    """Without the HDR chain and TAA the scale stays native."""
    surface = port_render.HeadlessSurface(64, 48)
    r = port_render.Renderer(
        surface,
        port_render.RendererConfig(tile_h=8, tile_w=32, max_tris_per_tile=32,
                                   shadows_enabled=False, render_scale=0.5),
        device="cpu")
    r.set_mesh(port_core.Mesh.create_cube())
    args = _args(port_core, [2.5, 2, 4], [0, 0, 0], 4 / 3)
    assert r.prepare_frame(*args).config.render_scale == 1.0
    out = r.render_frame(*args)
    assert out.color.shape == (48, 64, 3) and out.history is None
    assert int(out.covered_pixels) > 100


def test_render_scale_validation():
    r, _ = _cube(port_render, port_core, 64, 48, (1, 1, 1, 1), device="cpu")
    with pytest.raises(ValueError, match="render_scale"):
        r.set_render_scale(0.1)
    with pytest.raises(ValueError, match="render_scale"):
        frame.raster_size(frame.FrameConfig(width=64, height=48,
                                            render_scale=1.5))


def test_history_resets():
    """set_taa_enabled(False), reset_taa_history, set_render_scale and a
    resize drop the history; a changed draw count falls back to zero
    velocity."""
    r, surface = _cube(port_render, port_core, 64, 48, (0.8, 0.3, 0.2, 1.0),
                       device="cpu")
    args = _args(port_core, [2.5, 2, 4], [0, 0, 0], 4 / 3)

    def render():
        return r.render_frame(*args)

    render()
    assert r.prepare_frame(*args).taa_params.blend_factor == float(np.float32(0.9))
    r.set_taa_enabled(False)
    assert r._taa_history is None and render().history is None
    r.set_taa_enabled(True)
    assert r.prepare_frame(*args).taa_params.blend_factor == 0.0
    render()
    r.reset_taa_history()
    assert r._taa_history is None and r.temporal_aa.halton.index == 0
    render()
    r.set_render_scale(0.5)
    assert r._taa_history is None
    assert render().history.shape == (48, 64, 3)
    surface.resize(40, 24)
    assert render().history.shape == (24, 40, 3)
    assert r.temporal_aa.halton.index == 1  # the sequence began anew

    # A second draw: last frame's models have another shape.
    r.register_mesh_handle(0, port_core.Mesh.create_cube())
    r.submit_render_commands([
        port_render.RenderCommand(mesh=0, transform=np.eye(4, dtype=np.float32)),
        port_render.RenderCommand(
            mesh=0, transform=maths.mat4_translation([1.5, 0, 0])),
    ])
    inputs = r.prepare_frame(*args)
    assert inputs.uniforms.prev_models is inputs.uniforms.models
