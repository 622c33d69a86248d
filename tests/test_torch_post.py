"""The HDR post chain: ash_tpu_torch's tonemap, bloom and FXAA ops, the post
branch of finalize_frame and the renderer's post setters against ash_tpu on
the CPU.

Inputs are seeded HDR images with values in [0, 8). Tolerances (ROADMAP.md
section C has what was measured):

- the tonemap operators, `tonemap_compose`, `soft_threshold`,
  `downsample_karis`, `upsample_tent`, `bloom_pyramid` (even sizes, which
  take the slice path, and odd sizes, which take the gather path, among them
  the parities of a 1080-row pyramid), `bilinear_clamp` and `fxaa`:
  atol 1e-5 + rtol 1e-5;
- `shift_clamp`: equal;
- whole frames through both renderers (the emissive cube of
  tests/test_post.py, every tonemap operator, bloom off, FXAA on,
  `PostProcessingFeature.apply_to`): u8 PSNR >= 40 dB.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ash_tpu.core as ref_core
import ash_tpu.render as ref_render
import ash_tpu_torch.core as port_core
import ash_tpu_torch.render as port_render
from ash_tpu.ops import bloom as ref_bloom
from ash_tpu.ops import fxaa as ref_fxaa
from ash_tpu.ops import tonemap as ref_tonemap
from ash_tpu.render.features import post_processing as ref_post
from ash_tpu.utils.image import psnr
from ash_tpu_torch.ops import bloom, fxaa, tonemap
from ash_tpu_torch.render import features

torch.set_num_threads(1)

ATOL = 1e-5
RTOL = 1e-5
MIN_PSNR = 40.0


def _t(a):
    return torch.from_numpy(np.array(a))


def _hdr(seed, h, w, c=3, peak=8.0):
    """A seeded HDR image: mostly dim, a tenth of the pixels up to `peak`."""
    rng = np.random.default_rng(seed)
    img = rng.random((h, w, c)) * 0.9
    hot = rng.random((h, w, 1)) < 0.1
    return np.where(hot, img * peak / 0.9, img).astype(np.float32)


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


@pytest.mark.parametrize("operator", ["aces", "reinhard", "uncharted2", "none"])
def test_tonemap_operator(operator):
    x = _hdr(1, 48, 64)
    got = tonemap.OPERATORS[operator](_t(x))
    want = ref_tonemap._OPERATORS[operator](jnp.asarray(x))
    _assert_close(got, want, f"tonemap {operator}")


@pytest.mark.parametrize("operator", ["aces", "reinhard", "uncharted2", "none"])
@pytest.mark.parametrize("with_bloom", [False, True])
def test_tonemap_compose(operator, with_bloom):
    hdr = _hdr(2, 48, 64)
    glow = _hdr(3, 48, 64, peak=2.0) if with_bloom else None
    got = tonemap.tonemap_compose(
        _t(hdr), None if glow is None else _t(glow), 1.3, 2.2, 0.5, operator)
    want = ref_tonemap.tonemap_compose(
        jnp.asarray(hdr), None if glow is None else jnp.asarray(glow),
        np.float32(1.3), np.float32(2.2), np.float32(0.5), operator)
    _assert_close(got, want, f"tonemap_compose {operator} bloom={with_bloom}")


def test_tonemap_compose_rejects_unknown_operator():
    with pytest.raises(ValueError, match="operator"):
        tonemap.tonemap_compose(torch.zeros(2, 2, 3), None, 1.0, 2.2, 0.5, "x")


def test_soft_threshold():
    x = _hdr(4, 48, 64)
    got = bloom.soft_threshold(_t(x), 0.8, 0.5)
    want = ref_bloom.soft_threshold(jnp.asarray(x), 0.8, 0.5)
    _assert_close(got, want, "soft_threshold")


# Even sizes take the slice path, odd sizes the bilinear gather.
@pytest.mark.parametrize("h,w", [(48, 64), (2, 2), (135, 240), (67, 120),
                                 (48, 65), (3, 5)])
def test_downsample_karis(h, w):
    x = _hdr(5, h, w)
    got = bloom.downsample_karis(_t(x))
    want = ref_bloom.downsample_karis(jnp.asarray(x))
    _assert_close(got, want, f"downsample_karis {h}x{w}")


@pytest.mark.parametrize("h,w,dh,dw", [
    (24, 32, 48, 64),  # the 2x slice path
    (67, 120, 135, 240),  # odd target: the gather path
    (33, 60, 67, 120),
    (24, 32, 48, 65),
    (1, 1, 2, 2),
])
def test_upsample_tent(h, w, dh, dw):
    x = _hdr(6, h, w)
    got = bloom.upsample_tent(_t(x), dh, dw, 0.7)
    want = ref_bloom.upsample_tent(jnp.asarray(x), dh, dw, 0.7)
    _assert_close(got, want, f"upsample_tent {h}x{w} -> {dh}x{dw}")


# 128x192 halves evenly five times; 135x240 and 270x480 have the parities of
# a 1080-row pyramid's lower levels (1080, 540, 270, 135, 67, 33).
@pytest.mark.parametrize("h,w,mips", [(128, 192, 5), (135, 240, 2),
                                      (270, 480, 5), (64, 96, 1), (20, 12, 5)])
def test_bloom_pyramid(h, w, mips):
    x = _hdr(7, h, w)
    got = bloom.bloom_pyramid(_t(x), 0.8, 0.5, mips)
    want = ref_bloom.bloom_pyramid(jnp.asarray(x), 0.8, 0.5, mips)
    assert float(np.asarray(want).max()) > 0.1
    _assert_close(got, want, f"bloom_pyramid {h}x{w} mips={mips}")


def test_bilinear_clamp():
    img = _hdr(8, 37, 53)
    rng = np.random.default_rng(9)
    # Past both edges, so the clamp acts.
    u = rng.uniform(-0.1, 1.1, (40, 60)).astype(np.float32)
    v = rng.uniform(-0.1, 1.1, (40, 60)).astype(np.float32)
    got = bloom.bilinear_clamp(_t(img), _t(u), _t(v))
    want = ref_bloom.bilinear_clamp(jnp.asarray(img), jnp.asarray(u),
                                    jnp.asarray(v))
    _assert_close(got, want, "bilinear_clamp")


@pytest.mark.parametrize("oy,ox", [(0, 0), (1, 0), (0, -1), (-2, 3), (5, -4)])
def test_shift_clamp(oy, ox):
    img = _hdr(10, 9, 11)
    got = bloom.shift_clamp(_t(img), oy, ox)
    want = ref_bloom.shift_clamp(jnp.asarray(img), oy, ox)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    plane = _t(img[..., 0])
    np.testing.assert_array_equal(
        np.asarray(bloom.shift_clamp(plane, oy, ox)),
        np.asarray(ref_bloom.shift_clamp(jnp.asarray(img[..., 0]), oy, ox)))


@pytest.mark.parametrize("h,w", [(48, 64), (37, 53)])
def test_fxaa(h, w):
    rng = np.random.default_rng(11)
    # An LDR image with hard edges: blocks of flat colour plus a little noise.
    blocks = rng.random((h // 6 + 1, w // 6 + 1, 3))
    img = np.kron(blocks, np.ones((6, 6, 1)))[:h, :w]
    img = np.clip(img + rng.normal(0, 0.01, img.shape), 0, 1).astype(np.float32)
    got = fxaa.fxaa(_t(img))
    want = ref_fxaa.fxaa(jnp.asarray(img))
    assert float(np.abs(np.asarray(want) - img).max()) > 0.05  # it acts
    _assert_close(got, want, f"fxaa {h}x{w}")


# ---------------------------------------------------------------------------
# Whole frames through both renderers
# ---------------------------------------------------------------------------


def _emissive_cube(render, core, **kw):
    """tests/test_post.py's scene: an emissive cube, no shadows."""
    surface = render.HeadlessSurface(96, 64)
    cfg = render.RendererConfig(tile_h=8, tile_w=32, max_tris_per_tile=32,
                                shadows_enabled=False)
    r = render.Renderer(surface, cfg, **kw)
    r.set_mesh(core.Mesh.create_cube())
    r.set_material(core.Material(color=(1.0, 0.3, 0.1, 1.0),
                                 emissive=(4.0, 2.0, 0.5, 1.0)))
    cam = core.Camera.new([0, 1.5, 5], [0, 0, 0], 96 / 64)
    return r, surface, (cam.view_matrix(), cam.projection_matrix(),
                        cam.position)


def _both(setup, frames=1):
    """Render `frames` frames on the port and on the reference after
    setup(renderer) -> (port renderer, port outputs, port image, reference
    image)."""
    port, psurf, pcam = _emissive_cube(port_render, port_core, device="cpu")
    ref, rsurf, rcam = _emissive_cube(ref_render, ref_core)
    out = None
    for r, cam in ((port, pcam), (ref, rcam)):
        setup(r)
        for _ in range(frames):
            o = r.render_frame(*cam)
        out = out or o
    return port, out, psurf.read_back(), np.asarray(rsurf.read_back())


def _assert_psnr(got, want, what):
    value = psnr(got, want)
    differing = int((got != want).any(-1).sum())
    print(f"measured {what}: PSNR {value:.2f} dB, {differing} pixels differ")
    assert value >= MIN_PSNR, f"{what}: PSNR {value:.2f} dB < {MIN_PSNR}"


def test_e2e_hdr_post_chain():
    """HDR render + bloom + ACES + TAA over 3 frames."""
    def setup(r):
        r.initialize_hdr()
        r.set_taa_enabled(True)

    port, out, img, ref_img = _both(setup, frames=3)
    assert img.shape == (64, 96, 4)
    assert img[32, 48][0] > 150, "the emissive cube should be bright"
    background = (out.depth == 1.0).numpy()
    assert (img[..., :3].sum(-1)[background] > 10).any(), \
        "bloom should leak onto the background"
    assert port._taa_history is not None
    _assert_psnr(img, ref_img, "emissive cube, bloom + ACES + TAA, 3 frames")


@pytest.mark.parametrize("operator", ["aces", "reinhard", "uncharted2"])
def test_tonemap_operators_through_the_renderer(operator):
    def setup(r):
        r.initialize_hdr()
        r.set_tonemapping_operator(operator)
        r.set_tonemapping_exposure(0.8)
        r.set_tonemapping_gamma(2.0)
        r.set_bloom_intensity(0.9)
        r.set_bloom_threshold(0.6)

    _, _, img, ref_img = _both(setup)
    _assert_psnr(img, ref_img, f"emissive cube, {operator}")


def test_post_switches_through_the_renderer():
    """Tonemapping off (a clamp), bloom off, FXAA on."""
    def setup(r):
        r.initialize_hdr()
        r.set_tonemapping_enabled(False)
        r.set_bloom_enabled(False)
        r.set_fxaa_enabled(True)

    port, _, img, ref_img = _both(setup)
    cfg = port.prepare_frame(np.eye(4), np.eye(4), np.zeros(3)).config
    assert cfg.tonemap_operator == "none" and not cfg.bloom_enabled
    assert cfg.fxaa_enabled and cfg.post_enabled
    _assert_psnr(img, ref_img, "emissive cube, clamp + FXAA")


def test_fxaa_without_the_post_chain():
    """FXAA also runs on the sRGB-encoded image of the plain frame."""
    _, _, plain, _ = _both(lambda r: None)
    _, _, img, ref_img = _both(lambda r: r.set_fxaa_enabled(True))
    assert not np.array_equal(img, plain)
    _assert_psnr(img, ref_img, "emissive cube, FXAA on the plain frame")


def test_post_processing_feature_applies_to_both():
    config = dict(enable_bloom=False, enable_fxaa=True,
                  enable_tonemapping=True, exposure=1.4, gamma=1.8)

    def setup(r):
        mod = features if isinstance(r, port_render.Renderer) else ref_post
        mod.PostProcessingFeature(
            mod.PostProcessingConfig(**config)).apply_to(r)

    port, _, img, ref_img = _both(setup)
    assert port.hdr_enabled and port.fxaa_enabled
    assert not port.bloom_enabled_flag
    assert port.tonemapping_exposure == 1.4 and port.tonemapping_gamma == 1.8
    _assert_psnr(img, ref_img, "emissive cube, PostProcessingFeature")


def test_post_setters_clamp_like_the_reference():
    port, _, _ = _emissive_cube(port_render, port_core, device="cpu")
    ref, _, _ = _emissive_cube(ref_render, ref_core)
    for r in (port, ref):
        r.set_tonemapping_exposure(-1.0)
        r.set_tonemapping_gamma(0.0)
        r.set_bloom_intensity(5.0)
    assert (port.tonemapping_exposure, port.tonemapping_gamma,
            port.bloom_intensity) == (ref.tonemapping_exposure,
                                      ref.tonemapping_gamma,
                                      ref.bloom_intensity) == (0.0, 0.1, 2.0)


def test_feature_configs_match_the_reference_defaults():
    from ash_tpu.render.features import bloom as ref_bloom_f
    from ash_tpu.render.features import tonemapping as ref_tm_f
    import dataclasses

    assert (dataclasses.asdict(features.BloomConfig())
            == dataclasses.asdict(ref_bloom_f.BloomConfig()))
    assert (dataclasses.asdict(features.PostProcessingConfig())
            == dataclasses.asdict(ref_post.PostProcessingConfig()))
    got, want = features.TonemappingConfig(), ref_tm_f.TonemappingConfig()
    assert (got.operator.value, got.exposure, got.gamma, got.enabled) == (
        want.operator.value, want.exposure, want.gamma, want.enabled)
    assert ([o.value for o in features.TonemapOperator]
            == [o.value for o in ref_tm_f.TonemapOperator])
    feature = features.BloomFeature()
    feature.set_enabled(False)
    assert not feature.config.enabled
