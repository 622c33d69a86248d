"""MSAA: ash_tpu_torch.ops.msaa_edge, the explicit coordinates of
interpolate_gbuffer and shade_pbr, and the supersampled frames against
ash_tpu on the CPU.

- msaa_edge's integer outputs (capacity, primary triangle, uniform mask,
  worklist slots, sample ids and coordinates, the edge count) are equal;
  `resolve` agrees to atol 1e-6 (a mean of up to 8 floats).
- interpolate_gbuffer(pixel_xy=, deriv_step=) and shade_pbr(pixel_xy=), fed
  the reference's own inputs: atol 1e-5, the earlier slices' bar
  (tests/test_torch_shade.py).
- Whole frames (the scenes of tests/test_edge_msaa.py and
  tests/test_post.py): u8 images at PSNR >= 40 dB against the reference,
  msaa_edge_overflow equal; the port's own edge frame against its SSAA
  frame at >= 40 dB, the reference test's bar.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ash_tpu.core as ref_core
import ash_tpu.render as ref_render
import ash_tpu_torch.core as port_core
import ash_tpu_torch.render as port_render
from ash_tpu.ops import msaa_edge as ref_msaa
from ash_tpu.ops import shade as ref_shade
from ash_tpu.render.csm import CsmConfig as RefCsmConfig
from ash_tpu_torch.ops import geometry, msaa_edge, shade
from ash_tpu_torch.render import frame
from ash_tpu_torch.render.csm import CsmConfig
from ash_tpu_torch.utils.image import psnr

from test_torch_shade import (  # noqa: F401  (the fixture)
    H,
    W,
    _assert_gbuffers_match,
    _nt,
    _t,
    _uniforms,
    ref_frame,
)

torch.set_num_threads(1)

ATOL = 1e-5
MIN_PSNR = 40.0


# -- ops/msaa_edge.py --------------------------------------------------------

@pytest.mark.parametrize("n_pixels", [4, 1000, 4096, 1920 * 1080])
@pytest.mark.parametrize("fraction", [1e-9, 0.125, 0.5, 1.0])
@pytest.mark.parametrize("samples", [1, 2, 3, 4, 6, 8, 12])
def test_edge_capacity_equals_the_reference(n_pixels, fraction, samples):
    assert (msaa_edge.edge_capacity(n_pixels, fraction, samples)
            == ref_msaa.edge_capacity(n_pixels, fraction, samples))


def _sample_buffers(seed, hp, wp, sy, sx):
    """Seeded sample-rate buffers: blocks of one triangle with edges
    through them, background, and depth ties within a pixel."""
    rng = np.random.default_rng(seed)
    tid = rng.integers(-1, 6, (hp, wp)).repeat(sy, 0).repeat(sx, 1)
    flip = rng.random(tid.shape) < 0.15
    tid = np.where(flip, rng.integers(-1, 6, tid.shape), tid).astype(np.int32)
    depth = rng.choice(np.float32([0.25, 0.5, 0.75]), tid.shape)
    depth = np.where(tid < 0, np.float32(1.0), depth).astype(np.float32)
    return tid, depth


SHAPES = [(6, 10, 2, 1), (6, 10, 2, 2), (5, 7, 2, 4), (4, 9, 1, 3),
          (32, 40, 2, 2)]


@pytest.mark.parametrize("hp,wp,sy,sx", SHAPES)
def test_classify_equals_the_reference(hp, wp, sy, sx):
    tid, depth = _sample_buffers(1, hp, wp, sy, sx)
    want = ref_msaa.classify(jnp.asarray(tid), jnp.asarray(depth), sy, sx)
    got = msaa_edge.classify(_t(tid), _t(depth), sy, sx)
    for field in msaa_edge.EdgePlan._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    assert 0 < int(got.uniform.sum()) < hp * wp


@pytest.mark.parametrize("hp,wp,sy,sx", SHAPES)
def test_center_coordinates_equal_the_reference(hp, wp, sy, sx):
    got = msaa_edge.center_pixel_xy(hp, wp, sy, sx, 7, "cpu")
    want = ref_msaa.center_pixel_xy(hp, wp, sy, sx, 7)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    got = msaa_edge.center_tile_xy(hp, wp, sy, sx, "cpu")
    want = ref_msaa.center_tile_xy(hp, wp, sy, sx)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("hp,wp,sy,sx", SHAPES)
@pytest.mark.parametrize("fraction", [1.0, 0.125, 1e-9])
def test_worklist_equals_the_reference(hp, wp, sy, sx, fraction):
    """The reference's (cap*S/128, 128) rows are the port's (cap, S) rows
    flattened; a capacity of 1e-9 overflows where the rounding unit is
    below the edge count."""
    tid, depth = _sample_buffers(2, hp, wp, sy, sx)
    s = sy * sx
    cap = msaa_edge.edge_capacity(hp * wp, fraction, s)
    want = ref_msaa.build_worklist(
        jnp.asarray(tid),
        ref_msaa.classify(jnp.asarray(tid), jnp.asarray(depth), sy, sx),
        cap, sy, sx, y0r=16)
    got = msaa_edge.build_worklist(
        _t(tid), msaa_edge.classify(_t(tid), _t(depth), sy, sx), cap, sy, sx,
        y0r=16)
    for field in msaa_edge.EdgeWorklist._fields:
        w = np.asarray(getattr(want, field))
        g = getattr(got, field).numpy()
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g.reshape(-1), w.reshape(-1),
                                      err_msg=field)
    assert got.tid.shape == (cap, s)
    if fraction < 1e-3 and hp * wp > 1000:
        assert int(got.n_edge) > cap


@pytest.mark.parametrize("hp,wp,sy,sx", SHAPES)
def test_resolve_matches_the_reference(hp, wp, sy, sx):
    tid, depth = _sample_buffers(3, hp, wp, sy, sx)
    s = sy * sx
    cap = msaa_edge.edge_capacity(hp * wp, 0.25, s)
    rng = np.random.default_rng(4)
    center = rng.random((hp, wp, 3)).astype(np.float32)
    samples = rng.random((cap, s, 3)).astype(np.float32)
    wl_ref = ref_msaa.build_worklist(
        jnp.asarray(tid),
        ref_msaa.classify(jnp.asarray(tid), jnp.asarray(depth), sy, sx),
        cap, sy, sx)
    want = ref_msaa.resolve(jnp.asarray(center),
                            jnp.asarray(samples).reshape(-1, 128, 3), wl_ref,
                            s)
    wl = msaa_edge.build_worklist(
        _t(tid), msaa_edge.classify(_t(tid), _t(depth), sy, sx), cap, sy, sx)
    got = msaa_edge.resolve(_t(center), _t(samples), wl, s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    assert int((got.numpy() != center).any(-1).sum()) > 0


# -- explicit coordinates in ops/shade.py ------------------------------------

def _edge_inputs(f, sy, sx):
    """The reference frame's vis buffer read as sample rate (sy, sx): its
    classification, centre coordinates and worklist, in both packages."""
    tid = np.asarray(f["vis"].tri_id)
    depth = np.asarray(f["vis"].depth)
    hp, wp = H // sy, W // sx
    plan_r = ref_msaa.classify(jnp.asarray(tid), jnp.asarray(depth), sy, sx)
    plan_p = msaa_edge.classify(_t(tid), _t(depth), sy, sx)
    cap = msaa_edge.edge_capacity(hp * wp, 0.5, sy * sx)
    wl_r = ref_msaa.build_worklist(jnp.asarray(tid), plan_r, cap, sy, sx)
    wl_p = msaa_edge.build_worklist(_t(tid), plan_p, cap, sy, sx)
    return hp, wp, plan_r, plan_p, wl_r, wl_p


def _as_port(ref_g, shape):
    """The reference's G-buffer in the port's layout: each field reshaped
    to `shape` (the worklist's (cap, S)) plus its channels."""
    fields = []
    for name in shade.GBuffer._fields:
        v = getattr(ref_g, name)
        if v is not None:
            v = _t(v)
            v = v.reshape(tuple(shape) + tuple(v.shape[2:]))
        fields.append(v)
    return shade.GBuffer(*fields)


def _gbuffers(f, ref_tid, port_tid, pixel_xy, deriv_step=(1.0, 1.0)):
    ref = ref_shade.interpolate_gbuffer(
        ref_tid, f["setup"], jnp.asarray(f["tri_v"]),
        jnp.asarray(f["tri_draw"]), f["tv"], jnp.asarray(f["uv"]),
        jnp.asarray(f["color"]), vert_uid=jnp.asarray(f["vert_uid"]),
        fb_height=H, fb_width=W, pixel_xy=pixel_xy[0],
        deriv_step=deriv_step)
    got = shade.interpolate_gbuffer(
        port_tid, _nt(geometry.TriangleSetup, f["setup"]), _t(f["tri_v"]),
        _t(f["tri_draw"]), _nt(geometry.TransformedVerts, f["tv"]),
        _t(f["uv"]), _t(f["color"]), vert_uid=_t(f["vert_uid"]),
        fb_height=H, fb_width=W, pixel_xy=pixel_xy[1],
        deriv_step=deriv_step)
    return ref, got


@pytest.mark.parametrize("sy,sx", [(1, 2), (2, 2), (2, 4)])
def test_interpolate_gbuffer_at_explicit_coordinates(ref_frame, sy, sx):
    """The centre G-buffer (pixel centres, derivatives stepping a pixel)
    and the worklist's (sample centres, one row per edge pixel)."""
    f = ref_frame
    hp, wp, plan_r, plan_p, wl_r, wl_p = _edge_inputs(f, sy, sx)
    ref, got = _gbuffers(
        f, plan_r.primary_tid, plan_p.primary_tid,
        (ref_msaa.center_pixel_xy(hp, wp, sy, sx, 0),
         msaa_edge.center_pixel_xy(hp, wp, sy, sx, 0, "cpu")),
        deriv_step=(float(sx), float(sy)))
    assert int(got.mask.sum()) > 100
    _assert_gbuffers_match(got, ref)
    # The derivative step is the footprint's: one render pixel is smaller.
    _, unit = _gbuffers(
        f, plan_r.primary_tid, plan_p.primary_tid,
        (ref_msaa.center_pixel_xy(hp, wp, sy, sx, 0),
         msaa_edge.center_pixel_xy(hp, wp, sy, sx, 0, "cpu")))
    m = got.mask
    assert (got.uv_ddx[m].abs().sum() > unit.uv_ddx[m].abs().sum())
    ref_e, got_e = _gbuffers(f, wl_r.tid, wl_p.tid,
                             ((wl_r.px, wl_r.py), (wl_p.px, wl_p.py)))
    for field in shade.GBuffer._fields:
        want = getattr(ref_e, field)
        if want is None:
            assert getattr(got_e, field) is None
            continue
        want = np.asarray(want)
        have = getattr(got_e, field).numpy().reshape(want.shape)
        np.testing.assert_allclose(have, want, atol=ATOL, rtol=0,
                                   err_msg=field)


def _lights(rng, n=24):
    """Packed GpuLight rows: point and spot lights around the cubes."""
    rows = np.zeros((n, 16), np.float32)
    rows[:, 0:3] = rng.uniform(-2.5, 2.5, (n, 3))
    rows[:, 3] = rng.uniform(1.0, 4.0, n)
    rows[:, 4:7] = rng.uniform(0.2, 1.0, (n, 3))
    rows[:, 7] = rng.uniform(1.0, 4.0, n)
    d = rng.normal(size=(n, 3))
    rows[:, 8:11] = d / np.linalg.norm(d, axis=-1, keepdims=True)
    rows[:, 11] = rng.integers(0, 2, n)
    rows[:, 12] = 0.3
    rows[:, 13] = 0.6
    return rows


@pytest.mark.parametrize("sy,sx", [(2, 2), (2, 4)])
def test_shade_pbr_tile_lookup_at_explicit_coordinates(ref_frame, sy, sx):
    """The Forward+ lookup of the centre G-buffer and of the worklist by
    explicit band-local render coordinates, over a random tile-light
    table, with a shadow map."""
    f = ref_frame
    hp, wp, plan_r, plan_p, wl_r, wl_p = _edge_inputs(f, sy, sx)
    rng = np.random.default_rng(5)
    lights = _lights(rng)
    tile = 8
    ty, tx = -(-H // tile), -(-W // tile)
    idx = rng.integers(-1, lights.shape[0], (ty, tx, 6)).astype(np.int32)
    counts = (idx >= 0).sum(-1).astype(np.int32)
    cases = [
        (plan_r.primary_tid, plan_p.primary_tid,
         (ref_msaa.center_pixel_xy(hp, wp, sy, sx, 0),
          msaa_edge.center_pixel_xy(hp, wp, sy, sx, 0, "cpu")),
         (ref_msaa.center_tile_xy(hp, wp, sy, sx),
          msaa_edge.center_tile_xy(hp, wp, sy, sx, "cpu"))),
        (wl_r.tid, wl_p.tid, ((wl_r.px, wl_r.py), (wl_p.px, wl_p.py)),
         ((wl_r.tile_px, wl_r.tile_py), (wl_p.tile_px, wl_p.tile_py))),
    ]
    for ref_tid, port_tid, xy, tile_xy in cases:
        ref_g, got_g = _gbuffers(f, ref_tid, port_tid, xy)
        want = ref_shade.shade_pbr(
            ref_g, jnp.asarray(f["mats"]),
            _uniforms(ref_shade.ShadeUniforms, f),
            shadow_map=jnp.asarray(f["smap"]), lights=jnp.asarray(lights),
            tile_light_indices=jnp.asarray(idx),
            tile_light_counts=jnp.asarray(counts), light_tile_size=tile,
            pixel_xy=tile_xy[0])
        port_g = _as_port(ref_g, port_tid.shape)
        got = shade.shade_pbr(
            port_g, _t(f["mats"]),
            _uniforms(shade.ShadeUniforms, f), shadow_map=_t(f["smap"]),
            lights=_t(lights), tile_light_indices=_t(idx),
            tile_light_counts=_t(counts), light_tile_size=tile,
            pixel_xy=tile_xy[1])
        np.testing.assert_allclose(got.numpy().reshape(np.shape(want)),
                                   np.asarray(want), atol=ATOL, rtol=0)
        # The explicit lookup matters: the grid's own would read other
        # tiles' lights.
        grid = shade.shade_pbr(
            port_g, _t(f["mats"]),
            _uniforms(shade.ShadeUniforms, f), shadow_map=_t(f["smap"]),
            lights=_t(lights), tile_light_indices=_t(idx),
            tile_light_counts=_t(counts), light_tile_size=tile)
        assert (grid - got).abs().max() > 1e-3


# -- whole frames ------------------------------------------------------------

def _textured_cube(core):
    """A cube with all five maps: seeded noise for the base colour,
    normal, metallic-roughness and occlusion maps, a checker for the
    emissive one."""
    rng = np.random.default_rng(31)
    mesh = core.Mesh.create_named_cube("MapsCube")
    for attr in ("texture_data", "normal_texture_data",
                 "metallic_roughness_texture_data",
                 "occlusion_texture_data"):
        px = rng.integers(0, 256, (32, 32, 4)).astype(np.uint8)
        px[..., 3] = 255
        setattr(mesh, attr, core.TextureData(32, 32, px))
    mesh.emissive_texture_data = core.TextureData.checkerboard(32, 4)
    return mesh


def _render(render, core, mode, preset, size=64, lights=False, extra=None,
            hdr=False, frames=1, textured=False, **kw):
    """tests/test_edge_msaa.py's scene: a cube at 64x64, 8x32 tiles, no
    shadows unless `extra` turns them on; textured=True maps all five
    textures onto it."""
    cfg = dict(tile_h=8, tile_w=32, max_tris_per_tile=64,
               shadows_enabled=False, msaa_resolve=mode)
    cfg.update(extra or {})
    r = render.Renderer(render.HeadlessSurface(size, size),
                        render.RendererConfig(**cfg), **kw)
    r.set_mesh(_textured_cube(core) if textured else core.Mesh.create_cube())
    r.set_msaa_preset(preset)
    if lights:
        r.add_point_light([1.5, 1.5, 3.0], color=(3, 1, 0), intensity=5.0,
                          radius=12.0)
    if hdr:
        r.initialize_hdr()
        r.set_taa_enabled(True)
    cam = core.Camera.new([3, 2, 4], [0, 0, 0], 1.0)
    for _ in range(frames):
        out = r.render_frame(cam.view_matrix(), cam.projection_matrix(),
                             cam.position)
    return np.asarray(r.surface.read_back()), out


def _csm(core_csm):
    return {"shadows_enabled": True, "shadow_resolution": 256,
            "csm": core_csm(cascade_count=2, resolution=256),
            "shadow_distance": 20.0}


FRAMES = {
    # name: (mode, preset, lights, extra for (reference, port), hdr)
    "ssaa x2": ("ssaa", "x2", False, None, False),
    "ssaa x4": ("ssaa", "x4", False, None, False),
    "ssaa x8": ("ssaa", "x8", False, None, False),
    "edge x2": ("edge", "x2", False, None, False),
    "edge x4": ("edge", "x4", False, None, False),
    "edge x8": ("edge", "x8", False, None, False),
    "ssaa x4 lights": ("ssaa", "x4", True, None, False),
    "edge x4 lights": ("edge", "x4", True, None, False),
    "ssaa x4 csm": ("ssaa", "x4", False, "csm", False),
    "edge x4 csm": ("edge", "x4", False, "csm", False),
    "edge x4 capacity 1e-9": ("edge", "x4", False,
                              {"msaa_edge_capacity": 1e-9}, False),
    "edge x4 hdr taa": ("edge", "x4", False, None, True),
    "ssaa x4 textured": ("ssaa", "x4", False, "textured", False),
    "edge x4 textured": ("edge", "x4", False, "textured", False),
    "edge x8 textured": ("edge", "x8", False, "textured", False),
}


def _extra(extra, ref):
    if extra == "csm":
        return _csm(RefCsmConfig if ref else CsmConfig)
    return None if extra == "textured" else extra


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_msaa_frame_matches_the_reference(name):
    mode, preset, lights, extra, hdr = FRAMES[name]
    kw = dict(lights=lights, hdr=hdr, frames=2 if hdr else 1,
              textured=extra == "textured")
    got, out = _render(port_render, port_core, mode, preset,
                       extra=_extra(extra, False), device="cpu", **kw)
    want, ref_out = _render(ref_render, ref_core, mode, preset,
                            extra=_extra(extra, True), **kw)
    value = psnr(got, want)
    print(f"measured {name}: PSNR {value:.2f} dB, "
          f"{int((got != want).any(-1).sum())} pixels differ")
    assert value >= MIN_PSNR, f"{name}: {value:.2f} dB"
    assert out.depth.shape == (64, 64) and out.color.shape == (64, 64, 3)
    if mode == "edge":
        assert int(out.msaa_edge_overflow) == int(ref_out.msaa_edge_overflow)
        assert (int(out.msaa_edge_overflow) > 0) == isinstance(extra, dict)
    else:
        assert out.msaa_edge_overflow is None


@pytest.mark.parametrize("preset,lights,extra", [
    ("x2", False, None), ("x4", True, None), ("x8", False, None),
    ("x4", False, "csm")])
def test_edge_frame_matches_its_ssaa_frame(preset, lights, extra):
    """The port's edge resolve against its own SSAA frame: edge pixels
    shade the same samples, interior pixels shade at their centre."""
    kw = dict(lights=lights, extra=_extra(extra, False), device="cpu",
              textured=extra == "textured")
    ssaa, _ = _render(port_render, port_core, "ssaa", preset, **kw)
    edge, out = _render(port_render, port_core, "edge", preset, **kw)
    assert int(out.msaa_edge_overflow) == 0
    assert psnr(edge, ssaa) >= MIN_PSNR, psnr(edge, ssaa)


def test_edge_overflow_degrades_to_center_shading():
    ssaa, _ = _render(port_render, port_core, "ssaa", "x4", device="cpu")
    edge, out = _render(port_render, port_core, "edge", "x4", device="cpu",
                        extra={"msaa_edge_capacity": 1e-9})
    assert int(out.msaa_edge_overflow) > 0
    assert np.isfinite(out.color.numpy()).all()
    assert psnr(edge, ssaa) >= 25.0


def _post_scene(render, core, preset, **kw):
    """tests/test_post.py's MSAA scene: a cube at 48x48."""
    surface = render.HeadlessSurface(48, 48)
    r = render.Renderer(surface, render.RendererConfig(
        tile_h=8, tile_w=32, max_tris_per_tile=32, shadows_enabled=False),
        **kw)
    r.set_mesh(core.Mesh.create_cube())
    r.set_msaa_preset(preset)
    cam = core.Camera.new([3, 2, 4], [0, 0, 0], 1.0)
    out = r.render_frame(cam.view_matrix(), cam.projection_matrix(),
                         cam.position)
    return np.asarray(surface.read_back()), out


@pytest.mark.parametrize("preset", ["x2", "x4", "x8"])
def test_post_msaa_scene_matches_the_reference(preset):
    got, out = _post_scene(port_render, port_core, preset, device="cpu")
    want, _ = _post_scene(ref_render, ref_core, preset)
    assert got.shape == (48, 48, 4) and out.depth.shape == (48, 48)
    assert psnr(got, want) >= MIN_PSNR
    if preset == "x4":  # the reference test's check: edges antialiased
        assert len(np.unique(got[..., 0])) > 10


def test_msaa_raster_runs_at_the_sample_rate(monkeypatch):
    """x8 rasters 4x2 samples a pixel, and the light grid with it."""
    sizes = []
    raster = frame.rasterize
    monkeypatch.setattr(frame, "rasterize", lambda s, b, h, w, *a, **k: (
        sizes.append((w, h)) or raster(s, b, h, w, *a, **k)))
    _render(port_render, port_core, "ssaa", "x8", size=32, device="cpu")
    assert sizes == [(128, 64)]


def test_msaa_presets_are_the_references():
    assert port_render.MsaaPreset.SCALE == ref_render.MsaaPreset.SCALE
    r = port_render.Renderer(port_render.HeadlessSurface(16, 16),
                             device="cpu")
    assert r.msaa_preset() == "off"
    r.set_msaa_preset("x8")
    assert r.msaa_preset() == "x8"
    with pytest.raises(ValueError, match="preset"):
        r.set_msaa_preset("x16")


@pytest.mark.parametrize("cfg,match", [
    (dict(ssaa_x=2, msaa_resolve="edge", shading="flat"), "pbr"),
    (dict(ssaa_x=2, msaa_resolve="edge", alpha_blend=True), "blend"),
    (dict(ssaa_x=2, render_scale=0.5), "exclusive with SSAA"),
    (dict(ssaa_x=2, msaa_resolve="box"), "msaa_resolve"),
])
def test_invalid_msaa_configs_raise(cfg, match):
    with pytest.raises(ValueError, match=match):
        frame.edge_msaa(frame.FrameConfig(width=16, height=16, **cfg))
        frame.raster_size(frame.FrameConfig(width=16, height=16, **cfg))
