"""Chunked geometry (the rest of A16) on ash_tpu_torch, on the CPU.

A draw list longer than RendererConfig.max_draws_per_chunk renders in
groups of that many draws, depth-composited: for opaque geometry exactly
the winner the unchunked depth test picks. The cases of
tests/test_chunked.py on the port's renderer, each chunked frame against
the port's unchunked frame of the same draws: the pixelwise match with the
shadow map reused, the auto-fitted shadow volume (the union of the chunks'
boxes) through a transform update, update_transforms, the refusals, and the
chunks that share one scene's buffers. The reference's
test_chunked_presents_scaled_during_async_resize is left out:
`Renderer._present_scale` is on ROADMAP.md's "Not ported" list (the port
adopts a new extent on the next frame). Beside them: the refusals' messages
against the reference's, update_material, TRS updates, a resubmit, TAA,
the alpha test with textures, example 10's chunking, and the chunked
renderer against ash_tpu's chunked renderer on commands(11, seed=1).

Tolerances: inside the port, chunked frames equal unchunked ones bit for
bit (u8 image; scalars where the test names them). Against ash_tpu (eager
torch against XLA programs that contract a*b + c into FMA): the u8 image
within 1 LSB, the reference tests' bar (-s prints the measured numbers).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import ash_tpu.core as ref_core
import ash_tpu.render as ref_render
from ash_tpu.errors import InvalidOperation as RefInvalidOperation
from ash_tpu_torch import Material, Mesh
from ash_tpu_torch.core.transform import Camera
from ash_tpu_torch.errors import InvalidOperation
from ash_tpu_torch.render import (
    HeadlessSurface,
    RenderCommand,
    Renderer,
    RendererConfig,
    bench_scene,
)
from ash_tpu_torch.render.csm import CsmConfig

torch.set_num_threads(1)

W, H = 128, 96
CFG = dict(tile_h=8, tile_w=32, max_tris_per_tile=128, shadow_resolution=64,
           shadow_tile=64, shadow_max_tris_per_tile=128)


def make_renderer(pin_bounds=True, port=True, **kw):
    """The reference test's renderer: one cube mesh, two materials."""
    mod = (Mesh, Material, Renderer, RendererConfig, HeadlessSurface) if port \
        else (ref_core.Mesh, ref_core.Material, ref_render.Renderer,
              ref_render.RendererConfig, ref_render.HeadlessSurface)
    mesh, material, renderer, config, surface = mod
    extra = {"device": "cpu"} if port else {}
    r = renderer(surface(W, H), config(**CFG, **kw), **extra)
    r.register_mesh_handle(0, mesh.create_cube())
    r.register_material_handle(1, material(color=(0.7, 0.4, 0.2, 1.0)))
    r.register_material_handle(2, material(color=(0.2, 0.5, 0.8, 1.0)))
    if pin_bounds:
        r.shadow_feature.set_scene_bounds([0, 0, 0], 10.0)
    return r


def commands(n, seed=0, command=RenderCommand):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] *= 0.5
        m[:3, 3] = ((rng.random(3) - 0.5) * 7.0).astype(np.float32)
        out.append(command(mesh=0, transform=m, material=1 + i % 2))
    return out


def _camera(camera=Camera):
    return camera.new([6.0, 5.0, 8.0], [0, 0, 0], W / H)


def render(r, camera=Camera):
    cam = _camera(camera)
    return np.asarray(r.render_frame(cam.view_matrix(),
                                     cam.projection_matrix(),
                                     cam.position).image)


def pair(cmds, pin_bounds=True, chunk=4, **kw):
    """(chunked, unchunked) port renderers with `cmds` submitted."""
    out = []
    for c in (chunk, None):
        r = make_renderer(pin_bounds, max_draws_per_chunk=c, **kw)
        r.submit_render_commands(cmds)
        out.append(r)
    return out


def test_chunked_matches_unchunked_pixelwise():
    r_ch, r_ref = pair(commands(11, seed=1))
    ref = render(r_ref)
    img = render(r_ch)
    assert r_ch._chunk_scenes is not None and len(r_ch._chunk_scenes) == 3
    assert r_ch._scene is None
    np.testing.assert_array_equal(img, ref)
    assert (int(r_ch.last_outputs().shadow_overflow)
            == int(r_ref.last_outputs().shadow_overflow))
    # Frame 2: the chunk scenes and the merged shadow map are reused.
    map1 = r_ch._shadow_cache[1]
    epoch = r_ch._scene_epoch
    np.testing.assert_array_equal(render(r_ch), ref)
    assert r_ch._shadow_cache[1] is map1 and r_ch._scene_epoch == epoch
    torch.testing.assert_close(map1, r_ref.last_outputs().shadow_map,
                               rtol=0, atol=0)


def test_chunked_autofit_bounds_match_fused():
    """Without set_scene_bounds, the chunks' boxes union to the unchunked
    scene's, so the fitted shadow volume and the image are the same, and
    they follow a transform update."""
    cmds = commands(11, seed=4)
    r_ch, r_ref = pair(cmds, pin_bounds=False)
    np.testing.assert_array_equal(render(r_ch), render(r_ref))
    moved = [np.asarray(c.transform, np.float32).copy() for c in cmds]
    for m in moved:
        m[:3, 3] *= np.float32(1.5)
    r_ch.update_transforms(np.stack(moved))
    r_ref.update_transforms(np.stack(moved))
    np.testing.assert_array_equal(render(r_ch), render(r_ref))
    np.testing.assert_array_equal(r_ch.shadow_feature.light_space_matrix(),
                                  r_ref.shadow_feature.light_space_matrix())


def test_chunked_update_transforms():
    cmds = commands(9, seed=2)
    r_ch = make_renderer(max_draws_per_chunk=4)
    r_ch.submit_render_commands(cmds)
    render(r_ch)
    moved = [np.asarray(c.transform, np.float32).copy() for c in cmds]
    for m in moved:
        m[:3, 3] += np.float32(0.8)
    map1 = r_ch._shadow_cache[1]
    r_ch.update_transforms(np.stack(moved))
    r_ch.update_transforms({0: moved[0]})  # a sparse update as well
    img = render(r_ch)
    assert r_ch._shadow_cache[1] is not map1  # the moved scene's map
    r_ref = make_renderer()
    r_ref.submit_render_commands([
        RenderCommand(mesh=0, transform=m, material=1 + i % 2)
        for i, m in enumerate(moved)])
    np.testing.assert_array_equal(img, render(r_ref))


def test_chunked_update_transforms_trs_and_resubmit():
    """update_transforms_trs composes on the host for a chunked scene; a
    resubmit of the same handles moves the models without a rebuild."""
    from ash_tpu_torch.core import maths

    cmds = commands(9, seed=5)
    r_ch, r_ref = pair(cmds)
    render(r_ch), render(r_ref)
    rng = np.random.default_rng(8)
    t = rng.uniform(-3, 3, (9, 3)).astype(np.float32)
    q = rng.normal(size=(9, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    s = rng.uniform(0.3, 0.6, 9).astype(np.float32)
    r_ch.update_transforms_trs(t, q, s)
    r_ref.update_transforms_trs(t, q, s)
    np.testing.assert_array_equal(render(r_ch), render(r_ref))
    epoch = r_ch._scene_epoch
    m = maths.mat4_trs_batch(t + 0.5, q, np.repeat(s[:, None], 3, 1))
    resub = [RenderCommand(mesh=0, transform=m[i], material=1 + i % 2)
             for i in range(9)]
    r_ch.submit_render_commands(resub)
    r_ref.submit_render_commands(resub)
    assert r_ch._scene_epoch == epoch
    np.testing.assert_array_equal(render(r_ch), render(r_ref))


def test_chunked_update_material():
    """A material edit rebuilds the chunks from the items."""
    r_ch, r_ref = pair(commands(11, seed=1))
    render(r_ch), render(r_ref)
    new = Material(color=(0.1, 0.9, 0.3, 1.0), metallic=0.8)
    r_ch.update_material(2, new)
    r_ref.update_material(2, new)
    img = render(r_ch)
    np.testing.assert_array_equal(img, render(r_ref))
    assert r_ch._chunk_scenes is not None


def test_chunked_taa_matches_unchunked():
    """HDR post and TAA over three frames: each chunked frame equals the
    unchunked frame N (the jitter, the history, the motion vectors)."""
    r_ch, r_ref = pair(commands(11, seed=1))
    for r in (r_ch, r_ref):
        r.initialize_hdr()
        r.set_taa_enabled(True)
    for _ in range(3):
        np.testing.assert_array_equal(render(r_ch), render(r_ref))
    torch.testing.assert_close(r_ch.last_outputs().history,
                               r_ref.last_outputs().history, rtol=0, atol=0)


def test_chunked_textured_alpha_test_matches_unchunked():
    """The small textured bench scene (64 cubes, four textured meshes,
    every fourth cube alpha-tested in both passes; trilinear sampling) in
    chunks of 16."""
    imgs = []
    for chunk in (16, None):
        r, _, cam, _ = bench_scene.build_bench_renderer(
            96, 64, 64, "cpu", textured=True, max_draws_per_chunk=chunk,
            max_tris_per_tile=1024, shadow_max_tris_per_tile=1024,
            max_anisotropy=1)
        out = r.render_frame(cam.view_matrix(), cam.projection_matrix(),
                             cam.position)
        imgs.append(r.read_back())
        assert int(out.binning_overflow) == 0
    assert r.config.max_draws_per_chunk is None
    np.testing.assert_array_equal(imgs[0], imgs[1])


def _point_light(r):
    r.add_point_light((0, 2, 0))


def _spot_light(r):
    r.add_spot_light((0, 2, 0), (0, -1, 0))


def _msaa(r):
    r.set_msaa_preset("x4")


def _render_scale(r):
    r.set_render_scale(0.5)


def _occlusion(r):
    r.set_occlusion_culling(True)


def _lod(r, mesh=Mesh):
    ball = mesh.create_sphere("Ball", segments=8, rings=6)
    ball.add_lod(mesh.create_sphere("Ball_l1", segments=5, rings=4), 0.05)
    r.register_mesh_handle(0, ball)


def _blend(r, material=Material):
    r.register_material_handle(2, material(color=(0.2, 0.5, 0.8, 0.5)))


REFUSALS = {
    "point light": (_point_light, {}),
    "spot light": (_spot_light, {}),
    "msaa": (_msaa, {}),
    "render_scale": (_render_scale, {}),
    "occlusion": (_occlusion, {}),
    "csm": (None, "csm"),
    "lod": (_lod, {}),
    "blend": (_blend, {}),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_chunked_rejects_unsupported_features(case):
    """What the chunked frame cannot composite raises InvalidOperation with
    the reference's message, on both renderers."""
    setup, kw = REFUSALS[case]
    messages = []
    for port in (True, False):
        extra = {}
        if kw == "csm":
            csm = (CsmConfig if port else ref_render.CsmConfig)
            extra = dict(csm=csm(cascade_count=2, resolution=64))
        r = make_renderer(port=port, max_draws_per_chunk=4, **extra)
        if setup is _lod:
            setup(r, Mesh if port else ref_core.Mesh)
        elif setup is _blend:
            setup(r, Material if port else ref_core.Material)
        elif setup is not None:
            setup(r)
        r.submit_render_commands(commands(
            9, seed=3,
            command=RenderCommand if port else ref_render.RenderCommand))
        with pytest.raises(InvalidOperation if port
                           else RefInvalidOperation) as err:
            render(r, Camera if port else ref_core.Camera)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_chunked_dedupes_identical_chunk_buffers():
    """Chunks with identical (mesh, material) sequences share one scene's
    device buffers; every chunk keeps its own world box, and the image is
    the unchunked one."""
    cmds = commands(12, seed=4)
    for c in cmds:
        c.material = 1
    r_ch, r_ref = pair(cmds, pin_bounds=False)
    img = render(r_ch)
    assert len(r_ch._chunk_scenes) == 3
    assert len({id(s.buffers.position) for s in r_ch._chunk_scenes}) == 1
    assert len({tuple(s.scene_lo) for s in r_ch._chunk_scenes}) == 3
    np.testing.assert_array_equal(img, render(r_ref))


def test_example10_scene_chunks():
    """Example 10's default scene: 10,000 instances of the 98x49 sphere
    (9,604 triangles) in chunks of 312 draws, 33 chunks; and a small cut of
    it (4 instances, chunks of 2, caps over its largest tile counts, 7,608
    fine and 16,894 coarse, so nothing drops) equal to its unchunked
    frame."""
    sphere = Mesh.create_sphere("heavy", segments=98, rings=49)
    tris = len(sphere.indices) // 3
    cfg = bench_scene.mega_instancing_config(tris)
    cmds, extent = bench_scene.mega_instancing_commands()
    assert tris == 9604 and cfg["max_draws_per_chunk"] == 312
    assert len(cmds) == 10_000 and -(-len(cmds) // 312) == 33
    assert (cfg["tile_h"], cfg["max_tris_per_tile"]) == (8, 2048)
    assert cfg["binning_policy"] == "nearest" and not cfg["shadows_enabled"]
    imgs = []
    for chunk in (2, None):
        r, _, cam, _ = bench_scene.build_mega_instancing_renderer(
            64, 48, "cpu", n=4, max_draws_per_chunk=chunk,
            max_tris_per_tile=8192, binning_coarse_cap=32768)
        out = r.render_frame(cam.view_matrix(), cam.projection_matrix(),
                             cam.position)
        assert int(out.binning_overflow) == 0
        imgs.append(r.read_back())
    assert (imgs[0][..., :3] > 0).any()
    np.testing.assert_array_equal(imgs[0], imgs[1])


def test_chunked_matches_ash_tpu():
    """The chunked renderer against ash_tpu's chunked renderer on the
    reference test's commands(11, seed=1), chunks of 4."""
    port = make_renderer(max_draws_per_chunk=4)
    port.submit_render_commands(commands(11, seed=1))
    ref = make_renderer(port=False, max_draws_per_chunk=4)
    ref.submit_render_commands(commands(11, seed=1,
                                        command=ref_render.RenderCommand))
    got = render(port)
    want = render(ref, ref_core.Camera)
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    print(f"measured: largest u8 difference {d.max()}, "
          f"{int((d.max(-1) > 0).sum())} pixels differ")
    assert len(ref._chunk_scenes) == len(port._chunk_scenes) == 3
    assert d.max() <= 1
    for f in ("covered_pixels", "binning_overflow", "shadow_overflow"):
        assert (int(getattr(port.last_outputs(), f))
                == int(getattr(ref.last_outputs(), f))), f
