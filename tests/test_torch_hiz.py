"""Hi-Z occlusion culling: ash_tpu_torch.ops.hiz, ops.occlusion with a
pyramid and the Renderer's two-frame path, against ash_tpu on the CPU with
the same numpy inputs.

Tolerances:

- pyramid tables and texels: equal (a max of equal inputs is exact);
- `sample_level`: equal (the same f32 product u * size, truncated);
- `occlusion_test` and `cull_objects` with a pyramid: equal verdicts on the
  reference test's cases; on 2000 seeded boxes over a seeded depth buffer,
  at most 0.5% verdicts and mip choices may differ (the corner projection
  sums in another order than XLA's einsum, so ceil(log2(size)) can flip a
  level when the size sits on a power of two); the test prints the counts;
- frames: the port's frames with occlusion culling against its frames
  without, max 1 u8 level (the reference test's bar), the port's frames
  against the reference's, u8 PSNR >= 40 dB, and visible draws equal;
- the bench frame (1000 cubes at 480x270), where the reference's Hi-Z test
  culls visible draws (it reads one texel at the screen rectangle's
  centre, which a rectangle as wide as a texel may straddle): the port
  culls as the reference does, visible draws within 1% of the reference's
  per frame and u8 PSNR >= 40 dB against its frames (ROADMAP.md C).
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ash_tpu.core as ref_core
import ash_tpu.render as ref_render
import ash_tpu_torch.core as port_core
import ash_tpu_torch.render as port_render
from ash_tpu.core import maths
from ash_tpu.ops import hiz as ref_hiz
from ash_tpu.ops import occlusion as ref_occ
from ash_tpu.utils.image import psnr
from ash_tpu_torch.ops import hiz, occlusion
from ash_tpu_torch.ops.geometry import transform_points
from ash_tpu_torch.render.occlusion_culling import (
    CullBoundingBox,
    CullObjectData,
    OcclusionCullingSystem,
)

torch.set_num_threads(1)

REF = SimpleNamespace(core=ref_core, render=ref_render, kw={})
PORT = SimpleNamespace(core=port_core, render=port_render,
                       kw={"device": "cpu"})
MIN_PSNR = 40.0


def _t(a):
    return torch.from_numpy(np.array(a))


def _depth(h, w, seed=3):
    """A seeded depth buffer: background 1.0 with rectangles nearer."""
    rng = np.random.default_rng(seed)
    d = np.ones((h, w), np.float32)
    for _ in range(12):
        y0, x0 = rng.integers(0, h), rng.integers(0, w)
        d[y0:y0 + rng.integers(1, h // 2 + 2),
          x0:x0 + rng.integers(1, w // 2 + 2)] = rng.uniform(0.05, 0.99)
    return d


@pytest.mark.parametrize("h,w", [(16, 16), (135, 240), (84, 120), (17, 9),
                                 (1, 5), (1080, 1920)])
def test_pyramid_matches_reference(h, w):
    d = _depth(h, w)
    ref = ref_hiz.build_hiz(jnp.asarray(d))
    got = hiz.build_hiz(_t(d))
    np.testing.assert_array_equal(got.table, ref.table)
    assert got.levels == ref.levels
    np.testing.assert_array_equal(got.texels.numpy(), np.asarray(ref.texels))
    if (h, w) == (1080, 1920):  # floor-sized levels, odd axes folded
        assert [int(x) for x in got.table[:, 2]] == [
            1080, 540, 270, 135, 67, 33, 16, 8, 4, 2]
        assert [int(x) for x in got.table[:, 1]] == [
            1920, 960, 480, 240, 120, 60, 30, 15, 7, 3]


def test_pyramid_keeps_the_far_edge():
    """An odd level's last column is max-folded, not dropped: a far depth
    there reaches the top level."""
    d = np.full((135, 241), 0.2, np.float32)
    d[:, -1] = 1.0
    got = hiz.build_hiz(_t(d))
    assert float(got.level(got.levels - 1).max()) == 1.0


def test_sample_level_matches_reference():
    rng = np.random.default_rng(5)
    d = _depth(84, 120)
    n = 4000
    level = rng.integers(-2, 12, n).astype(np.int32)
    u = rng.uniform(-0.1, 1.1, n).astype(np.float32)
    v = rng.uniform(-0.1, 1.1, n).astype(np.float32)
    u[:50] = np.arange(50, dtype=np.float32) / 15.0  # texel edges of level 3
    ref = ref_hiz.sample_level(ref_hiz.build_hiz(jnp.asarray(d)),
                               jnp.asarray(level), jnp.asarray(u), jnp.asarray(v))
    got = hiz.sample_level(hiz.build_hiz(_t(d)), _t(level), _t(u), _t(v))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _camera_mats():
    proj = maths.perspective_rh(np.deg2rad(60), 1.0, 0.1, 100.0)
    proj[1, 1] *= -1
    view = maths.look_at_rh([0, 0, 10], [0, 0, 0], [0, 1, 0])
    return (proj @ view).astype(np.float32)


@pytest.mark.parametrize("case", ["near_wall", "far_wall", "disabled"])
def test_cull_objects_with_pyramid_matches_reference(case):
    """The reference's occlusion cases (tests/test_compute_passes.py)."""
    vp = _camera_mats()
    size = 32 if case == "disabled" else 64
    depth = np.full((size, size), 0.1 if case == "near_wall" else 1.0,
                    np.float32)
    if case == "near_wall":
        centers = np.array([[0, 0, 0], [500, 0, 0]], np.float32)
    else:
        centers = np.zeros((1, 3), np.float32)
    extents = np.ones_like(centers)
    models = np.tile(np.eye(4, dtype=np.float32), (len(centers), 1, 1))
    enabled = np.full(len(centers), case != "disabled")
    ref = ref_occ.cull_objects(
        jnp.asarray(centers), jnp.asarray(extents), jnp.asarray(models),
        jnp.asarray(enabled), jnp.asarray(vp),
        ref_hiz.build_hiz(jnp.asarray(depth)), size, size)
    got = occlusion.cull_objects(_t(centers), _t(extents), _t(models),
                                 _t(enabled), _t(vp),
                                 hiz.build_hiz(_t(depth)), size, size)
    np.testing.assert_array_equal(got.visibility.numpy(),
                                  np.asarray(ref.visibility))
    np.testing.assert_array_equal(got.draw_list.numpy(),
                                  np.asarray(ref.draw_list))
    assert int(got.visible_count) == int(ref.visible_count)
    assert int(got.visible_count) == (1 if case == "far_wall" else 0)


def _ref_mip(centers_w, extents_w, vp, levels, width, height):
    """The reference's level choice (ops/occlusion.py:occlusion_test),
    in jnp, for counting flips."""
    signs = jnp.asarray([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                         for sz in (-1, 1)], jnp.float32)
    corners = centers_w[:, None, :] + extents_w[:, None, :] * signs[None]
    c4 = jnp.concatenate([corners, jnp.ones(corners.shape[:2] + (1,))], -1)
    clip = jnp.einsum("ij,nkj->nki", vp, c4)
    w = clip[..., 3]
    safe_w = jnp.where(jnp.abs(w) < 1e-8, 1e-8, w)
    screen = clip[..., :2] / safe_w[..., None] * 0.5 + 0.5
    size = (jnp.clip(screen.max(1), 0, 1) - jnp.clip(screen.min(1), 0, 1)) \
        * jnp.asarray([width, height], jnp.float32)
    mip = jnp.ceil(jnp.log2(jnp.maximum(size.max(-1), 1e-8)))
    return np.asarray(jnp.clip(mip, 0, levels - 1).astype(jnp.int32))


def _port_mip(centers_w, extents_w, vp, levels, width, height):
    signs = torch.tensor([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                          for sz in (-1, 1)], dtype=torch.float32)
    corners = centers_w[:, None, :] + extents_w[:, None, :] * signs[None]
    clip = transform_points(vp, corners)
    w = clip[..., 3]
    screen = clip[..., :2] / torch.where(w.abs() < 1e-8, 1e-8, w)[..., None]
    screen = screen * 0.5 + 0.5
    size = ((screen.amax(1).clamp(0, 1) - screen.amin(1).clamp(0, 1))
            * torch.tensor([width, height], dtype=torch.float32))
    mip = torch.ceil(torch.log2(size.amax(-1).clamp_min(1e-8)))
    return mip.clamp(0, levels - 1).to(torch.int32).numpy()


def test_occlusion_test_on_random_boxes():
    rng = np.random.default_rng(12)
    n, width, height = 2000, 120, 84
    cam = ref_core.Camera.new([0.0, 3.0, 12.0], [0, 0, 0], width / height)
    vp = (cam.projection_matrix() @ cam.view_matrix()).astype(np.float32)
    centers = rng.uniform([-8, -4, -10], [8, 4, 6], (n, 3)).astype(np.float32)
    extents = rng.uniform(0.05, 2.0, (n, 3)).astype(np.float32)
    depth = _depth(height, width, seed=9)
    pyr_ref = ref_hiz.build_hiz(jnp.asarray(depth))
    ref = np.asarray(ref_occ.occlusion_test(
        jnp.asarray(centers), jnp.asarray(extents), jnp.asarray(vp), pyr_ref,
        width, height))
    got = occlusion.occlusion_test(_t(centers), _t(extents), _t(vp),
                                   hiz.build_hiz(_t(depth)), width,
                                   height).numpy()
    mip_ref = _ref_mip(jnp.asarray(centers), jnp.asarray(extents),
                       jnp.asarray(vp), pyr_ref.levels, width, height)
    mip_got = _port_mip(_t(centers), _t(extents), _t(vp), pyr_ref.levels,
                        width, height)
    flips = int((mip_ref != mip_got).sum())
    verdicts = int((ref != got).sum())
    print(f"\nHi-Z on {n} boxes: {int(ref.sum())} occluded (reference), "
          f"{verdicts} verdicts and {flips} mip choices differ")
    assert 0 < ref.sum() < n
    assert verdicts <= n // 200 and flips <= n // 200


def test_occlusion_culling_system_feeds_cull_objects():
    """The host registry packs what cull_objects takes; its stats count the
    result."""
    system = OcclusionCullingSystem()
    for x in (0.0, 500.0):
        m = np.eye(4, dtype=np.float32)
        m[0, 3] = x
        system.register(CullObjectData(
            bounds=CullBoundingBox.from_min_max([-1, -1, -1], [1, 1, 1]),
            model=m))
    centers, extents, models, enabled = system.packed()
    res = occlusion.cull_objects(_t(centers), _t(extents), _t(models),
                                 _t(enabled), _t(_camera_mats()),
                                 hiz.build_hiz(torch.ones(32, 32)), 32, 32)
    stats = system.record_result(res.visibility.numpy())
    assert (stats.total_objects, stats.visible, stats.occlusion_culled) == (2, 1, 1)
    assert stats.culled_fraction == 0.5


def _renderer(P, w=96, h=64):
    return P.render.Renderer(
        P.render.HeadlessSurface(w, h),
        P.render.RendererConfig(tile_h=8, tile_w=32, max_tris_per_tile=64,
                                shadows_enabled=False),
        **P.kw)


def _wall_scene(P):
    r = _renderer(P)
    r.register_mesh_handle(0, P.core.Mesh.create_cube())
    r.register_material_handle(1, P.core.Material(color=(0, 1, 0, 1)))
    wall = np.eye(4, dtype=np.float32)
    wall[0, 0], wall[1, 1], wall[2, 2] = 8.0, 8.0, 0.2
    behind = np.eye(4, dtype=np.float32)
    behind[:3, 3] = [0, 0, -6.0]
    r.submit_render_commands([
        P.render.RenderCommand(mesh=0, transform=wall, material=1),
        P.render.RenderCommand(mesh=0, transform=behind, material=1),
    ])
    r.set_occlusion_culling(True)
    return r


def test_occlusion_culling_two_frames_matches_reference():
    """Frame 1 tests against the far plane (frustum only); frame 2 culls the
    cube behind the wall; the image does not change."""
    cam = port_core.Camera.new([0, 0, 6], [0, 0, 0], 96 / 64)
    args = (cam.view_matrix(), cam.projection_matrix(), cam.position)
    outs = {}
    for name, P in (("ref", REF), ("port", PORT)):
        r = _wall_scene(P)
        outs[name] = [r.render_frame(*args) for _ in range(2)]
        assert [int(o.visible_draws) for o in outs[name]] == [2, 1], name
    port, ref = outs["port"], outs["ref"]
    np.testing.assert_array_equal(port[0].image.numpy(), port[1].image.numpy())
    for p, q in zip(port, ref):
        assert psnr(p.image.numpy(), np.asarray(q.image)) >= MIN_PSNR


def test_disabling_occlusion_culling_drops_the_depth():
    r = _wall_scene(PORT)
    cam = port_core.Camera.new([0, 0, 6], [0, 0, 0], 96 / 64)
    args = (cam.view_matrix(), cam.projection_matrix(), cam.position)
    r.render_frame(*args)
    assert r._prev_depth is not None
    r.set_occlusion_culling(False)
    assert r._prev_depth is None
    assert int(r.render_frame(*args).visible_draws) == 2
    r.set_occlusion_culling(True)
    assert int(r.render_frame(*args).visible_draws) == 2  # far plane again
    r.surface.resize(80, 64)
    assert int(r.render_frame(*args).visible_draws) == 2  # resized: dropped
    assert int(r.render_frame(*args).visible_draws) == 1


@pytest.mark.parametrize("seed", range(4))
def test_occlusion_culling_never_changes_the_image(seed):
    """The reference's conservativeness scene (tests/test_culling_wired.py)
    on the port: three frames with occlusion culling equal, within one u8
    level, the frame without it; and the reference's frame."""
    def build(P, occlusion):
        rng = np.random.default_rng(seed + 31)
        r = _renderer(P, w=120, h=84)  # an odd Hi-Z level chain
        r.register_mesh_handle(0, P.core.Mesh.create_cube())
        r.register_material_handle(1, P.core.Material(color=(0.8, 0.4, 0.2, 1)))
        cmds = []
        for _ in range(16):
            m = np.eye(4, dtype=np.float32)
            m[:3, 3] = rng.uniform([-3, -2, -6], [3, 2, 0], 3)
            m[0, 0] = m[1, 1] = m[2, 2] = rng.uniform(0.3, 1.2)
            cmds.append(P.render.RenderCommand(mesh=0, transform=m, material=1))
        r.submit_render_commands(cmds)
        r.set_occlusion_culling(occlusion)
        return r

    cam = port_core.Camera.new([0, 1.0, 7.0], [0, 0, 0], 120 / 84)
    args = (cam.view_matrix(), cam.projection_matrix(), cam.position)
    r_off = build(PORT, False)
    out_off = r_off.render_frame(*args)
    base = r_off.read_back().astype(np.int16)
    r_on = build(PORT, True)
    for _ in range(3):
        out_on = r_on.render_frame(*args)
    got = r_on.read_back().astype(np.int16)
    assert int(out_off.binning_overflow) == 0 and int(out_on.binning_overflow) == 0
    assert np.abs(base - got).max() <= 1
    r_ref = build(REF, True)
    for _ in range(3):
        out_ref = r_ref.render_frame(*args)
    assert int(out_ref.visible_draws) == int(out_on.visible_draws)
    assert psnr(got.astype(np.uint8), np.asarray(out_ref.image)) >= MIN_PSNR


def test_bench_frame_culls_as_the_reference():
    """The reference's Hi-Z test is not conservative on the bench frame:
    frame 2 culls about 190 of 999 visible cubes and the image changes.
    The port reproduces those verdicts rather than fixing them."""
    from ash_tpu_torch.render import bench_scene

    w, h = 480, 270
    draws, extent = bench_scene.bench_draws(1000)

    def build(P, occlusion):
        r = P.render.Renderer(
            P.render.HeadlessSurface(w, h),
            P.render.RendererConfig(**bench_scene.bench_config(
                h, shadows_enabled=False, max_tris_per_tile=1024)), **P.kw)
        r.register_mesh_handle(0, P.core.Mesh.create_cube())
        cmds = []
        for i, (m, mat) in enumerate(draws):
            r.register_material_handle(i + 1, P.core.Material(
                color=mat.color, metallic=mat.metallic,
                roughness=mat.roughness))
            cmds.append(P.render.RenderCommand(mesh=0, transform=m,
                                               material=i + 1))
        r.submit_render_commands(cmds)
        r.set_occlusion_culling(occlusion)
        return r

    cam = bench_scene.bench_camera(w, h, extent)
    args = (cam.view_matrix(), cam.projection_matrix(), cam.position)
    frames = {}
    for name, P in (("ref", REF), ("port", PORT)):
        base = np.array(build(P, False).render_frame(*args).image)
        r = build(P, True)
        outs = [r.render_frame(*args) for _ in range(3)]
        assert all(int(o.binning_overflow) == 0 for o in outs)
        changed = int((np.abs(np.array(outs[1].image).astype(np.int16)
                              - base.astype(np.int16)).max(-1) > 1).sum())
        frames[name] = ([int(o.visible_draws) for o in outs],
                        [np.array(o.image) for o in outs], changed)
    (vis, imgs, changed), (ref_vis, ref_imgs, ref_changed) = (
        frames["port"], frames["ref"])
    print(f"\nbench frame with Hi-Z: visible draws {vis} (reference "
          f"{ref_vis}); frame 2 changes {changed} pixels (reference "
          f"{ref_changed}) against the frame without culling")
    assert ref_vis[0] == vis[0] == 999 and ref_changed > 0
    for a, b in zip(vis, ref_vis):
        assert abs(a - b) <= b // 100
    for a, b in zip(imgs, ref_imgs):
        assert psnr(a, b) >= MIN_PSNR
