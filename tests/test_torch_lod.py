"""In-frame LOD selection and instancing: ash_tpu_torch's pass_lod
(render/frame.py:lod_tri_mask), Renderer.lod_stats, the host copies of
render/lod_system.py and render/instancing.py, and LOD scenes with
shadows, against ash_tpu on the CPU with the same scenes
(tests/test_instancing_lod.py's).

Tolerances:

- lod_stats: equal, field for field (the same numpy on the host);
- the frame's triangle mask: the triangles it keeps equal the reference
  lod_stats' triangles_after, and per draw the level it keeps equals the
  host mirror's (coverage thresholds are far from every draw's coverage
  in these scenes, so the f32 products' order cannot flip a level);
- frames: u8 PSNR >= 40 dB against the reference's frame; covered pixels
  within 0.5%;
- shadow maps of a LOD scene: the texels each side covers differ in at
  most 0.5%, and the light-space depth of the texels both cover within
  5e-4 at the 99.5th percentile and 5e-3 at most (measured: median
  1.6e-5, 99th percentile 1.7e-4, largest 1.8e-3 on these spheres' small
  triangles, where the setup's cross products amplify the f32 sums of the
  vertex stage; ROADMAP.md C);
- InstancingManager: equal stats, packed tables and draw lists;
- example 07's scenes cut to 200 cubes at 192x128 and 40 spheres at
  96x64: the first instancing frame >= 40 dB, visible draws under Hi-Z
  within 5% of the reference's (measured 191 against 197 on frame 2: the
  boxes are a pixel or two wide); LOD frames >= 40 dB, lod_stats equal.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import ash_tpu.core as ref_core
import ash_tpu.render as ref_render
import ash_tpu_torch.core as port_core
import ash_tpu_torch.render as port_render
from ash_tpu.render import instancing as ref_instancing
from ash_tpu.render import lod_system as ref_lod_system
from ash_tpu.utils.image import psnr
from ash_tpu_torch.render import bench_scene, frame, instancing, lod_system

torch.set_num_threads(1)

REF = SimpleNamespace(core=ref_core, render=ref_render, kw={})
PORT = SimpleNamespace(core=port_core, render=port_render,
                       kw={"device": "cpu"})
MIN_PSNR = 40.0
MAP_FLIPS = 0.005


def _small_cfg(P, **kw):
    """The reference test's config; frames held against the reference's
    raise the tile caps so that no triangle drops (which triangles an
    overflowing tile drops follows last-bit differences of the setup)."""
    return P.render.RendererConfig(**{
        **dict(tile_h=8, tile_w=32, max_tris_per_tile=64,
               shadow_resolution=128, shadow_tile=32, shadow_tile_h=8,
               shadow_max_tris_per_tile=64), **kw})


def _lod_sphere(P):
    m = P.core.Mesh.create_sphere("ball", segments=24, rings=16)
    m.add_lod(P.core.Mesh.create_sphere("ball_l1", segments=12, rings=8), 0.05)
    m.add_lod(P.core.Mesh.create_sphere("ball_l2", segments=6, rings=4), 0.01)
    return m


def _lod_scene(P, cam_dist, shadows=False, **kw):
    kw.setdefault("max_tris_per_tile", 1024)
    kw.setdefault("shadow_max_tris_per_tile", 1024)
    r = P.render.Renderer(P.render.HeadlessSurface(96, 96),
                          _small_cfg(P, shadows_enabled=shadows, **kw), **P.kw)
    r.register_mesh_handle(0, _lod_sphere(P))
    r.register_material_handle(1, P.core.Material(color=(0.7, 0.7, 0.2, 1)))
    cmds = []
    for i in range(9):
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = [(i % 3 - 1) * 2.5, 0, (i // 3 - 1) * 2.5]
        cmds.append(P.render.RenderCommand(mesh=0, transform=m, material=1))
    r.submit_render_commands(cmds)
    if shadows:
        r.shadow_feature.set_scene_bounds([0, 0, 0], 6.0)
    cam = port_core.Camera.new([0, cam_dist * 0.4, cam_dist], [0, 0, 0], 1.0)
    return r, cam


def _args(cam):
    return cam.view_matrix(), cam.projection_matrix(), cam.position


def _stats_tuple(s):
    return (s.triangles_before, s.triangles_after, s.objects_culled,
            list(s.objects_per_lod), s.reduction_rate)


@pytest.mark.parametrize("dist", [4.0, 9.0, 20.0, 60.0])
def test_lod_frame_and_stats_match_reference(dist):
    outs, stats = {}, {}
    for name, P in (("ref", REF), ("port", PORT)):
        r, cam = _lod_scene(P, dist)
        outs[name] = r.render_frame(*_args(cam))
        assert int(outs[name].binning_overflow) == 0
        stats[name] = r.lod_stats(cam.view_matrix(), cam.projection_matrix())
    assert _stats_tuple(stats["port"]) == _stats_tuple(stats["ref"])
    got, want = outs["port"], outs["ref"]
    assert psnr(got.image.numpy(), np.asarray(want.image)) >= MIN_PSNR
    cov, ref_cov = int(got.covered_pixels), int(want.covered_pixels)
    assert abs(cov - ref_cov) <= max(2, ref_cov // 200)
    if dist == 60.0:  # every sphere under the coverage cull
        assert stats["port"].objects_culled == 9 and cov == 0
    if dist == 20.0:
        assert stats["port"].objects_per_lod[0] == 0
        assert stats["port"].reduction_rate > 0.5


@pytest.mark.parametrize("dist", [4.0, 9.0, 20.0, 60.0])
def test_lod_mask_keeps_the_selected_levels(dist):
    """pass_lod on the device against the reference's host mirror: the
    kept triangles, and per draw the kept level."""
    r, cam = _lod_scene(PORT, dist)
    inputs = r.prepare_frame(*_args(cam))
    assert inputs.config.lod_enabled
    sb = inputs.scene.buffers
    mask = frame.lod_tri_mask(inputs.config, sb, inputs.uniforms)
    ref_r, _ = _lod_scene(REF, dist)
    ref_r.render_frame(*_args(cam))
    ref_stats = ref_r.lod_stats(cam.view_matrix(), cam.projection_matrix())
    assert int((mask & sb.tri_valid).sum()) == ref_stats.triangles_after
    draws = sb.tri_draw[mask].long()
    levels = sb.tri_lod[mask].long()
    for lvl, count in enumerate(ref_stats.objects_per_lod):
        kept = torch.unique(draws[levels == lvl]).numel()
        assert kept == count, (lvl, kept, count)


def test_lod_cull_threshold_is_an_option():
    """A higher threshold culls what the default keeps, on both sides."""
    got = {}
    for name, P in (("ref", REF), ("port", PORT)):
        r, cam = _lod_scene(P, 20.0, lod_cull_threshold=0.02)
        r.render_frame(*_args(cam))
        got[name] = _stats_tuple(r.lod_stats(cam.view_matrix(),
                                             cam.projection_matrix()))
    assert got["port"] == got["ref"]
    assert got["port"][2] == 9


def test_lod_disabled_draws_every_level():
    """With lod_enabled=False a chain is drawn whole, as in the reference."""
    r, cam = _lod_scene(PORT, 20.0, lod_enabled=False)
    inputs = r.prepare_frame(*_args(cam))
    assert not inputs.config.lod_enabled
    out = r.render_frame(*_args(cam))
    ref_r, _ = _lod_scene(REF, 20.0, lod_enabled=False)
    ref_out = ref_r.render_frame(*_args(cam))
    assert psnr(out.image.numpy(), np.asarray(ref_out.image)) >= MIN_PSNR


def test_single_level_meshes_keep_lod_off():
    r = PORT.render.Renderer(PORT.render.HeadlessSurface(48, 48),
                             _small_cfg(PORT, shadows_enabled=False),
                             device="cpu")
    r.set_mesh(port_core.Mesh.create_cube())
    cam = port_core.Camera.new([3, 2, 4], [0, 0, 0], 1.0)
    assert r.prepare_frame(*_args(cam)).config.lod_enabled is False
    stats = r.lod_stats(cam.view_matrix(), cam.projection_matrix())
    assert stats.triangles_before == 0


def test_lod_shadow_map_follows_the_camera():
    """A LOD scene renders its shadow map in the frame, under the camera's
    level mask: moving the camera re-renders it (the cache is not used),
    and each map matches the reference's."""
    r, near = _lod_scene(PORT, 4.0, shadows=True)
    ref_r, _ = _lod_scene(REF, 4.0, shadows=True)
    far = port_core.Camera.new([0, 8.0, 20.0], [0, 0, 0], 1.0)
    maps = []
    for cam in (near, far, near):
        out = r.render_frame(*_args(cam))
        ref_out = ref_r.render_frame(*_args(cam))
        sm, ref_sm = out.shadow_map.numpy(), np.asarray(ref_out.shadow_map)
        both = (sm < 1.0) & (ref_sm < 1.0)
        flips = float(((sm < 1.0) != (ref_sm < 1.0)).mean())
        err = np.abs(sm - ref_sm)[both]
        print(f"\nLOD shadow map: {100 * flips:.3f}% of texels covered on "
              f"one side only; depth err median {np.median(err):.2e}, 99.5% "
              f"{np.quantile(err, 0.995):.2e}, max {err.max():.2e}")
        assert flips <= MAP_FLIPS
        assert np.quantile(err, 0.995) <= 5e-4 and err.max() <= 5e-3
        assert psnr(out.image.numpy(), np.asarray(ref_out.image)) >= MIN_PSNR
        maps.append(sm)
    assert r._shadow_cache is None
    assert not np.array_equal(maps[0], maps[1])  # other levels cast it
    np.testing.assert_array_equal(maps[0], maps[2])


def test_instances_share_unique_vertex_pool():
    surface = port_render.HeadlessSurface(64, 64)
    r = port_render.Renderer(surface, _small_cfg(PORT), device="cpu")
    r.register_mesh_handle(0, port_core.Mesh.create_cube())
    r.register_material_handle(1, port_core.Material(color=(0.8, 0.2, 0.2, 1)))
    cmds = []
    n = 257
    for i in range(n):
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = [(i % 8) - 4, (i // 8 % 8) - 4, (i // 64) - 2]
        m[:3, :3] *= 0.3
        cmds.append(port_render.RenderCommand(mesh=0, transform=m, material=1))
    r.submit_render_commands(cmds)
    cam = port_core.Camera.new([6, 5, 8], [0, 0, 0], 1.0)
    out = r.render_frame(*_args(cam))
    assert r._scene.buffers.num_unique_vertices <= 32
    assert r._scene.num_vertices == 24 * n
    assert r._scene.num_triangles == 12 * n
    assert int(out.covered_pixels) > 100


def _fill(mod, n=50, batches=2):
    mgr = mod.InstancingManager()
    for i in range(n):
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = [(i % 10) - 5, 0, (i // 10) - 2]
        m[:3, :3] *= 0.4
        assert mgr.add_instance(0, 1 + i % batches, mod.InstanceData(model=m))
    return mgr


def test_instancing_manager_matches_reference():
    got, want = _fill(instancing), _fill(ref_instancing)
    assert got.stats() == instancing.InstancingStats(50, 2, 48)
    assert (got.stats().total_instances, got.stats().batch_count,
            got.stats().draw_calls_saved) == (
        want.stats().total_instances, want.stats().batch_count,
        want.stats().draw_calls_saved)
    assert list(got.batches) == list(want.batches)
    for key, batch in got.batches.items():
        np.testing.assert_array_equal(batch.packed(), want.batches[key].packed())
        np.testing.assert_array_equal(batch.bounds_min, want.batches[key].bounds_min)
        np.testing.assert_array_equal(batch.bounds_max, want.batches[key].bounds_max)
    full = instancing.InstanceBatch(mesh_id=0, material_id=0)
    full.instances = [None] * instancing.MAX_INSTANCES_PER_BATCH
    assert not full.add(instancing.InstanceData(model=np.eye(4)))
    assert instancing.MAX_INSTANCES_PER_BATCH == 65536


def test_instancing_manager_batches_render():
    outs = {}
    for name, P, mod in (("ref", REF, ref_instancing),
                         ("port", PORT, instancing)):
        r = P.render.Renderer(P.render.HeadlessSurface(64, 64),
                              _small_cfg(P, shadows_enabled=False), **P.kw)
        r.register_mesh_handle(0, P.core.Mesh.create_cube())
        r.register_material_handle(1, P.core.Material(color=(0.2, 0.8, 0.2, 1)))
        r.register_material_handle(2, P.core.Material(color=(0.8, 0.2, 0.2, 1)))
        _fill(mod).to_draw_items(r)
        assert len(r.draw_items) == 50
        cam = port_core.Camera.new([0, 8, 8], [0, 0, 0], 1.0)
        outs[name] = r.render_frame(*_args(cam))
    assert int(outs["port"].covered_pixels) > 200
    assert psnr(outs["port"].image.numpy(),
                np.asarray(outs["ref"].image)) >= MIN_PSNR


def test_lod_system_host_copy_matches_reference():
    """LodManager's selection and stats and the coverage functions."""
    cam = port_core.Camera.new([0, 3, 10], [0, 0, 0], 1.5)
    vp = (cam.projection_matrix() @ cam.view_matrix()).astype(np.float32)
    rng = np.random.default_rng(4)
    pos = rng.uniform(-20, 20, (64, 3)).astype(np.float32)
    radii = rng.uniform(0.1, 3.0, 64).astype(np.float32)
    np.testing.assert_array_equal(
        lod_system.screen_coverage_batch(pos, radii, vp, 640, 400),
        ref_lod_system.screen_coverage_batch(pos, radii, vp, 640, 400))
    results = []
    for mod in (lod_system, ref_lod_system):
        mgr = mod.LodManager(mod.LodConfig(global_bias=0.4))
        mesh = mod.LodMesh("m", [mod.LodLevel(0.05, 10.0, 300),
                                 mod.LodLevel(0.01, 30.0, 60),
                                 mod.LodLevel(0.0, 90.0, 8)])
        mgr.begin_frame()
        sel = [mgr.select_lod(mesh, p, vp, cam.position, 640, 400)
               for p in pos]
        mgr.config.mode = mod.LodSelectionMode.DISTANCE
        sel += [mgr.select_lod(mesh, p, vp, cam.position, 640, 400)
                for p in pos]
        results.append(([(s.level, s.blend, s.culled, s.screen_coverage)
                         for s in sel], _stats_tuple(mgr.stats)))
    assert results[0] == results[1]


def test_example07_scenes_match_reference():
    """bench_scene's example 07 scenes, cut to a few draws (chip_smoke.py
    runs them at the example's size on the GPU): the instancing batch with
    Hi-Z over three frames at 192x128, and the LOD spheres from distance 15
    and 30 at 96x64."""
    cfg = dict(tile_h=8, tile_w=32, shadow_resolution=128, shadow_tile=32,
               shadow_tile_h=8, max_tris_per_tile=1024,
               shadow_max_tris_per_tile=1024)
    outs = {}
    for name, P, mod in (("ref", REF, ref_instancing),
                         ("port", PORT, instancing)):
        r = P.render.Renderer(
            P.render.HeadlessSurface(192, 128),
            P.render.RendererConfig(**bench_scene.instancing_config(**cfg)),
            **P.kw)
        r.set_occlusion_culling(True)
        mgr = bench_scene.instancing_manager(200, mod)
        assert mgr.stats().total_instances == 200
        bench_scene.fill_instancing_scene(r, mgr, P.core)
        cam = bench_scene.instancing_camera(192, 128)
        inst = [r.render_frame(*_args(cam)) for _ in range(3)]
        r = P.render.Renderer(
            P.render.HeadlessSurface(96, 64),
            P.render.RendererConfig(**bench_scene.lod_config(**cfg)), **P.kw)
        bench_scene.fill_lod_scene(r, P.core, P.render.RenderCommand, n=40)
        lod = []
        for dist in (15.0, 30.0):
            cam = bench_scene.lod_camera(dist, 96, 64)
            lod.append((r.render_frame(*_args(cam)),
                        _stats_tuple(r.lod_stats(cam.view_matrix(),
                                                 cam.projection_matrix()))))
        outs[name] = (inst, lod)
    (inst, lod), (ref_inst, ref_lod) = outs["port"], outs["ref"]
    vis = [int(o.visible_draws) for o in inst]
    ref_vis = [int(o.visible_draws) for o in ref_inst]
    per_frame = [round(psnr(o.image.numpy(), np.asarray(q.image)), 2)
                 for o, q in zip(inst, ref_inst)]
    print(f"\nexample 07 instancing at 192x128, 200 cubes: visible draws "
          f"{vis} (reference {ref_vis}); PSNR per frame {per_frame}")
    # Frame 1 culls nothing; after it, Hi-Z verdicts on these boxes of a
    # pixel or two flip where a texel or a depth sits on an edge, and a
    # flipped verdict on a visible box changes its pixels: visible draws
    # within 5% of the reference's.
    assert vis[0] == ref_vis[0] == 200 and vis[1] < vis[0]
    for a, b in zip(vis, ref_vis):
        assert abs(a - b) <= b // 20
    assert all(int(o.binning_overflow) == 0 for o in inst)
    assert psnr(inst[0].image.numpy(), np.asarray(ref_inst[0].image)) >= MIN_PSNR
    for (o, st), (ref, ref_st) in zip(lod, ref_lod):
        assert st == ref_st
        assert psnr(o.image.numpy(), np.asarray(ref.image)) >= MIN_PSNR
    assert lod[0][1][1] > lod[1][1][1]  # fewer triangles from farther
