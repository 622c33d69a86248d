"""Dynamic scenes on ash_tpu_torch against ash_tpu on the CPU.

The scenes of tests/test_dynamic_scene.py run through both renderers: the
transforms-only fast path of submit_render_commands, update_transforms
(arrays and sparse dicts, before and after the first frame),
update_transforms_trs, update_material, the shadow cache and the bounds
refit. Each test holds the port to the reference test's own bars on the
port's frames (the same renderer state, and images equal bit for bit to a
fresh build of the moved scene), and each frame to the reference's frame
of the same scene.

Tolerances:

- a frame of the port against the reference's frame of the same scene:
  u8 PSNR >= 40 dB (the goldens' bar); the differing pixels are printed;
- the port's frame against the port's own fresh build, and TRS against
  matrices: equal bit for bit (the reference test's bar);
- `frame.models_from_trs` against `core/maths.mat4_trs_batch`: equal bit
  for bit;
- the refitted shadow volume against a fresh build's: centre atol 1e-4,
  radius rtol 1e-5 (the reference test's bar; the refit and the build
  bound the same boxes with other float operations).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import ash_tpu.core as ref_core
import ash_tpu.render as ref_render
import ash_tpu_torch.core as port_core
import ash_tpu_torch.render as port_render
from ash_tpu.utils.image import psnr
from ash_tpu_torch.render import bench_scene, frame

torch.set_num_threads(1)

W, H = 96, 64
MIN_PSNR = 40.0

REF = SimpleNamespace(core=ref_core, render=ref_render, kw={})
PORT = SimpleNamespace(core=port_core, render=port_render,
                       kw={"device": "cpu"})


def small_cfg(P, **kw):
    return P.render.RendererConfig(
        tile_h=8, tile_w=32, max_tris_per_tile=64,
        shadow_resolution=64, shadow_tile=64, shadow_max_tris_per_tile=64,
        **kw,
    )


def make_renderer(P, pinned=True, **kw):
    r = P.render.Renderer(P.render.HeadlessSurface(W, H), small_cfg(P, **kw),
                          **P.kw)
    r.register_mesh_handle(0, P.core.Mesh.create_cube())
    if pinned:
        r.shadow_feature.set_scene_bounds([0, 0, 0], 8.0)
    return r


def render(r):
    cam = port_core.Camera.new([5.0, 4.0, 6.0], [0, 0, 0], W / H)
    out = r.render_frame(cam.view_matrix(), cam.projection_matrix(),
                         cam.position)
    return np.array(out.image)


def make_transforms(n, seed=0, spread=4.0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = ((rng.random(3) - 0.5) * spread).astype(np.float32)
        out.append(m)
    return out


def commands(P, transforms, material=1):
    return [P.render.RenderCommand(mesh=0, transform=t, material=material)
            for t in transforms]


def register_mat(P, r, color=(0.8, 0.3, 0.2, 1.0), handle=1):
    r.register_material_handle(handle, P.core.Material(color=color))
    return handle


def fresh_image(P, transforms, color=(0.8, 0.3, 0.2, 1.0)):
    r = make_renderer(P)
    register_mat(P, r, color)
    r.submit_render_commands(commands(P, transforms))
    return render(r)


def random_trs(n, seed):
    rng = np.random.default_rng(seed)
    t = ((rng.random((n, 3), np.float32) - 0.5) * 4.0).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    s = (0.5 + rng.random((n, 3), np.float32)).astype(np.float32)
    return t, q, s


def against_reference(scene, what):
    """Run scene(P) -> [images] on both packages; hold each of the port's
    images to the reference's; return the port's run."""
    want = scene(REF)
    got = scene(PORT)
    for i, (g, w) in enumerate(zip(got["images"], want["images"])):
        p = psnr(g, w)
        print(f"measured {what} frame {i}: PSNR {p:.2f} dB, "
              f"{int((g != w).any(-1).sum())} of {W * H} pixels differ")
        assert p >= MIN_PSNR, f"{what} frame {i}: {p:.2f} dB"
    return got


def test_resubmit_same_geometry_takes_fast_path():
    def scene(P):
        r = make_renderer(P)
        register_mat(P, r)
        r.submit_render_commands(commands(P, make_transforms(6, seed=1)))
        first = render(r)
        state = (r._scene, r._scene_epoch, r._models_epoch)
        t1 = make_transforms(6, seed=2)
        r.submit_render_commands(commands(P, t1))
        return {"images": [first, render(r)], "r": r, "state": state,
                "t1": t1}

    got = against_reference(scene, "fast-path resubmit")
    r, (scene_before, epoch, models_epoch) = got["r"], got["state"]
    assert r._scene is scene_before, "the fast path rebuilt the scene"
    assert r._scene_epoch == epoch
    assert r._models_epoch > models_epoch
    np.testing.assert_array_equal(got["images"][1],
                                  fresh_image(PORT, got["t1"]))


def test_update_transforms_array_matches_rebuild():
    t1 = make_transforms(5, seed=4)

    def scene(P):
        r = make_renderer(P)
        register_mat(P, r)
        r.submit_render_commands(commands(P, make_transforms(5, seed=3)))
        render(r)
        r.update_transforms(np.stack(t1))
        return {"images": [render(r)]}

    got = against_reference(scene, "dense update")
    np.testing.assert_array_equal(got["images"][0], fresh_image(PORT, t1))


def test_update_transforms_sparse_dict():
    t0 = make_transforms(5, seed=5)
    moved = np.eye(4, dtype=np.float32)
    moved[:3, 3] = [1.5, 0.5, -1.0]

    def scene(P):
        r = make_renderer(P)
        register_mat(P, r)
        r.submit_render_commands(commands(P, t0))
        render(r)
        r.update_transforms({2: moved})
        return {"images": [render(r)]}

    got = against_reference(scene, "sparse update")
    expect = list(t0)
    expect[2] = moved
    np.testing.assert_array_equal(got["images"][0], fresh_image(PORT, expect))


def test_update_material_changes_pixels_without_rebuild():
    t0 = make_transforms(4, seed=6)

    def scene(P):
        r = make_renderer(P)
        h = register_mat(P, r, (0.8, 0.3, 0.2, 1.0))
        r.submit_render_commands(commands(P, t0))
        red = render(r)
        before = r._scene
        r.update_material(h, P.core.Material(color=(0.1, 0.2, 0.9, 1.0)))
        return {"images": [red, render(r)], "r": r, "before": before}

    got = against_reference(scene, "update_material")
    r, red, blue = got["r"], *got["images"]
    assert r._scene_epoch == 1 and r._scene is not None
    assert not np.array_equal(red, blue)
    np.testing.assert_array_equal(
        blue, fresh_image(PORT, t0, color=(0.1, 0.2, 0.9, 1.0)))
    # The geometry stays; only the material table is replaced.
    assert r._scene.buffers.position is got["before"].buffers.position


def test_reregister_material_invalidates_fast_path():
    t0 = make_transforms(4, seed=7)

    def scene(P):
        r = make_renderer(P)
        h = register_mat(P, r, (0.8, 0.3, 0.2, 1.0))
        r.submit_render_commands(commands(P, t0))
        render(r)
        r.register_material_handle(
            h, P.core.Material(color=(0.1, 0.9, 0.2, 1.0)))
        r.submit_render_commands(commands(P, t0))
        return {"images": [render(r)], "r": r}

    got = against_reference(scene, "re-registered material")
    assert got["r"]._scene_epoch == 2, "the resubmit must rebuild"
    np.testing.assert_array_equal(
        got["images"][0], fresh_image(PORT, t0, color=(0.1, 0.9, 0.2, 1.0)))


def test_shadow_cache_reused_when_static():
    def scene(P):
        r = make_renderer(P)
        register_mat(P, r)
        r.submit_render_commands(commands(P, make_transforms(4, seed=8)))
        img1 = render(r)
        map1 = r._shadow_cache[1]
        img2 = render(r)
        return {"images": [img1, img2], "same_map": r._shadow_cache[1] is map1}

    got = against_reference(scene, "static shadow cache")
    assert got["same_map"], "a static frame must reuse the map"
    np.testing.assert_array_equal(*got["images"])


def test_shadow_cache_invalidated_by_transform_update():
    t0 = make_transforms(4, seed=9)
    t1 = [t.copy() for t in t0]
    t1[0][:3, 3] += np.float32(1.0)

    def scene(P):
        r = make_renderer(P)
        register_mat(P, r)
        r.submit_render_commands(commands(P, t0))
        render(r)
        map1 = r._shadow_cache[1]
        r.update_transforms(np.stack(t1))
        img = render(r)
        stale = r._shadow_cache is not None and r._shadow_cache[1] is map1
        return {"images": [img], "stale": stale}

    got = against_reference(scene, "moved shadow caster")
    assert not got["stale"], "moved models served the cached shadow map"
    np.testing.assert_array_equal(got["images"][0], fresh_image(PORT, t1))


def test_shadow_cache_invalidated_by_light_change():
    def scene(P):
        r = make_renderer(P)
        register_mat(P, r)
        r.submit_render_commands(commands(P, make_transforms(4, seed=10)))
        img1 = render(r)
        map1 = r._shadow_cache[1]
        r.shadow_feature.set_light_direction([0.3, -1.0, 0.5])
        img2 = render(r)
        return {"images": [img1, img2],
                "new_map": r._shadow_cache[1] is not map1}

    got = against_reference(scene, "new light direction")
    assert got["new_map"]


def test_auto_fit_bounds_track_moving_objects():
    t0 = make_transforms(3, seed=11, spread=2.0)
    t1 = [t.copy() for t in t0]
    t1[0][:3, 3] = [20.0, 0.0, 0.0]  # one cube flies far away

    def scene(P):
        r = make_renderer(P, pinned=False)
        register_mat(P, r)
        r.submit_render_commands(commands(P, t0))
        first = render(r)
        r0 = r.shadow_feature.scene_radius
        light0 = r.shadow_feature.light_space_matrix().copy()
        r.update_transforms(np.stack(t1))
        fit = (r.shadow_feature.scene_center.copy(),
               r.shadow_feature.scene_radius)
        moved = render(r)
        return {"images": [first, moved], "r0": r0, "fit": fit, "r": r,
                "light0": light0}

    got = against_reference(scene, "unpinned bounds")
    center, radius = got["fit"]
    assert radius > got["r0"] + 5.0
    # The light matrix follows the refit, so the shadow cache misses
    # through the light key too.
    assert not np.array_equal(got["r"].shadow_feature.light_space_matrix(),
                              got["light0"])
    r2 = make_renderer(PORT, pinned=False)
    register_mat(PORT, r2)
    r2.submit_render_commands(commands(PORT, t1))
    render(r2)
    np.testing.assert_allclose(center, r2.shadow_feature.scene_center,
                               atol=1e-4)
    np.testing.assert_allclose(radius, r2.shadow_feature.scene_radius,
                               rtol=1e-5)


def test_update_transforms_before_first_frame():
    t1 = make_transforms(3, seed=13)

    def scene(P):
        r = make_renderer(P)
        register_mat(P, r)
        r.submit_render_commands(commands(P, make_transforms(3, seed=12)))
        r.update_transforms(np.stack(t1))  # nothing built yet
        return {"images": [render(r)]}

    got = against_reference(scene, "update before the first frame")
    np.testing.assert_array_equal(got["images"][0], fresh_image(PORT, t1))


@pytest.mark.parametrize("case", ["larger_list", "same_size_new_signature"])
def test_resubmit_after_dense_update(case):
    """A dense update defers the items' write-back; a new draw list after
    it (longer, or as long under a new material handle) must render its
    own transforms, not the old mirror's."""
    n0, n1 = (2, 3) if case == "larger_list" else (3, 3)
    t1 = make_transforms(n1, seed=8)

    def scene(P):
        r = make_renderer(P)
        register_mat(P, r)
        r.submit_render_commands(commands(P, make_transforms(n0, seed=6)))
        render(r)
        r.update_transforms(np.stack(make_transforms(n0, seed=7)))
        render(r)
        handle = 1
        if case == "same_size_new_signature":
            handle = register_mat(P, r, handle=2)
        r.submit_render_commands(commands(P, t1, material=handle))
        return {"images": [render(r)]}

    got = against_reference(scene, f"resubmit, {case}")
    np.testing.assert_array_equal(got["images"][0], fresh_image(PORT, t1))


def test_update_material_before_first_render_applies():
    t0 = make_transforms(3, seed=21)

    def scene(P):
        r = make_renderer(P)
        h = register_mat(P, r, color=(0.1, 0.1, 0.9, 1.0))
        r.submit_render_commands(commands(P, t0, material=h))
        r.update_material(h, P.core.Material(color=(0.9, 0.1, 0.1, 1.0)))
        return {"images": [render(r)]}

    got = against_reference(scene, "update_material before the first frame")
    np.testing.assert_array_equal(
        got["images"][0], fresh_image(PORT, t0, color=(0.9, 0.1, 0.1, 1.0)))


@pytest.mark.parametrize("update", ["dense", "sparse"])
def test_static_frames_after_update_keep_the_update(update):
    """A frame right after an update and static frames after it render the
    updated transforms (the host mirror, not the stale items, is what the
    frames read), also once the shadow cache hits again."""
    t0 = make_transforms(4, seed=30)
    t1 = [t.copy() for t in t0]
    if update == "dense":
        for t in t1:
            t[:3, 3] += np.float32(0.8)
    else:
        t1[2][:3, 3] -= np.float32(1.2)

    def scene(P):
        r = make_renderer(P)
        register_mat(P, r)
        r.submit_render_commands(commands(P, t0))
        render(r)
        r.update_transforms(np.stack(t1) if update == "dense" else {2: t1[2]})
        return {"images": [render(r), render(r), render(r)]}

    got = against_reference(scene, f"{update} update, then static frames")
    want = fresh_image(PORT, t1)
    for img in got["images"]:
        np.testing.assert_array_equal(img, want)


def test_update_transforms_trs_matches_matrix_path():
    t, q, s = random_trs(4, seed=40)
    base = make_transforms(4, seed=41)

    def scene(P, trs=True):
        r = make_renderer(P)
        register_mat(P, r)
        r.submit_render_commands(commands(P, base))
        render(r)
        if trs:
            r.update_transforms_trs(t, q, s)
        else:
            r.update_transforms(P.core.maths.mat4_trs_batch(t, q, s))
        return {"images": [render(r), render(r)]}

    got = against_reference(scene, "TRS update")
    by_matrix = scene(PORT, trs=False)["images"][0]
    np.testing.assert_array_equal(got["images"][0], by_matrix)
    np.testing.assert_array_equal(got["images"][1], by_matrix)


def test_update_transforms_trs_uniform_scale_and_transitions():
    """(N,) uniform scales, then a sparse matrix update on top of the TRS
    state (the mirror is composed first)."""
    t, q, _ = random_trs(3, seed=42)
    s1 = np.array([0.5, 1.0, 1.5], np.float32)
    moved = np.eye(4, dtype=np.float32)
    moved[:3, 3] = [1.0, 0.2, -0.5]

    def scene(P):
        r = make_renderer(P)
        register_mat(P, r)
        r.submit_render_commands(commands(P, make_transforms(3, seed=43)))
        render(r)
        r.update_transforms_trs(t, q, s1)
        render(r)
        r.update_transforms({1: moved})
        return {"images": [render(r)]}

    got = against_reference(scene, "TRS then a sparse matrix update")
    full = port_core.maths.mat4_trs_batch(t, q, np.repeat(s1[:, None], 3, 1))
    np.testing.assert_array_equal(
        got["images"][0], fresh_image(PORT, [full[0], moved, full[2]]))


def test_update_transforms_trs_before_scene_build():
    t, q, s = random_trs(3, seed=44)

    def scene(P):
        r = make_renderer(P)
        register_mat(P, r)
        r.submit_render_commands(commands(P, make_transforms(3, seed=45)))
        r.update_transforms_trs(t, q, s)  # nothing built yet
        return {"images": [render(r)]}

    got = against_reference(scene, "TRS before the first frame")
    np.testing.assert_array_equal(
        got["images"][0],
        fresh_image(PORT, list(port_core.maths.mat4_trs_batch(t, q, s))))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_models_from_trs_is_mat4_trs_batch(seed):
    """The device compose equals the host compose bit for bit: arbitrary
    unnormalised quaternions, non-uniform and negative scales."""
    rng = np.random.default_rng(seed)
    n = 257
    t = rng.normal(0, 50, (n, 3)).astype(np.float32)
    q = rng.normal(0, 1.5, (n, 4)).astype(np.float32)
    s = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    got = frame.models_from_trs(torch.from_numpy(t), torch.from_numpy(q),
                                torch.from_numpy(s)).numpy()
    want = port_core.maths.mat4_trs_batch(t, q, s)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def _taa_scene(P, move):
    """HDR + TAA, three cubes; after frame 1 a TRS update moves draw 1
    (or, with move=False, restates every transform unchanged)."""
    r = make_renderer(P)
    register_mat(P, r)
    r.initialize_hdr()
    r.set_taa_enabled(True)
    base = make_transforms(3, seed=51)
    r.submit_render_commands(commands(P, base))
    images = [render(r)]
    t, q, s = random_trs(3, seed=50)
    tt = np.array([m[:3, 3] for m in base])
    qq = np.tile(np.array([0, 0, 0, 1], np.float32), (3, 1))
    ss = np.ones((3, 3), np.float32)
    if move:
        tt[1], qq[1], ss[1] = t[1], q[1], s[1]
    r.update_transforms_trs(tt, qq, ss)
    return r, images


def _velocity_after_update(move):
    """(prev_models handed to the frame after the update, last frame's
    models, the models, the frame's largest |velocity|) on the port."""
    r, _ = _taa_scene(PORT, move)
    prev = r._prev_models.clone()
    cam = port_core.Camera.new([5.0, 4.0, 6.0], [0, 0, 0], W / H)
    inputs = r.prepare_frame(cam.view_matrix(), cam.projection_matrix(),
                             cam.position)
    band = frame.render_band(inputs.config, inputs.scene.buffers,
                             inputs.uniforms, r._external_shadow(inputs))
    uni = inputs.uniforms
    return uni.prev_models, prev, uni.models, float(band.velocity.abs().max())


def test_trs_update_gives_taa_its_previous_models():
    """With the HDR chain and TAA on, the frame after a TRS update gets
    last frame's models as prev_models, so the moved draw has motion
    vectors (a still camera leaves only the jitter elsewhere), and the
    frames match the reference's."""
    def scene(P):
        r, images = _taa_scene(P, move=True)
        images += [render(r), render(r)]
        return {"images": images}

    against_reference(scene, "TAA after a TRS update")
    prev_models, last, models, moving = _velocity_after_update(True)
    assert torch.equal(prev_models, last)
    changed = (models != prev_models).flatten(1).any(1).nonzero().flatten()
    assert changed.tolist() == [1]
    _, _, _, still = _velocity_after_update(False)
    print(f"measured largest |velocity|: {moving:.4f} with draw 1 moved, "
          f"{still:.4f} with every transform restated")
    assert moving > 5 * still


def test_bench_animation_is_bench_py():
    """bench_scene's anim dict and poses are bench.py's."""
    import bench

    _, _, _, anim = bench.build_bench_renderer(64, 64, 27, shadow_resolution=64)
    _, _, _, got = bench_scene.build_bench_renderer(64, 64, 27, "cpu",
                                                    animate=True)
    for k in ("positions", "scales", "phases"):
        np.testing.assert_array_equal(got[k], anim[k])
    assert got["extent"] == anim["extent"]
    for t in (0.0, 0.5, 1.0 / 60.0):
        np.testing.assert_array_equal(bench_scene.animated_models(got, t),
                                      bench.animated_models(anim, t))
        for a, b in zip(bench_scene.animated_models_trs(got, t),
                        bench.animated_models_trs(anim, t)):
            np.testing.assert_array_equal(a, b)
    c1 = port_core.Camera.new([1, 2, 3], [0, 0, 0], 1.0)
    c2 = ref_core.Camera.new([1, 2, 3], [0, 0, 0], 1.0)
    np.testing.assert_array_equal(bench_scene.orbit_camera(c1, 9.0, 2.5),
                                  bench.orbit_camera(c2, 9.0, 2.5))
