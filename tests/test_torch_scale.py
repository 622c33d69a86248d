"""Scale on ash_tpu_torch against ash_tpu on the CPU: two-level binning,
tile-capacity escalation, and a sphere grid above the automatic switch.

Tolerances:

- `bin_triangles_two_level` and `_keep_rank` against the reference's on the
  same inputs: equal array for array (ids, counts, overflow), under both
  keep policies;
- the scenes of tests/test_capacity_escalation.py: the escalation's
  returned caps equal; overflow counts equal to the reference's; the
  reference test's bars on the port's own frames (bit for bit); each frame
  against the reference's frame of the same scene at u8 PSNR >= 40 dB;
- the sphere grid (build_sphere_grid(130), 33,282 triangles, 65,536
  padded) at 160x120: the same escalation rounds and caps, each overflow
  within 2 triangles or 0.5% of the reference's (its setup contracts FMA,
  ROADMAP.md C), bins equal array for array on the port's own setup, the
  frame at u8 PSNR >= 40 dB against the reference's (the PSNR and the
  differing pixels are printed).
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
from ash_tpu.ops import binning as ref_binning
from ash_tpu.utils.image import psnr
from ash_tpu_torch.ops import binning
from ash_tpu_torch.render import bench_scene, frame

torch.set_num_threads(1)

MIN_PSNR = 40.0
REF = SimpleNamespace(core=ref_core, render=ref_render, kw={})
PORT = SimpleNamespace(core=port_core, render=port_render,
                       kw={"device": "cpu"})


def _same_bins(got, want, what):
    for f in ("tri_ids", "counts", "overflow"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{what}: {f}")


def _random_boxes(t, w, h, seed, spread=(60, 40)):
    rng = np.random.default_rng(seed)
    x0 = rng.random(t) * w
    y0 = rng.random(t) * h
    bbox = np.stack([x0, y0, x0 + rng.random(t) * spread[0],
                     y0 + rng.random(t) * spread[1]], 1).astype(np.float32)
    return bbox, rng.random(t) > 0.2


def _binning_case(case):
    """-> [(bbox, valid, args, kwargs)] of one reference test's inputs:
    tests/test_raster.py:200-251 and tests/test_ops_regressions.py:62, and
    a dense random set that overflows both levels."""
    if case == "matches_dense":
        bbox, valid = _random_boxes(300, 200, 150, seed=5)
        return [(bbox, valid, (h, 208, 16, 32, 64),
                 dict(y0=y0, coarse_tiles=(3, 2), coarse_cap=300))
                for y0, h in ((0, 160), (64, 48))]
    if case == "coarse_overflow":
        bbox = np.tile(np.array([[1.0, 1.0, 3.0, 3.0]], np.float32), (64, 1))
        return [(bbox, np.ones(64, bool), (64, 64, 16, 32, 64),
                 dict(coarse_cap=16))]
    if case == "pad_tiles":
        w = 96
        bbox = np.array([(4.0, 4.0, 12.0, 12.0)]
                        + [(w + 2.0 + i, 1.0, w + 20.0 + i, 6.0)
                           for i in range(6)], np.float32)
        return [(bbox, np.ones(len(bbox), bool), (64, w, 8, 32, 4),
                 dict(coarse_tiles=(4, 2)))]
    bbox, valid = _random_boxes(5000, 300, 100, seed=0, spread=(30, 24))
    bbox[:20] = [-1e9, -1e9, 1e9, 1e9]  # near-plane crossers' boxes
    return [(bbox, valid, (100, 300, 8, 32, cap), dict(y0=y0, coarse_cap=kc))
            for cap, kc in ((64, 200), (16, 100), (300, 5000))
            for y0 in (0, 16)]


@pytest.mark.parametrize("policy", ["draw_order", "nearest"])
@pytest.mark.parametrize("case", ["matches_dense", "coarse_overflow",
                                  "pad_tiles", "random_overflow"])
def test_two_level_binning_matches_reference(case, policy):
    for i, (bbox, valid, args, kw) in enumerate(_binning_case(case)):
        rng = np.random.default_rng(i)
        # Few distinct scores: ties decide by id, as in the reference.
        score = (rng.integers(0, 7, len(bbox)).astype(np.float32)
                 if policy == "nearest" else None)
        got = binning.bin_triangles_two_level(
            torch.from_numpy(bbox), torch.from_numpy(valid), *args, **kw,
            keep_score=None if score is None else torch.from_numpy(score))
        want = ref_binning.bin_triangles_two_level(
            jnp.asarray(bbox), jnp.asarray(valid), *args, **kw,
            keep_score=None if score is None else jnp.asarray(score))
        _same_bins(got, want, f"{case} {policy} {i}")
        if case == "matches_dense":
            dense = binning.bin_triangles(
                torch.from_numpy(bbox), torch.from_numpy(valid), *args,
                y0=kw["y0"],
                keep_score=None if score is None else torch.from_numpy(score))
            _same_bins(got, dense, f"two-level == dense, {policy} {i}")
        elif case == "coarse_overflow":
            assert int(got.overflow) >= 64 - 16
        elif case == "pad_tiles":
            assert int(got.overflow) == 0 and int(got.counts.max()) == 1


def test_keep_rank_matches_lexsort_above_32768():
    """The rank behind the "nearest" policy, over 70,000 scores with many
    ties, against the reference's lexsort."""
    rng = np.random.default_rng(3)
    score = rng.integers(-500, 500, 70000).astype(np.float32)
    rank, to_id = binning._keep_rank(torch.from_numpy(score))
    want_rank, want_id = ref_binning._keep_rank(jnp.asarray(score))
    np.testing.assert_array_equal(rank.numpy(), np.asarray(want_rank))
    np.testing.assert_array_equal(to_id.numpy(), np.asarray(want_id))


# The scenes of tests/test_capacity_escalation.py.


def _stacked(P, r, n=24, far_first=False):
    """n cubes stacked along the view axis: their triangles share tiles, a
    small cap overflows, the front cube hides the rest."""
    r.register_mesh_handle(0, P.core.Mesh.create_cube())
    cmds = []
    for i in (range(n - 1, -1, -1) if far_first else range(n)):
        m = np.eye(4, dtype=np.float32)
        m[2, 3] = -0.15 * i
        r.register_material_handle(
            i + 1, P.core.Material(color=(0.9, 0.3 + 0.5 * (i % 2), 0.2, 1.0)))
        cmds.append(P.render.RenderCommand(mesh=0, transform=m,
                                           material=i + 1))
    r.submit_render_commands(cmds)


def _cam_args():
    cam = port_core.Camera.new([0, 0, 4], [0, 0, 0], 1.0)
    return cam.view_matrix(), cam.projection_matrix(), cam.position


def _stacked_render(P, cap, policy="nearest", coarse=None, escalate=0,
                    far_first=False):
    """-> (renderer, [(image, main overflow)] of each render: the first
    frame, then one per escalation round while anything drops)."""
    cfg = P.render.RendererConfig(
        tile_h=8, tile_w=32, max_tris_per_tile=cap,
        shadow_max_tris_per_tile=cap, shadows_enabled=False,
        shadow_resolution=128, shadow_tile=32, binning_policy=policy)
    if coarse is not None:
        cfg.two_level_binning = True
        cfg.binning_coarse_cap = coarse
    r = P.render.Renderer(P.render.HeadlessSurface(64, 64), cfg, **P.kw)
    _stacked(P, r, far_first=far_first)
    out = r.render_frame(*_cam_args())
    frames = [(np.array(out.image), int(out.binning_overflow))]
    for _ in range(escalate):
        if frames[-1][1] == 0:
            break
        assert r.escalate_tile_capacities(frames[-1][1], 0)
        out = r.render_frame(*_cam_args())
        frames.append((np.array(out.image), int(out.binning_overflow)))
    return r, frames


def _both(**kw):
    """The port's and the reference's runs of one stacked scene, held
    together: equal overflows and caps, frames at MIN_PSNR."""
    r, got = _stacked_render(PORT, **kw)
    r_ref, want = _stacked_render(REF, **kw)
    assert [o for _, o in got] == [o for _, o in want]
    assert ((r.config.max_tris_per_tile, r.config.binning_coarse_cap)
            == (r_ref.config.max_tris_per_tile,
                r_ref.config.binning_coarse_cap))
    for (g, _), (w, _) in zip(got, want):
        p = psnr(g, w)
        print(f"measured stacked cubes {kw}: PSNR {p:.2f} dB")
        assert p >= MIN_PSNR
    return r, got


def test_escalation_arithmetic():
    """Cap 8192 with a worst-tile excess of 24376 main / 13240 shadow
    grows to 32768 / 32768 fine and 65536 coarse, as the reference does."""
    results = []
    for P in (PORT, REF):
        r = P.render.Renderer(P.render.HeadlessSurface(16, 16),
                              P.render.RendererConfig(
                                  max_tris_per_tile=8192,
                                  shadow_max_tris_per_tile=8192,
                                  binning_coarse_cap=16384), **P.kw)
        results.append((r.escalate_tile_capacities(24376, 13240),
                        r.escalate_tile_capacities(0, 0),
                        r.config.max_tris_per_tile))
    assert results[0] == results[1]
    assert results[0][0] == {"max_tris_per_tile": 32768,
                             "shadow_max_tris_per_tile": 32768,
                             "binning_coarse_cap": 65536}
    assert results[0][1] == {}


def test_escalation_drops_the_shadow_cache():
    r, _, cam, _ = bench_scene.build_bench_renderer(64, 48, 8, "cpu")
    r.render_frame(cam.view_matrix(), cam.projection_matrix(), cam.position)
    assert r._shadow_cache is not None
    r.escalate_tile_capacities(0, 5)
    assert r._shadow_cache is None
    assert r.config.shadow_max_tris_per_tile == 128


def test_escalated_render_is_drop_free_and_exact():
    _, uncapped = _both(cap=512)
    assert uncapped[0][1] == 0
    r, frames = _both(cap=16, escalate=1)
    assert frames[0][1] > 0 and frames[-1][1] == 0
    assert r.config.max_tris_per_tile > 16
    np.testing.assert_array_equal(frames[-1][0], uncapped[0][0])


def test_escalation_covers_coarse_level_overflow():
    _, uncapped = _both(cap=512)
    r, frames = _both(cap=16, coarse=32, escalate=5)
    assert frames[-1][1] == 0
    assert r.config.binning_coarse_cap > 32
    np.testing.assert_array_equal(frames[-1][0], uncapped[0][0])


def test_nearest_policy_occluded_drops_are_invisible():
    _, uncapped = _both(cap=512)
    _, capped = _both(cap=16)
    assert capped[0][1] > 0
    np.testing.assert_array_equal(capped[0][0], uncapped[0][0])


def test_draw_order_policy_can_differ_under_overflow():
    _, uncapped = _both(cap=512, far_first=True)
    _, capped = _both(cap=16, policy="draw_order", far_first=True)
    assert capped[0][1] > 0
    assert not np.array_equal(capped[0][0], uncapped[0][0])


# A sphere grid above the automatic switch to two-level binning.

SPHERE_GRID = 130  # 2 * 129^2 = 33,282 triangles, 65,536 padded
SPHERE_W, SPHERE_H = 160, 120
SPHERE_BASE_CAP = 256


def _sphere(P):
    """bench.py's mega frame at a small size: the grid through set_mesh,
    16x32 tiles (a 160x120 frame has 40), a 256^2 shadow map, base caps
    of 256 escalated until nothing drops."""
    cfg = P.render.RendererConfig(**bench_scene.mega_config(
        max_tris_per_tile=SPHERE_BASE_CAP,
        shadow_max_tris_per_tile=SPHERE_BASE_CAP, tile_h=16, tile_w=32,
        shadow_resolution=256, shadow_tile=64))
    r = P.render.Renderer(P.render.HeadlessSurface(SPHERE_W, SPHERE_H), cfg,
                          **P.kw)
    r.set_mesh(bench_scene.build_sphere_grid(SPHERE_GRID, P.core))
    r.set_material(bench_scene.mega_material(P.core))
    cam = bench_scene.mega_camera(SPHERE_W, SPHERE_H, P.core)
    args = cam.view_matrix(), cam.projection_matrix(), cam.position
    out = r.render_frame(*args)
    rounds = [(int(out.binning_overflow), int(out.shadow_overflow))]
    base = np.array(out.image)
    for _ in range(4):
        if rounds[-1] == (0, 0):
            break
        r.escalate_tile_capacities(*rounds[-1])
        out = r.render_frame(*args)
        rounds.append((int(out.binning_overflow), int(out.shadow_overflow)))
    return r, rounds, base, np.array(out.image), args


def test_sphere_grid_two_level_frame_matches_reference():
    r, rounds, base, image, args = _sphere(PORT)
    r_ref, rounds_ref, base_ref, image_ref, _ = _sphere(REF)
    caps = (r.config.max_tris_per_tile, r.config.shadow_max_tris_per_tile,
            r.config.binning_coarse_cap)
    print(f"measured sphere grid: overflow (main, shadow) per round "
          f"{rounds}, caps {caps}")
    assert r._scene.buffers.num_triangles == 65536
    # The two setups differ in the last bits (XLA contracts a*b+c into FMA
    # on the CPU, ROADMAP.md C), which moves a worst tile's count by a
    # triangle or two; the bins on one setup are equal (below).
    assert len(rounds) == len(rounds_ref) and rounds[-1] == (0, 0)
    for got, want in zip(rounds, rounds_ref):
        assert all(abs(g - w) <= max(2, 0.005 * w) for g, w in zip(got, want))
    assert rounds[0] != (0, 0)
    assert caps == (r_ref.config.max_tris_per_tile,
                    r_ref.config.shadow_max_tris_per_tile,
                    r_ref.config.binning_coarse_cap)
    for what, g, w in (("base caps", base, base_ref),
                       ("escalated", image, image_ref)):
        p = psnr(g, w)
        print(f"measured sphere grid, {what}: PSNR {p:.2f} dB, "
              f"{int((g != w).any(-1).sum())} of {SPHERE_W * SPHERE_H} "
              "pixels differ")
        assert p >= MIN_PSNR
    print(f"measured sphere grid: base caps against drop-free "
          f"{psnr(base, image):.2f} dB")

    # Both levels of the binner on this scene's own setup, main and shadow.
    inputs = r.prepare_frame(*args)
    cfg, sb, uni = inputs.config, inputs.scene.buffers, inputs.uniforms
    _, setup, bins, _ = frame.main_pass_bins(cfg, sb, uni)
    setup_s, bins_s = frame.shadow_pass_bins(
        cfg, sb, frame.shadow_world(sb, uni.models), uni.light_space_matrix)
    s = cfg.shadow_resolution
    for what, st, got, shape in (
            ("main", setup, bins, (cfg.height, cfg.width, cfg.tile_h,
                                   cfg.tile_w, cfg.max_tris_per_tile)),
            ("shadow", setup_s, bins_s, (s, s, cfg.shadow_rows,
                                         cfg.shadow_tile,
                                         cfg.shadow_max_tris_per_tile))):
        score = -st.z_clip.amin(-1)
        want = ref_binning.bin_triangles_two_level(
            jnp.asarray(st.bbox.numpy()), jnp.asarray(st.valid.numpy()),
            *shape, coarse_cap=cfg.binning_coarse_cap,
            keep_score=jnp.asarray(score.numpy()))
        _same_bins(got, want, f"sphere {what} bins")
        assert int(got.counts.max()) > SPHERE_BASE_CAP
