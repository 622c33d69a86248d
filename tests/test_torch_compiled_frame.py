"""The frame as the renderer runs it (render/compiled.py): its static
buffers, its graph keys and the TAA resolve's device values, on the CPU;
graphed frames against eager ones on the card.

- The renderer's step (the constants in one static buffer, the models in
  its region, the TRS composed there, last frame's models as a copy, the
  TAA jitters and blend factor read on the device) against
  render_frame_program run as before the static buffers, on fresh copies
  of the same inputs with the TAA values on the host and the shadow map
  rendered anew: bit for bit (u8, colour, depth, every scalar, the shadow
  map and the history), 4 frames each of the standard, animated (TRS every
  frame), rich (TAA, 3 cascades, 32 lights, bloom), textured, glass (2
  passes) and a two-level-binned scene, at 192x128 with 64 cubes and 16x32
  tiles.
- A frame's outputs stay as they were after the next frame.
- TAA's motion vectors move after a models update (last frame's models are
  a copy, not the models region the update overwrites).
- taa_resolve with the jitters and the blend factor as tensors equals its
  host form bit for bit, and ash_tpu's resolve at tests/test_torch_taa.py's
  tolerance (atol 1e-5 + rtol 1e-5).
- The frame graph's key changes on a resize, an escalation, a scene
  rebuild, a material edit, a pool change, a light change, a PostParams
  change and a TAA switch, and not on a camera move or a models update.
- Frames that profiling or the chunked path takes are counted as eager.

tests/test_torch_graphs_cuda.py holds graphed frames to eager ones on the
card.
"""

import dataclasses
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ash_tpu.ops import taa as ref_taa
from ash_tpu_torch.core import maths
from ash_tpu_torch.ops import taa
from ash_tpu_torch.render import compiled, frame
from ash_tpu_torch.render.bench_scene import (
    animated_models_trs,
    build_bench_renderer,
    orbit_camera,
)

torch.set_num_threads(1)

W, H, N = 192, 128, 64
TILES = dict(tile_h=16, tile_w=32)
SCENES = {
    "standard": dict(),
    "animated": dict(animate=True),
    "rich": dict(rich=True),
    "textured": dict(textured=True),
    "glass p=2": dict(glass=True, transparency_passes=2),
    "two-level": dict(two_level_binning=True),
}


def _build(device, **kw):
    return build_bench_renderer(W, H, N, device, **{**TILES, **kw})


def _poses(kw, cam, extent, frames=4):
    """Per frame: (update or None, view, proj, pos)."""
    proj = cam.projection_matrix()
    out = []
    for i in range(frames):
        if kw.get("animate"):
            t = (i + 1) / 60.0
            view = orbit_camera(cam, extent["extent"], t)
            out.append((animated_models_trs(extent, t), view, proj,
                        cam.position))
        else:
            out.append((None, cam.view_matrix(), proj, cam.position))
    return out


class _Spy:
    """Wraps prepare_frame: keeps fresh copies of each frame's inputs, as
    the frame read them, with the TAA values on the host."""

    def __init__(self, r):
        self.r, self.frames = r, []
        self._prepare = r.prepare_frame
        r.prepare_frame = self

    def __call__(self, *args):
        inputs = self._prepare(*args)
        uni = type(inputs.uniforms)(*(
            None if x is None else x.clone() for x in inputs.uniforms))
        t = inputs.taa_params
        host_taa = None if t is None else taa.TaaParams(
            float(t.blend_factor), t.color_clamp, t.velocity_rejection,
            t.jitter.numpy().copy(), t.prev_jitter.numpy().copy())
        trs = None
        if self.r._trs_pending:
            trs = tuple(torch.from_numpy(x.copy()) for x in self.r._trs_host)
        self.frames.append((inputs._replace(uniforms=uni,
                                            taa_params=host_taa), trs))
        return inputs


def _as_before(spy):
    """render_frame_program on the spy's fresh inputs, with the history,
    the previous depth and last frame's models chained as the renderer
    chained them before its static buffers, the shadow map rendered anew
    each frame -> [FrameOutputs]."""
    r = spy.r
    outs, history, prev_depth, prev_models = [], None, None, None
    for inputs, trs in spy.frames:
        cfg, uni = inputs.config, inputs.uniforms
        if trs is not None:  # the models as the TRS compose them
            assert torch.equal(uni.models, frame.models_from_trs(*trs))
        if inputs.taa_params is not None:
            uni = uni._replace(prev_models=(
                prev_models if prev_models is not None
                and prev_models.shape == uni.models.shape else uni.models))
        shadow = None
        if cfg.shadow_enabled and not cfg.lod_enabled:
            shadow = frame.shadow_program(
                cfg, inputs.scene.buffers, uni.models, uni.light_space_matrix,
                inputs.pool, uni.cascade_matrices)
        hist = None
        if inputs.taa_params is not None:
            hist = (history if history is not None
                    else torch.zeros((cfg.height, cfg.width, 3)))
        pd = None
        if cfg.occlusion_culling:
            pd = (prev_depth if prev_depth is not None
                  else torch.ones((cfg.height, cfg.width)))
        o = frame.render_frame_program(
            cfg, inputs.scene.buffers, uni, shadow, inputs.pool,
            inputs.lights, inputs.post, inputs.taa_params, hist, pd, r._ibl)
        if o.history is not None:
            history = o.history
        if cfg.occlusion_culling:
            prev_depth = o.depth
        prev_models = uni.models
        outs.append(o)
    return outs


def _snapshot(o):
    return {k: (v.clone() if isinstance(v, torch.Tensor) else v)
            for k, v in o._asdict().items()}


def _assert_same(got, want, what):
    for k, v in want._asdict().items() if not isinstance(want, dict) \
            else want.items():
        g = got[k] if isinstance(got, dict) else getattr(got, k)
        if v is None:
            assert g is None, f"{what}: {k} is not None"
            continue
        assert torch.equal(g, v), f"{what}: {k} differs"


@pytest.mark.parametrize("name", sorted(SCENES))
def test_static_buffer_step_equals_the_eager_program(name):
    kw = SCENES[name]
    r, _, cam, extent = _build("cpu", **kw)
    spy = _Spy(r)
    got = []
    for update, view, proj, pos in _poses(kw, cam, extent):
        if update is not None:
            r.update_transforms_trs(*update)
        got.append(_snapshot(r.render_frame(view, proj, pos)))
    want = _as_before(spy)
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_same(g, w, f"{name} frame {i}")
    if kw.get("rich"):
        # TAA moved the history and the jitter moved the frame.
        assert not torch.equal(got[2]["color"], got[3]["color"])
    if kw.get("animate"):
        assert not torch.equal(got[1]["image"], got[2]["image"])


@pytest.mark.parametrize("name", ["rich", "animated"])
def test_outputs_stay_after_the_next_frame(name):
    kw = SCENES[name]
    r, _, cam, extent = _build("cpu", **kw)
    kept = []
    for update, view, proj, pos in _poses(kw, cam, extent, frames=3):
        if update is not None:
            r.update_transforms_trs(*update)
        out = r.render_frame(view, proj, pos)
        kept.append((out, _snapshot(out), r.read_back().copy()))
    for i, (out, snap, image) in enumerate(kept):
        _assert_same(out, snap, f"{name} frame {i} after frame {len(kept)}")
        assert np.array_equal(image, snap["image"].numpy())
    last = kept[-1][0]
    assert r.last_outputs() is last
    # What the frame reads goes in through the renderer's own buffers, which
    # the steps write in place, not a returned tensor; the returned map is
    # the cached copy of the shadow pass's.
    assert r._shadow_cache[1] is last.shadow_map
    owned = {b.data_ptr() for b in (r._history_buf, *r._shadow_bufs)
             if b is not None}
    returned = {t.data_ptr() for o, _, _ in kept
                for t in o if isinstance(t, torch.Tensor)}
    assert not returned & owned, owned
    assert (r._taa_history is not None) == (last.history is not None)


def test_motion_vectors_move_after_a_models_update():
    """A static camera and a moved scene: with last frame's models kept as a
    copy the moved draws' velocity shows; with the models region itself
    (the alias) it would be the jitter's alone."""
    r, _, cam, extent = _build("cpu", rich=True)
    velocities = []

    def spy(color, history, params, velocity=None):
        velocities.append(velocity.clone())
        return taa.taa_resolve(color, history, params, velocity=velocity)

    view, proj, pos = cam.view_matrix(), cam.projection_matrix(), cam.position
    models = np.stack([np.asarray(it.model) for it in r.draw_items])
    with mock.patch.object(frame, "taa_resolve", spy):
        r.render_frame(view, proj, pos)
        r.render_frame(view, proj, pos)
        moved = models.copy()
        moved[:, :3, 3] += np.float32(0.25)
        r.update_transforms(moved)
        r.render_frame(view, proj, pos)
        r.render_frame(view, proj, pos)
    # The jitter's own motion is under a pixel (0.0013-0.002 in uv here);
    # the moved draws' is about 0.015, and would be the jitter's alone
    # if last frame's models were the region the update overwrote.
    still, moved, stopped = (float(v.abs().max()) for v in velocities[1:])
    print(f"measured max |velocity|: static {still:.4g}, after the update "
          f"{moved:.4g}, after that {stopped:.4g}")
    assert moved > 4 * max(still, stopped)
    assert torch.equal(r._prev_models, r._models)
    assert r._prev_models.data_ptr() != r._models.data_ptr()


def _resolve_inputs(h=48, w=64):
    rng = np.random.default_rng(3)
    current = (rng.random((h, w, 3)) * 2.0).astype(np.float32)
    history = (rng.random((h, w, 3)) * 2.0).astype(np.float32)
    velocity = rng.normal(0.0, 0.01, (h, w, 2)).astype(np.float32)
    velocity[:, :8, 0] = 0.2  # history off screen at the left edge
    velocity[::5, ::7] = 0.0  # below 1e-4: the jitter difference
    return current, history, velocity


@pytest.mark.parametrize("with_velocity", [False, True])
@pytest.mark.parametrize("switches", [(1.0, 1.0), (0.0, 1.0), (1.0, 0.0)])
def test_taa_resolve_device_values_equal_host_values(with_velocity,
                                                     switches):
    current, history, velocity = _resolve_inputs()
    jitter = np.array([0.25, -0.125], np.float32) * np.float32(1.37)
    prev_jitter = np.array([-0.3, 0.4], np.float32) * np.float32(0.71)
    vel = torch.from_numpy(velocity) if with_velocity else None
    cur, hist = torch.from_numpy(current), torch.from_numpy(history)
    host = taa.taa_resolve(cur, hist, taa.TaaParams(
        0.9, *switches, jitter, prev_jitter), velocity=vel)
    dev = taa.taa_resolve(cur, hist, taa.TaaParams(
        torch.tensor(np.float32(0.9)), *switches, torch.from_numpy(jitter),
        torch.from_numpy(prev_jitter)), velocity=vel)
    assert torch.equal(dev, host)
    want = ref_taa.taa_resolve(
        jnp.asarray(current), jnp.asarray(history),
        ref_taa.TaaParams(np.float32(0.9), np.float32(switches[0]),
                          np.float32(switches[1]), jitter, prev_jitter),
        velocity=jnp.asarray(velocity) if with_velocity else None)
    err = np.abs(dev.numpy() - np.asarray(want))
    print(f"measured taa_resolve device values against ash_tpu: max abs err "
          f"{err.max():.3e}")
    assert (err <= 1e-5 + 1e-5 * np.abs(np.asarray(want))).all()


def test_frame_key_follows_what_shapes_the_frame():
    r, surface, cam, _ = _build("cpu", textured=True)
    view, proj, pos = cam.view_matrix(), cam.projection_matrix(), cam.position

    def key(view=view):
        r.render_frame(view, proj, pos)
        return r._graphs["frame"].key

    k0 = key()
    assert key() == k0
    moved = cam.view_matrix() @ maths.mat4_translation(
        np.array([0.1, 0.0, 0.0], np.float32))
    assert key(moved) == k0, "a camera move keeps the key"
    models = np.stack([np.asarray(it.model) for it in r.draw_items])
    models[:, :3, 3] += np.float32(0.1)
    r.update_transforms(models)
    assert key() == k0, "a models update keeps the key"

    def changes(what, edit):
        before = key()
        edit()
        after = key()
        assert after != before, f"{what} keeps the key"

    r.request_swapchain_resize(160, 96)  # one frame at 160x96
    assert key() != k0, "a resize keeps the key"
    assert key() == k0, "the surface's size again"
    changes("an escalation",
            lambda: r.escalate_tile_capacities(main_overflow=1))
    changes("a material edit", lambda: r.update_material(
        1, dataclasses.replace(r.material_handles[1], roughness=0.9)))
    changes("a pool change", lambda: r.request_texture_residency(0, 1))
    changes("a light change", lambda: r.add_point_light([0.0, 1.0, 0.0]))
    changes("a PostParams change", lambda: r.set_bloom_intensity(0.7))
    changes("a TAA switch", lambda: r.set_taa_enabled(True))
    changes("a scene rebuild", lambda: r.submit_render_commands(
        r_commands(r)[:-1]))


def r_commands(r):
    from ash_tpu_torch.render import RenderCommand

    meshes = {v: k for k, v in r.mesh_handles.items()}
    mats = r._draw_mat_handles
    return [RenderCommand(mesh=meshes[it.mesh_key], transform=it.model,
                          material=m)
            for it, m in zip(r.draw_items, mats)]


def test_profiling_and_chunked_frames_count_as_eager():
    r, _, cam, _ = _build("cpu")
    view, proj, pos = cam.view_matrix(), cam.projection_matrix(), cam.position
    compiled.reset_stats()
    r.render_frame(view, proj, pos)
    r.frame_cost_analysis(view, proj, pos)
    r.profile_passes(view, proj, pos, n=1)
    with compiled.eager("asked"):
        r.render_frame(view, proj, pos)
    eager = compiled.stats["frame"]["eager"]
    assert eager == {"cpu": 1, "cost_analysis": 1, "profile_passes": 1,
                     "asked": 1}
    assert compiled.stats["frame"]["replays"] == 0
    rc, _, cam, _ = _build("cpu", max_draws_per_chunk=16)
    rc.render_frame(cam.view_matrix(), cam.projection_matrix(), cam.position)
    assert compiled.stats["frame"]["eager"]["chunked"] == 1
