"""The frame farm (A18) on ash_tpu_torch, on the CPU: each device of a mesh
of `["cpu"] * n` renders another frame.

The cases of tests/test_frame_parallel.py on the port: make_frame_parallel
against the same frames rendered one by one, with the TAA ring against a
sequence that carries the history, example 09's farm over two batches
chained through history0, the (frames x bands) mesh of
make_frame_parallel_banded, and the refusals. Then make_frame_parallel
with the TAA ring and make_frame_parallel_banded against ash_tpu's own over
JAX's 8 virtual CPU devices.

Tolerances:

- inside the port: every frame's u8 image, history and covered pixels
  equal to the frame rendered alone, bit for bit;
- against ash_tpu (eager torch against one XLA program that contracts
  a*b + c into FMA): every frame's u8 image within 1 LSB (the reference
  tests' own bar), covered pixels equal, the resolved history within 1e-5
  (tests/test_torch_taa.py's ATOL) but for at most 0.1% of its values (-s
  prints the measured numbers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import __graft_entry__ as graft
from ash_tpu.core.transform import Camera as RefCamera
from ash_tpu.ops.taa import TaaParams as RefTaaParams
from ash_tpu.parallel import (
    batch_uniforms as ref_batch_uniforms,
    make_frame_parallel as ref_make_frame_parallel,
    make_frame_parallel_banded as ref_make_frame_parallel_banded,
)
from ash_tpu.render.frame import FrameConfig as RefFrameConfig
from ash_tpu_torch.core import Camera
from ash_tpu_torch.ops.taa import TaaParams
from ash_tpu_torch.parallel import (
    batch_uniforms,
    make_frame_parallel,
    make_frame_parallel_banded,
    render_mesh,
)
from ash_tpu_torch.render import bench_scene, frame
from ash_tpu_torch.render.frame import FrameConfig

torch.set_num_threads(1)

HISTORY_ATOL = 1e-5
HISTORY_FLIPS = 1e-3


def _kw(**kw):
    base = dict(
        width=96, height=64, tile_h=8, tile_w=32, max_tris_per_tile=32,
        shadow_resolution=64, shadow_tile=32, shadow_max_tris_per_tile=32,
        textured=True, lights_enabled=True, post_enabled=True,
        bloom_mips=2, reinhard=False,
    )
    base.update(kw)
    return base


def _config(**kw):
    return FrameConfig(**_kw(**kw))


def _camera(theta):
    pos = np.array([6.0 * np.cos(theta), 4.0, 6.0 * np.sin(theta)],
                   np.float32)
    return pos, Camera.new(pos, [0, 0, 0], 96 / 64)


def _uniforms_for_angle(theta, uni0):
    """The example camera rotated about Y by theta."""
    pos, cam = _camera(theta)
    view, proj = cam.view_matrix(), cam.projection_matrix()

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    return uni0._replace(view_proj=t(proj @ view), camera_pos=t(pos),
                         view=t(view), projection=t(proj))


def _ref_uniforms_for_angle(theta, uni0):
    pos, _ = _camera(theta)
    cam = RefCamera.new(pos, [0, 0, 0], 96 / 64)
    view, proj = cam.view_matrix(), cam.projection_matrix()
    return uni0._replace(view_proj=(proj @ view).astype(np.float32),
                         camera_pos=pos, view=view.astype(np.float32),
                         projection=proj.astype(np.float32))


def _with_motion(unis):
    """Frame i's previous camera is frame i - 1's."""
    return [u._replace(prev_view_proj=unis[max(i - 1, 0)].view_proj,
                       prev_models=u.models) for i, u in enumerate(unis)]


def _taa_list(n, cls=TaaParams):
    return [cls(blend_factor=np.float32(0.0 if i == 0 else 0.9),
                color_clamp=np.float32(1.0),
                velocity_rejection=np.float32(1.0),
                jitter=np.zeros(2, np.float32),
                prev_jitter=np.zeros(2, np.float32)) for i in range(n)]


def alone(cfg, scene, uni, pool=None, lights=None, taa=None, history=None):
    """One frame rendered alone, its shadow map rendered here."""
    shadow = None
    if cfg.shadow_enabled and not cfg.lod_enabled:
        shadow = frame.shadow_program(cfg, scene, uni.models,
                                      uni.light_space_matrix, pool,
                                      uni.cascade_matrices)
    return frame.render_frame_program(cfg, scene, uni, shadow, pool, lights,
                                      None, taa, history)


@pytest.fixture(scope="module")
def rich():
    return bench_scene.example_scene(rich=True, device="cpu")


def test_frame_parallel_matches_sequential(rich):
    n = 4
    scene, uni0, extras = rich
    cfg = _config()
    unis = [_uniforms_for_angle(0.5 * i, uni0) for i in range(n)]
    lights = extras["lights"]
    out = make_frame_parallel(cfg, render_mesh(devices=["cpu"] * n,
                                               axis="fp"))(
        scene, batch_uniforms(unis), pool=extras["pool"],
        lights=lights[None].expand(n, -1, -1))
    assert out.image.shape == (n, 64, 96, 4)
    assert out.history is None
    for i in range(n):
        want = alone(cfg, scene, unis[i], extras["pool"], lights)
        assert torch.equal(out.image[i], want.image), f"frame {i}"
        assert int(out.covered_pixels[i]) == int(want.covered_pixels)
        assert torch.equal(out.shadow_map[i], want.shadow_map)
    assert not torch.equal(out.image[0], out.image[1])


def test_frame_parallel_rejects_taau():
    with pytest.raises(ValueError, match="TAAU"):
        make_frame_parallel(_config(taa_enabled=True, render_scale=0.5),
                            render_mesh(devices=["cpu"] * 2, axis="fp"))


def test_frame_parallel_taa_arguments(rich):
    """TAA needs taa_batch; taa_batch needs TAA."""
    scene, uni0, _ = rich
    m = render_mesh(devices=["cpu"] * 2, axis="fp")
    batch = batch_uniforms([uni0, uni0])
    taa = batch_uniforms(_taa_list(2))
    plain = _config(textured=False, lights_enabled=False)
    with pytest.raises(ValueError, match="taa_batch"):
        make_frame_parallel(dataclasses.replace(plain, taa_enabled=True),
                            m)(scene, batch)
    with pytest.raises(ValueError, match="taa_enabled=False"):
        make_frame_parallel(plain, m)(scene, batch, taa_batch=taa)


def test_frame_parallel_pipelined_taa_matches_sequential(rich):
    """The TAA ring: a 4-frame batch equals one device rendering the 4
    frames in order, carrying the history."""
    n = 4
    scene, uni0, extras = rich
    cfg = _config(taa_enabled=True)
    lights = extras["lights"]
    unis = _with_motion([_uniforms_for_angle(0.1 * i, uni0)
                         for i in range(n)])
    taas = _taa_list(n)
    out = make_frame_parallel(cfg, render_mesh(devices=["cpu"] * n,
                                               axis="fp"))(
        scene, batch_uniforms(unis), pool=extras["pool"],
        lights=lights[None].expand(n, -1, -1),
        taa_batch=batch_uniforms(taas))
    assert out.image.shape == (n, 64, 96, 4)
    assert out.history.shape == (n, 64, 96, 3)
    history = torch.zeros((64, 96, 3))
    for i in range(n):
        want = alone(cfg, scene, unis[i], extras["pool"], lights, taas[i],
                     history)
        history = want.history
        assert torch.equal(out.image[i], want.image), f"frame {i}"
        assert torch.equal(out.history[i], want.history), f"frame {i}"


def test_example09_farm_chains_batches():
    """examples/09_animation_farm.py on the port: 12 cubes at 256x192 with
    TAA and bloom, two batches of two frames on ["cpu"] * 2, the second
    batch's history0 the first's last history, against the four frames
    rendered in order."""
    scene, uni0 = bench_scene.example_scene(n_cubes=12, device="cpu")
    cfg = bench_scene.example09_config()
    n, total = 2, 4
    unis, prev = [], bench_scene.example09_uniforms(uni0, 0, total)
    for i in range(total):
        u = bench_scene.example09_uniforms(uni0, i, total)
        unis.append(u._replace(prev_view_proj=prev.view_proj,
                               prev_models=u.models))
        prev = u
    taas = [bench_scene.example09_taa(i) for i in range(total)]
    farm = make_frame_parallel(cfg, render_mesh(devices=["cpu"] * n,
                                                axis="fp"))
    images, history0 = [], None
    for b in range(0, total, n):
        out = farm(scene, batch_uniforms(unis[b:b + n]),
                   taa_batch=batch_uniforms(taas[b:b + n]),
                   history0=history0)
        images.extend(out.image)
        history0 = out.history[n - 1]
    history = torch.zeros((cfg.height, cfg.width, 3))
    for i in range(total):
        want = alone(cfg, scene, unis[i], taa=taas[i], history=history)
        history = want.history
        assert torch.equal(images[i], want.image), f"frame {i}"


def test_frame_parallel_banded_2d_matches_sequential(rich):
    """(frames x bands): 2 frames, each over 4 bands, shadows, lights and
    post: each frame equals the frame rendered alone."""
    nf, nb = 2, 4
    scene, uni0, extras = rich
    cfg = _config(shadow_resolution=128)
    lights = extras["lights"]
    unis = [_uniforms_for_angle(0.7 * i, uni0) for i in range(nf)]
    m = render_mesh(devices=[["cpu"] * nb] * nf, axis=("fp", "sp"))
    out = make_frame_parallel_banded(cfg, m)(
        scene, batch_uniforms(unis), pool=extras["pool"],
        lights=lights[None].expand(nf, -1, -1))
    assert out.image.shape == (nf, 64, 96, 4)
    for i in range(nf):
        want = alone(cfg, scene, unis[i], extras["pool"], lights)
        assert torch.equal(out.image[i], want.image), f"frame {i}"
        assert int(out.covered_pixels[i]) == int(want.covered_pixels)
        assert torch.equal(out.shadow_map[i], want.shadow_map)


def test_frame_parallel_banded_rejects_taa():
    m = render_mesh(devices=[["cpu"] * 2] * 2, axis=("fp", "sp"))
    with pytest.raises(ValueError, match="TAA"):
        make_frame_parallel_banded(_config(taa_enabled=True), m)


def test_frame_parallel_batch_size_check(rich):
    scene, uni0, _ = rich
    cfg = _config(textured=False, lights_enabled=False, post_enabled=False)
    frames = make_frame_parallel(cfg, render_mesh(devices=["cpu"] * 2,
                                                  axis="fp"))
    with pytest.raises(ValueError, match="frames"):
        frames(scene, batch_uniforms([uni0] * 3))


def test_batch_uniforms_stacks_each_field():
    """Tensors stack with torch, host values with numpy, all-None stays."""
    a = TaaParams(0.5, 1.0, 0.0, np.zeros(2, np.float32),
                  np.ones(2, np.float32))
    got = batch_uniforms([a, a._replace(blend_factor=0.25)])
    np.testing.assert_array_equal(got.blend_factor, [0.5, 0.25])
    assert got.jitter.shape == (2, 2)
    u = bench_scene.example_scene(n_cubes=2, device="cpu")[1]
    b = batch_uniforms([u, u])
    assert isinstance(b.models, torch.Tensor) and b.models.shape[0] == 2
    assert b.cascade_matrices is None


def _diff(got, want):
    d = np.abs(np.asarray(got).astype(np.int16)
               - np.asarray(want).astype(np.int16))
    return int(d.max()), int((d.max(-1) > 0).sum())


@pytest.fixture(scope="module")
def ref_rich():
    return graft._example_scene(rich=True)


def test_pipelined_taa_matches_ash_tpu(rich, ref_rich):
    """make_frame_parallel with the TAA ring against ash_tpu's over 4
    devices (its ppermute ring), on the same inputs."""
    n = 4
    cfg = _config(taa_enabled=True)
    scene, uni0, extras = rich
    rscene, runi0, rextras = ref_rich
    unis = _with_motion([_uniforms_for_angle(0.1 * i, uni0)
                         for i in range(n)])
    runis = _with_motion([_ref_uniforms_for_angle(0.1 * i, runi0)
                          for i in range(n)])
    lights = extras["lights"]
    out = make_frame_parallel(cfg, render_mesh(devices=["cpu"] * n,
                                               axis="fp"))(
        scene, batch_uniforms(unis), pool=extras["pool"],
        lights=lights[None].expand(n, -1, -1),
        taa_batch=batch_uniforms(_taa_list(n)))
    rlights = np.asarray(rextras["lights"], np.float32)
    ref = ref_make_frame_parallel(
        RefFrameConfig(**_kw(taa_enabled=True)),
        JaxMesh(jax.devices()[:n], ("fp",)))(
        rscene, ref_batch_uniforms([jax.tree.map(np.asarray, u)
                                    for u in runis]),
        pool=rextras["pool"], lights=np.tile(rlights[None], (n, 1, 1)),
        taa_batch=jax.tree.map(lambda *xs: np.stack(xs),
                               *_taa_list(n, RefTaaParams)))
    for i in range(n):
        most, px = _diff(out.image[i].numpy(), ref.image[i])
        err = np.abs(out.history[i].numpy() - np.asarray(ref.history[i]))
        over = float((err > HISTORY_ATOL).mean())
        print(f"measured frame {i}: largest u8 difference {most} at {px} "
              f"pixels; history max abs err {err.max():.3e}, "
              f"{100 * over:.3f}% over {HISTORY_ATOL}")
        assert most <= 1, f"frame {i}: max u8 diff {most}"
        assert over <= HISTORY_FLIPS, f"frame {i}: history"
        assert int(out.covered_pixels[i]) == int(ref.covered_pixels[i])


def test_banded_2d_matches_ash_tpu(rich, ref_rich):
    """make_frame_parallel_banded over a (2, 4) mesh against ash_tpu's."""
    nf, nb = 2, 4
    scene, uni0, extras = rich
    rscene, runi0, rextras = ref_rich
    unis = [_uniforms_for_angle(0.7 * i, uni0) for i in range(nf)]
    runis = [_ref_uniforms_for_angle(0.7 * i, runi0) for i in range(nf)]
    lights = extras["lights"]
    out = make_frame_parallel_banded(
        _config(shadow_resolution=128),
        render_mesh(devices=[["cpu"] * nb] * nf, axis=("fp", "sp")))(
        scene, batch_uniforms(unis), pool=extras["pool"],
        lights=lights[None].expand(nf, -1, -1))
    rlights = np.asarray(rextras["lights"], np.float32)
    ref = ref_make_frame_parallel_banded(
        RefFrameConfig(**_kw(shadow_resolution=128)),
        JaxMesh(np.array(jax.devices()[:nf * nb]).reshape(nf, nb),
                ("fp", "sp")))(
        rscene, ref_batch_uniforms([jax.tree.map(np.asarray, u)
                                    for u in runis]),
        pool=rextras["pool"], lights=np.tile(rlights[None], (nf, 1, 1)))
    for i in range(nf):
        most, px = _diff(out.image[i].numpy(), ref.image[i])
        print(f"measured frame {i}: largest u8 difference {most} at {px} "
              "pixels")
        assert most <= 1, f"frame {i}: max u8 diff {most}"
        assert int(out.covered_pixels[i]) == int(ref.covered_pixels[i])
