"""bf16 shading: ash_tpu_torch against
ash_tpu on the CPU, on tests/test_bf16.py's full-feature scene (textures,
a normal-mapped sphere, the shadow map, a point and a spot light).

Tolerances:

- the port's bf16 frame against its f32 frame: u8 PSNR >= 40 dB and not
  identical (the reference test's bars);
- the port's frame against the reference's frame of the same dtype, with
  tile caps raised to 1024 so that no triangle drops (at the test's caps
  of 64 the main pass drops 100 triangles and the shadow pass about 300,
  and which ones follows last-bit differences of the setup): u8 PSNR >= 40
  dB. PyTorch rounds every bf16 operation, while XLA on the CPU keeps f32
  between the operations it fuses, so the bf16 frames sit further apart
  (measured 55.7 dB) than the f32 frames (83.9 dB); printed, and recorded
  in ROADMAP.md C;
- a frame with `gbuffer_packed=True` (the reference's gather-schedule
  knob for XLA, accepted and without effect here) against one without:
  equal bit for bit.
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
from ash_tpu_torch.render import bench_scene

torch.set_num_threads(1)

REF = SimpleNamespace(core=ref_core, render=ref_render, kw={})
PORT = SimpleNamespace(core=port_core, render=port_render,
                       kw={"device": "cpu"})
MIN_PSNR = 40.0
# Tile caps of the frames held against the reference's: nothing drops.
DROP_FREE_CAP = 1024


def _renderer(P, **cfg):
    """tests/test_bf16.py's scene on either package."""
    r = P.render.Renderer(
        P.render.HeadlessSurface(192, 128),
        P.render.RendererConfig(**{
            **dict(tile_h=8, tile_w=64, max_tris_per_tile=64,
                   shadow_resolution=256, shadow_tile=64,
                   shadow_max_tris_per_tile=64, use_pallas=False), **cfg}),
        **P.kw)
    r.register_mesh_handle(0, P.core.Mesh.create_cube())
    sphere = P.core.Mesh.create_sphere("ball", segments=24, rings=12)
    sphere.texture_data = P.core.TextureData.checkerboard(size=64, cell=8)
    r.register_mesh_handle(1, sphere)
    rng = np.random.default_rng(11)
    cmds = []
    for i in range(9):
        y, x = divmod(i, 3)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] *= 0.6
        m[:3, 3] = [(x - 1) * 2.0, (y - 1) * 2.0, 0.0]
        r.register_material_handle(i + 1, P.core.Material(
            color=(*(0.3 + 0.7 * rng.random(3)), 1.0),
            metallic=float(rng.random()),
            roughness=float(0.2 + 0.8 * rng.random()),
        ))
        cmds.append(P.render.RenderCommand(mesh=i % 2, transform=m,
                                           material=i + 1))
    r.submit_render_commands(cmds)
    r.shadow_feature.set_scene_bounds([0, 0, 0], 6.0)
    r.add_point_light([0, 3, 3], color=(1, 0.9, 0.7), intensity=5, radius=14)
    r.add_spot_light([-3, 2, 2], direction=[1, -0.5, -0.5],
                     color=(0.4, 0.6, 1.0), intensity=6, radius=15,
                     inner_cone_angle=0.3, outer_cone_angle=0.6)
    return r


CAM = port_core.Camera.new([4.0, 3.0, 5.0], [0, 0, 0], 192 / 128)
ARGS = (CAM.view_matrix(), CAM.projection_matrix(), CAM.position)


def _render(P, drop_free, **cfg):
    if drop_free:
        cfg.update(max_tris_per_tile=DROP_FREE_CAP,
                   shadow_max_tris_per_tile=DROP_FREE_CAP)
    r = _renderer(P, **cfg)
    out = r.render_frame(*ARGS)
    if drop_free:
        assert int(out.binning_overflow) == 0 and int(out.shadow_overflow) == 0
    return np.array(r.read_back())


@pytest.fixture(scope="module")
def frames():
    """(package, dtype, drop_free) -> u8 frame; the port's at both caps,
    the reference's drop-free."""
    return {(name, dtype, free): _render(P, free, shade_dtype=dtype)
            for name, P in (("ref", REF), ("port", PORT))
            for dtype in ("f32", "bf16")
            for free in ((False, True) if name == "port" else (True,))}


def test_bf16_shading_matches_f32(frames):
    f32, bf16 = frames["port", "f32", False], frames["port", "bf16", False]
    value = psnr(f32.astype(np.float32), bf16.astype(np.float32), peak=255.0)
    print(f"\nport bf16 vs port f32: {value:.2f} dB")
    assert value >= MIN_PSNR
    assert not np.array_equal(f32, bf16), "bf16 path identical to f32"


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_frame_matches_reference(frames, dtype):
    got, want = frames["port", dtype, True], frames["ref", dtype, True]
    value = psnr(got, want)
    diff = np.abs(got.astype(int) - want.astype(int)).max(-1)
    print(f"\nport {dtype} vs reference {dtype}: {value:.2f} dB, "
          f"{int((diff > 0).sum())} pixels differ, by up to {diff.max()}; "
          f"reference bf16 vs f32: "
          f"{psnr(frames['ref', 'bf16', True], frames['ref', 'f32', True]):.2f}"
          " dB")
    assert value >= MIN_PSNR


def test_bf16_with_ibl_matches_f32():
    """bf16 shading under an environment (IBL's samples stay f32)."""
    imgs = {}
    for dtype in ("f32", "bf16"):
        r = _renderer(PORT, shade_dtype=dtype)
        r.set_environment_map(bench_scene.sky_environment(16, 32))
        r.render_frame(*ARGS)
        imgs[dtype] = np.array(r.read_back())
    value = psnr(imgs["f32"], imgs["bf16"])
    print(f"\nport bf16 vs f32 with IBL: {value:.2f} dB")
    assert value >= MIN_PSNR and not np.array_equal(imgs["f32"], imgs["bf16"])


def test_shade_dtype_is_validated():
    with pytest.raises(ValueError, match="shade_dtype"):
        port_render.RendererConfig(shade_dtype="fp16")


@pytest.mark.parametrize("taa", [False, True])
def test_packed_gbuffer_frame_is_bit_identical(taa):
    """gbuffer_packed=True is accepted and the frame equals the frame
    without, also with TAA's motion vectors (two frames)."""
    images = []
    for packed in (False, True):
        r = _renderer(PORT, gbuffer_packed=packed)
        if taa:
            r.initialize_hdr()
            r.set_taa_enabled(True)
        for _ in range(2 if taa else 1):
            out = r.render_frame(*ARGS)
        images.append((np.array(r.read_back()), out.color.numpy()))
    np.testing.assert_array_equal(images[0][0], images[1][0])
    np.testing.assert_array_equal(images[0][1], images[1][1])
