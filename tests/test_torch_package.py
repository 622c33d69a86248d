"""ash_tpu_torch package policy: no jax, no CPU fallback for CUDA, plain
raster on CPU tensors with no kernel launch, and the options that once
refused (every reference option now runs)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import ash_tpu_torch
from ash_tpu_torch import RenderCommand, Renderer, RendererConfig
from ash_tpu_torch.core.mesh import Mesh
from ash_tpu_torch.ops import _build, binning, geometry, raster, raster_cuda
from ash_tpu_torch.render import HeadlessSurface
from ash_tpu_torch.render.csm import CsmConfig

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fresh_interpreter(code):
    """Run `code` in a new interpreter with only the repo on the path (other
    tests of this process load jax and ash_tpu)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, cwd=REPO, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


# Prints the loaded modules that are jax or the reference package.
_FOREIGN = (
    "print(sorted(m for m in sys.modules if m == 'jax' or m == 'ash_tpu'"
    " or m.startswith(('jax.', 'ash_tpu.'))))\n"
)


def test_import_loads_no_jax():
    code = (
        "import sys\n"
        "import ash_tpu_torch\n"
        "import ash_tpu_torch.render.bench_scene, ash_tpu_torch.ops.raster_cuda\n"
        "import ash_tpu_torch.host_profile\n"
        + _FOREIGN
    )
    assert _fresh_interpreter(code) == "[]"


def test_cube_pbr_renders_without_ash_tpu():
    """A whole frame on the CPU, and still neither jax nor ash_tpu loaded."""
    code = (
        "import sys\n"
        "from ash_tpu_torch.render import golden_scenes\n"
        "img = golden_scenes.scene_cube_pbr('cpu').read_back()\n"
        "assert img.shape == (128, 192, 4) and img[..., :3].any()\n"
        + _FOREIGN
    )
    assert _fresh_interpreter(code) == "[]"


def test_cuda_device_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ash_tpu_torch.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        Renderer(HeadlessSurface(16, 16), device="cuda")


def test_cpu_device_by_name():
    assert ash_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    r = Renderer(HeadlessSurface(16, 16), device="cpu")
    assert r.device == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_raster_wrapper_on_cpu_runs_plain_and_launches_nothing():
    cube = Mesh.create_cube()
    cam = ash_tpu_torch.Camera.new([3.0, 2.0, 4.0], [0, 0, 0], 1.5)
    vp = torch.tensor(cam.projection_matrix() @ cam.view_matrix())
    tv = geometry.transform_vertices(
        torch.eye(4)[None], vp, torch.from_numpy(cube.vertices.position),
        torch.from_numpy(cube.vertices.normal),
        torch.from_numpy(cube.vertices.tangent),
        torch.zeros(24, dtype=torch.int32),
    )
    setup = geometry.triangle_setup(
        tv.clip, torch.from_numpy(cube.triangle_indices),
        torch.ones(12, dtype=torch.bool), 96, 64,
    )
    bins = binning.bin_triangles(setup.bbox, setup.valid, 64, 96, 16, 32, 16)
    before = raster_cuda.rasterize.launches
    got = raster_cuda.rasterize(setup, bins, 64, 96, 16, 32)
    want = raster.rasterize(setup, bins, 64, 96, 16, 32)
    assert raster_cuda.rasterize.launches == before
    assert torch.equal(got.tri_id, want.tri_id)
    assert torch.equal(got.depth, want.depth)
    assert int((got.tri_id >= 0).sum()) > 0


def test_kernel_build_is_keyed_on_source(monkeypatch, tmp_path):
    lib = _build.library_path("raster")
    assert lib.parent == _build.BUILD_DIR
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "raster.cu").write_text("// a different source\n")
    edited = _build.library_path("raster")
    assert edited != lib
    # Any file under csrc/ (a header the source includes) keys the build.
    (tmp_path / "common.cuh").write_text("// a header\n")
    with_header = _build.library_path("raster")
    assert with_header != edited
    (tmp_path / "common.cuh").write_text("// an edited header\n")
    assert _build.library_path("raster") != with_header
    with pytest.raises(FileNotFoundError):
        _build.library_path("missing")


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build.os, "access", lambda *a: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.find_nvcc()


@pytest.mark.parametrize("option,value", [
    ("max_draws_per_chunk", 100),
])
def test_unported_config_raises(option, value):
    """Named for the refusal this option met until chunked geometry was
    ported (A16): the option is now taken, and a draw list longer than it
    renders in chunks."""
    cfg = RendererConfig(**{option: value},
                         shadow_resolution=64, shadow_tile=64)
    assert getattr(cfg, option) == value
    r = Renderer(HeadlessSurface(16, 16), cfg, device="cpu")
    r.register_mesh_handle(0, Mesh.create_cube())
    r.submit_render_commands([RenderCommand(mesh=0, transform=np.eye(4))]
                             * (value + 1))
    cam = ash_tpu_torch.Camera.new([3.0, 2.0, 4.0], [0, 0, 0], 1.0)
    r.render_frame(cam.view_matrix(), cam.projection_matrix(), cam.position)
    assert len(r._chunk_scenes) == 2 and r._scene is None


def _small_cube_renderer():
    r = Renderer(HeadlessSurface(16, 16),
                 RendererConfig(shadow_resolution=64, shadow_tile=64),
                 device="cpu")
    r.set_mesh(Mesh.create_cube())
    return r


def _works_set_msaa_preset(r):
    r.set_msaa_preset("x4")
    return r.prepare_frame(*_cam_args()).config.ssaa_x == 2


def _works_request_swapchain_resize(r):
    r.request_swapchain_resize(24, 12)
    return r.render_frame(*_cam_args()).image.shape == (12, 24, 4)


def _works_frame_cost_analysis(r):
    cost = r.frame_cost_analysis(*_cam_args())
    return cost["flops"] > 0 and "pass_raster" in cost["programs"]


def _works_toggle_diagnostics(r):
    r.toggle_diagnostics()
    return r.diagnostics().mode.console_enabled


def _works_msaa_preset(r):
    return r.msaa_preset() == "off"


@pytest.mark.parametrize("method", [
    "set_msaa_preset", "request_swapchain_resize", "frame_cost_analysis",
    "toggle_diagnostics", "msaa_preset",
])
def test_a15_a17_renderer_method_works(method):
    """The methods that raised until MSAA (A15) and the diagnostics and
    host side (A17) landed now run."""
    assert globals()[f"_works_{method}"](_small_cube_renderer())


@pytest.mark.parametrize("option,value", [
    ("csm", CsmConfig(cascade_count=3, resolution=64)),
    ("render_scale", 0.5),
    ("shade_dtype", "bf16"),
    ("gbuffer_packed", True),
    ("lod_cull_threshold", 0.01),
    ("msaa_resolve", "edge"),
    ("msaa_edge_capacity", 0.25),
])
def test_ported_config_is_accepted(option, value):
    """Options that raised before their slice landed now reach the frame."""
    r = Renderer(HeadlessSurface(32, 32), RendererConfig(**{option: value}),
                 device="cpu")
    assert getattr(r.config, option) == value


@pytest.mark.parametrize("method,args", [
    ("initialize_hdr", ()), ("set_taa_enabled", (True,)),
    ("reset_taa_history", ()), ("set_render_scale", (0.5,)),
    ("set_tonemapping_enabled", (False,)),
    ("set_tonemapping_operator", ("reinhard",)),
    ("set_tonemapping_exposure", (1.5,)), ("set_tonemapping_gamma", (2.0,)),
    ("set_bloom_enabled", (False,)), ("set_bloom_intensity", (0.3,)),
    ("set_bloom_threshold", (1.0,)), ("set_fxaa_enabled", (True,)),
])
def test_post_setter_is_ported(method, args):
    r = Renderer(HeadlessSurface(16, 16), device="cpu")
    assert getattr(r, method)(*args) is None


def test_full_frame_renders_without_ash_tpu():
    """The post chain, TAA over three frames and the point light on the
    CPU, and still neither jax nor ash_tpu loaded."""
    code = (
        "import sys\n"
        "from ash_tpu_torch.render import golden_scenes\n"
        "img = golden_scenes.scene_full_frame('cpu').read_back()\n"
        "assert img.shape == (128, 192, 4) and img[..., :3].any()\n"
        + _FOREIGN
    )
    assert _fresh_interpreter(code) == "[]"


def test_lod_chain_raises():
    """A LOD chain registers and renders (A14); one longer than
    MAX_LOD_LEVELS raises when the scene is packed, as in the reference."""
    mesh = Mesh.create_cube()
    for i in range(8):
        mesh.add_lod(Mesh.create_named_cube(f"lod{i + 1}"), 0.1 / (i + 1))
    r = Renderer(HeadlessSurface(16, 16), device="cpu")
    r.register_mesh_handle(0, mesh)
    r.submit_render_commands([RenderCommand(0, np.eye(4, dtype=np.float32))])
    with pytest.raises(ValueError, match="LOD levels"):
        r.render_frame(*_cam_args())
    mesh.lods.pop()
    r.register_mesh_handle(0, mesh)
    r.render_frame(*_cam_args())
    assert r.lod_stats(*_cam_args()[:2]).triangles_before == 12


def _cam_args():
    cam = ash_tpu_torch.Camera.new([3.0, 2.0, 4.0], [0, 0, 0], 1.0)
    return cam.view_matrix(), cam.projection_matrix(), cam.position


def test_large_scene_needs_two_level_binning(monkeypatch):
    """Above 32768 padded triangles the automatic switch bins in two
    levels, and the frame renders."""
    from ash_tpu_torch.ops import binning
    from ash_tpu_torch.render import frame

    calls = []
    two_level = binning.bin_triangles_two_level
    monkeypatch.setattr(frame.binning, "bin_triangles_two_level",
                        lambda *a, **k: calls.append(k) or two_level(*a, **k))
    r = Renderer(HeadlessSurface(32, 32), RendererConfig(shadows_enabled=False),
                 device="cpu")
    r.register_mesh_handle(0, Mesh.create_cube())
    r.submit_render_commands(
        [RenderCommand(mesh=0, transform=np.eye(4, dtype=np.float32))] * 2800
    )
    out = r.render_frame(*_cam_args())
    assert r._scene.buffers.num_triangles == 65536
    assert [k["coarse_cap"] for k in calls] == [16384]
    assert int(out.covered_pixels) > 0
