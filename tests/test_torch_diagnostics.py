"""Diagnostics: ash_tpu_torch.render.diagnostics, render_stats, the overlay
and the overflow taint, the Renderer's diagnostics, frame_cost_analysis and
profile_passes, against ash_tpu on the CPU (tests/test_diagnostics.py's
cases through both packages).

The font, the text patch, the overlay composite and the taint blocks must
equal the reference's exactly; the stats objects format the same lines.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ash_tpu.core as ref_core
import ash_tpu.render as ref_render
import ash_tpu_torch.core as port_core
import ash_tpu_torch.render as port_render
from ash_tpu.render import diagnostics as ref_diag
from ash_tpu.render import render_stats as ref_stats
from ash_tpu.render.diagnostics import font_data as ref_font
from ash_tpu.render.diagnostics import overlay as ref_overlay
from ash_tpu_torch.render import bench_scene, diagnostics, render_stats
from ash_tpu_torch.render.diagnostics import (
    DiagnosticsMode,
    DiagnosticsState,
    DeviceProfiler,
    FrameProfiler,
)
from ash_tpu_torch.render.diagnostics import font_data, overlay

torch.set_num_threads(1)


def test_mode_cycling():
    m = DiagnosticsMode.OFF
    seq = [m := m.next() for _ in range(4)]
    assert seq == [DiagnosticsMode.CONSOLE_ONLY, DiagnosticsMode.OVERLAY_ONLY,
                   DiagnosticsMode.BOTH_WITH_TOGGLE, DiagnosticsMode.OFF]
    assert DiagnosticsMode.CONSOLE_ONLY.console_enabled
    assert not DiagnosticsMode.CONSOLE_ONLY.overlay_enabled
    assert DiagnosticsMode.BOTH_WITH_TOGGLE.overlay_enabled
    assert ([x.value for x in DiagnosticsMode]
            == [x.value for x in ref_diag.DiagnosticsMode])


def test_frame_profiler_window():
    p = FrameProfiler(window=4)
    for t in (10.0, 20.0, 30.0, 40.0, 50.0):
        p.record(t)
    assert p.min_ms == 20.0 and p.max_ms == 50.0
    assert p.avg_ms == 35.0
    assert abs(p.fps - 1000.0 / 35.0) < 1e-6
    assert p.total_frames == 5


def test_stats_lines_equal_the_reference():
    lines = []
    for mod in (diagnostics, ref_diag):
        st = mod.DiagnosticsState()
        st.frame_stats.fps = 60.0
        st.frame_stats.draw_calls = 5
        st.frame_stats.triangles = 12
        st.gpu_timings.passes = {"Raster": 0.25, "SceneEnd": 4.5}
        st.memory_stats.gpu_used_bytes = 3 * 2**20
        st.memory_stats.gpu_budget_bytes = 80 * 2**30
        lines.append(st.overlay_lines())
    assert lines[0] == lines[1]
    assert "FPS: 60.0" in lines[0][0] and "Draws: 5" in lines[0][0]


def test_console_print_cadence():
    st = DiagnosticsState(mode=DiagnosticsMode.CONSOLE_ONLY,
                          console_print_interval=3)
    out = []
    for _ in range(7):
        st.on_frame(log=out.append)
    assert len(out) == 8  # printed at frames 3 and 6, four lines each


def test_font_equals_the_reference_bit_for_bit():
    assert font_data.FONT_8X8.shape == (95, 8, 8)
    np.testing.assert_array_equal(font_data.FONT_8X8, ref_font.FONT_8X8)
    assert font_data.glyph("A").sum() > 0
    assert font_data.glyph(" ").sum() == 0
    assert font_data.glyph("\x01").sum() == 0  # unknown -> space


@pytest.mark.parametrize("scale", [1, 2, 3])
def test_text_patch_equals_the_reference(scale):
    lines = ["FPS: 60.0 | Frame: 16.67ms", "Device: (no samples)", "~{}|"]
    got = overlay.render_text_patch(lines, overlay.OverlayConfig(scale=scale))
    want = ref_overlay.render_text_patch(
        lines, ref_overlay.OverlayConfig(scale=scale))
    np.testing.assert_array_equal(got, want)
    assert (got[..., 1] == 1.0).any() and (got[..., 3] == np.float32(0.6)).any()


@pytest.mark.parametrize("size,scale", [((64, 128), 1), ((96, 160), 2),
                                        ((20, 30), 2)])
def test_overlay_composite_equals_the_reference(size, scale):
    """The same u8 frame and lines: equal images (the patch is cropped to
    a frame smaller than it)."""
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (*size, 4), dtype=np.uint8)
    lines = ["FPS: 60.0 | Frame: 16.67ms", "HI"]
    got = overlay.DiagnosticsOverlay(overlay.OverlayConfig(scale=scale))
    got = got.composite(torch.from_numpy(img.copy()), lines).numpy()
    want = ref_overlay.DiagnosticsOverlay(ref_overlay.OverlayConfig(
        scale=scale)).composite(jnp.asarray(img), lines)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (got != img).any()


def test_efficiency_score_and_collector():
    for mod in (render_stats, ref_stats):
        s = mod.RenderStats()
        s.draws = mod.DrawStats(draw_calls=100, instanced_draws=100)
        s.culling = mod.CullingStats(objects_submitted=100,
                                     after_occlusion=50)
        assert s.efficiency_score() == 100.0
        s2 = mod.RenderStats()
        s2.draws = mod.DrawStats(draw_calls=5000)
        assert s2.efficiency_score() == 70.0
        c = mod.StatsCollector()
        c.begin_frame()
        got = c.end_frame(16.6)
        assert abs(got.fps - 1000 / 16.6) < 0.1 and len(c.history) == 1
    assert (render_stats.RenderStats(frame=3).format_compact()
            == ref_stats.RenderStats(frame=3).format_compact())


def test_device_profiler_on_the_cpu(tmp_path):
    p = DeviceProfiler(sample_interval=2, enabled=True, device="cpu")
    p.begin_frame()
    with p.scope("SceneEnd"):
        torch.ones(8).sum()
    assert p.timings_ms() == {}  # frame 1 does not sample
    p.begin_frame()
    with p.scope("SceneEnd"):
        torch.ones(8).sum()
    with p.pass_scope("Raster", torch.ones(2)):
        pass
    assert set(p.timings_ms()) == {"SceneEnd", "Raster"}
    p.start_trace(str(tmp_path / "trace"))
    torch.ones(8).sum()
    p.stop_trace()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_device_profiler_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        DeviceProfiler()


# -- through the Renderer ----------------------------------------------------

def _cube(render, core, size=96, mode=None, **kw):
    r = render.Renderer(
        render.HeadlessSurface(size, size),
        render.RendererConfig(tile_h=8, tile_w=32, max_tris_per_tile=32,
                              shadows_enabled=False), **kw)
    r.set_mesh(core.Mesh.create_cube())
    if mode is not None:
        r.set_diagnostics_mode(mode)
    cam = core.Camera.new([0, 0, 5], [0, 0, 0], 1.0)
    return r, (cam.view_matrix(), cam.projection_matrix(), cam.position)


def test_overlay_frame_is_the_plain_frame_with_the_reference_overlay():
    """The overlay frame equals the plain frame with the reference's
    composite of the same lines, and the diagnostics are filled in."""
    r, cam = _cube(port_render, port_core, device="cpu")
    r.render_frame(*cam)
    plain = r.read_back().copy()
    r.set_diagnostics_mode(DiagnosticsMode.OVERLAY_ONLY)
    lines = r.diagnostics().overlay_lines()
    r.render_frame(*cam)
    got = r.read_back()
    want = ref_overlay.DiagnosticsOverlay().composite(jnp.asarray(plain),
                                                      lines)
    np.testing.assert_array_equal(got, np.asarray(want))
    corner = got[:40, :96]
    assert ((corner[..., 1] > 150) & (corner[..., 0] < 100)).any()
    assert r.diagnostics().frame_stats.draw_calls == 1
    assert r.diagnostics().frame_stats.triangles == 12
    assert r.diagnostics().memory_stats.gpu_used_bytes > 0


def _build_probe(mode, render=port_render, core=port_core, **kw):
    r = render.Renderer(
        render.HeadlessSurface(32, 32),
        render.RendererConfig(tile_h=8, tile_w=32, max_tris_per_tile=4,
                              shadows_enabled=False), **kw)
    r.set_mesh(core.Mesh.create_cube())  # the front faces overflow cap 4
    r.set_diagnostics_mode(mode)
    cam = core.Camera.new([1.5, 1.2, 4.0], [0, 0, 0], 1.0)
    return r, (cam.view_matrix(), cam.projection_matrix(), cam.position)


def test_overflow_probe_only_in_console_mode(caplog, monkeypatch):
    """Diagnostics off: no probe is ever held and no overflow scalar is
    read on the host. Console mode: the warning fires after 60 frames."""
    r, cam = _build_probe(DiagnosticsMode.OFF, device="cpu")
    reads = []
    real_int = torch.Tensor.__int__
    monkeypatch.setattr(torch.Tensor, "__int__",
                        lambda t: reads.append(1) or real_int(t))
    for _ in range(65):
        r.render_frame(*cam)
    assert r._overflow_probe is None and not reads
    r, cam = _build_probe(DiagnosticsMode.CONSOLE_ONLY, device="cpu")
    with caplog.at_level(logging.WARNING, logger="ash_tpu_torch.renderer"):
        for _ in range(62):
            r.render_frame(*cam)
    assert any("binning overflow" in m for m in caplog.messages)
    assert reads  # the 60-frame probe


def _taint_scene(render, core, mode, **kw):
    """tests/test_diagnostics.py's taint scene: four stacked cubes and
    tile caps of 1, so both binners drop."""
    r = render.Renderer(render.HeadlessSurface(160, 120), render.RendererConfig(
        tile_h=8, tile_w=32, max_tris_per_tile=1, shadow_resolution=64,
        shadow_tile=64, shadow_max_tris_per_tile=1), **kw)
    r.register_mesh_handle(0, core.Mesh.create_cube())
    r.register_material_handle(1, core.Material())
    cmds = []
    for i in range(4):
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = [0.05 * i] * 3
        cmds.append(render.RenderCommand(mesh=0, transform=m, material=1))
    r.submit_render_commands(cmds)
    r.set_diagnostics_mode(mode)
    cam = core.Camera.new([0, 1.5, 4], [0, 0, 0], 1.0)
    out = r.render_frame(cam.view_matrix(), cam.projection_matrix(),
                         cam.position)
    assert int(out.binning_overflow) > 0 and int(out.shadow_overflow) > 0
    return np.asarray(out.image)


def test_overflow_taint_equals_the_reference():
    """Magenta (main pass) and cyan (shadow pass) 8x8 blocks at the bottom
    right in overlay mode; the same blocks as the reference's, and the
    frame off the blocks is the frame without diagnostics."""
    got = _taint_scene(port_render, port_core, DiagnosticsMode.OVERLAY_ONLY,
                       device="cpu")
    want = _taint_scene(ref_render, ref_core, DiagnosticsMode.OVERLAY_ONLY)
    assert (got[-8:, -8:, :3] == [255, 0, 255]).all()
    assert (got[-8:, -16:-8, :3] == [0, 255, 255]).all()
    np.testing.assert_array_equal(got[-8:, -16:], want[-8:, -16:])
    off = _taint_scene(port_render, port_core, DiagnosticsMode.OFF,
                       device="cpu")
    assert not (off[-8:, -8:, :3] == [255, 0, 255]).all()
    body = np.ones(got.shape[:2], bool)
    body[-8:, -16:] = False
    # The text overlay: three lines at the default scale.
    body[:overlay.render_text_patch(["x"] * 3, overlay.OverlayConfig())
         .shape[0]] = False
    np.testing.assert_array_equal(got[body], off[body])


def test_example_02_loop_prints_frame_stats(capsys):
    """examples/02_cube.py's loop on the port (3 of its frames) ends with
    diagnostics().frame_stats, as the example prints it."""
    r, surface = bench_scene.build_cube_example("cpu")
    for i in range(3):
        r.render_frame(*bench_scene.cube_example_camera(i))
    stats = r.diagnostics().frame_stats
    print(f"after 3 frames (avg {stats.frame_time_ms:.2f} ms)")
    assert "avg" in capsys.readouterr().out
    assert stats.total_frames == 3 and stats.frame_time_ms > 0
    assert surface.read_back().shape == (480, 640, 4)


def test_frame_cost_analysis_on_the_cpu():
    r, cam = _cube(port_render, port_core, size=48, device="cpu")
    r.render_frame(*cam)
    cost = r.frame_cost_analysis(*cam)
    assert set(cost) == {"flops", "bytes_accessed", "programs"}
    assert cost["flops"] > 0 and cost["bytes_accessed"] > 0
    assert {"pass_vertex", "pass_raster", "pass_shade",
            "pass_pack"} <= set(cost["programs"])
    assert r.frame_count == 2  # it renders one frame


def test_profile_passes_on_the_cpu():
    r, cam = _cube(port_render, port_core, size=48, device="cpu")
    r.render_frame(*cam)
    t = r.profile_passes(*cam, n=2)
    assert list(t) == ["Vertex", "Setup", "Binning", "Raster", "GBuffer",
                       "SceneEnd"]
    assert all(v > 0 for v in t.values())
    assert r.diagnostics().gpu_timings.passes == t
    assert r.device_profiler.timings_ms() == t


def test_profile_passes_with_shadows_names_shadow_end():
    r, _ = bench_scene.build_cube_example("cpu", 64, 48)
    t = r.profile_passes(*bench_scene.cube_example_camera(0, 64, 48), n=1)
    assert "ShadowEnd" in t and t["ShadowEnd"] > 0
