"""The frame loop's host profile (ash_tpu_torch/host_profile.py, the port of
tools/host_profile.py) on the CPU, at its --small size (160x120, 16 cubes).

- Each scene (animated with TRS, animated with matrices, static) prints the
  reference's buckets and the split of render_frame; the JSON buckets add up
  to the loop's host time (to float rounding) and the spans to the traced
  render_frame time (within the tool's 1%).
- --cprofile prints a pstats table.
- The loop feeds the poses that tools/host_profile.py feeds
  (bench.animated_models / animated_models_trs and bench.orbit_camera),
  bit for bit, and its last image equals a plain loop's over those poses.
- --device cuda raises without CUDA.
"""

import json

import numpy as np
import pytest
import torch

from ash_tpu_torch import host_profile
from ash_tpu_torch.render import bench_scene

torch.set_num_threads(1)

FRAMES = 3
PASSES = ("pass_vertex", "pass_cull", "pass_setup", "pass_binning",
          "pass_raster", "pass_gbuffer", "pass_shade", "pass_pack")


def _run(capsys, *flags):
    rc = host_profile.main(["--small", "--device", "cpu", "--frames",
                            str(FRAMES), *flags])
    out = capsys.readouterr().out
    assert rc == 0
    lines = out.strip().splitlines()
    return out, json.loads(lines[-1])


@pytest.mark.parametrize("flags,scene,update", [
    ((), "animated", "trs"),
    (("--matrices",), "animated", "matrices"),
    (("--static",), "standard", "none"),
])
def test_main_prints_every_bucket(capsys, flags, scene, update):
    out, line = _run(capsys, *flags)
    for name in (*host_profile.BUCKETS, "(loop overhead)", "(device drain)",
                 "traced loop:", "prepare", "between_passes", "image_copy",
                 "present_rest", *PASSES):
        assert name in out, name
    assert (line["scene"], line["update"], line["frames"]) == (
        scene, update, FRAMES)
    assert (line["width"], line["height"], line["objects"]) == (160, 120, 16)
    assert line["device"] == "cpu" and line["card"] is None
    b = line["buckets_ms"]
    assert set(b) == {*host_profile.BUCKETS, "loop_overhead", "device_drain"}
    host = sum(v for k, v in b.items() if k != "device_drain")
    assert host == pytest.approx(line["host_ms"], rel=1e-9, abs=1e-9)
    assert line["loop_ms"] == pytest.approx(line["host_ms"]
                                            + b["device_drain"], rel=1e-9)
    if scene == "standard":
        assert b["anim_math"] == b["update_transforms"] == 0.0
        assert b["orbit_camera"] == 0.0
    else:
        assert b["anim_math"] > 0 and b["update_transforms"] > 0
    assert b["render_frame"] > 0
    split = line["render_frame_split"]
    assert split["frames_traced"] == FRAMES
    want_passes = set(PASSES) | ({"pass_shadow"} if scene == "animated"
                                 else set())
    assert set(split["passes"]) == want_passes
    for p in split["passes"].values():
        assert p["calls"] == 1.0 and p["ms"] > 0
    parts = (split["prepare"]["ms"]
             + sum(p["ms"] for p in split["passes"].values())
             + sum(split[k]["ms"] for k in ("between_passes", "image_copy",
                                            "present_rest")))
    assert parts == pytest.approx(split["sum_ms"], rel=1e-9)
    assert split["sum_ms"] == pytest.approx(line["traced_render_frame_ms"],
                                            rel=host_profile.SPLIT_TOLERANCE)
    # The plain raster on the CPU: no CUDA runtime call, no ctypes call.
    assert all(p["kernel_launches"] == p["raster_calls"] == 0
               for p in split["passes"].values())


def test_cprofile_prints_a_pstats_table(capsys):
    out, _ = _run(capsys, "--static", "--cprofile")
    assert "Ordered by: cumulative time" in out
    assert "ncalls" in out and "render_frame" in out


@pytest.fixture(scope="module")
def reference_scene():
    """bench.py's scene at the --small size: its camera and anim dict."""
    import bench

    _, _, cam, anim = bench.build_bench_renderer(160, 120, 16)
    return bench, cam, anim


@pytest.mark.parametrize("matrices", [False, True])
def test_poses_are_the_reference_tools(reference_scene, matrices):
    """Frames 1-3 of the loop feed the models (or TRS) and view matrices
    that tools/host_profile.py's loop feeds at t = i / 60."""
    bench, ref_cam, ref_anim = reference_scene
    loop = host_profile.FrameLoop("cpu", 16, matrices=matrices, small=True)
    fed, depth = [], [0]
    r = loop.renderer

    def spy(kind, real):
        # Records the loop's own calls, not the renderer's calls inside
        # them.
        def call(*args):
            if depth[0] == 0:
                fed.append((kind, args))
            depth[0] += 1
            try:
                return real(*args)
            finally:
                depth[0] -= 1
        return call

    r.update_transforms = spy("m", r.update_transforms)
    r.update_transforms_trs = spy("trs", r.update_transforms_trs)
    real_frame = r.render_frame
    r.render_frame = lambda v, p, pos: (fed.append(("view", (v, pos.copy()))),
                                        real_frame(v, p, pos))[1]
    loop.run(FRAMES)
    assert len(fed) == 2 * FRAMES
    for i in range(FRAMES):
        t = (i + 1) * host_profile.FRAME_DT
        (kind, pose), (_, (view, pos)) = fed[2 * i], fed[2 * i + 1]
        if matrices:
            assert kind == "m"
            np.testing.assert_array_equal(pose[0],
                                          bench.animated_models(ref_anim, t))
        else:
            assert kind == "trs"
            for a, b in zip(pose, bench.animated_models_trs(ref_anim, t)):
                np.testing.assert_array_equal(a, b)
        want = bench.orbit_camera(ref_cam, ref_anim["extent"], t)
        np.testing.assert_array_equal(view, want)
        np.testing.assert_array_equal(pos, ref_cam.position)


def test_last_image_equals_a_plain_loop(capsys):
    """The profiled loop (warm-up, timed and traced loops) leaves the image
    a plain loop over the same poses renders, bit for bit."""
    loop = host_profile.FrameLoop("cpu", 16, small=True)
    host_profile.measure(loop, FRAMES)
    capsys.readouterr()
    got = loop.renderer.read_back()
    r, _, cam, anim = bench_scene.build_bench_renderer(160, 120, 16, "cpu",
                                                       animate=True)
    proj = cam.projection_matrix()
    for i in range(1, FRAMES + 1):
        t = i * host_profile.FRAME_DT
        r.update_transforms_trs(*bench_scene.animated_models_trs(anim, t))
        r.render_frame(bench_scene.orbit_camera(cam, anim["extent"], t), proj,
                       cam.position)
    want = r.read_back()
    assert got.shape == (120, 160, 4) and got[..., :3].any()
    np.testing.assert_array_equal(got, want)


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        host_profile.main(["--small", "--frames", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        host_profile.main(["--small", "--device", "cuda", "--frames", "1"])
