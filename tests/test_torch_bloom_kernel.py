"""The bloom pyramid's entry point (ash_tpu_torch/ops/bloom_cuda.py) on the
CPU; the kernels themselves (csrc/bloom.cu) on the card.

- CPU tensors run the plain chain (ops/bloom.py's bloom_pyramid): the
  entry equals it by torch.equal, never loads the library and counts no
  launch, and it is held against ash_tpu's bloom_pyramid on the same numpy
  inputs at atol 1e-5 + rtol 1e-5, the tolerance of test_torch_post.py
  (XLA contracts a*b+c on the CPU, the port never does).
- `levels` plans the launches the plain chain makes: its downsample and
  upsample shapes, and which take the 2x2 blocks, the 2x lerps or the
  gather, over a grid of sizes from 1 to 300 and mip counts 0-6.
- The argument checks raise on a wrong dtype, shape, layout or mip count,
  and pass the frames' own calls; `launcher` refuses CPU tensors.
- finalize_frame hands pass_bloom to the entry once a post frame with bloom
  (f32, contiguous: what the card takes), and never with bloom off.
- chip_smoke.py's build phase names every instantiation the C entries
  launch.
- On the card (marked `cuda`, skipped here): the kernels against the plain
  chain on the same CUDA tensors, by torch.equal, with one launch a level
  each way; and the probes that pin the roundings the kernels code: a
  division by a CPU scalar multiplies by the f32 reciprocal, a Python float
  is an f32 operand, maximum, clamp and clamp_min propagate NaN. The CPU
  rounds some of these otherwise, so no CPU test mirrors the kernels.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ash_tpu.ops import bloom as ref_bloom
from ash_tpu_torch.ops import _build, bloom, bloom_cuda
from ash_tpu_torch.render import bench_scene, frame

torch.set_num_threads(1)

ATOL = 1e-5
RTOL = 1e-5
# (H, W, mip_count): a five-level even pyramid, the parities of a 1080-row
# pyramid's lower levels (135, 270), a narrow one, a frame too small for a
# level, and no level at all.
CASES = [(128, 192, 5), (135, 240, 2), (270, 480, 5), (20, 12, 5), (2, 2, 5),
         (64, 96, 0)]


def _hdr(seed, h, w, peak=8.0):
    """A seeded HDR image: mostly dim, a tenth of the pixels up to `peak`."""
    rng = np.random.default_rng(seed)
    img = rng.random((h, w, 3)) * 0.9
    hot = rng.random((h, w, 1)) < 0.1
    return np.where(hot, img * peak / 0.9, img).astype(np.float32)


@pytest.fixture
def no_library(monkeypatch):
    """Loading (or building) the CUDA library raises."""
    def refuse(name):
        raise AssertionError(f"the CPU path loaded the {name} library")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)


@pytest.mark.parametrize("h,w,mips", CASES)
def test_cpu_entry_is_the_plain_chain(h, w, mips, no_library):
    x = _hdr(7, h, w)
    before = dict(bloom_cuda.launches)
    got = bloom_cuda.bloom_pyramid(torch.from_numpy(x), 0.8, 0.5, mips)
    assert bloom_cuda.launches == before
    assert torch.equal(got, bloom.bloom_pyramid(torch.from_numpy(x), 0.8, 0.5,
                                                mips))
    want = np.asarray(ref_bloom.bloom_pyramid(jnp.asarray(x), 0.8, 0.5, mips))
    assert got.shape == want.shape == (h, w, 3)
    err = np.abs(got.numpy() - want)
    print(f"measured bloom {h}x{w} mips={mips}: max abs err {err.max():.3e}")
    assert np.all(err <= ATOL + RTOL * np.abs(want))
    assert float(want.max()) > 0.1


def _plain_plan(h, w, mips):
    """The plain chain's launches at (h, w, mips) as (kind, src, dst, path),
    read from its calls on a CPU tensor of zeros."""
    steps, taps = [], []
    real = {name: getattr(bloom, name) for name in
            ("_downsample_karis", "_upsample_tent", "_down_tap", "_up_tap")}

    def down(src):
        n = len(taps)
        out = real["_downsample_karis"](src)
        steps.append(("down", tuple(src.shape[1:]), tuple(out.shape[1:]),
                      "blocks" if len(taps) > n else "gather"))
        return out

    def up(src, dh, dw, *args):
        n = len(taps)
        out = real["_upsample_tent"](src, dh, dw, *args)
        steps.append(("up", tuple(src.shape[1:]), (dh, dw),
                      "double" if len(taps) > n else "gather"))
        return out

    def tap(name):
        def f(*args):
            taps.append(name)
            return real[name](*args)
        return f

    with mock.patch.multiple(bloom, _downsample_karis=down,
                             _upsample_tent=up, _down_tap=tap("_down_tap"),
                             _up_tap=tap("_up_tap")):
        bloom.bloom_pyramid(torch.zeros(h, w, 3), 0.8, 0.5, mips)
    return steps


SIZES_H = [1, 2, 3, 5, 8, 67, 135, 300]
SIZES_W = [1, 2, 4, 7, 33, 120, 240, 299]


@pytest.mark.parametrize("mips", range(7))
def test_levels_are_the_plain_chains_launches(mips):
    """Over sizes 1-300 (both parities, sides of 2 and less, the 1080p
    pyramid's levels): the shapes and paths the plain chain takes; the
    threshold on the first launch only, the add on every up but the last."""
    for h in SIZES_H:
        for w in SIZES_W:
            plan = bloom_cuda.levels(h, w, mips)
            assert [(s.kind, s.src, s.dst, s.path) for s in plan] == \
                _plain_plan(h, w, mips), (h, w, mips)
            assert [s.threshold for s in plan] == [True] + [False] * (
                len(plan) - 1)
            ups = [s.add for s in plan if s.kind == "up"]
            assert ups == [True] * (len(ups) - 1) + [False]
            n_down = sum(s.kind == "down" for s in plan)
            assert len(plan) == max(2 * n_down, 1) and n_down <= mips


def test_levels_of_the_rich_frame():
    """1080p with 5 mips: ten launches; the two odd levels take the gather
    down and up."""
    plan = bloom_cuda.levels(1080, 1920, 5)
    assert [(s.kind, s.src, s.path) for s in plan] == [
        ("down", (1080, 1920), "blocks"), ("down", (540, 960), "blocks"),
        ("down", (270, 480), "blocks"), ("down", (135, 240), "gather"),
        ("down", (67, 120), "gather"), ("up", (33, 60), "gather"),
        ("up", (67, 120), "gather"), ("up", (135, 240), "double"),
        ("up", (270, 480), "double"), ("up", (540, 960), "double")]
    assert plan[-1].dst == (1080, 1920)


def test_threshold_operands_are_f32():
    t, k, hi, inv = bloom_cuda.threshold_operands(0.8, 0.5)
    assert t == float(np.float32(0.8)) and k == 0.5
    assert hi == float(np.float32(1.0))
    assert inv == float(np.float32(1.0) / np.float32(2.00001))


def _bad_inputs():
    x = torch.zeros(8, 12, 3)
    return {
        "float64": (x.double(), 0.8, 0.5, 5),
        "float16": (x.half(), 0.8, 0.5, 5),
        "four channels": (torch.zeros(8, 12, 4), 0.8, 0.5, 5),
        "two dims": (torch.zeros(8, 12), 0.8, 0.5, 5),
        "empty": (torch.zeros(0, 12, 3), 0.8, 0.5, 5),
        "not contiguous": (torch.zeros(12, 8, 3).transpose(0, 1), 0.8, 0.5,
                           5),
        "negative mips": (x, 0.8, 0.5, -1),
        "float mips": (x, 0.8, 0.5, 2.0),
        "tensor threshold": (x, torch.tensor(0.8), 0.5, 5),
        "not a tensor": (np.zeros((8, 12, 3), np.float32), 0.8, 0.5, 5),
    }


@pytest.mark.parametrize("bad", sorted(_bad_inputs()))
def test_argument_checks_raise(bad, no_library):
    with pytest.raises(ValueError, match="bloom kernel"):
        bloom_cuda.check_inputs(*_bad_inputs()[bad])


def test_launcher_refuses_the_cpu(no_library):
    with pytest.raises(ValueError, match="unsupported device cpu"):
        bloom_cuda.launcher(torch.zeros(8, 12, 3), 0.8, 0.5, 5)


def _recording():
    calls = []
    real = bloom_cuda.bloom_pyramid

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    return calls, mock.patch.object(bloom_cuda, "bloom_pyramid", record)


@pytest.mark.parametrize("render_scale", [1.0, 0.5])
def test_frame_hands_bloom_to_the_entry(render_scale):
    """The small rich frame (bloom, TAA, ACES) calls the entry once a frame
    with an f32 contiguous frame the card takes, at render_scale 1 and 0.5;
    with bloom off, never."""
    r, _, cam, _ = bench_scene.build_bench_renderer(
        96, 64, 16, "cpu", rich=True, render_scale=render_scale)
    args = (cam.view_matrix(), cam.projection_matrix(), cam.position)
    calls, patch = _recording()
    with patch:
        for _ in range(2):
            r.render_frame(*args)
        assert len(calls) == 2
        for (hdr,), kw in calls:
            assert hdr.dtype == torch.float32 and hdr.shape == (64, 96, 3)
            bloom_cuda.check_inputs(hdr, **kw)
            assert kw == dict(threshold=float(np.float32(0.8)),
                              soft_knee=0.5, mip_count=5)
        r.set_bloom_enabled(False)
        r.render_frame(*args)
    assert len(calls) == 2


def test_farm_frame_hands_bloom_to_the_entry():
    """Example 09's 256x192 frame (3 bloom mips) through
    render_frame_program: one entry call, f32 and contiguous."""
    scene, uni = bench_scene.example_scene(n_cubes=12, device="cpu")
    cfg = bench_scene.example09_config()
    uni = bench_scene.example09_uniforms(uni, 1, 4)
    shadow = frame.shadow_program(cfg, scene, uni.models,
                                  uni.light_space_matrix, None,
                                  uni.cascade_matrices)
    calls, patch = _recording()
    with patch:
        frame.render_frame_program(cfg, scene, uni, shadow, None, None, None,
                                   bench_scene.example09_taa(1),
                                   torch.zeros(192, 256, 3))
    assert len(calls) == 1
    (hdr,), kw = calls[0]
    bloom_cuda.check_inputs(hdr, **kw)
    assert hdr.shape == (192, 256, 3) and kw["mip_count"] == 3


# -- on the card -----------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _kernels_match_plain(x, mips, threshold=0.8, soft_knee=0.5):
    """One counted chain against the plain chain on the same CUDA tensor."""
    hdr = torch.from_numpy(x).cuda()
    want = bloom.bloom_pyramid(hdr, threshold, soft_knee, mips)
    plan = bloom_cuda.levels(x.shape[0], x.shape[1], mips)
    before = dict(bloom_cuda.launches)
    got = bloom_cuda.bloom_pyramid(hdr, threshold, soft_knee, mips)
    for kind in ("down", "up"):
        assert bloom_cuda.launches[kind] - before[kind] == sum(
            s.kind == kind for s in plan)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,mips", CASES + [(1080, 1920, 5), (3, 5, 4),
                                              (67, 120, 3), (192, 256, 3)])
def test_cuda_kernels_match_plain(h, w, mips):
    _need_card()
    _kernels_match_plain(_hdr(7, h, w), mips)


# The edges of the staged paths: one texel; odd sides; rows whose start is
# not 16-byte aligned (482 texels of 12 bytes); targets that fill neither
# the downsample's 32x8 tile nor the tent's 16x64 one (1918 = 29 * 64 + 62
# at the last tent, 959 = 29 * 32 + 31 at the first downsample); and a 2x
# tent of 2^16 targets (staged) beside one just under (one thread a
# target).
STAGED_CASES = [(1, 1, 5), (5, 7, 3), (270, 482, 5), (66, 130, 4),
                (1080, 1918, 5), (256, 256, 1), (256, 254, 1)]


def test_chip_smoke_names_every_launched_instantiation():
    """Each kernel instantiation that csrc/bloom.cu's C entries launch, as
    nvcc would name it in its -Xptxas -v log, gets a distinct name from
    chip_smoke.py's ptxas_usage, and those are BLOOM_INSTANTIATIONS, the
    list its build phase requires; PR 15's bool form parses too."""
    import re
    import sys

    sys.path.insert(0, str(_build.CSRC.parents[1]))
    import chip_smoke

    source = (_build.CSRC / "bloom.cu").read_text()
    paths = {"kGatherPath": 0, "kDirectPath": 1, "kStagedPath": 2}
    launched = set(re.findall(
        r"bloom_(down|up)_kernel<(k\w+Path), (true|false)>\s*<<<", source))
    assert len(launched) == len(chip_smoke.BLOOM_INSTANTIATIONS)

    def entry(mangled, regs):
        return (f"ptxas info    : Compiling entry function '{mangled}' for "
                "'sm_90a'\n    0 bytes stack frame, 0 bytes spill stores, "
                f"0 bytes spill loads\nptxas info    : Used {regs} registers\n")

    log = "".join(
        entry(f"_ZN12_GLOBAL__N_117bloom_{kind}_kernelILi{paths[path]}ELb"
              f"{int(thr == 'true')}EEEv", 30 + i)
        for i, (kind, path, thr) in enumerate(sorted(launched)))
    usage = chip_smoke.ptxas_usage(log)
    assert sorted(usage) == chip_smoke.BLOOM_INSTANTIATIONS
    assert len(set(usage.values())) == len(usage)
    old = chip_smoke.ptxas_usage(
        entry("_ZN12_GLOBAL__N_117bloom_down_kernelILb1ELb1EEEv", 72))
    assert old == {"bloom down blocks threshold": (72, 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,mips", STAGED_CASES)
def test_cuda_kernels_match_plain_at_the_tiles_edges(h, w, mips):
    _need_card()
    _kernels_match_plain(_hdr(9, h, w), mips)


@pytest.mark.cuda
def test_cuda_kernels_match_plain_on_an_unaligned_frame():
    """A frame 4 bytes past a 16-byte boundary: the staging takes scalar
    loads."""
    _need_card()
    x = _hdr(11, 136, 246)
    store = torch.zeros(x.size + 1, dtype=torch.float32, device="cuda")
    hdr = store[1:].view(x.shape)
    hdr.copy_(torch.from_numpy(x))
    assert hdr.is_contiguous() and hdr.data_ptr() % 16 == 4
    want = bloom.bloom_pyramid(hdr, 0.8, 0.5, 5)
    got = bloom_cuda.bloom_pyramid(hdr, 0.8, 0.5, 5)
    torch.cuda.synchronize()
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.cuda
def test_cuda_launches_replay_one_level():
    """launch(steps) runs only those launches of the plan: replaying the
    last one rewrites the same bloom."""
    _need_card()
    hdr = torch.from_numpy(_hdr(7, 270, 480)).cuda()
    launch, out = bloom_cuda.launcher(hdr, 0.8, 0.5, 5)
    made = launch()
    first = out.clone()
    out.zero_()
    again = launch([len(made) - 1])
    torch.cuda.synchronize()
    assert len(again) == 1 and again[0][0] == "up"
    assert torch.equal(out, first)
    assert torch.equal(first, bloom.bloom_pyramid(hdr, 0.8, 0.5, 5))


@pytest.mark.cuda
def test_cuda_reciprocal_is_the_quotient():
    """__frcp_rn(x), which the Karis weight takes, equals __fdiv_rn(1, x) and
    PyTorch's reciprocal on the card, bit for bit, over hard values:
    subnormals, zeros, infinities, powers of two, the largest and smallest
    normals, and random bit patterns (NaNs give NaN)."""
    _need_card()
    rng = np.random.default_rng(12)
    bits = rng.integers(0, 2**32, 1 << 20, dtype=np.uint64).astype(np.uint32)
    edges = np.array([0x00000000, 0x80000000, 0x7F800000, 0xFF800000,
                      0x00000001, 0x80000001, 0x007FFFFF, 0x00800000,
                      0x00400000, 0x7F7FFFFF, 0xFF7FFFFF, 0x7F000000,
                      0x7E800000, 0x7E7FFFFF, 0x3F800000, 0x3F800001,
                      0x3FFFFFFF, 0x40000000, 0x7FC00000], np.uint32)
    x = torch.from_numpy(np.concatenate([bits, edges]).view(
        np.float32)).cuda()
    rcp, quot = bloom_cuda.probe_reciprocal(x)
    torch.cuda.synchronize()
    nan = torch.isnan(x)
    assert torch.equal(torch.isnan(rcp), nan)
    assert torch.equal(torch.isnan(quot), nan)
    assert torch.equal(rcp[~nan], quot[~nan])
    assert torch.equal(rcp[~nan], torch.reciprocal(x)[~nan])


@pytest.mark.cuda
def test_cuda_kernels_match_plain_on_hard_values():
    """Negative values, signed zeros, subnormals and values up to 1e4 at
    odd and even sides, another threshold and knee."""
    _need_card()
    rng = np.random.default_rng(3)
    for h, w in ((270, 480), (135, 241)):
        x = rng.standard_normal((h, w, 3)) * np.exp2(rng.uniform(-20, 13,
                                                                 (h, w, 1)))
        pick = rng.random((h, w, 3))
        x[pick < 0.05] = 0.0
        x[(pick >= 0.05) & (pick < 0.1)] = -0.0
        x[(pick >= 0.1) & (pick < 0.12)] = 1e-42
        _kernels_match_plain(x.astype(np.float32), 5, 1.0, 0.25)


@pytest.mark.cuda
def test_cuda_scalar_division_is_the_reciprocal_product():
    """target_uv's / w, the threshold's / (4 knee + 1e-5) and the tent's
    / 16 multiply by the f32 reciprocal of the CPU scalar; some sides tell
    that from a true division."""
    _need_card()
    differs = False
    for n in (3, 7, 60, 67, 120, 135, 241, 1920):
        x = torch.arange(n, dtype=torch.float32, device="cuda") + 0.5
        inv = float(np.float32(1.0) / np.float32(n))
        assert torch.equal(x / n, x * inv)
        differs |= not torch.equal(x / n, x / torch.full_like(x, n))
    assert differs
    x = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 1, 1 << 20).astype(np.float32)).cuda()
    inv = bloom_cuda.threshold_operands(0.8, 0.5)[3]
    assert torch.equal(x / (4.0 * 0.5 + 1e-5), x * inv)
    assert not torch.equal(x / (4.0 * 0.5 + 1e-5),
                           x / torch.full_like(x, 2.00001))


@pytest.mark.cuda
def test_cuda_python_float_is_an_f32_operand():
    """u + ox * dx adds the f32 of the double: not the double sum rounded."""
    _need_card()
    u = (torch.arange(4096, dtype=torch.float32, device="cuda") + 0.5) / 4096
    d = -1.0 / 135
    assert torch.equal(u + d, u + float(np.float32(d)))
    assert not torch.equal(u + d, (u.double() + d).float())


@pytest.mark.cuda
def test_cuda_maximum_and_clamps_propagate_nan():
    _need_card()
    nan = float("nan")
    a = torch.tensor([nan, 1.0, nan, 2.0, -0.0], device="cuda")
    b = torch.tensor([1.0, nan, nan, 3.0, 0.0], device="cuda")
    m = torch.maximum(a, b)
    assert torch.isnan(m[:3]).all() and m[3] == 3.0
    assert torch.isnan(a.clamp(0.0, 1.0)[0]) and torch.isnan(
        a.clamp_min(1e-5)[0])
    assert a.clamp(0.0, 1.0)[1] == 1.0 and a.clamp_min(1e-5)[4] == float(np.float32(1e-5))
