"""The G-buffer fetch's entry point (ash_tpu_torch/ops/gbuffer_cuda.py) on the
CPU; the kernel itself (csrc/gbuffer.cu) on the card.

The cases start from the G-buffer calls of small bench frames (96x64, 16
cubes, a seeded scene), recorded from the entry point: the standard
frame's pixel grid, the rich frame's (with last frame's clip positions),
edge MSAA x4's centres (pixel_xy as expanded views, deriv_step (2, 2)) and
worklist ((cap, 4) samples), glass's second layer; from them a band (rows
from 16 on, y0 = 16, a larger framebuffer), the tables without vert_uid
(the unique attributes expanded), and seeded vertices behind last frame's
eye (the card also takes them at its w floor).

- On CPU tensors the entry is the plain version (ops/shade.py's
  interpolate_gbuffer), bit for bit, never loads the library and counts no
  launch; and it holds to ash_tpu.ops.shade.interpolate_gbuffer through
  JAX on the CPU at the same inputs: ints and bools equal, floats within
  atol 1e-5 on the covered elements, as tests/test_torch_shade.py holds
  the plain version (f32 divisions, and XLA's fused multiply-adds on the
  CPU, differ from PyTorch's in the last bits); the uncovered elements
  extrapolate triangle 0 to values of up to about 72, held within atol
  1e-5 plus 1e-6 of the value (a few f32 steps there).
- The argument checks pass every case and every frame's call, and raise
  on the wrong dtype, shape, device, layout and scalar argument.
- The frames make one entry call a shaded layer (and one for edge MSAA's
  worklist); the pass profiler and the cost analysis go through it.
- On the card (marked `cuda`, skipped here): the kernel against the plain
  version on the same CUDA tensors, every field bit for bit with NaN in
  the same places, over the cases, seeded triangle ids, weight sums near
  and at 0, uncovered elements whose triangle 0 gives inf and NaN, and
  framebuffer sizes whose reciprocals round; the 1080p frames' own calls;
  and probes of the card's roundings that the kernel codes: lam.sum(-1)
  as (l0 + l2) + l1, _interp's sum over the non-innermost axis as
  (p0 + p1) + p2 for 2, 3 and 4 channels, vector_norm of a 3-vector as
  sqrt((x*x + z*z) + y*y), no sum -0, and a division by a host int as the
  product with its f32 reciprocal.
"""

import functools
from unittest import mock

import numpy as np
import pytest
import torch

from ash_tpu_torch.ops import _build, gbuffer_cuda, shade
from ash_tpu_torch.render import bench_scene, cost_analysis, pass_profiler

torch.set_num_threads(1)

ATOL = 1e-5
# Uncovered elements carry triangle 0's interpolation extrapolated across
# the frame (|world| up to about 72 here, where one f32 step is 7.6e-6):
# they are held at ATOL plus this share of the value, about 8 f32 steps.
RTOL_UNCOVERED = 1e-6
W, H = 96, 64

# The small bench frames whose calls the cases start from: name ->
# (build_bench_renderer keywords, MSAA preset or None).
FRAMES = {
    "standard": ({}, None),
    "rich": (dict(rich=True), None),
    "edge x4": (dict(msaa_resolve="edge"), "x4"),
    "glass": (dict(glass=True), None),
}
# The recorded calls a frame makes: one a shaded layer (glass peels 4), and
# the edge worklist's.
CALLS_PER_FRAME = {"standard": 1, "rich": 1, "edge x4": 2, "glass": 4}

# Cases held to the reference through JAX on the CPU.
REFERENCE_CASES = ("grid", "grid without vert_uid", "band with velocity",
                   "behind the eye", "edge centres", "edge worklist",
                   "glass layer 2")
# Cases only the card's bit-for-bit check takes: their values are
# deliberately extreme, where XLA's fused arithmetic and PyTorch's part.
CARD_CASES = ("seeded ids", "w floor", "near-zero sums",
              "triangle 0 non-finite",
              "framebuffer 97x67", "framebuffer 1000x3",
              "framebuffer 1921x1083")
CASES = REFERENCE_CASES + CARD_CASES


def _record(kw, preset, device, width=W, height=H, n=16):
    """Frame 1 of a bench renderer with the entry point wrapped -> its
    G-buffer calls [(args, kwargs)] in call order."""
    r, _, cam, _ = bench_scene.build_bench_renderer(width, height, n, device,
                                                    **kw)
    if preset is not None:
        r.set_msaa_preset(preset)
    calls = []
    real = gbuffer_cuda.interpolate_gbuffer

    def entry(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    with mock.patch.object(gbuffer_cuda, "interpolate_gbuffer", entry):
        r.render_frame(cam.view_matrix(), cam.projection_matrix(),
                       cam.position)
    return calls


@functools.lru_cache(maxsize=None)
def _frames(device):
    return {name: _record(kw, preset, device)
            for name, (kw, preset) in FRAMES.items()}


def _replace(call, i=None, value=None, **kwargs):
    """A recorded call with positional argument i set to value and the
    keywords updated."""
    args, kw = call
    args = list(args)
    if i is not None:
        args[i] = value
    return tuple(args), {**kw, **kwargs}


def _case(name, device="cpu"):
    """-> (args, kwargs) of the entry for case `name` on `device`."""
    frames = _frames(device)
    grid, rich = frames["standard"][0], frames["rich"][0]
    tri_id, setup = grid[0][0], grid[0][1]
    rng = np.random.default_rng(CASES.index(name) + 90)
    dev = tri_id.device
    if name == "grid":
        return grid
    if name == "grid without vert_uid":
        args, kw = grid
        uid = kw["vert_uid"].long()
        args = (*args[:5], args[5][uid].contiguous(),
                args[6][uid].contiguous())
        return args, {**kw, "vert_uid": None}
    if name == "band with velocity":
        return _replace(rich, 0, rich[0][0][16:], y0=16, fb_height=H,
                        fb_width=W + 4)
    if name in ("behind the eye", "w floor"):
        # Vertices behind last frame's eye, or (a velocity of hundreds of
        # uv units, divided by the 1e-6 floor) just in front of it.
        prev = rich[1]["prev_clip"].clone()
        some = torch.from_numpy(rng.random(prev.shape[0]) < 0.2).to(dev)
        prev[some, 3] = -0.5 if name == "behind the eye" else 1e-7
        return _replace(rich, prev_clip=prev)
    if name == "edge centres":
        return frames["edge x4"][0]
    if name == "edge worklist":
        return frames["edge x4"][1]
    if name == "glass layer 2":
        return frames["glass"][1]
    if name == "seeded ids":
        ids = rng.integers(-1, setup.edge.shape[0], tri_id.shape)
        return _replace(rich, 0, torch.from_numpy(ids.astype(np.int32))
                        .to(dev))
    if name == "near-zero sums":
        # Scale the edge rows of the frame's triangles so that their
        # weight sums fall either side of the 1e-12 floor; one triangle's
        # rows are all 0.
        edge = setup.edge.clone()
        seen = torch.unique(tri_id[tri_id >= 0]).long()
        scale = torch.from_numpy(10.0 ** rng.choice(
            np.arange(-13.0, -10.0, 0.25), seen.shape[0])).to(dev)
        edge[seen] = edge[seen] * scale[:, None, None].float()
        edge[seen[0]] = 0.0
        return _replace(grid, 1, setup._replace(edge=edge))
    if name == "triangle 0 non-finite":
        # Uncovered elements read triangle 0: rows that overflow, and
        # vertex attributes that are inf and NaN.
        args, kw = rich
        edge = setup.edge.clone()
        edge[0, 0] = torch.tensor([1e30, -1e30, 3e38], device=dev)
        edge[0, 1, 2] = float("inf")
        verts = args[4]
        v0 = args[2][0].long()
        world, normal = verts.world.clone(), verts.normal.clone()
        world[v0[0], 0] = float("inf")
        normal[v0[1]] = float("nan")
        prev = kw["prev_clip"].clone()
        prev[v0[2], 3] = float("nan")
        assert bool((tri_id < 0).any())
        return ((args[0], setup._replace(edge=edge), *args[2:4],
                 verts._replace(world=world, normal=normal), *args[5:]),
                {**kw, "prev_clip": prev})
    if name.startswith("framebuffer"):
        w, h = map(int, name.split()[1].split("x"))
        return _replace(rich, fb_width=w, fb_height=h)
    raise KeyError(name)


def _numpy(t):
    return None if t is None else np.ascontiguousarray(t.cpu().numpy())


def _reference(args, kw):
    """ash_tpu.ops.shade.interpolate_gbuffer through JAX on the CPU at the
    same inputs, as numpy arrays."""
    import jax.numpy as jnp

    from ash_tpu.ops import geometry as ref_geo
    from ash_tpu.ops import shade as ref_shade

    tri_id, setup, tri_v, tri_draw, verts, uv, color = args

    def j(t):
        return None if t is None else jnp.asarray(_numpy(t))

    ref_setup = ref_geo.TriangleSetup(
        **{f: j(getattr(setup, f)) for f in ref_geo.TriangleSetup._fields})
    ref_verts = ref_geo.TransformedVerts(
        **{f: j(getattr(verts, f)) for f in ref_geo.TransformedVerts._fields})
    pixel_xy = kw.get("pixel_xy")
    out = ref_shade.interpolate_gbuffer(
        j(tri_id), ref_setup, j(tri_v), j(tri_draw), ref_verts, j(uv),
        j(color), y0=kw.get("y0", 0), prev_clip=j(kw.get("prev_clip")),
        fb_height=kw.get("fb_height"), fb_width=kw.get("fb_width"),
        vert_uid=j(kw.get("vert_uid")),
        pixel_xy=None if pixel_xy is None else tuple(map(j, pixel_xy)),
        deriv_step=kw.get("deriv_step", (1.0, 1.0)))
    return {f: None if v is None else np.asarray(v)
            for f, v in out._asdict().items()}


@pytest.fixture
def no_library(monkeypatch):
    """Loading (or building) the CUDA library raises."""
    def refuse(name):
        raise AssertionError(f"the CPU path loaded the {name} library")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)


def _assert_fields(got, shape, velocity):
    """Every field of `got` has the plain version's dtype, shape and a
    contiguous layout; the velocity is there iff `velocity`."""
    for name, t in got._asdict().items():
        if name == "velocity" and not velocity:
            assert t is None
            continue
        last = {"world": (3,), "normal": (3,), "tangent": (4,), "uv": (2,),
                "color": (3,), "uv_ddx": (2,), "uv_ddy": (2,),
                "velocity": (2,)}.get(name, ())
        dtype = {"mask": torch.bool, "front_facing": torch.bool,
                 "draw_id": torch.int32}.get(name, torch.float32)
        assert t.dtype == dtype and tuple(t.shape) == shape + last, name
        assert t.is_contiguous(), name


@pytest.mark.parametrize("name", CASES)
def test_cpu_entry_is_the_plain_version(name, no_library):
    args, kw = _case(name)
    gbuffer_cuda.check_inputs(*args, **kw)
    before = dict(gbuffer_cuda.launches)
    got = gbuffer_cuda.interpolate_gbuffer(*args, **kw)
    want = shade.interpolate_gbuffer(*args, **kw)
    assert gbuffer_cuda.launches == before
    _assert_fields(got, tuple(args[0].shape), "prev_clip" in kw
                   and kw["prev_clip"] is not None)
    for f in shade.GBuffer._fields:
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if g is None:
            continue
        if g.is_floating_point():
            nan = torch.isnan(w)
            assert torch.equal(torch.isnan(g), nan), f
            g, w = g[~nan], w[~nan]
        assert torch.equal(g, w), f


@pytest.mark.parametrize("name", REFERENCE_CASES)
def test_entry_matches_reference(name, no_library):
    """The entry on CPU tensors against ash_tpu through JAX: ints and bools
    equal, floats within ATOL on the covered elements and within ATOL plus
    RTOL_UNCOVERED of the value on the others."""
    args, kw = _case(name)
    got = gbuffer_cuda.interpolate_gbuffer(*args, **kw)
    want = _reference(args, kw)
    mask = got.mask.numpy()
    assert 0 < int(mask.sum()) < mask.size
    for f in shade.GBuffer._fields:
        have, ref = getattr(got, f), want[f]
        assert (have is None) == (ref is None), f
        if have is None:
            continue
        have = have.numpy()
        if ref.dtype in (np.bool_, np.int32):
            np.testing.assert_array_equal(have, ref, err_msg=f)
        else:
            np.testing.assert_allclose(have[mask], ref[mask], atol=ATOL,
                                       rtol=0, err_msg=f)
            np.testing.assert_allclose(have[~mask], ref[~mask], atol=ATOL,
                                       rtol=RTOL_UNCOVERED, err_msg=f)
    if kw.get("prev_clip") is not None:
        velocity = got.velocity.numpy()
        assert float(np.abs(velocity).max()) > 0.0
        assert (velocity[~mask] == 0).all()
        if name == "behind the eye":
            # Some covered pixels interpolate a w at or below 0.
            assert bool(((velocity == 0).all(-1) & mask).any())


def test_cases_cover_the_variants():
    """The recorded calls are the variants the frames hand the entry."""
    grid, _ = _case("grid")
    assert grid[0].shape == (H, W) and _case("grid")[1]["vert_uid"] \
        is not None
    centres = _case("edge centres")
    px, py = centres[1]["pixel_xy"]
    assert px.stride() == (0, 1) and py.stride() == (1, 0)
    assert centres[1]["deriv_step"] == (2.0, 2.0)
    worklist = _case("edge worklist")
    assert worklist[0][0].shape[1] == 4 and worklist[0][0].dim() == 2
    band = _case("band with velocity")
    assert band[1]["y0"] == 16 and band[1]["prev_clip"] is not None
    assert band[1]["fb_height"] > band[0][0].shape[0]
    assert band[1]["fb_width"] > band[0][0].shape[1]
    assert _case("grid without vert_uid")[1]["vert_uid"] is None


@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_frames_call_the_entry_once_a_shaded_layer(frame):
    calls = _frames("cpu")[frame]
    assert len(calls) == CALLS_PER_FRAME[frame]
    for args, kw in calls:
        gbuffer_cuda.check_inputs(*args, **kw)
        assert (kw["prev_clip"] is not None) == (frame == "rich")


def _bad_inputs():
    """name -> a function of (args, kwargs) that breaks them."""
    def arg(i, fn):
        def make(args, kw):
            args = list(args)
            args[i] = fn(args[i])
            return tuple(args), kw
        return make

    def key(k, fn):
        return lambda args, kw: (args, {**kw, k: fn(kw.get(k))})

    def setup(field, fn):
        return arg(1, lambda s: s._replace(**{field: fn(getattr(s, field))}))

    def verts(field, fn):
        return arg(4, lambda v: v._replace(**{field: fn(getattr(v, field))}))

    def meta(t):
        return torch.empty(t.shape, dtype=t.dtype, device="meta")

    def strided(t):
        return torch.cat([t, t], -1)[..., ::2]

    return {
        "tri_id int64": arg(0, lambda t: t.long()),
        "tri_id 1-d": arg(0, lambda t: t.reshape(-1)),
        "tri_id empty": arg(0, lambda t: t[:0]),
        "tri_id on another device": arg(0, meta),
        "edge float64": setup("edge", lambda t: t.double()),
        "edge 3x4": setup("edge", lambda t: torch.cat([t, t[..., :1]], -1)),
        "edge strided": setup("edge", strided),
        "det one short": setup("det", lambda t: t[1:]),
        "tri_v int64": arg(2, lambda t: t.long()),
        "tri_draw int64": arg(3, lambda t: t.long()),
        "tri_draw one short": arg(3, lambda t: t[1:]),
        "world strided": verts("world", strided),
        "normal bf16": verts("normal", lambda t: t.to(torch.bfloat16)),
        "tangent 3 wide": verts("tangent", lambda t: t[:, :3].contiguous()),
        "uv 3 wide": arg(5, lambda t: torch.cat([t, t[:, :1]], 1)),
        "color one short": arg(6, lambda t: t[1:]),
        "vert_uid int64": key("vert_uid", lambda t: t.long()),
        "vert_uid one short": key("vert_uid", lambda t: t[1:]),
        "prev_clip 3 wide": key("prev_clip", lambda t: t[:, :3].contiguous()),
        "prev_clip float64": key("prev_clip", lambda t: t.double()),
        "pixel_xy one tensor": key("pixel_xy", lambda p: p[0]),
        "pixel_xy float64": key("pixel_xy", lambda p: (p[0].double(), p[1])),
        "pixel_xy wrong shape": key("pixel_xy", lambda p: (p[0][:1], p[1])),
        "y0 float": key("y0", lambda v: 0.5),
        "fb_width 0": key("fb_width", lambda v: 0),
        "fb_height float": key("fb_height", lambda v: 64.0),
        "deriv_step nan": key("deriv_step", lambda v: (float("nan"), 1.0)),
        "deriv_step one": key("deriv_step", lambda v: (1.0,)),
    }


BAD = _bad_inputs()


@pytest.mark.parametrize("bad", sorted(BAD))
def test_argument_checks_raise(bad):
    base = "edge centres" if bad.startswith("pixel_xy") else "grid"
    if bad.startswith("prev_clip"):
        base = "band with velocity"
    args, kw = _case(base)
    gbuffer_cuda.check_inputs(*args, **kw)
    args, kw = BAD[bad](args, kw)
    with pytest.raises(ValueError):
        gbuffer_cuda.check_inputs(*args, **kw)


def test_launcher_refuses_the_cpu(no_library):
    args, kw = _case("grid")
    with pytest.raises(ValueError, match="unsupported device"):
        gbuffer_cuda.launcher(*args, **kw)


def test_pass_profiler_and_cost_analysis_reach_the_entry(monkeypatch):
    """profile_passes fetches its G-buffer through the entry, and the cost
    analysis listens to its launches while it counts."""
    calls = []
    real = gbuffer_cuda.interpolate_gbuffer

    def entry(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(gbuffer_cuda, "interpolate_gbuffer", entry)
    r, _, cam, _ = bench_scene.build_bench_renderer(W, H, 16, "cpu")
    timings = pass_profiler.profile_passes(
        r, cam.view_matrix(), cam.projection_matrix(), cam.position, 1)
    assert "GBuffer" in timings and calls and calls[0] == (H, W)
    with cost_analysis.FrameCost() as cost:
        assert cost._kernel_launch in gbuffer_cuda.observers
    assert cost._kernel_launch not in gbuffer_cuda.observers


# -- on the card -----------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


def _assert_same(got, want):
    """Every field: ints and bools equal, floats bit for bit where the plain
    version has a number and NaN where it has NaN."""
    for f in shade.GBuffer._fields:
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if g is None:
            continue
        assert g.shape == w.shape and g.dtype == w.dtype, f
        if not w.is_floating_point():
            assert torch.equal(g, w), f
            continue
        nan = torch.isnan(w)
        assert torch.equal(torch.isnan(g), nan), f
        assert torch.equal(g[~nan].view(torch.int32),
                           w[~nan].view(torch.int32)), f


def _kernel_matches_plain(args, kw):
    want = shade.interpolate_gbuffer(*args, **kw)
    before = gbuffer_cuda.launches["gbuffer"]
    got = gbuffer_cuda.interpolate_gbuffer(*args, **kw)
    torch.cuda.synchronize()
    assert gbuffer_cuda.launches["gbuffer"] == before + 1
    _assert_fields(got, tuple(args[0].shape),
                   kw.get("prev_clip") is not None)
    _assert_same(got, want)
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_cuda_kernel_matches_plain(name):
    _need_card()
    got, _ = _kernel_matches_plain(*_case(name, "cuda"))
    if name == "triangle 0 non-finite":
        uncovered = ~got.mask
        assert bool(torch.isnan(got.normal[uncovered]).any())
    if name == "near-zero sums":
        assert bool((got.uv[got.mask] == 0).all(-1).any())


@pytest.mark.cuda
@pytest.mark.parametrize("frame", ["standard", "rich", "glass", "edge x4"])
def test_cuda_kernel_matches_plain_on_the_1080p_frames(frame):
    _need_card()
    kw, preset = FRAMES[frame]
    calls = _record(kw, preset, "cuda", 1920, 1080, 1000)
    assert len(calls) == CALLS_PER_FRAME[frame]
    for args, kwargs in calls:
        _kernel_matches_plain(args, kwargs)


def _probe_values(shape, seed):
    """Seeded f32 values of mixed signs and magnitudes, so that the orders
    of a sum round differently."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=shape) * 10.0 ** rng.integers(-3, 4, shape)
    return torch.from_numpy(v.astype(np.float32)).cuda()


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.cuda
def test_cuda_weight_sum_adds_lanes_0_and_2_first():
    """lam.sum(-1, keepdim=True) over 3 innermost values: (l0 + l2) + l1,
    not (l0 + l1) + l2."""
    _need_card()
    lam = _probe_values((512, 384, 3), 1)
    got = lam.sum(-1)
    l0, l1, l2 = lam.unbind(-1)
    assert torch.equal(_bits(got), _bits((l0 + l2) + l1))
    assert not torch.equal(_bits(got), _bits((l0 + l1) + l2))


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [2, 3, 4])
def test_cuda_interp_sums_the_vertices_in_order(channels):
    """_interp's (pw[..., :, None] * attr).sum(-2) is ((p0 + p1) + p2)
    from +0 for 2, 3 and 4 channels, not the innermost sum's lanes."""
    _need_card()
    pw = _probe_values((256, 384, 3), 2)
    attr = _probe_values((256, 384, 3, channels), 3 + channels)
    got = shade._interp(pw, attr)
    p = pw[..., :, None] * attr
    p0, p1, p2 = p.unbind(-2)
    assert torch.equal(_bits(got), _bits(((p0 + p1) + p2) + 0.0))
    assert not torch.equal(_bits(got), _bits(((p0 + p2) + p1) + 0.0))
    # -0 products sum to +0.
    zero = shade._interp(torch.full((4, 3), -0.0, device="cuda"),
                         torch.ones((4, 3, channels), device="cuda"))
    assert torch.equal(_bits(zero), torch.zeros_like(_bits(zero)))


@pytest.mark.cuda
def test_cuda_normalize_of_3_vectors():
    """light_loop._normalize: vector_norm as sqrt((x*x + z*z) + y*y), each
    square rounded, floored at f32(1e-8), then an IEEE division."""
    _need_card()
    v = _probe_values((512, 384, 3), 9)
    v[:4] = 0.0
    got = shade._normalize(v)
    x, y, z = v.unbind(-1)
    n = torch.sqrt((x * x + z * z) + y * y).clamp_min(1e-8)[..., None]
    assert torch.equal(_bits(got), _bits(v / n))


@pytest.mark.cuda
def test_cuda_division_by_a_host_int_is_the_f32_reciprocal():
    """px / n (a Python int) on the card is px times 1.0f / f32(n), which
    the wrapper hands the kernel; at some (px, n) that differs from the
    IEEE quotient."""
    _need_card()
    px = torch.arange(8192, dtype=torch.float32, device="cuda") + 0.5
    differs = 0
    for n in (3, 67, 97, 1000, 1083, 1920, 1921):
        got = px / n
        rcp = float(np.float32(1.0) / np.float32(n))
        assert torch.equal(_bits(got), _bits(px * rcp)), n
        ieee = px / torch.full_like(px, float(n))
        differs += int((_bits(got) != _bits(ieee)).sum())
    assert differs > 0
