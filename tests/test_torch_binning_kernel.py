"""The binning kernels' entry points (ash_tpu_torch/ops/binning_cuda.py) on
the CPU; the kernels themselves (csrc/binning.cu) on the card.

The cases: the reference tests' inputs (tests/test_torch_binning.py's cubes
at 96x64, dense, in a band and at a cap of 4; tests/test_torch_scale.py's
two-level cases: a coarse tile of 3 x 2 fine tiles of 16x32 (48 rows) in
two bands, a coarse overflow, boxes landing in the pad tiles, 5000 random
boxes whose first 20 span +-1e9) and seeded variants: NaN boxes on invalid
triangles, infinite boxes, a band from row 16, a cap above T. Under "nearest"
the scores are few distinct values, so ties decide by id.

- On CPU tensors the entries are the plain binner (ops/binning.py), never
  load the library and count no launch; they equal ash_tpu.ops.binning's
  on JAX's CPU backend at the same numpy inputs array for array (ids,
  counts, overflow), under both policies.
- `frame._binner` hands out the entries; the small frames' binner calls
  (dense and two-level, both policies, the shadow pass and the cascades,
  a band) pass `check_inputs`, which refuses the wrong dtype, shape,
  device, layout and scalar arguments, naming the kernel.
- On the card (marked `cuda`, skipped here): the kernels against the plain
  binner on the same CUDA tensors, array for array, at every case; a
  seeded 1,002,528-triangle case at the 1080p frame's two-level caps,
  dropping nothing and overflowing both levels under ties; the card's
  division by a host int (floor(y / 48) as the product with the f32
  reciprocal, which differs from the quotient at 48k - ulp) probed and the
  kernels held to the plain binner there; a capture and replay in a
  CUDAGraph equal to the eager call; a frame's calls counted.
"""

import functools

import numpy as np
import pytest
import torch

from ash_tpu_torch.ops import _build, binning, binning_cuda
from ash_tpu_torch.ops import geometry
from ash_tpu_torch.render import bench_scene, cost_analysis, frame

torch.set_num_threads(1)

W, H = 96, 64


def _boxes(t, w, h, seed, spread=(60, 40)):
    """tests/test_torch_scale.py's random boxes and validity."""
    rng = np.random.default_rng(seed)
    x0 = rng.random(t) * w
    y0 = rng.random(t) * h
    bbox = np.stack([x0, y0, x0 + rng.random(t) * spread[0],
                     y0 + rng.random(t) * spread[1]], 1).astype(np.float32)
    return bbox, rng.random(t) > 0.2


@functools.lru_cache(maxsize=None)
def _cubes(n=8, seed=2):
    """The setup of tests/test_torch_binning.py's n random cubes at 96x64,
    taken by the port's geometry -> (bbox, valid, -min z_clip)."""
    from ash_tpu_torch.core.mesh import Mesh
    from ash_tpu_torch.core.transform import Camera

    rng = np.random.default_rng(seed)
    cube = Mesh.create_cube()
    models = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    models[:, :3, 3] = rng.uniform(-1.5, 1.5, (n, 3))
    cam = Camera.new([3.0, 2.0, 4.0], [0, 0, 0], W / H)
    vp = (cam.projection_matrix() @ cam.view_matrix()).astype(np.float32)
    tv = geometry.transform_vertices(
        torch.from_numpy(models), torch.from_numpy(vp),
        torch.from_numpy(cube.vertices.position),
        torch.from_numpy(cube.vertices.normal),
        torch.from_numpy(cube.vertices.tangent),
        torch.arange(n, dtype=torch.int32).repeat_interleave(24),
        vert_uid=torch.arange(24, dtype=torch.int32).repeat(n))
    tri_v = cube.triangle_indices[None] + 24 * np.arange(n)[:, None, None]
    setup = geometry.triangle_setup(
        tv.clip, torch.from_numpy(tri_v.reshape(-1, 3).astype(np.int32)),
        torch.ones(12 * n, dtype=torch.bool), W, H)
    return (setup.bbox.numpy(), setup.valid.numpy(),
            (-setup.z_clip.amin(-1)).numpy())


def _ties(t, seed):
    """Scores of few distinct values: ties decide by id."""
    return np.random.default_rng(seed).integers(0, 7, t).astype(np.float32)


def _with(bbox, valid, rows, value, invalid=True):
    bbox, valid = bbox.copy(), valid.copy()
    bbox[rows] = value
    if invalid:
        valid[rows] = False
    return bbox, valid


def _probe_boxes():
    """Boxes whose edges lie at 48k - ulp, where floor(y / 48) taken as
    the product with the f32 reciprocal of 48 rounds up to k (and the
    quotient does not), and at 48k, in a 208x160 frame."""
    edges = np.array([239.99998, 240.0, 431.99997, 432.0, 479.99997,
                      95.99999, 96.0, 143.99998, 47.999996], np.float32)
    rng = np.random.default_rng(7)
    rows = []
    for e in edges:
        for _ in range(6):
            x0 = np.float32(rng.random() * 180)
            rows.append((x0, e - 30, x0 + 20, e))
            rows.append((x0, e, x0 + 20, e + 10))
    bbox = np.array(rows, np.float32)
    return bbox, np.ones(len(bbox), bool)


def _cases():
    """name -> (bbox, valid, nearest score, (height, width, tile_h,
    tile_w, cap), kwargs: y0, and for the two-level binner coarse_tiles
    and coarse_cap)."""
    cases = {}
    bbox, valid, z = _cubes()
    for name, rows, y0, cap in (("cubes", H, 0, 64), ("cubes cap 4", H, 0, 4),
                                ("cubes band", H // 2, H // 2, 64),
                                ("cubes cap above T", H, 0, 200)):
        cases[name] = (bbox, valid, z, (rows, W, 16, 32, cap), dict(y0=y0))
    rb, rv = _boxes(300, 200, 150, seed=5)
    for y0, h in ((0, 160), (64, 48)):
        cases[f"coarse 48 rows y0={y0}"] = (
            rb, rv, _ties(300, 0), (h, 208, 16, 32, 64),
            dict(y0=y0, coarse_tiles=(3, 2), coarse_cap=300))
    pb, pv = _probe_boxes()
    cases["division probe"] = (pb, pv, _ties(len(pb), 4), (160, 208, 16, 32,
                                                          64),
                               dict(coarse_tiles=(3, 2), coarse_cap=500))
    cases["division probe dense"] = (pb, pv, _ties(len(pb), 4),
                                     (160, 208, 48, 32, 64), dict())
    cases["coarse overflow"] = (
        np.tile(np.array([[1.0, 1.0, 3.0, 3.0]], np.float32), (64, 1)),
        np.ones(64, bool), _ties(64, 1), (64, 64, 16, 32, 64),
        dict(coarse_tiles=(4, 2), coarse_cap=16))
    pad = np.array([(4.0, 4.0, 12.0, 12.0)]
                   + [(96 + 2.0 + i, 1.0, 96 + 20.0 + i, 6.0)
                      for i in range(6)], np.float32)
    cases["pad tiles"] = (pad, np.ones(len(pad), bool), _ties(len(pad), 2),
                          (64, 96, 8, 32, 4), dict(coarse_tiles=(4, 2),
                                                   coarse_cap=16384))
    big, bv = _boxes(5000, 300, 100, seed=0, spread=(30, 24))
    big[:20] = [-1e9, -1e9, 1e9, 1e9]
    score = _ties(5000, 3)
    for cap, kc in ((64, 200), (16, 100), (300, 5000)):
        for y0 in (0, 16):
            cases[f"random cap {cap} coarse {kc} y0={y0}"] = (
                big, bv, score, (100, 300, 8, 32, cap),
                dict(y0=y0, coarse_tiles=(4, 2), coarse_cap=kc))
    cases["random dense cap 16 y0=16"] = (big, bv, score, (100, 300, 8, 32,
                                                          16), dict(y0=16))
    nb, nv = _with(big, bv, slice(20, 60), np.nan)
    cases["nan boxes invalid"] = (nb, nv, score, (100, 300, 8, 32, 64),
                                  dict(coarse_tiles=(4, 2), coarse_cap=200))
    cases["nan boxes invalid dense"] = (nb, nv, score, (100, 300, 8, 32, 64),
                                        dict())
    ib, iv = _with(big, bv, slice(60, 70),
                   np.array([-np.inf, -np.inf, np.inf, np.inf], np.float32),
                   invalid=False)
    cases["infinite boxes"] = (ib, iv, score, (100, 300, 8, 32, 64),
                               dict(coarse_tiles=(2, 4), coarse_cap=300))
    cases["infinite boxes dense"] = (ib, iv, score, (100, 300, 8, 32, 64),
                                     dict())
    return cases


CASES = _cases()
# Cases only the card's check takes: the reference's JAX binner need not
# agree where the card's division rounds (floor(y / 48) as a product).
CARD_ONLY = ("division probe", "division probe dense")
POLICIES = ("draw_order", "nearest")


def _entry(two_level):
    return (binning_cuda.bin_triangles_two_level if two_level
            else binning_cuda.bin_triangles)


def _call(fn, case, device, policy):
    bbox, valid, score, args, kw = CASES[case]
    keep = None
    if policy == "nearest":
        keep = torch.from_numpy(score).to(device)
    return fn(torch.from_numpy(bbox).to(device),
              torch.from_numpy(valid).to(device), *args, **kw,
              keep_score=keep)


def _plain(two_level):
    return (binning.bin_triangles_two_level if two_level
            else binning.bin_triangles)


def _assert_contract(bins, case):
    height, width, tile_h, tile_w, cap = CASES[case][3]
    tiles = (-(-height // tile_h)) * (-(-width // tile_w))
    assert bins.tri_ids.dtype == torch.int32 and bins.tri_ids.is_contiguous()
    assert tuple(bins.tri_ids.shape) == (tiles, cap)
    assert bins.counts.dtype == torch.int32
    assert tuple(bins.counts.shape) == (tiles,)
    assert bins.overflow.dtype == torch.int32 and bins.overflow.dim() == 0


def _assert_same(got, want, what):
    for f in ("tri_ids", "counts", "overflow"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.shape == w.shape and g.dtype == w.dtype, f"{what}: {f}"
        assert torch.equal(g.cpu(), w.cpu()), f"{what}: {f}"


# -- on the CPU ------------------------------------------------------------

@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize(
    "case", [c for c in CASES if c not in CARD_ONLY])
def test_entry_matches_reference_on_cpu(case, policy, monkeypatch):
    """The entry on CPU tensors: the plain binner, equal to ash_tpu's."""
    import jax.numpy as jnp
    from ash_tpu.ops import binning as ref_binning

    def no_library(name):
        raise AssertionError("the CPU entry loaded a CUDA library")

    monkeypatch.setattr(_build, "load", no_library)
    bbox, valid, score, args, kw = CASES[case]
    two_level = "coarse_tiles" in kw
    before = dict(binning_cuda.launches)
    got = _call(_entry(two_level), case, "cpu", policy)
    assert binning_cuda.launches == before
    _assert_contract(got, case)
    _assert_same(got, _call(_plain(two_level), case, "cpu", policy), case)
    ref = (ref_binning.bin_triangles_two_level if two_level
           else ref_binning.bin_triangles)
    want = ref(jnp.asarray(bbox), jnp.asarray(valid), *args, **kw,
               keep_score=(jnp.asarray(score) if policy == "nearest"
                           else None))
    for f in ("tri_ids", "counts", "overflow"):
        np.testing.assert_array_equal(
            getattr(got, f).numpy(), np.asarray(getattr(want, f)),
            err_msg=f"{case} {policy}: {f}")


def test_cases_reach_every_path():
    """The cases overflow, drop nothing, use bands and two levels."""
    over, clean = set(), set()
    for case in CASES:
        for policy in POLICIES:
            bins = _call(_entry("coarse_tiles" in CASES[case][4]), case,
                         "cpu", policy)
            (over if int(bins.overflow) else clean).add(case)
    assert {"cubes cap 4", "coarse overflow",
            "random cap 16 coarse 100 y0=0"} <= over
    assert {"cubes", "pad tiles", "random cap 300 coarse 5000 y0=16"} <= clean


@pytest.mark.parametrize("two", [False, True])
def test_frame_binner_is_the_entry(two):
    cfg = frame.FrameConfig(width=W, height=H, two_level_binning=two,
                            binning_coarse_cap=123)
    fn = frame._binner(cfg, 100)
    if two:
        assert fn.func is binning_cuda.bin_triangles_two_level
        assert fn.keywords == {"coarse_cap": 123}
    else:
        assert fn is binning_cuda.bin_triangles


# The small frames whose binner calls the checks must pass: name ->
# build_bench_renderer keywords.
FRAMES = {
    "standard": dict(),
    "animated": dict(animate=True),
    "rich": dict(rich=True),
    "glass": dict(glass=True),
    "two-level nearest": dict(two_level_binning=True,
                              binning_policy="nearest"),
    "ssaa x4": dict(msaa_resolve="ssaa"),
}


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_frames_hand_the_kernels_what_they_take(name, monkeypatch):
    calls = []
    real = {f: getattr(binning_cuda, f)
            for f in ("bin_triangles", "bin_triangles_two_level")}

    def checked(fname):
        def entry(*args, **kwargs):
            kw = dict(kwargs)
            if fname == "bin_triangles_two_level":
                kw.setdefault("coarse_tiles", (4, 2))
                kw.setdefault("coarse_cap", 16384)
            binning_cuda.check_inputs(*args, **kw)
            calls.append((fname, kw.get("keep_score") is not None))
            return real[fname](*args, **kwargs)
        return entry

    for f in real:
        monkeypatch.setattr(binning_cuda, f, checked(f))
    kw = FRAMES[name]
    r, _, cam, extent = bench_scene.build_bench_renderer(96, 64, 16, "cpu",
                                                         **kw)
    if name == "ssaa x4":
        r.set_msaa_preset("x4")
    for i in range(2):
        if kw.get("animate"):
            r.update_transforms_trs(
                *bench_scene.animated_models_trs(extent, i / 60.0))
        r.render_frame(cam.view_matrix(), cam.projection_matrix(),
                       cam.position)
    # The main pass each frame; the shadow pass at least once (every frame
    # when animated, a pass a cascade in the rich frame).
    assert len(calls) >= 3
    if kw.get("animate"):
        assert len(calls) == 4
    if kw.get("rich"):
        assert len(calls) == 2 + 3
    two = kw.get("two_level_binning", False)
    assert {f for f, _ in calls} == {
        "bin_triangles_two_level" if two else "bin_triangles"}
    assert all(k == (kw.get("binning_policy") == "nearest") for _, k in calls)


def _refused(match, *args, **kw):
    with pytest.raises(ValueError, match=f"binning kernel: .*{match}"):
        binning_cuda.check_inputs(*args, **kw)


def test_check_inputs_refuses_what_the_kernels_do_not_take():
    bbox = torch.zeros(10, 4)
    valid = torch.ones(10, dtype=torch.bool)
    args = (64, 96, 16, 32, 8)
    binning_cuda.check_inputs(bbox, valid, *args)
    binning_cuda.check_inputs(bbox, valid, *args, keep_score=torch.zeros(10),
                              coarse_tiles=(4, 2), coarse_cap=16)
    _refused("bbox", bbox.double(), valid, *args)
    _refused("bbox", torch.zeros(10, 3), valid, *args)
    _refused("bbox", torch.zeros(4, 10).t(), valid, *args)
    _refused("bbox", torch.zeros(40), valid, *args)
    _refused("valid", bbox, valid.to(torch.uint8), *args)
    _refused("valid", bbox, torch.ones(11, dtype=torch.bool), *args)
    _refused("valid", bbox, torch.ones(20, dtype=torch.bool)[::2], *args)
    _refused("valid", bbox, valid.to("meta"), *args)
    _refused("unsupported device", bbox.to("meta"), valid.to("meta"), *args)
    _refused("keep_score", bbox, valid, *args,
             keep_score=torch.zeros(10, dtype=torch.float64))
    _refused("keep_score", bbox, valid, *args, keep_score=torch.zeros(9))
    _refused("height", bbox, valid, 0, 96, 16, 32, 8)
    _refused("tile_w", bbox, valid, 64, 96, 16, 32.0, 8)
    _refused("max_per_tile", bbox, valid, 64, 96, 16, 32, True)
    _refused("y0", bbox, valid, *args, y0=1.5)
    _refused("coarse_tiles", bbox, valid, *args, coarse_tiles=(4,),
             coarse_cap=16)
    _refused("coarse_tiles", bbox, valid, *args, coarse_tiles=(0, 2),
             coarse_cap=16)
    _refused("coarse_cap", bbox, valid, *args, coarse_tiles=(4, 2),
             coarse_cap=0)
    _refused("no triangles", torch.zeros(0, 4),
             torch.ones(0, dtype=torch.bool), *args)
    _refused("32-bit", bbox, valid, 64, 96, 16, 32, 2**30)
    with pytest.raises(ValueError, match="binning kernel: unsupported device"):
        binning_cuda.launcher(bbox, valid, *args)


def test_check_inputs_refuses_a_dense_grid_past_16_bits():
    """The kernels keep a dense-level tile range in 16 bits a bound."""
    bbox = torch.zeros(10, 4)
    valid = torch.ones(10, dtype=torch.bool)
    side = binning_cuda.MAX_GRID_SIDE
    binning_cuda.check_inputs(bbox, valid, 8, side, 8, 1, 4)
    _refused("dense grid", bbox, valid, 8, side + 1, 8, 1, 4)
    _refused("dense grid", bbox, valid, side + 1, 8, 1, 8, 4)
    # The two-level binner's fine grid may be wider; its coarse one not.
    binning_cuda.check_inputs(bbox, valid, 8, side + 1, 8, 1, 4,
                              coarse_tiles=(1, 2), coarse_cap=4)
    _refused("dense grid", bbox, valid, 8, 2 * side + 2, 8, 1, 4,
             coarse_tiles=(1, 2), coarse_cap=4)


def test_chunk_halves_to_fill_the_card():
    """256 items a chunk, halved down to 64 while a level has fewer chunks
    than two blocks an SM (264 on a 132-SM card)."""
    assert binning_cuda.chunk_size(1, 1_002_528, 264) == 256
    assert binning_cuda.chunk_size(72, 65536, 264) == 256
    assert binning_cuda.chunk_size(1, 16384, 264) == 64
    assert binning_cuda.chunk_size(1, 40000, 264) == 128
    assert binning_cuda.chunk_size(1, 10, 264) == 64
    assert binning_cuda.chunk_size(6, 600, 264) == 64


def _bits(x):
    return np.array([x], np.uint32).view(np.float32)[0]


def _odd_scores(t, seed, denormals=True):
    """Seeded scores of few distinct values (ties) with +-0.0, NaNs of
    either sign and +-inf among them, and the smallest denormals."""
    rng = np.random.default_rng(seed)
    score = rng.integers(-3, 4, t).astype(np.float32) * np.float32(0.5)
    special = [0.0, -0.0, np.inf, -np.inf, np.nan, _bits(0xFFC00000),
               _bits(0x7F800001), _bits(0xFFFFFFFF)]
    if denormals:
        special += [np.float32(1e-45), -np.float32(1e-45)]
    special = np.array(special, np.float32)
    pick = rng.random(t) < 0.3
    score[pick] = special[rng.integers(0, len(special), int(pick.sum()))]
    return score


def _keep_key(score):
    """csrc/binning.cu's "nearest" key of each triangle, as its source
    note states it: the high word NaN -> 0xFFFFFFFF, +-0.0 -> 0x80000000,
    else ~u with the sign set and u | 0x80000000 without (u the score's
    bits); the low word ~id. uint64."""
    u = score.view(np.uint32).astype(np.uint64)
    hi = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    hi = np.where(score == 0, 0x80000000, hi)
    hi = np.where(np.isnan(score), 0xFFFFFFFF, hi)
    ids = np.arange(len(score), dtype=np.uint64)
    return (hi << np.uint64(32)) | (~ids & np.uint64(0xFFFFFFFF))


def _rank_of_keys(key):
    rank = np.empty(len(key), np.int64)
    rank[np.argsort(key, kind="stable")] = np.arange(len(key))
    return rank


@pytest.mark.parametrize("t,seed", [(7, 0), (300, 1), (5000, 2),
                                    (40000, 3)])
def test_keep_key_orders_as_keep_rank(t, seed):
    """The kernels' 64-bit key sorts the triangles as ops/binning.py's
    _keep_rank ranks them (a stable argsort: ties to the lower id, -0.0
    equal to +0.0, every NaN above +inf), so "nearest" needs no sort."""
    score = _odd_scores(t, seed)
    key = _keep_key(score)
    assert len(np.unique(key)) == t
    rank = binning._keep_rank(torch.from_numpy(score))[0].numpy()
    np.testing.assert_array_equal(_rank_of_keys(key), rank)


@pytest.mark.parametrize("t,seed", [(300, 1), (40000, 3)])
def test_keep_rank_of_odd_scores_matches_reference(t, seed):
    """With +-0.0, NaNs of either sign and +-inf among the scores, the
    port's _keep_rank ranks as ash_tpu's lexsort on JAX's CPU backend (no
    denormals: XLA's CPU backend flushes them to zero, PyTorch does not)."""
    import jax.numpy as jnp
    from ash_tpu.ops import binning as ref_binning

    score = _odd_scores(t, seed, denormals=False)
    rank, order = binning._keep_rank(torch.from_numpy(score))
    want_rank, want_order = ref_binning._keep_rank(jnp.asarray(score))
    np.testing.assert_array_equal(rank.numpy(), np.asarray(want_rank))
    np.testing.assert_array_equal(order.numpy(), np.asarray(want_order))


def test_cost_analysis_observes_the_entry():
    with cost_analysis.FrameCost() as cost:
        assert cost._kernel_launch in binning_cuda.observers
    assert cost._kernel_launch not in binning_cuda.observers


# -- on the card -----------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _kernel_matches_plain(fn, plain, *args, what="", **kw):
    """The entry (counted, never through the plain binner) against the
    plain binner on the same CUDA tensors."""
    kind = "two_level" if fn is binning_cuda.bin_triangles_two_level \
        else "dense"
    want = plain(*args, **kw)
    before = binning_cuda.launches[kind]
    real = (binning.bin_triangles, binning.bin_triangles_two_level)
    try:
        binning.bin_triangles = binning.bin_triangles_two_level = None
        got = fn(*args, **kw)
    finally:
        binning.bin_triangles, binning.bin_triangles_two_level = real
    torch.cuda.synchronize()
    assert binning_cuda.launches[kind] == before + 1
    _assert_same(got, want, what)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_kernels_match_plain(case, policy):
    _need_card()
    bbox, valid, score, args, kw = CASES[case]
    two = "coarse_tiles" in kw
    keep = (torch.from_numpy(score).cuda() if policy == "nearest" else None)
    got = _kernel_matches_plain(
        _entry(two), _plain(two), torch.from_numpy(bbox).cuda(),
        torch.from_numpy(valid).cuda(), *args, **kw, keep_score=keep,
        what=f"{case} {policy}")
    _assert_contract(got, case)


@pytest.mark.cuda
def test_cuda_division_by_a_host_int_is_the_reciprocal_product():
    """floor(y / 48) on the card is floor(y * f32(1 / 48)): at 48k - ulp the
    product rounds up to k, which the quotient does not reach; the kernels
    code the product."""
    _need_card()
    y = torch.tensor([239.99998, 431.99997, 479.99997, 240.0],
                     dtype=torch.float32)
    rcp = np.float32(1.0) / np.float32(48)
    got = torch.floor(y.cuda() / 48).cpu()
    want = torch.floor(y * float(rcp))
    assert torch.equal(got, want)
    assert torch.equal(got, torch.tensor([5.0, 9.0, 10.0, 5.0]))
    assert not torch.equal(got, torch.floor(y.double() / 48).float())


@pytest.mark.cuda
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("caps", [(32768, 65536, 0), (8192, 16384, 200_000)])
def test_cuda_mega_frame_sizes(policy, caps):
    """The 1080p frame's two-level binning at 32x128 tiles: at the escalated
    caps nothing drops; at the base caps with a crowded corner both levels
    overflow, many scores tied."""
    import chip_smoke

    _need_card()
    cap, coarse_cap, crowd = caps
    bbox, valid, score = chip_smoke.mega_binning_boxes(11, crowd)
    keep = score if policy == "nearest" else None
    got = _kernel_matches_plain(
        binning_cuda.bin_triangles_two_level, binning.bin_triangles_two_level,
        bbox, valid, 1080, 1920, 32, 128, cap, coarse_tiles=(4, 2),
        coarse_cap=coarse_cap, keep_score=keep, what=f"mega {caps} {policy}")
    if crowd:
        assert int(got.overflow) > 0
    else:
        assert int(got.overflow) == 0
    # The dense binner at the 2048^2 shadow pass's tiles, on the same boxes.
    _kernel_matches_plain(
        binning_cuda.bin_triangles, binning.bin_triangles, bbox, valid, 1080,
        1920, 64, 128, 256, keep_score=keep, what=f"mega dense {policy}")


@pytest.mark.cuda
@pytest.mark.parametrize("two", [False, True])
def test_cuda_graph_replay_equals_eager(two):
    """Captured in a CUDAGraph (no host sync, every buffer sized on the
    host) and replayed on new boxes written in place: equal to the eager
    call on those boxes."""
    _need_card()
    bbox, valid, score, args, kw = CASES["random cap 16 coarse 100 y0=16"]
    if not two:
        kw = dict(y0=kw["y0"])
    fn = _entry(two)
    b = torch.from_numpy(bbox).cuda()
    v = torch.from_numpy(valid).cuda()
    s = torch.from_numpy(score).cuda()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(b, v, *args, **kw, keep_score=s)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(b, v, *args, **kw, keep_score=s)
    rng = np.random.default_rng(9)
    for _ in range(3):
        nb, nv = _boxes(len(bbox), 300, 100, int(rng.integers(1 << 30)),
                        spread=(30, 24))
        b.copy_(torch.from_numpy(nb))
        v.copy_(torch.from_numpy(nv))
        s.copy_(torch.from_numpy(_ties(len(bbox), int(rng.integers(99)))))
        graph.replay()
        _assert_same(out, _plain(two)(b, v, *args, **kw, keep_score=s),
                     f"replay two-level={two}")


@pytest.mark.cuda
def test_cuda_frame_calls_go_through_the_kernels():
    """A small two-level "nearest" frame and a standard one on the card:
    every binner call launches the kernels, none runs the plain binner."""
    _need_card()
    real = (binning.bin_triangles, binning.bin_triangles_two_level)
    for kw, kind in ((dict(), "dense"),
                     (dict(two_level_binning=True,
                           binning_policy="nearest"), "two_level")):
        r, _, cam, _ = bench_scene.build_bench_renderer(192, 128, 64, "cuda",
                                                        **kw)
        r.set_cuda_graphs(False)
        before = binning_cuda.launches[kind]
        try:
            binning.bin_triangles = binning.bin_triangles_two_level = None
            out = r.render_frame(cam.view_matrix(), cam.projection_matrix(),
                                 cam.position)
        finally:
            binning.bin_triangles, binning.bin_triangles_two_level = real
        torch.cuda.synchronize()
        assert binning_cuda.launches[kind] - before == 2  # main and shadow
        assert int(out.covered_pixels) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("t", [300, 5000, 1_002_528])
def test_cuda_keep_key_orders_as_argsort_on_the_card(t):
    """_keep_rank on the card (PyTorch's stable argsort there) ranks the
    odd scores (+-0.0, NaNs of either sign, +-inf, ties) as the kernels'
    key orders them."""
    _need_card()
    score = _odd_scores(t, 5)
    rank = binning._keep_rank(torch.from_numpy(score).cuda())[0].cpu()
    np.testing.assert_array_equal(_rank_of_keys(_keep_key(score)),
                                  rank.numpy())


def _coarse_counts_case(counts, filler):
    """Boxes inside coarse tiles of 4x2 fine tiles of 16x32 (64x64 pixels)
    in a 3 x 3 grid (192x192): coarse tile g holds counts[g] of them, then
    `filler` invalid triangles."""
    rng = np.random.default_rng(len(counts) + filler)
    rows = []
    for g, n in enumerate(counts):
        x, y = (g % 3) * 64, (g // 3) * 64
        x0 = x + rng.random(n) * 50
        y0 = y + rng.random(n) * 50
        rows.append(np.stack([x0, y0, x0 + rng.random(n) * 12,
                              y0 + rng.random(n) * 12], 1))
    bbox = np.concatenate(rows + [np.zeros((filler, 4))]).astype(np.float32)
    valid = np.arange(len(bbox)) < len(bbox) - filler
    return bbox, valid


@pytest.mark.cuda
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("cap,coarse_cap,filler", [
    (600, 8000, 6526),  # 256 items a chunk: kc = 8000
    (600, 1000, 0),     # 64 items a chunk: kc = 1474
    (100, 8000, 6526),  # the fine tiles overflow
    (100, 256, 0),      # both levels overflow
])
def test_cuda_coarse_counts_at_chunk_edges(policy, cap, coarse_cap, filler):
    """Coarse lists of 0, 1, 63, 64, 65, 255, 256, 257 and 513 candidates:
    the fine blocks past a list's count return at once and its select
    block scans only its own chunks."""
    _need_card()
    counts = (0, 1, 63, 64, 65, 255, 256, 257, 513)
    bbox, valid = _coarse_counts_case(counts, filler)
    keep = (torch.from_numpy(_odd_scores(len(bbox), 6)).cuda()
            if policy == "nearest" else None)
    b, v = torch.from_numpy(bbox).cuda(), torch.from_numpy(valid).cuda()
    coarse = binning.bin_triangles(b, v, 192, 192, 64, 64, min(coarse_cap,
                                                               len(bbox)),
                                   keep_score=keep)
    assert sorted(coarse.counts.tolist()) == sorted(
        min(n, coarse_cap) for n in counts)
    _kernel_matches_plain(
        binning_cuda.bin_triangles_two_level, binning.bin_triangles_two_level,
        b, v, 192, 192, 16, 32, cap, coarse_tiles=(4, 2),
        coarse_cap=coarse_cap, keep_score=keep,
        what=f"coarse counts {cap} {coarse_cap} {policy}")


@pytest.mark.cuda
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("cap", [1, 3, 7, 13, 257])
def test_cuda_rows_of_any_length(policy, cap):
    """K not a multiple of 4: the padding's 16-byte stores start at each
    row's own boundary and end in a scalar tail; dense and two levels."""
    _need_card()
    bbox, valid, score, args, kw = CASES["random cap 16 coarse 100 y0=0"]
    keep = (torch.from_numpy(score).cuda() if policy == "nearest" else None)
    b, v = torch.from_numpy(bbox).cuda(), torch.from_numpy(valid).cuda()
    dims = args[:4]
    _kernel_matches_plain(binning_cuda.bin_triangles, binning.bin_triangles,
                          b, v, *dims, cap, keep_score=keep,
                          what=f"dense K={cap} {policy}")
    _kernel_matches_plain(
        binning_cuda.bin_triangles_two_level, binning.bin_triangles_two_level,
        b, v, *dims, cap, coarse_tiles=(4, 2), coarse_cap=301,
        keep_score=keep, what=f"two-level K={cap} {policy}")


def _standard_boxes(seed, t=16384, live=12000):
    """A 1000-cube frame's setup at 1920x1080 as the dense binner sees it:
    `live` small boxes (cube faces), some crossing the screen's edges, then
    padding triangles that are invalid."""
    rng = np.random.default_rng(seed)
    x0 = rng.random(t) * 2000 - 40
    y0 = rng.random(t) * 1160 - 40
    size = rng.exponential(25.0, (t, 2))
    bbox = np.stack([x0, y0, x0 + size[:, 0], y0 + size[:, 1]], 1)
    valid = (np.arange(t) < live) & (rng.random(t) > 0.05)
    return bbox.astype(np.float32), valid


@pytest.mark.cuda
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("cap", [256, 8])
def test_cuda_dense_16384_at_standard_tiles(policy, cap):
    """16,384 padded triangles at the standard frame's 64x128 tiles (255
    tiles), in chunks of 64: array for array, with and without drops."""
    _need_card()
    bbox, valid = _standard_boxes(13)
    keep = (torch.from_numpy(_odd_scores(len(bbox), 7)).cuda()
            if policy == "nearest" else None)
    got = _kernel_matches_plain(
        binning_cuda.bin_triangles, binning.bin_triangles,
        torch.from_numpy(bbox).cuda(), torch.from_numpy(valid).cuda(), 1080,
        1920, 64, 128, cap, keep_score=keep, what=f"standard {cap} {policy}")
    assert (int(got.overflow) > 0) == (cap == 8)


@pytest.mark.cuda
@pytest.mark.parametrize("two", [False, True])
def test_cuda_nearest_odd_scores_overflow(two):
    """"nearest" with +-0.0, NaNs of either sign, +-inf and ties, where the
    tiles overflow (both levels of the two-level binner): the radix select
    over the 64-bit key keeps what the plain binner's argsort keeps."""
    _need_card()
    bbox, valid, _, args, kw = CASES["random cap 16 coarse 100 y0=0"]
    if not two:
        kw = dict(y0=kw["y0"])
    b, v = torch.from_numpy(bbox).cuda(), torch.from_numpy(valid).cuda()
    for seed in range(3):
        keep = torch.from_numpy(_odd_scores(len(bbox), 10 + seed)).cuda()
        got = _kernel_matches_plain(
            _entry(two), _plain(two), b, v, *args, **kw, keep_score=keep,
            what=f"odd scores two-level={two} seed {seed}")
        assert int(got.overflow) > 0
    if two:
        coarse = binning.bin_triangles(b, v, 128, 320, 32, 64, 100)
        assert int(coarse.overflow) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("two", [False, True])
def test_cuda_graph_replay_with_odd_scores(two):
    """The entry captured in a CUDAGraph at 16,384 triangles (dense, or two
    levels over coarse tiles of 4x2 fine tiles) and replayed on new boxes
    and odd scores written in place: equal to the eager call."""
    _need_card()
    bbox, valid = _standard_boxes(21)
    kw = dict(coarse_tiles=(4, 2), coarse_cap=4096) if two else {}
    args = (1080, 1920, 64, 128, 64)
    b = torch.from_numpy(bbox).cuda()
    v = torch.from_numpy(valid).cuda()
    s = torch.from_numpy(_odd_scores(len(bbox), 8)).cuda()
    fn = _entry(two)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(b, v, *args, **kw, keep_score=s)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(b, v, *args, **kw, keep_score=s)
    for seed in range(3):
        nb, nv = _standard_boxes(30 + seed)
        b.copy_(torch.from_numpy(nb))
        v.copy_(torch.from_numpy(nv))
        s.copy_(torch.from_numpy(_odd_scores(len(bbox), 40 + seed)))
        graph.replay()
        _assert_same(out, _plain(two)(b, v, *args, **kw, keep_score=s),
                     f"replay two-level={two} seed {seed}")


def _device_kernels(fn, tries=3, want=None):
    """The CUDA kernel names torch.profiler records for one fn() (warmed
    up), taken again up to `tries` times until `want(names)` holds (a
    trace of a short call can lose records)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if want is None or want(names):
            break
    return names


@pytest.mark.cuda
def test_cuda_nearest_entry_launches_no_sort():
    """The mega main call's entry with "nearest" (1,002,528 triangles,
    32x128 tiles, caps 32768 / 65536) launches the three binning kernels a
    level and no sort: the kernels rank by the key. The plain binner's
    trace of the same call shows its argsort, so the trace would."""
    import re

    import chip_smoke

    _need_card()
    bbox, valid, score = chip_smoke.mega_binning_boxes(11, 0)
    args = (bbox, valid, 1080, 1920, 32, 128, 32768)
    kw = dict(coarse_tiles=(4, 2), coarse_cap=65536, keep_score=score)

    def sorts(names):
        return [n for n in names if re.search("sort", n, re.I)]

    plain = _device_kernels(
        lambda: binning.bin_triangles_two_level(*args, **kw), want=sorts)
    assert sorts(plain)
    names = _device_kernels(
        lambda: binning_cuda.bin_triangles_two_level(*args, **kw),
        want=lambda n: sum("bin_" in k for k in n) == 6)
    assert sum("bin_" in k for k in names) == 6, names
    assert not sorts(names), sorts(names)
