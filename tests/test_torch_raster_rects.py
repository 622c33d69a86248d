"""The raster kernels' per-warp candidate rejection, checked in plain torch.

The CUDA kernels skip, per warp, every candidate whose conservative pixel
rectangle (ops/raster.py:candidate_rects) misses the warp's 8x16 pixels.
That is exact only if the rectangle holds every pixel the triangle covers.
Here:

- `candidate_rects` equals a brute-force numpy version (every pixel centre
  tested against the triangle's rect_bounds box);
- conservativeness: no pixel that the plain raster covers with triangle t,
  in any peel layer, with or without a depth floor, lies outside t's
  rectangle, on every raster of the golden scenes, the small bench and
  small glass scenes, and seeded random triangles (slivers, off-screen,
  near-plane crossers, perspective-stretched, both cull modes);
- the rejection emulated in plain torch (`warp_bins`: the plain raster fed
  each warp rectangle's list with the rejected candidates removed) equals
  the plain raster bit for bit;
- on a card (tests marked cuda), the kernels' own rectangles equal
  `candidate_rects` bit for bit, and the kernels equal the plain raster on
  the small scenes with 16x32 tiles and on the random triangles.
"""

import numpy as np
import pytest
import torch

import ash_tpu_torch.core as core
from ash_tpu_torch.ops import binning, geometry, raster, raster_cuda
from ash_tpu_torch.render import bench_scene, frame, golden_scenes

torch.set_num_threads(1)

W, H, TH, TW = 96, 64, 16, 32


# -- scenes: (setup, bins) built with the port alone -----------------------

def _setup_from_clip(clip, cull="back", height=H, width=W):
    t = clip.shape[0] // 3
    return geometry.triangle_setup(
        torch.from_numpy(clip), torch.arange(3 * t, dtype=torch.int32)
        .reshape(t, 3), torch.ones(t, dtype=torch.bool), width, height,
        cull_mode=cull,
    )


def _mesh_setup(name, cull="back", seed=3):
    """Panes or cubes under a perspective camera, like the peel tests."""
    rng = np.random.default_rng(seed)
    if name == "panes":
        mesh = core.Mesh.create_plane("pane", size=1.2)
        n = 6
        models = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        for i in range(n):
            a = rng.uniform(-0.15, 0.15)
            c, s = np.cos(a), np.sin(a)
            models[i, :3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
            models[i, :3, 3] = [rng.uniform(-0.4, 0.4), 1.5 - 0.4 * i,
                                rng.uniform(-0.4, 0.4)]
        eye = (0.3, 5.0, 0.6)
    else:
        mesh = core.Mesh.create_cube()
        n = 8
        models = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        models[:, :3, 3] = rng.uniform(-1.5, 1.5, (n, 3))
        eye = (3.0, 2.0, 4.0)
    cam = core.Camera.new(np.asarray(eye, np.float32), [0, 0, 0], W / H)
    vp = torch.from_numpy(cam.projection_matrix() @ cam.view_matrix())
    pos = mesh.vertices.position
    world = np.einsum("nij,vj->nvi", models[:, :3, :3], pos) + models[:, None,
                                                                      :3, 3]
    world = torch.from_numpy(world.reshape(-1, 3).astype(np.float32))
    clip = geometry.transform_points(vp, world)
    tri = (mesh.triangle_indices[None]
           + pos.shape[0] * np.arange(n)[:, None, None]).reshape(-1, 3)
    return geometry.triangle_setup(
        clip, torch.from_numpy(tri.astype(np.int32)),
        torch.ones(tri.shape[0], dtype=torch.bool), W, H, cull_mode=cull)


def _random_clip(kind, rng, t=60):
    """(3t, 4) f32 clip-space vertices of t random triangles."""
    w = rng.uniform(0.5, 4.0, (t, 3))
    xy = rng.uniform(-1.2, 1.2, (t, 3, 2)) * w[..., None]
    if kind == "slivers":  # third vertex almost on the first edge
        u = rng.uniform(0.0, 1.0, (t, 1))
        xy[:, 2] = xy[:, 0] + u * (xy[:, 1] - xy[:, 0]) + rng.normal(
            0, 1e-3, (t, 2))
        w[:, 2] = w[:, 0] + u[:, 0] * (w[:, 1] - w[:, 0])
    elif kind == "offscreen":  # mostly beyond the frustum's sides
        xy = rng.uniform(-4.0, 4.0, (t, 3, 2)) * w[..., None]
    elif kind == "near_plane":  # vertices behind, on and near the eye
        w = rng.uniform(-1.0, 2.0, (t, 3))
        w[::4, 0] = 1e-6
        xy = rng.uniform(-1.5, 1.5, (t, 3, 2)) * np.abs(w)[..., None] + \
            rng.normal(0, 0.2, (t, 3, 2))
    elif kind == "perspective":  # one near vertex, two far (w ratio ~1e3)
        w[:, 0] = rng.uniform(2e-3, 1e-2, t)
        w[:, 1:] = rng.uniform(2.0, 8.0, (t, 2))
        xy = rng.uniform(-1.5, 1.5, (t, 3, 2)) * w[..., None]
    elif kind == "large":  # triangles much larger than the screen
        xy = rng.uniform(-40.0, 40.0, (t, 3, 2)) * w[..., None]
    elif kind == "grazing":
        # An on-screen edge just in front of the eye (w ~ 2e-4) and a far
        # third vertex (w ~ 30): the seam tolerance then admits pixels up
        # to ~13 px beyond the near edge, outside the bbox.
        ndc = np.stack([rng.uniform(-0.9, -0.1, t), rng.uniform(0.1, 0.9, t),
                        rng.uniform(-0.5, 0.5, t)], -1)
        y_near = rng.uniform(-0.6, 0.2, t)
        w[:, :2] = rng.uniform(1e-4, 3e-4, (t, 1))
        w[:, 2] = rng.uniform(10.0, 50.0, t)
        xy[..., 0] = ndc * w
        xy[:, :2, 1] = y_near[:, None] * w[:, :2]
        xy[:, 2, 1] = 0.95 * w[:, 2]
        flip = rng.random(t) < 0.5  # both windings, for both cull modes
        xy[flip] = xy[flip][:, [1, 0, 2]]
        w[flip] = w[flip][:, [1, 0, 2]]
    z = rng.uniform(0.0, 1.0, (t, 3)) * np.abs(w)
    clip = np.concatenate([xy, z[..., None], w[..., None]], axis=-1)
    return clip.reshape(-1, 4).astype(np.float32)


RANDOM_KINDS = ["slivers", "offscreen", "near_plane", "perspective", "large",
                "grazing", "uniform"]


def _bins(setup, height=H, width=W, th=TH, tw=TW, y0=0):
    t = setup.bbox.shape[0]
    return binning.bin_triangles(setup.bbox, setup.valid, height, width, th,
                                 tw, t, y0=y0)


# -- the checks ------------------------------------------------------------

def _assert_conservative(setup, vis, height, width, y0, what):
    """Every covered pixel of every layer lies in its triangle's rectangle.
    Returns the farthest a covered pixel centre lies outside its
    triangle's raw bbox (the margin's measured slack), in pixels."""
    rects = raster.candidate_rects(setup, height, width, y0)
    rows = torch.arange(height)[:, None].expand(height, width)
    cols = torch.arange(width)[None, :].expand(height, width)
    slack = 0.0
    for i in range(vis.num_layers):
        tid = vis.layer(i)[1]
        hit = tid >= 0
        if not bool(hit.any()):
            continue
        t = tid[hit].long()
        r, c = rows[hit], cols[hit]
        rc = rects[t]
        inside = (c >= rc[:, 0]) & (c <= rc[:, 2]) & (r >= rc[:, 1]) & (
            r <= rc[:, 3])
        assert bool(inside.all()), (
            f"{what}, layer {i}: {int((~inside).sum())} covered pixels "
            f"outside their rectangle")
        bb = setup.bbox[t].double()
        cx, cy = c.double() + 0.5, (r + y0).double() + 0.5
        out = torch.stack([bb[:, 0] - cx, cx - bb[:, 2], bb[:, 1] - cy,
                           cy - bb[:, 3]], -1).amax(-1)
        slack = max(slack, float(out.max()))
    return slack


def _assert_rejection_exact(setup, bins, height, width, th, tw, y0=0,
                            layers=1, floor=None):
    rects = raster.candidate_rects(setup, height, width, y0)
    wb = raster.warp_bins(bins, rects, height, width, th, tw)
    rh, rw = raster.WARP_RECT
    want = raster.rasterize(setup, bins, height, width, th, tw, y0,
                            layers=layers, depth_floor=floor)
    got = raster.rasterize(setup, wb, height, width, rh, rw, y0,
                           layers=layers, depth_floor=floor)
    for i in range(layers):
        assert torch.equal(got.layer(i)[1], want.layer(i)[1]), f"layer {i}"
        assert torch.equal(got.layer(i)[0], want.layer(i)[0]), f"layer {i}"
    return wb, want


# -- candidate_rects against brute force -----------------------------------

def _brute_rects(setup, height, width, y0):
    """Every pixel centre c + 0.5 of the band tested against the triangle's
    rect_bounds box (f64)."""
    box = raster.rect_bounds(setup, height, width, y0).numpy()
    out = np.tile(np.array([width, height, -1, -1], np.int32), (len(box), 1))
    cx = np.arange(width, dtype=np.float64) + 0.5
    cy = np.arange(y0, y0 + height, dtype=np.float64) + 0.5
    for t in range(len(box)):
        xs = np.nonzero((cx >= box[t, 0]) & (cx <= box[t, 2]))[0]
        ys = np.nonzero((cy >= box[t, 1]) & (cy <= box[t, 3]))[0]
        if len(xs) and len(ys):
            out[t] = [xs[0], ys[0], xs[-1], ys[-1]]
    return out


@pytest.mark.parametrize("band", [(0, H), (16, 32), (40, 24)])
@pytest.mark.parametrize("kind", ["uniform", "near_plane", "large"])
def test_candidate_rects_match_brute_force(kind, band):
    y0, rows = band
    setup = _setup_from_clip(_random_clip(kind, np.random.default_rng(1)),
                             cull="none")
    got = raster.candidate_rects(setup, rows, W, y0)
    assert got.dtype == torch.int32 and got.shape == (setup.bbox.shape[0], 4)
    np.testing.assert_array_equal(got.numpy(), _brute_rects(setup, rows, W,
                                                            y0))


def test_rect_bounds_tight_for_ordinary_triangles():
    """For cubes under a perspective camera the proven box is the vertices'
    bbox widened by thousandths of a pixel; a vertex behind the eye gives
    the whole band."""
    s = _mesh_setup("cubes8")
    box = raster.rect_bounds(s, H, W)[s.valid]
    bb = s.bbox[s.valid].double()
    assert bool((box[:, :2] <= bb[:, :2]).all())
    assert bool((box[:, 2:] >= bb[:, 2:]).all())
    assert float((box - bb).abs().max()) < 0.01
    near = _setup_from_clip(_random_clip("near_plane",
                                         np.random.default_rng(2)), "none")
    behind = (near.inv_w <= 0).any(-1)
    assert bool(behind.any())
    rects = raster.candidate_rects(near, H, W)[behind & near.valid]
    assert bool((rects == torch.tensor([0, 0, W - 1, H - 1],
                                       dtype=torch.int32)).all())


def test_rects_conservative_on_slivers_far_from_origin():
    """Slivers a hundredth of a pixel thin near (2000, 2000), rasterized in
    a 64-row band of a 2048^2 target. Their f32 edge rows describe a
    triangle whose vertices lie far from the divided ones, so the plain
    raster covers pixels well outside the setup's bbox, which a margin
    around the bbox misses; rect_bounds, built from the edge rows, holds
    them."""
    rng = np.random.default_rng(5)
    size, y0, rows, t = 2048, 1952, 64, 200
    w = rng.uniform(0.5, 4.0, (t, 1))
    p0 = rng.uniform([1800.0, 1960.0], [2040.0, 2010.0], (t, 2))
    d = rng.normal(0.0, 1.0, (t, 2))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    normal = d[:, ::-1] * [1.0, -1.0]
    p1 = p0 + d * rng.uniform(0.5, 30.0, (t, 1))
    p2 = p0 + d * rng.uniform(-2.0, 3.0, (t, 1)) + normal * rng.uniform(
        -0.02, 0.02, (t, 1))
    pix = np.stack([p0, p1, p2], 1)  # (t, 3, 2) framebuffer coordinates
    ndc = pix / (size / 2.0) - 1.0
    clip = np.concatenate([ndc * w[..., None], np.broadcast_to(
        0.5 * w[..., None], (t, 3, 1)), np.broadcast_to(w[..., None],
                                                         (t, 3, 1))], -1)
    setup = _setup_from_clip(clip.reshape(-1, 4).astype(np.float32), "none",
                             height=size, width=size)
    bins = _bins(setup, rows, size, y0=y0)
    vis = raster.rasterize(setup, bins, rows, size, TH, TW, y0, layers=2)
    assert int((vis.tri_id >= 0).sum()) > 0
    slack = _assert_conservative(setup, vis, rows, size, y0, "far slivers")
    _assert_rejection_exact(setup, bins, rows, size, TH, TW, y0, layers=2)
    assert slack > 2.0, slack


def _sliver_tips(width, height, perspective, seed, rows=64, t=400):
    """Slivers 0.006-0.06 px thin and 20-200 px long, each pointing along
    a pixel row of a band at the bottom of a width x height target, its
    tip 0.2-3 px short of a pixel centre -> (setup, y0, rows). At such a
    centre both long edge functions are nearly 0 while their terms are
    large, so their f32 rounding alone decides whether it is covered."""
    rng = np.random.default_rng(seed)
    y0 = height - rows
    yc = rng.integers(y0 + 2, y0 + rows - 2, t) + 0.5
    gap = rng.uniform(0.2, 3.0, t)
    xt = rng.integers(210, width - 4, t) + 0.5 - gap
    length = rng.uniform(20.0, 200.0, (t, 1))
    half = rng.uniform(0.003, 0.03, (t, 1))
    tip = np.stack([xt, yc], 1)
    base = tip - length * [1.0, 0.0]
    pix = np.stack([tip, base - half * [0.0, 1.0], base + half * [0.0, 1.0]],
                   1)
    ndc = pix / [width / 2.0, height / 2.0] - 1.0
    w = (rng.uniform(0.5, 4.0, (t, 1)) if perspective else np.ones((t, 1)))
    clip = np.concatenate([ndc * w[..., None], np.broadcast_to(
        0.5 * w[..., None], (t, 3, 1)), np.broadcast_to(w[..., None],
                                                         (t, 3, 1))], -1)
    setup = _setup_from_clip(clip.reshape(-1, 4).astype(np.float32), "none",
                             height=height, width=width)
    return setup, y0, rows


def _outside_rects(setup, vis, height, width, y0):
    rects = raster.candidate_rects(setup, height, width, y0)
    hit = vis.tri_id >= 0
    r, c = hit.nonzero(as_tuple=True)
    rc = rects[vis.tri_id[hit].long()]
    return int((~((c >= rc[:, 0]) & (c <= rc[:, 2]) & (r >= rc[:, 1])
                  & (r <= rc[:, 3]))).sum())


@pytest.mark.parametrize("width,height,perspective", [
    (512, 8192, False), (7680, 2160, True)])
def test_rects_rounding_term_decides_on_sliver_tips(monkeypatch, width,
                                                     height, perspective):
    """An input on which the f32 rounding term of `covers` (GAMMA3 in
    rect_bounds) decides the box: sliver tips far from the origin, in a
    512x8192 target and a 7680x2160 one (the SSAA size of A15) with
    perspective w. The plain raster covers pixel centres up to about 3 px
    beyond a tip through rounding alone; the box holds them, and the same
    box built with GAMMA3 = 0 leaves some outside."""
    setup, y0, rows = _sliver_tips(width, height, perspective, seed=1)
    bins = _bins(setup, rows, width, y0=y0)
    vis = raster.rasterize(setup, bins, rows, width, TH, TW, y0)
    assert int((vis.tri_id >= 0).sum()) > 10000
    _assert_conservative(setup, vis, rows, width, y0, "sliver tips")
    monkeypatch.setattr(raster, "GAMMA3", 0.0)
    missed = _outside_rects(setup, vis, rows, width, y0)
    print(f"measured sliver tips {width}x{height}: {missed} covered pixels "
          "outside the box built with GAMMA3 = 0")
    assert missed > 0


# -- conservativeness ------------------------------------------------------

@pytest.mark.parametrize("cull", ["back", "front"])
@pytest.mark.parametrize("kind", RANDOM_KINDS)
def test_rects_conservative_on_random_triangles(kind, cull):
    setup = _setup_from_clip(_random_clip(kind, np.random.default_rng(7)),
                             cull=cull)
    bins = _bins(setup)
    vis = raster.rasterize(setup, bins, H, W, TH, TW, layers=4)
    assert int((vis.tri_id >= 0).sum()) > 0
    slack = _assert_conservative(setup, vis, H, W, 0, f"{kind}/{cull}")
    _assert_rejection_exact(setup, bins, H, W, TH, TW, layers=4)
    if kind == "grazing":
        # The seam tolerance admits pixels more than 4 px outside the
        # bbox: the w-ratio term of rect_bounds keeps the rejection exact.
        assert slack > 4.0, slack


@pytest.mark.parametrize("layers,floor", [(1, False), (2, False),
                                          (2, True), (4, False), (4, True),
                                          (8, False), (8, True)])
@pytest.mark.parametrize("name", ["cubes8", "panes"])
def test_warp_rejection_is_exact(name, layers, floor):
    """The plain raster fed per-warp lists equals the plain raster, in every
    layer, with and without a floor, also in a y0 band."""
    setup = _mesh_setup(name)
    bins = _bins(setup)
    depth_floor = None
    if floor:
        depth_floor = raster.rasterize(setup, bins, H, W, TH, TW,
                                       layers=2).layer(1)[0]
    wb, want = _assert_rejection_exact(setup, bins, H, W, TH, TW,
                                       layers=layers, floor=depth_floor)
    _assert_conservative(setup, want, H, W, 0, name)
    # The warps test fewer candidates than the tiles hold.
    rh, rw = raster.WARP_RECT
    tile_pairs = int(bins.counts.sum()) * TH * TW
    assert 0 < int(wb.counts.sum()) * rh * rw < tile_pairs
    y0, rows = 16, 32
    band_bins = _bins(setup, rows, W, y0=y0)
    _assert_rejection_exact(setup, band_bins, rows, W, TH, TW, y0=y0,
                            layers=layers, floor=None if depth_floor is None
                            else depth_floor[y0:y0 + rows].contiguous())


def test_warp_bins_refuse_tiles_that_split_a_warp():
    setup = _mesh_setup("cubes8")
    rects = raster.candidate_rects(setup, H, W)
    bins = _bins(setup, th=12, tw=32)
    with pytest.raises(ValueError, match="warp rectangles"):
        raster.warp_bins(bins, rects, H, W, 12, 32)


@pytest.fixture
def checked_rasters(monkeypatch):
    """Wrap the frame's raster entry point: every raster a frame runs is
    checked for conservativeness (all its layers, its floor) and for the
    exactness of the per-warp rejection. Records (rows, layers, floor,
    slack) per call."""
    calls = []
    real = frame.rasterize

    def checking(setup, bins, height, width, tile_h, tile_w, y0=0,
                 layers=1, depth_floor=None):
        vis = real(setup, bins, height, width, tile_h, tile_w, y0,
                   layers=layers, depth_floor=depth_floor)
        slack = _assert_conservative(setup, vis, height, width, y0,
                                     f"{height}x{width} layers={layers}")
        _assert_rejection_exact(setup, bins, height, width, tile_h, tile_w,
                                y0, layers, depth_floor)
        calls.append((height, layers, depth_floor is not None, slack))
        return vis

    monkeypatch.setattr(frame, "rasterize", checking)
    return calls


@pytest.mark.parametrize("name", sorted(golden_scenes.SCENES))
def test_rects_conservative_on_golden_scenes(checked_rasters, name):
    golden_scenes.SCENES[name]("cpu")
    assert checked_rasters, "the scene ran no raster"
    assert max(c[3] for c in checked_rasters) < 1.0


@pytest.mark.parametrize("glass,passes", [(False, 1), (True, 1), (True, 2)])
def test_rects_conservative_on_small_bench(checked_rasters, glass, passes):
    """The small bench and small glass scenes (192x128, 64 cubes); two
    transparency passes rasterize the second under a depth floor."""
    kw = dict(glass=True, transparency_passes=passes) if glass else {}
    r, _, cam, _ = bench_scene.build_bench_renderer(192, 128, 64, "cpu", **kw)
    r.render_frame(cam.view_matrix(), cam.projection_matrix(), cam.position)
    floors = [c[2] for c in checked_rasters]
    assert floors.count(True) == passes - 1
    assert max(c[3] for c in checked_rasters) < 1.0


# -- on the card -----------------------------------------------------------

def _small_scene_inputs(glass):
    """(setup, bins, floor) of the small bench or glass scene's main pass at
    192x128 with 16x32 tiles, where the rectangles cut most candidates."""
    r, _, cam, _ = bench_scene.build_bench_renderer(192, 128, 64, "cuda",
                                                    glass=glass)
    cfg, scene, uni = r.prepare_frame(
        cam.view_matrix(), cam.projection_matrix(), cam.position)[:3]
    _, setup, _, _ = frame.main_pass_bins(cfg, scene.buffers, uni)
    bins = binning.bin_triangles(setup.bbox, setup.valid, 128, 192, 16, 32,
                                 cfg.max_tris_per_tile)
    return setup, bins


@pytest.mark.cuda
@pytest.mark.parametrize("layers", [1, 4])
@pytest.mark.parametrize("glass", [False, True])
def test_cuda_kernels_match_plain_on_small_scenes(glass, layers):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    setup, bins = _small_scene_inputs(glass)
    floor = None
    if layers > 1:
        floor = raster.rasterize(setup, bins, 128, 192, 16, 32,
                                 layers=2).layer(1)[0]
    for f in (None, floor) if layers > 1 else (None,):
        got = raster_cuda.rasterize(setup, bins, 128, 192, 16, 32,
                                    layers=layers, depth_floor=f)
        want = raster.rasterize(setup, bins, 128, 192, 16, 32, layers=layers,
                                depth_floor=f)
        torch.cuda.synchronize()
        for i in range(layers):
            assert torch.equal(got.layer(i)[1], want.layer(i)[1])
            assert torch.equal(got.layer(i)[0], want.layer(i)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("band", [(0, H), (16, 32)])
@pytest.mark.parametrize("kind", RANDOM_KINDS)
def test_cuda_rects_equal_candidate_rects(kind, band):
    """The kernels' rectangles (their device function) are candidate_rects'
    bit for bit, so the CPU tests of candidate_rects hold for the kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    y0, rows = band
    setup = _setup_from_clip(_random_clip(kind, np.random.default_rng(7)),
                             cull="none")
    want = raster.candidate_rects(setup, rows, W, y0)
    setup = geometry.TriangleSetup._make(t.cuda() for t in setup)
    got = raster_cuda.device_rects(setup, rows, W, y0)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, raster.candidate_rects(setup, rows, W, y0))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", RANDOM_KINDS)
def test_cuda_kernel_matches_plain_on_random_triangles(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    setup = _setup_from_clip(_random_clip(kind, np.random.default_rng(7)))
    setup = geometry.TriangleSetup._make(t.cuda() for t in setup)
    bins = _bins(setup)
    for layers in (1, 4):
        got = raster_cuda.rasterize(setup, bins, H, W, TH, TW, layers=layers)
        want = raster.rasterize(setup, bins, H, W, TH, TW, layers=layers)
        torch.cuda.synchronize()
        for i in range(layers):
            assert torch.equal(got.layer(i)[1], want.layer(i)[1])
            assert torch.equal(got.layer(i)[0], want.layer(i)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("width,height,perspective", [
    (512, 8192, False), (7680, 2160, True)])
def test_cuda_kernel_matches_plain_on_sliver_tips(width, height, perspective):
    """The kernel's rectangles and raster on the sliver tips whose covered
    pixels only the rounding term keeps in their box."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    setup, y0, rows = _sliver_tips(width, height, perspective, seed=1)
    setup = geometry.TriangleSetup._make(t.cuda() for t in setup)
    assert torch.equal(raster_cuda.device_rects(setup, rows, width, y0),
                       raster.candidate_rects(setup, rows, width, y0))
    bins = _bins(setup, rows, width, y0=y0)
    got = raster_cuda.rasterize(setup, bins, rows, width, TH, TW, y0)
    want = raster.rasterize(setup, bins, rows, width, TH, TW, y0)
    assert torch.equal(got.tri_id, want.tri_id)
    assert torch.equal(got.depth, want.depth)
