"""The K-layer depth peel: the port's plain version against the reference's
scan oracle (ash_tpu.ops.raster.rasterize(layers=K)) and its Pallas kernel
in interpret mode (rasterize_pallas(layers=K)), fed the reference's own
setup and bins, with and without a depth floor; and, on a card, the CUDA
kernel against the plain version.

Tolerances against the reference, per layer, as for one layer
(tests/test_torch_raster.py, ROADMAP.md C): depth atol 1e-5, because XLA on
the CPU contracts a*b + c into fused multiply-adds and the port rounds
every product; tri_id flips only where both sides hold a surface, and on at
most 0.5% of the pixels. The floor is the reference's own deepest layer,
fed to both sides.

Within the port everything is exact: layer 0 of the peel is the one-layer
raster, a band is the cropped full frame, and the CUDA kernel equals the
plain version bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ash_tpu.core.mesh import Mesh
from ash_tpu.core.transform import Camera
from ash_tpu.ops import binning as ref_bin
from ash_tpu.ops import geometry as ref_geo
from ash_tpu.ops import raster as ref_raster
from ash_tpu.ops.raster_pallas import rasterize_pallas
from ash_tpu_torch.ops import binning, geometry, raster, raster_cuda

torch.set_num_threads(1)

W, H, TH, TW = 96, 64, 16, 32
DEPTH_ATOL = 1e-5


def _models_panes(rng, n=6):
    """n panes stacked under a top-down camera, each shifted and slightly
    tilted, so the stack is deeper than the small K values."""
    models = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        a = rng.uniform(-0.15, 0.15)
        c, s = np.cos(a), np.sin(a)
        models[i, :3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]],
                                     np.float32)
        models[i, :3, 3] = [rng.uniform(-0.4, 0.4), 1.5 - 0.4 * i,
                            rng.uniform(-0.4, 0.4)]
    return models


def _models_cubes(rng, n=8):
    models = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    models[:, :3, 3] = rng.uniform(-1.5, 1.5, (n, 3))
    return models


SCENES = {
    # name: (mesh, models, camera position, camera target)
    "panes": (lambda: Mesh.create_plane("pane", size=1.2), _models_panes,
              (0.3, 5.0, 0.6), (0.0, 0.0, 0.0)),
    "cubes8": (Mesh.create_cube, _models_cubes, (3.0, 2.0, 4.0),
               (0.0, 0.0, 0.0)),
}


def _ref_scene(name, band=None):
    """The reference's (setup, bins) of a scene; band = (y0, rows)."""
    make_mesh, make_models, cam_pos, target = SCENES[name]
    mesh = make_mesh()
    models = make_models(np.random.default_rng(3))
    n, nv = len(models), mesh.vertices.position.shape[0]
    nt = mesh.triangle_indices.shape[0]
    cam = Camera.new(np.asarray(cam_pos, np.float32), target, W / H)
    vp = cam.projection_matrix() @ cam.view_matrix()
    tv = ref_geo.transform_vertices(
        jnp.asarray(models), jnp.asarray(vp),
        jnp.asarray(mesh.vertices.position), jnp.asarray(mesh.vertices.normal),
        jnp.asarray(mesh.vertices.tangent),
        jnp.repeat(jnp.arange(n, dtype=jnp.int32), nv),
        vert_uid=jnp.tile(jnp.arange(nv, dtype=jnp.int32), n),
    )
    tri_v = mesh.triangle_indices[None] + nv * np.arange(n)[:, None, None]
    setup = ref_geo.triangle_setup(
        tv.clip, jnp.asarray(tri_v.reshape(-1, 3)), jnp.ones(nt * n, bool), W, H
    )
    y0, rows = band or (0, H)
    bins = ref_bin.bin_triangles(setup.bbox, setup.valid, rows, W, TH, TW,
                                 16 * n, y0=y0)
    return setup, bins


def _port(setup, bins):
    conv = lambda nt: type(nt)._make(  # noqa: E731
        torch.from_numpy(np.array(x)) for x in nt
    )
    return (
        geometry.TriangleSetup._make(conv(setup)),
        binning.TileBins._make(conv(bins)),
    )


def _assert_layer_matches(got_tid, got_depth, ref_tid, ref_depth, what):
    got_tid, ref_tid = np.asarray(got_tid), np.asarray(ref_tid)
    np.testing.assert_allclose(np.asarray(got_depth), np.asarray(ref_depth),
                               atol=DEPTH_ATOL, rtol=0, err_msg=what)
    flips = got_tid != ref_tid
    assert flips.mean() <= 0.005, f"{what}: {flips.sum()} tri_id flips"
    assert (got_tid[flips] >= 0).all() and (ref_tid[flips] >= 0).all(), what


def _reference(kind):
    if kind == "pallas":
        return lambda *a, **kw: rasterize_pallas(*a, interpret=True, **kw)
    return ref_raster.rasterize


@pytest.mark.parametrize("kind", ["scan", "pallas"])
@pytest.mark.parametrize("floor", [None, "own", "shared"])
@pytest.mark.parametrize("layers", [2, 3, 4, 8])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_plain_layers_match_reference(name, layers, floor, kind):
    """`floor` is the deepest layer of a first 2-layer pass (so surfaces
    stay behind it at every K): None; "own", each side's own, as the
    iterated peel of a frame feeds it; or "shared", one tensor fed to both:
    the reference's, raised by DEPTH_ATOL. The raise keeps the surface that
    made the floor on one side of it for both: re-evaluated at z == floor by
    the reference, it lands a rounding step above the floor in the port on
    some of its pixels and would be kept there (ROADMAP.md C)."""
    setup, bins = _ref_scene(name)
    ps, pb = _port(setup, bins)
    ref_floor = got_floor = None
    if floor is not None:
        ref_floor, _ = ref_raster.rasterize(setup, bins, H, W, TH, TW,
                                            layers=2).layer(1)
    if floor == "own":
        got_floor, _ = raster.rasterize(ps, pb, H, W, TH, TW,
                                        layers=2).layer(1)
    elif floor == "shared":
        ref_floor = ref_floor + DEPTH_ATOL
        got_floor = torch.from_numpy(np.array(ref_floor))
    ref = _reference(kind)(setup, bins, H, W, TH, TW, layers=layers,
                           depth_floor=ref_floor)
    got = raster.rasterize(ps, pb, H, W, TH, TW, layers=layers,
                           depth_floor=got_floor)
    assert got.num_layers == ref.num_layers == layers
    for i in range(layers):
        (gd, gt), (rd, rt) = got.layer(i), ref.layer(i)
        _assert_layer_matches(gt, gd, rt, rd, f"layer {i}")
    # The peel found more than one surface somewhere, and with the floor
    # still finds surfaces behind it.
    assert (got.layer(0 if floor else 1)[1] >= 0).sum() > 50


@pytest.mark.parametrize("layers", [2, 4, 8])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_layer0_is_the_one_layer_raster(name, layers):
    s, b = _port(*_ref_scene(name))
    one = raster.rasterize(s, b, H, W, TH, TW)
    peel = raster.rasterize(s, b, H, W, TH, TW, layers=layers)
    assert torch.equal(peel.depth, one.depth)
    assert torch.equal(peel.tri_id, one.tri_id)
    # Layers are sorted nearest first; an empty layer stays cleared.
    for i in range(1, layers):
        (zn, tn), (zp, tp) = peel.layer(i), peel.layer(i - 1)
        assert bool((zn >= zp).all())
        assert bool(((tn < 0) | (tp >= 0)).all())
        assert bool((zn[tn < 0] == 1.0).all())


@pytest.mark.parametrize("with_floor", [False, True])
def test_band_is_the_cropped_full_frame(with_floor):
    """A K=4 y0 band equals the same rows of the full frame, exactly."""
    name, layers = "cubes8", 4
    full_s, full_b = _port(*_ref_scene(name))
    full_floor = None
    if with_floor:
        full_floor = raster.rasterize(full_s, full_b, H, W, TH, TW,
                                      layers=2).layer(1)[0]
    full = raster.rasterize(full_s, full_b, H, W, TH, TW, layers=layers,
                            depth_floor=full_floor)
    y0, rows = 16, 32
    s, b = _port(*_ref_scene(name, band=(y0, rows)))
    band = raster.rasterize(
        s, b, rows, W, TH, TW, y0=y0, layers=layers,
        depth_floor=None if full_floor is None
        else full_floor[y0:y0 + rows].contiguous(),
    )
    for i in range(layers):
        assert torch.equal(band.layer(i)[0], full.layer(i)[0][y0:y0 + rows])
        assert torch.equal(band.layer(i)[1], full.layer(i)[1][y0:y0 + rows])


def test_depth_floor_needs_layers():
    s, b = _port(*_ref_scene("panes"))
    floor = torch.zeros(H, W)
    with pytest.raises(ValueError, match="layers >= 2"):
        raster.rasterize(s, b, H, W, TH, TW, depth_floor=floor)
    with pytest.raises(ValueError, match="layers >= 2"):
        raster_cuda.rasterize(s, b, H, W, TH, TW, depth_floor=floor)


@pytest.mark.parametrize("layers", [0, 9])
def test_wrapper_refuses_layer_counts_outside_the_kernel(layers):
    s, b = _port(*_ref_scene("panes"))
    with pytest.raises(ValueError, match="layers"):
        raster_cuda.rasterize(s, b, H, W, TH, TW, layers=layers)


def test_wrapper_on_cpu_runs_the_plain_peel_and_launches_nothing():
    s, b = _port(*_ref_scene("cubes8"))
    floor = raster.rasterize(s, b, H, W, TH, TW, layers=2).layer(1)[0]
    before = (raster_cuda.rasterize.launches,
              raster_cuda.rasterize.layer_launches)
    got = raster_cuda.rasterize(s, b, H, W, TH, TW, layers=3,
                                depth_floor=floor)
    want = raster.rasterize(s, b, H, W, TH, TW, layers=3, depth_floor=floor)
    assert (raster_cuda.rasterize.launches,
            raster_cuda.rasterize.layer_launches) == before
    for i in range(3):
        assert torch.equal(got.layer(i)[0], want.layer(i)[0])
        assert torch.equal(got.layer(i)[1], want.layer(i)[1])


def test_tile_image_matches_reference():
    img = np.random.default_rng(5).random((37, 70)).astype(np.float32)
    got = raster.tile_image(torch.from_numpy(img), 16, 32)
    want = ref_raster.tile_image(jnp.asarray(img), 16, 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = raster.untile(got, 37, 70, 16, 32)
    np.testing.assert_array_equal(back.numpy(), img)


def test_visibility_buffer_layers():
    d = torch.arange(5 * 2 * 3, dtype=torch.float32).reshape(5, 2, 3)
    t = d.to(torch.int32)
    vis = raster.VisibilityBuffer.from_layers(d, t)
    assert vis.num_layers == 5
    for i in range(5):
        assert torch.equal(vis.layer(i)[0], d[i])
        assert torch.equal(vis.layer(i)[1], t[i])
    one = raster.VisibilityBuffer.from_layers(d[:1], t[:1])
    assert one.num_layers == 1 and one.depth2 is None and one.depth_rest is None
    two = raster.VisibilityBuffer.from_layers(d[:2], t[:2])
    assert two.num_layers == 2 and two.depth_rest is None


@pytest.mark.cuda
@pytest.mark.parametrize("with_floor", [False, True])
@pytest.mark.parametrize("layers", [2, 4, 8])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_cuda_layer_kernel_matches_plain(name, layers, with_floor):
    """The K-layer kernel and the plain peel on the same CUDA tensors:
    bit-equal in every layer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    s, b = _port(*_ref_scene(name))
    s = geometry.TriangleSetup._make(t.cuda() for t in s)
    b = binning.TileBins._make(t.cuda() for t in b)
    floor = None
    if with_floor:
        floor = raster.rasterize(s, b, H, W, TH, TW, layers=2).layer(1)[0]
    before = raster_cuda.rasterize.layer_launches
    got = raster_cuda.rasterize(s, b, H, W, TH, TW, layers=layers,
                                depth_floor=floor)
    torch.cuda.synchronize()
    assert raster_cuda.rasterize.layer_launches == before + 1
    want = raster.rasterize(s, b, H, W, TH, TW, layers=layers,
                            depth_floor=floor)
    for i in range(layers):
        assert torch.equal(got.layer(i)[1], want.layer(i)[1])
        assert torch.equal(got.layer(i)[0], want.layer(i)[0])
