"""Shading: ash_tpu_torch.ops.shade and ops.shadow against ash_tpu, each
stage fed the reference's own inputs (its visibility buffer, setup, vertex
stage and G-buffer), so differences do not compound.

Tolerance atol 1e-5 (colour in [0, 1], world positions of a few units):
f32 transcendentals, divisions and XLA's fused multiply-adds differ from
PyTorch's in the last bits.
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
from ash_tpu.ops import shade as ref_shade
from ash_tpu.ops import shadow as ref_shadow
from ash_tpu.render.shadow_map import directional_light_matrix
from ash_tpu_torch.ops import geometry, shade, shadow

torch.set_num_threads(1)

ATOL = 1e-5
W, H = 96, 64
N = 8


def _t(a):
    return torch.from_numpy(np.array(a))


def _nt(cls, nt):
    return cls._make(_t(x) for x in nt)


@pytest.fixture(scope="module")
def ref_frame():
    """The reference's vertex stage, setup and visibility buffer of 8
    cubes, plus packed materials and shading uniforms."""
    rng = np.random.default_rng(21)
    cube = Mesh.create_cube()
    models = np.tile(np.eye(4, dtype=np.float32), (N, 1, 1))
    models[:, :3, 3] = rng.uniform(-1.5, 1.5, (N, 3))
    models[:, :3, :3] *= rng.uniform(0.5, 1.0, (N, 1, 1)).astype(np.float32)
    cam = Camera.new([3.0, 2.0, 4.0], [0, 0, 0], W / H)
    vp = (cam.projection_matrix() @ cam.view_matrix()).astype(np.float32)
    vert_uid = np.tile(np.arange(24, dtype=np.int32), N)
    tv = ref_geo.transform_vertices(
        jnp.asarray(models), jnp.asarray(vp),
        jnp.asarray(cube.vertices.position), jnp.asarray(cube.vertices.normal),
        jnp.asarray(cube.vertices.tangent),
        jnp.repeat(jnp.arange(N, dtype=jnp.int32), 24),
        vert_uid=jnp.asarray(vert_uid),
    )
    tri_v = (cube.triangle_indices[None] + 24 * np.arange(N)[:, None, None])
    tri_v = tri_v.reshape(-1, 3).astype(np.int32)
    tri_draw = np.repeat(np.arange(N, dtype=np.int32), 12)
    setup = ref_geo.triangle_setup(
        tv.clip, jnp.asarray(tri_v), jnp.ones(12 * N, bool), W, H
    )
    bins = ref_bin.bin_triangles(setup.bbox, setup.valid, H, W, 16, 32, 128)
    vis = ref_raster.rasterize(setup, bins, H, W, 16, 32)
    mats = np.zeros((N, 18), np.float32)
    mats[:, 0:3] = rng.uniform(0.3, 1.0, (N, 3))
    mats[:, 3] = 1.0
    mats[:, 4:7] = rng.uniform(0.0, 0.2, (N, 3))
    mats[:, 8] = rng.random(N)
    mats[:, 9] = rng.uniform(0.0, 1.0, N)
    mats[:, 10:12] = 1.0
    mats[:, 12:17] = -1.0
    lsm = directional_light_matrix([-0.5, -1.0, -0.3], [0, 0, 0], 4.0)
    uni = dict(
        camera_pos=np.asarray(cam.position, np.float32),
        light_direction=np.array([-0.35, -1.0, -0.25], np.float32)
        / np.linalg.norm([-0.35, -1.0, -0.25]),
        light_color=np.full(3, 1.5, np.float32),
        ambient_color=np.full(3, 0.35, np.float32),
        light_space_matrix=lsm,
    )
    smap = rng.uniform(0.3, 1.0, (64, 64)).astype(np.float32)
    return dict(tv=tv, setup=setup, vis=vis, tri_v=tri_v, tri_draw=tri_draw,
                vert_uid=vert_uid, uv=cube.vertices.uv,
                color=cube.vertices.color, mats=mats, uni=uni, smap=smap)


def _ref_gbuffer(f):
    return ref_shade.interpolate_gbuffer(
        f["vis"].tri_id, f["setup"], jnp.asarray(f["tri_v"]),
        jnp.asarray(f["tri_draw"]), f["tv"], jnp.asarray(f["uv"]),
        jnp.asarray(f["color"]), vert_uid=jnp.asarray(f["vert_uid"]),
    )


def _port_gbuffer(ref_g):
    return shade.GBuffer(*(
        None if getattr(ref_g, f) is None else _t(getattr(ref_g, f))
        for f in shade.GBuffer._fields
    ))


def _assert_gbuffers_match(got, ref):
    for field in shade.GBuffer._fields:
        if getattr(ref, field) is None:
            assert getattr(got, field) is None, field
            continue
        want = np.asarray(getattr(ref, field))
        have = getattr(got, field).numpy()
        if want.dtype == bool or want.dtype == np.int32:
            np.testing.assert_array_equal(have, want, err_msg=field)
        else:
            np.testing.assert_allclose(have, want, atol=ATOL, rtol=0,
                                       err_msg=field)


def test_interpolate_gbuffer_matches_reference(ref_frame):
    f = ref_frame
    ref = _ref_gbuffer(f)
    got = shade.interpolate_gbuffer(
        _t(f["vis"].tri_id), _nt(geometry.TriangleSetup, f["setup"]),
        _t(f["tri_v"]), _t(f["tri_draw"]),
        _nt(geometry.TransformedVerts, f["tv"]), _t(f["uv"]), _t(f["color"]),
        vert_uid=_t(f["vert_uid"]),
    )
    assert int(got.mask.sum()) > 500
    assert got.velocity is None
    _assert_gbuffers_match(got, ref)


def test_interpolate_gbuffer_velocity_matches_reference(ref_frame):
    """Motion vectors: last frame's clip positions come from a moved camera
    and one moved draw; the framebuffer size is that of a larger frame, as
    for a band."""
    f = ref_frame
    cube = Mesh.create_cube()
    rng = np.random.default_rng(22)
    prev_models = np.tile(np.eye(4, dtype=np.float32), (N, 1, 1))
    prev_models[:, :3, 3] = rng.uniform(-1.5, 1.5, (N, 3))
    prev_cam = Camera.new([2.8, 2.1, 4.2], [0.1, 0, 0], W / H)
    prev_vp = (prev_cam.projection_matrix()
               @ prev_cam.view_matrix()).astype(np.float32)
    pos = np.tile(cube.vertices.position, (N, 1))
    world = np.einsum("vij,vj->vi", np.repeat(prev_models, 24, 0)[:, :3, :3],
                      pos) + np.repeat(prev_models, 24, 0)[:, :3, 3]
    prev_clip = (np.concatenate([world, np.ones((24 * N, 1))], -1)
                 @ prev_vp.T).astype(np.float32)
    # A few vertices behind last frame's eye: their pixels get velocity 0
    # where the interpolated w is not positive.
    prev_clip[:24, 3] = -0.5
    ref = ref_shade.interpolate_gbuffer(
        f["vis"].tri_id, f["setup"], jnp.asarray(f["tri_v"]),
        jnp.asarray(f["tri_draw"]), f["tv"], jnp.asarray(f["uv"]),
        jnp.asarray(f["color"]), vert_uid=jnp.asarray(f["vert_uid"]),
        prev_clip=jnp.asarray(prev_clip), fb_height=H + 8, fb_width=W + 4,
    )
    got = shade.interpolate_gbuffer(
        _t(f["vis"].tri_id), _nt(geometry.TriangleSetup, f["setup"]),
        _t(f["tri_v"]), _t(f["tri_draw"]),
        _nt(geometry.TransformedVerts, f["tv"]), _t(f["uv"]), _t(f["color"]),
        vert_uid=_t(f["vert_uid"]), prev_clip=_t(prev_clip),
        fb_height=H + 8, fb_width=W + 4,
    )
    velocity = got.velocity.numpy()
    assert velocity.shape == (H, W, 2)
    assert float(np.abs(velocity).max()) > 0.01
    assert (velocity[~got.mask.numpy()] == 0).all()
    _assert_gbuffers_match(got, ref)


def _uniforms(cls, f):
    return cls(**{k: (jnp.asarray(v) if cls is ref_shade.ShadeUniforms
                      else _t(v)) for k, v in f["uni"].items()})


@pytest.mark.parametrize("with_shadow", [True, False])
@pytest.mark.parametrize("reinhard", [True, False])
def test_shade_pbr_matches_reference(ref_frame, with_shadow, reinhard):
    f = ref_frame
    ref_g = _ref_gbuffer(f)
    ref = ref_shade.shade_pbr(
        ref_g, jnp.asarray(f["mats"]), _uniforms(ref_shade.ShadeUniforms, f),
        shadow_map=jnp.asarray(f["smap"]) if with_shadow else None,
        clear_color=(0.1, 0.2, 0.3), reinhard=reinhard,
    )
    got = shade.shade_pbr(
        _port_gbuffer(ref_g), _t(f["mats"]), _uniforms(shade.ShadeUniforms, f),
        shadow_map=_t(f["smap"]) if with_shadow else None,
        clear_color=(0.1, 0.2, 0.3), reinhard=reinhard,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_shade_flat_matches_reference(ref_frame):
    ref_g = _ref_gbuffer(ref_frame)
    ref = ref_shade.shade_flat(ref_g, clear_color=(0.1, 0.2, 0.3))
    got = shade.shade_flat(_port_gbuffer(ref_g), clear_color=(0.1, 0.2, 0.3))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def _pcf_inputs(seed=4, n=500):
    rng = np.random.default_rng(seed)
    smap = rng.uniform(0.2, 1.0, (32, 32)).astype(np.float32)
    pos = np.concatenate([
        rng.uniform(-1.3, 1.3, (n, 2)),  # some taps off the map (border)
        rng.uniform(-1.0, 1.2, (n, 1)),  # some beyond the far plane
        rng.uniform(0.5, 1.5, (n, 1)),
    ], -1).astype(np.float32)
    normal = rng.normal(size=(n, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    light = np.array([0.3, 0.9, 0.2], np.float32)
    return smap, pos, normal, light / np.linalg.norm(light)


def test_shadow_pcf16_matches_reference():
    smap, pos, normal, light = _pcf_inputs()
    ref = ref_shadow.shadow_pcf16(jnp.asarray(smap), jnp.asarray(pos),
                                  jnp.asarray(normal), jnp.asarray(light))
    got = shadow.shadow_pcf16(_t(smap), _t(pos), _t(normal), _t(light))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    assert 0.0 < float(got.mean()) < 1.0


def test_gather_quad_white_border():
    smap, pos, _, _ = _pcf_inputs()
    u = pos[:, 0] * 0.5 + 0.5
    v = pos[:, 1] * 0.5 + 0.5
    ref = ref_shadow.gather_quad(jnp.asarray(smap), jnp.asarray(u), jnp.asarray(v))
    got = shadow.gather_quad(_t(smap), _t(u), _t(v))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got == 1.0).any()
