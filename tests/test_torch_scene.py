"""Scene packing: ash_tpu_torch.render.scene against ash_tpu.render.scene.

Both sides run the same numpy packing, so every field must match exactly.
Each side packs a scene built from its own package's core classes.
"""

import numpy as np
import pytest
import torch

import ash_tpu.core as ref_core
import ash_tpu_torch.core as port_core
from ash_tpu.render import scene as ref_scene
from ash_tpu_torch.render import scene

torch.set_num_threads(1)


def _material_uniform(core, color):
    m = core.Material(color=color, metallic=0.3, roughness=0.6)
    return core.MaterialUniform(
        base_color_factor=np.asarray(m.color, np.float32),
        emissive_factor=np.asarray(m.emissive, np.float32),
        params=np.array([m.metallic, m.roughness, 1.0, 1.0], np.float32),
    )


def _single_mesh(core):
    cube = core.Mesh.create_cube()
    items = [dict(mesh_key=cube.name, model=np.eye(4, dtype=np.float32),
                  material=_material_uniform(core, (0.8, 0.2, 0.2, 1.0)))]
    return items, {cube.name: cube}


def _grid27(core):
    """27 instanced draws over two meshes, like bench.py's cube grid."""
    cube = core.Mesh.create_cube()
    plane = core.Mesh.create_plane("pane", size=1.5)
    rng = np.random.default_rng(11)
    items = []
    for i in range(27):
        z, rem = divmod(i, 9)
        y, x = divmod(rem, 3)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] *= 0.4 + 0.4 * rng.random()
        m[:3, 3] = (np.array([x, y, z], np.float32) - 1.0) * 3.0
        mesh = plane if i % 5 == 0 else cube
        items.append(dict(
            mesh_key=mesh.name, model=m,
            material=_material_uniform(core, (*rng.random(3), 1.0)),
        ))
    return items, {cube.name: cube, plane.name: plane}


SCENES = {"single_mesh": _single_mesh, "grid27": _grid27}


def _both(name):
    ref_items, ref_meshes = SCENES[name](ref_core)
    items, meshes = SCENES[name](port_core)
    ref = ref_scene.build_scene([ref_scene.DrawItem(**d) for d in ref_items],
                                ref_meshes)
    got = scene.build_scene([scene.DrawItem(**d) for d in items], meshes, "cpu")
    return ref, got, items, ref_items


@pytest.mark.parametrize("name", sorted(SCENES))
def test_build_scene_matches_reference(name):
    ref, got, _, _ = _both(name)
    for field in scene.SceneBuffers._fields:
        want = np.asarray(getattr(ref.buffers, field))
        have = getattr(got.buffers, field).numpy()
        assert have.dtype == want.dtype, field
        np.testing.assert_array_equal(have, want, err_msg=field)
    assert got.num_draws == ref.num_draws
    assert got.num_triangles == ref.num_triangles
    assert got.num_vertices == ref.num_vertices
    np.testing.assert_array_equal(got.scene_center, ref.scene_center)
    assert got.scene_radius == ref.scene_radius
    assert got.has_lods == ref.has_lods


@pytest.mark.parametrize("name", sorted(SCENES))
def test_build_models_matches_reference(name):
    ref, got, items, ref_items = _both(name)
    d = got.buffers.num_draws
    np.testing.assert_array_equal(
        scene.build_models([scene.DrawItem(**i) for i in items], d),
        ref_scene.build_models([ref_scene.DrawItem(**i) for i in ref_items], d),
    )


def test_scene_from_numpy_round_trips():
    ref, _, _, _ = _both("grid27")
    carried = scene.scene_from_numpy(ref.buffers, "cpu")
    for field in scene.SceneBuffers._fields:
        want = np.asarray(getattr(ref.buffers, field))
        t = getattr(carried, field)
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), want, err_msg=field)
    again = scene.scene_from_numpy(
        scene.SceneBuffers(*(t.numpy() for t in carried)), "cpu"
    )
    for a, b in zip(carried, again):
        assert torch.equal(a, b)
