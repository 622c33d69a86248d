"""The port's own scene API (ash_tpu_torch.core, .errors, .utils.image)
against ash_tpu's, on the same inputs made from a seed with numpy.

The port keeps numpy copies of these modules so that it imports nothing of
ash_tpu. They must compute bit for bit what the reference computes: the
Vulkan Y-flip, the TRS composition order and every float operation.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import ash_tpu.core as ref_core
import ash_tpu.errors as ref_errors
import ash_tpu.utils.image as ref_image
import ash_tpu_torch.core as core
import ash_tpu_torch.errors as errors
import ash_tpu_torch.utils.image as image
from ash_tpu.core import maths as ref_maths
from ash_tpu_torch.core import maths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rng(seed=0):
    return np.random.default_rng(seed)


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _mats(rng, n):
    return rng.normal(size=(n, 4, 4)).astype(np.float32) + 4 * np.eye(
        4, dtype=np.float32)


# (name, inputs from a generator) -> each maths function on both packages.
MATHS_CASES = {
    "normalize": lambda r: [(r.normal(size=3).astype(np.float32),)],
    "mat4_translation": lambda r: [(r.normal(size=3),)],
    "mat4_scale": lambda r: [(r.random(3) + 0.1,)],
    "quat_from_axis_angle": lambda r: [(r.normal(size=3), float(r.normal()))],
    "quat_from_euler_xyz": lambda r: [tuple(float(x) for x in r.normal(size=3))],
    "quat_mul": lambda r: [tuple(_unit_quats(r, 2))],
    "mat4_from_quat": lambda r: [(q,) for q in _unit_quats(r, 4)],
    "mat4_trs": lambda r: [(r.normal(size=3), _unit_quats(r, 1)[0],
                            r.random(3) + 0.2)],
    "mat4_trs_batch": lambda r: [(r.normal(size=(16, 3)).astype(np.float32),
                                  _unit_quats(r, 16),
                                  (r.random((16, 3)) + 0.2).astype(np.float32))],
    "look_at_rh": lambda r: [(r.normal(size=3) * 5, r.normal(size=3),
                              [0.0, 1.0, 0.0])],
    "perspective_rh": lambda r: [(0.9, 1.7, 0.1, 200.0),
                                 (float(r.random() + 0.3), 0.75, 0.05, 50.0)],
    "stable_up": lambda r: [(r.normal(size=3),), ([0.0, -1.0, 0.0],)],
    "orthographic_rh": lambda r: [(-3.0, 4.0, -2.0, 5.0, 0.1, 30.0)],
    "mat4_inverse": lambda r: [(m,) for m in _mats(r, 3)],
    "normal_matrix": lambda r: [(m,) for m in _mats(r, 3)],
    "transform_point": lambda r: [(_mats(r, 1)[0], r.normal(size=3))],
    "transform_vector": lambda r: [(_mats(r, 1)[0], r.normal(size=3))],
    "halton": lambda r: [(i, b) for i in (1, 7, 33) for b in (2, 3)],
}


@pytest.mark.parametrize("name", sorted(MATHS_CASES))
def test_maths_bit_for_bit(name):
    for args in MATHS_CASES[name](_rng(sum(map(ord, name)))):
        got = getattr(maths, name)(*args)
        want = getattr(ref_maths, name)(*args)
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def _mesh_arrays(mesh):
    v = mesh.vertices
    return {f.name: getattr(v, f.name) for f in dataclasses.fields(v)} | {
        "indices": mesh.indices, "triangles": mesh.triangle_indices}


@pytest.mark.parametrize("make", [
    lambda c: c.Mesh.create_cube(),
    lambda c: c.Mesh.create_named_cube("crate"),
    lambda c: c.Mesh.create_plane("pane", size=1.6),
    lambda c: c.Mesh.create_sphere(),
], ids=["cube", "named_cube", "plane", "sphere"])
def test_mesh_arrays_equal(make):
    got, want = make(core), make(ref_core)
    assert got.name == want.name
    a, b = _mesh_arrays(got), _mesh_arrays(want)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for x, y in zip(got.bounds(), want.bounds()):
        np.testing.assert_array_equal(x, y)


def test_material_uniform_packing_equal():
    rng = _rng(3)
    for _ in range(5):
        kw = dict(
            base_color_factor=rng.random(4).astype(np.float32),
            emissive_factor=rng.random(4).astype(np.float32),
            params=rng.random(4).astype(np.float32),
            base_color_index=int(rng.integers(-1, 8)),
            emissive_index=int(rng.integers(-1, 8)),
            alpha_cutoff=float(rng.random()),
        )
        got = core.MaterialUniform(**kw).pack()
        want = ref_core.MaterialUniform(**kw).pack()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(core.MaterialUniform.default().pack(),
                                  ref_core.MaterialUniform.default().pack())
    assert dataclasses.asdict(core.Material()) == dataclasses.asdict(
        ref_core.Material())


def test_camera_and_transform_matrices_equal():
    rng = _rng(4)
    for _ in range(4):
        pos, target = rng.normal(size=3) * 6, rng.normal(size=3)
        aspect = float(rng.random() + 0.5)
        got = core.Camera.new(pos, target, aspect)
        want = ref_core.Camera.new(pos, target, aspect)
        np.testing.assert_array_equal(got.view_matrix(), want.view_matrix())
        # The Vulkan Y-flip: projection[1, 1] < 0 on both.
        np.testing.assert_array_equal(got.projection_matrix(),
                                      want.projection_matrix())
        assert got.projection_matrix()[1, 1] < 0
    t, rt = core.Transform.identity(), ref_core.Transform.identity()
    euler = rng.normal(size=3).tolist()
    for x in (t, rt):
        x.position = np.array([1.0, -2.0, 0.5], np.float32)
        x.scale = np.array([0.5, 2.0, 1.5], np.float32)
        x.set_rotation(euler)
        x.rotate([0.1, 0.2, -0.3])
    np.testing.assert_array_equal(t.model_matrix(), rt.model_matrix())
    view, proj = _mats(rng, 2)
    args = (t.model_matrix(), view, proj, [1.0, 2.0, 3.0], [0.0, -1.0, 0.0],
            [1.5, 1.5, 1.5], [0.35, 0.35, 0.35])
    got = core.MvpMatrices.compute(*args)
    want = ref_core.MvpMatrices.compute(*args)
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(getattr(got, f.name),
                                      getattr(want, f.name), err_msg=f.name)


def test_texture_decode_and_mips_equal():
    got = core.TextureData.checkerboard(size=16, cell=4)
    want = ref_core.TextureData.checkerboard(size=16, cell=4)
    np.testing.assert_array_equal(got.pixels, want.pixels)
    lin = got.to_linear_f32()
    np.testing.assert_array_equal(lin, want.to_linear_f32())
    a = core.texture.mip_chain(None, lin)
    b = ref_core.texture.mip_chain(None, lin)
    assert len(a) == len(b) > 1
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_image_helpers_round_trip(tmp_path):
    rng = _rng(5)
    img = rng.integers(0, 256, (24, 40, 4), dtype=np.uint8)
    path = str(tmp_path / "port.png")
    image.write_png(path, img)
    back = image.read_png(path)
    np.testing.assert_array_equal(back, img)
    np.testing.assert_array_equal(ref_image.read_png(path), img)
    noisy = img.copy()
    noisy[0, 0, 0] ^= 1
    assert image.psnr(img, img) == float("inf")
    assert image.psnr(img, noisy) == ref_image.psnr(img, noisy)
    f = rng.random((8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(image.to_u8(f), ref_image.to_u8(f))
    assert image.psnr(f, f * 0.99) == ref_image.psnr(f, f * 0.99)


def test_errors_are_the_ports_own():
    assert issubclass(errors.InvalidOperation, errors.AshError)
    assert not issubclass(errors.InvalidOperation, ref_errors.AshError)
    names = {n for n in dir(ref_errors) if isinstance(getattr(ref_errors, n),
                                                         type)}
    assert names <= set(dir(errors))


def test_no_module_of_the_port_imports_ash_tpu():
    """Every module of the package, imported in a fresh interpreter, loads
    neither jax nor anything of ash_tpu."""
    code = (
        "import pkgutil, sys\n"
        "import ash_tpu_torch\n"
        "for m in pkgutil.walk_packages(ash_tpu_torch.__path__,"
        " 'ash_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "import ash_tpu_torch.core.gltf\n"
        "print(sorted(m for m in sys.modules if m in ('jax', 'ash_tpu')"
        " or m.startswith(('jax.', 'ash_tpu.'))))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
