"""Image-based lighting: ash_tpu_torch.ops.brdf_lut and ops.ibl, and the
Renderer's environment frames, against ash_tpu on the CPU with the same
numpy environments (built in code, as tests/test_ibl.py builds them).

Tolerances:

- `_hammersley`: equal (integer bit reversal, one rounding to f32);
- `integrate_brdf` / `brdf_lut`: atol 2e-6 (f32 transcendental functions
  and the mean's summation order);
- `irradiance_map`, `prefilter_environment`: equal (the same numpy);
- `prefilter_environment_ggx`: atol 1e-4 relative to the environment's
  largest radiance (the taps' directions pass through arctan2 / arccos,
  whose last bits differ, and a tap at a texel edge moves its bilinear
  weights);
- `sample_radiance`, `sample_irradiance`, `ambient_ibl` on one bundle,
  over 3000 directions with 64 on the u wrap of the equirect map (where a
  last bit of arctan2 could move a tap to the other side of the map) and 8
  at the poles: atol 2e-5 relative to the largest radiance (measured
  1.9e-6 relative at most, away from the wrap); the largest difference and
  where it lies are printed;
- frames: u8 PSNR >= 40 dB against the reference's frame, and the
  reference test's own bars on the port's frames.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ash_tpu.core as ref_core
import ash_tpu.render as ref_render
import ash_tpu_torch.core as port_core
import ash_tpu_torch.render as port_render
from ash_tpu.ops import brdf_lut as ref_brdf
from ash_tpu.ops import ibl as ref_ibl
from ash_tpu.utils.image import psnr
from ash_tpu_torch.ops import brdf_lut, ibl
from ash_tpu_torch.render import bench_scene

torch.set_num_threads(1)

REF = SimpleNamespace(core=ref_core, render=ref_render, kw={})
PORT = SimpleNamespace(core=port_core, render=port_render,
                       kw={"device": "cpu"})
MIN_PSNR = 40.0


def _t(a):
    return torch.from_numpy(np.array(a))


def _sky_ground_env(h=32, w=64):
    env = np.zeros((h, w, 3), np.float32)
    env[: h // 2] = [0.2, 0.4, 1.0]
    env[h // 2:] = [0.35, 0.25, 0.15]
    return env


def _envs():
    rng = np.random.default_rng(2)
    impulse = np.zeros((32, 64, 3), np.float32)
    impulse[16, 16] = 100.0
    return {
        "sky_ground": _sky_ground_env(),
        "noise": rng.random((16, 32, 3)).astype(np.float32),
        "impulse": impulse,
        "example06": bench_scene.sky_environment(),
    }


@pytest.mark.parametrize("n", [64, 1024, 70001])
def test_hammersley_matches_reference(n):
    np.testing.assert_array_equal(brdf_lut._hammersley(n).numpy(),
                                  np.asarray(ref_brdf._hammersley(n)))


def test_brdf_lut_matches_reference():
    ref = np.asarray(ref_brdf.brdf_lut(size=16, samples=64))
    got = brdf_lut.brdf_lut(size=16, samples=64, device="cpu").numpy()
    print(f"\nbrdf_lut 16^2 x 64: max |err| {np.abs(got - ref).max():.2e}")
    np.testing.assert_allclose(got, ref, atol=2e-6, rtol=0)
    # The reference test's bars (tests/test_culling_wired.py).
    assert got.shape == (16, 16, 2)
    assert np.all(got >= 0.0) and (got.sum(-1) <= 1.05).all()


def test_integrate_brdf_matches_reference():
    rng = np.random.default_rng(4)
    nv = rng.uniform(0.0, 1.0, (7, 9)).astype(np.float32)
    rough = rng.uniform(0.0, 1.0, (7, 9)).astype(np.float32)
    ref = ref_brdf.integrate_brdf(jnp.asarray(nv), jnp.asarray(rough), 64)
    got = brdf_lut.integrate_brdf(_t(nv), _t(rough), 64)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-6, rtol=0)
    s, b = brdf_lut.integrate_brdf(torch.tensor(0.95), torch.tensor(0.05), 256)
    assert float(s) > 0.9 and float(b) < 0.1


def test_integrate_brdf_chunks_agree():
    """The row chunks of integrate_brdf change nothing."""
    rng = np.random.default_rng(5)
    nv = _t(rng.uniform(0, 1, 300).astype(np.float32))
    rough = _t(rng.uniform(0, 1, 300).astype(np.float32))
    whole = brdf_lut.integrate_brdf(nv, rough, 64)
    old = brdf_lut._CHUNK_ELEMENTS
    try:
        brdf_lut._CHUNK_ELEMENTS = 64 * 7
        chunked = brdf_lut.integrate_brdf(nv, rough, 64)
    finally:
        brdf_lut._CHUNK_ELEMENTS = old
    for a, b in zip(whole, chunked):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("name", ["sky_ground", "noise", "example06"])
def test_irradiance_and_box_prefilter_match_reference(name):
    env = _envs()[name]
    np.testing.assert_array_equal(ibl.irradiance_map(env, 8),
                                  ref_ibl.irradiance_map(env, 8))
    for a, b in zip(ibl.prefilter_environment(env, 4),
                    ref_ibl.prefilter_environment(env, 4)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["sky_ground", "noise", "impulse", "example06"])
def test_ggx_prefilter_matches_reference(name):
    env = _envs()[name]
    samples = 128 if name == "impulse" else 32  # the reference test's 128
    ref = ref_ibl.prefilter_environment_ggx(env, mips=4, samples=samples)
    got = [g.numpy() for g in ibl.prefilter_environment_ggx(
        env, mips=4, samples=samples, device="cpu")]
    assert [g.shape for g in got] == [r.shape for r in ref]
    np.testing.assert_array_equal(got[0], env)
    worst = max(float(np.abs(g - r).max()) for g, r in zip(got, ref))
    print(f"\nGGX prefilter {name}: max |err| {worst:.2e} "
          f"(largest radiance {env.max():.1f})")
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, atol=1e-4 * float(env.max()), rtol=0)
    if name == "impulse":  # the reference test's bar: the lobe spreads
        box = ibl.prefilter_environment(env, mips=4)
        assert got[3].max() < box[3].max() * 0.8 and got[3].sum() > 0.01


def _bundles(env):
    ref = ref_ibl.build_environment(env, mips=3, irradiance_size=8,
                                    lut_size=32)
    port = ibl.build_environment(env, mips=3, irradiance_size=8, lut_size=32,
                                 device="cpu")
    shared = ibl.EnvironmentIBL(
        radiance=_t(ref.radiance), table=ref.table, levels=ref.levels,
        irradiance=_t(ref.irradiance), lut=_t(ref.lut))
    return ref, port, shared


@pytest.mark.parametrize("name", ["sky_ground", "example06"])
def test_build_environment_matches_reference(name):
    env = _envs()[name]
    ref, port, _ = _bundles(env)
    np.testing.assert_array_equal(port.table, ref.table)
    assert port.levels == ref.levels
    np.testing.assert_array_equal(port.irradiance.numpy(),
                                  np.asarray(ref.irradiance))
    np.testing.assert_allclose(port.radiance.numpy(), np.asarray(ref.radiance),
                               atol=1e-4 * float(env.max()), rtol=0)
    np.testing.assert_allclose(port.lut.numpy(), np.asarray(ref.lut),
                               atol=2e-6, rtol=0)


@pytest.mark.parametrize("build", [
    lambda env: brdf_lut.brdf_lut(size=4, samples=8),
    lambda env: ibl.prefilter_environment_ggx(env, mips=2, samples=8),
    lambda env: ibl.build_environment(env, mips=2, irradiance_size=4,
                                      lut_size=4),
], ids=["brdf_lut", "prefilter_environment_ggx", "build_environment"])
def test_ibl_builders_default_to_the_card(build, monkeypatch):
    """Without a device the builders run on the card, and never fall back
    to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        build(_sky_ground_env(8, 16))


def _directions(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    # Directions on the u wrap (z = 0, x < 0) and at the poles.
    d[:64] = np.stack([-np.ones(64), rng.uniform(-0.9, 0.9, 64),
                       rng.uniform(-1e-6, 1e-6, 64)], -1)
    d[64:72] = [[0, 1, 0], [0, -1, 0]] * 4
    return d


@pytest.mark.parametrize("name", ["sky_ground", "example06"])
def test_sampling_matches_reference(name):
    env = _envs()[name]
    ref, _, shared = _bundles(env)
    rng = np.random.default_rng(8)
    n = 3000
    normal = _directions(n, 1)
    view = _directions(n, 2)
    lod = rng.uniform(-0.5, 3.0, n).astype(np.float32)
    base = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    metal = rng.uniform(0, 1, n).astype(np.float32)
    rough = rng.uniform(0.04, 1, n).astype(np.float32)
    atol = 2e-5 * float(env.max())
    cases = {
        "sample_radiance": (
            ibl.sample_radiance(shared, _t(normal), _t(lod)),
            ref_ibl.sample_radiance(ref, jnp.asarray(normal), jnp.asarray(lod))),
        "sample_irradiance": (
            ibl.sample_irradiance(shared, _t(normal)),
            ref_ibl.sample_irradiance(ref, jnp.asarray(normal))),
        "ambient_ibl": (
            ibl.ambient_ibl(shared, _t(normal), _t(view), _t(base), _t(metal),
                            _t(rough)),
            ref_ibl.ambient_ibl(ref, jnp.asarray(normal), jnp.asarray(view),
                                jnp.asarray(base), jnp.asarray(metal),
                                jnp.asarray(rough))),
    }
    for what, (got, want) in cases.items():
        err = np.abs(got.numpy() - np.asarray(want)).max(-1)
        i = int(err.argmax())
        print(f"\n{what} ({name}): max |err| {err[i]:.2e} at direction "
              f"{np.round(normal[i], 4).tolist()}, "
              f"{int((err > 1e-5).sum())} of {n} over 1e-5")
        assert err.max() <= atol, what


def test_ambient_ibl_metal_vs_dielectric():
    _, port, _ = _bundles(_sky_ground_env())
    n = torch.tensor([[0.0, 1.0, 0.0]])
    base = torch.ones(1, 3)
    metal = ibl.ambient_ibl(port, n, n, base, torch.tensor([1.0]),
                            torch.tensor([0.2]))
    dielec = ibl.ambient_ibl(port, n, n, base, torch.tensor([0.0]),
                             torch.tensor([0.2]))
    assert float(metal.sum()) > 0 and float(dielec.sum()) > 0
    up = ibl.sample_radiance(port, n, torch.tensor([0.0]))
    down = ibl.sample_radiance(port, -n, torch.tensor([0.0]))
    assert float(up[0, 2]) > float(down[0, 2])


def _cube_renderer(P):
    r = P.render.Renderer(
        P.render.HeadlessSurface(64, 64),
        P.render.RendererConfig(tile_h=8, tile_w=32, max_tris_per_tile=32,
                                shadows_enabled=False), **P.kw)
    r.set_mesh(P.core.Mesh.create_cube())
    r.set_material(P.core.Material(color=(1, 1, 1, 1), metallic=0.9,
                                   roughness=0.15))
    return r


def test_e2e_environment_lighting_matches_reference():
    """tests/test_ibl.py's frame on both renderers: the reference test's
    bars on the port, and the port's frames against the reference's."""
    cam = port_core.Camera.new([0, 2.0, 4.5], [0, 0, 0], 1.0)
    args = (cam.view_matrix(), cam.projection_matrix(), cam.position)
    frames = {}
    for name, P in (("ref", REF), ("port", PORT)):
        r = _cube_renderer(P)
        flat = r.render_frame(*args)
        r.set_environment_map(_sky_ground_env())
        lit = r.render_frame(*args)
        r.clear_environment_map()
        back = r.render_frame(*args)
        frames[name] = [np.array(o.image) for o in (flat, lit, back)]
        if name == "port":
            flat_c, lit_c, back_c = (o.color.numpy() for o in (flat, lit, back))
            top, top_flat = lit_c[18, 32], flat_c[18, 32]
            assert top[2] > top[0], f"sky reflection is blue: {top}"
            assert abs(float(top[2]) - float(top_flat[2])) > 0.01
            np.testing.assert_array_equal(back_c, flat_c)
    for got, want in zip(frames["port"], frames["ref"]):
        assert psnr(got, want) >= MIN_PSNR


def test_environment_from_texture_data():
    """set_environment_map takes a TextureData (its linear RGB)."""
    r = _cube_renderer(PORT)
    tex = port_core.TextureData.checkerboard(size=16, cell=4)
    r.set_environment_map(tex)
    assert r._ibl.levels == 5 and r.prepare_frame(
        np.eye(4), np.eye(4), np.zeros(3)).config.ibl_enabled


def test_example06_scene_matches_reference():
    """Example 06's sphere grid under its sky, HDR on, at a small size."""
    imgs = {}
    cam = bench_scene.ibl_camera(96, 60)
    for name, P in (("ref", REF), ("port", PORT)):
        r = P.render.Renderer(
            P.render.HeadlessSurface(96, 60),
            P.render.RendererConfig(**bench_scene.ibl_config(
                tile_h=8, tile_w=32, max_tris_per_tile=256)), **P.kw)
        bench_scene.fill_ibl_scene(r, P.core, P.render.RenderCommand,
                                   segments=12, rings=6)
        r.render_frame(cam.view_matrix(), cam.projection_matrix(), cam.position)
        imgs[name] = np.array(r.read_back())
    assert psnr(imgs["port"], imgs["ref"]) >= MIN_PSNR
    assert imgs["port"][..., :3].max() > 30
