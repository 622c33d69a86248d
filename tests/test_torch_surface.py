"""The port's public surface against ash_tpu's: FrameOutputs' fields, the
exported names, the Renderer's methods and RendererConfig's keywords.

Every reference name is either ported, or refused with NotImplementedError
naming its ROADMAP.md item, or (for RendererConfig) an XLA-only knob that
the port accepts, validates as the reference does, and ignores.
"""

import dataclasses
import inspect
import os

import numpy as np
import pytest

import ash_tpu
import ash_tpu.render as ref_render
import ash_tpu_torch
import ash_tpu_torch.render as port_render
from ash_tpu.render import renderer as ref_renderer
from ash_tpu_torch.render import renderer as port_renderer

REF_METHODS = sorted(n for n, v in vars(ref_renderer.Renderer).items()
                     if not n.startswith("_")
                     and (callable(v) or isinstance(v, property)))
REF_FIELDS = {f.name: f for f in dataclasses.fields(ref_renderer.RendererConfig)}


def _renderer():
    return port_render.Renderer(port_render.HeadlessSurface(16, 16),
                                device="cpu")


def test_frame_outputs_fields_match():
    assert (port_render.FrameOutputs._fields
            == ref_render.FrameOutputs._fields)
    assert port_render.FrameOutputs._field_defaults.keys() == \
        ref_render.FrameOutputs._field_defaults.keys()


def test_frame_outputs_by_position():
    r = _renderer()
    r.set_mesh(ash_tpu_torch.Mesh.create_cube())
    cam = ash_tpu_torch.Camera.new([3.0, 2.0, 4.0], [0, 0, 0], 1.0)
    out = r.render_frame(cam.view_matrix(), cam.projection_matrix(),
                         cam.position)
    image, color, depth, shadow, covered, overflow, history, visible, \
        shadow_overflow, msaa_edge_overflow = out
    assert image.shape == (16, 16, 4) and history is None
    assert int(visible) == 1 and msaa_edge_overflow is None
    assert shadow.shape == (2048, 2048) and int(shadow_overflow) == 0


@pytest.mark.parametrize("package,reference", [
    ("ash_tpu_torch", ash_tpu), ("ash_tpu_torch.render", ref_render)])
def test_reference_names_are_exported_or_listed(package, reference):
    port = {"ash_tpu_torch": ash_tpu_torch,
            "ash_tpu_torch.render": port_render}[package]
    for name in reference.__all__:
        if name in port_render.UNPORTED_NAMES:
            assert name not in port.__all__
            with pytest.raises(NotImplementedError,
                               match=port_render.UNPORTED_NAMES[name]):
                getattr(port, name)
        else:
            assert name in port.__all__, f"{package} does not export {name}"
            getattr(port, name)
    # The top level's lazily exported surfaces are accounted for too.
    for name in ("FileStreamSurface", "LiveViewSurface"):
        assert getattr(ash_tpu_torch, name) is getattr(port_render, name)
        assert name in ash_tpu_torch.__all__


def test_unported_names_name_their_item():
    """Every name of the reference's render package is ported (MSAA, A15,
    and the surfaces, A17, were the last): none is left to refuse."""
    assert port_render.UNPORTED_NAMES == {}
    from ash_tpu_torch.render import (  # noqa: F401
        FileStreamSurface,
        LiveViewSurface,
        MsaaPreset,
        TerminalSurface,
    )


@pytest.mark.parametrize("method", REF_METHODS)
def test_reference_renderer_method_is_accounted_for(method):
    r = _renderer()
    assert hasattr(type(r), method), f"Renderer.{method} is missing"
    if method in port_renderer.UNPORTED_METHODS:
        item = port_renderer.UNPORTED_METHODS[method]
        with pytest.raises(NotImplementedError, match=item.split(",")[0]):
            getattr(r, method)()
        return
    # Ported: the reference's parameters, by name, in order.
    ref = getattr(ref_renderer.Renderer, method)
    if isinstance(ref, property):
        assert isinstance(getattr(type(r), method), property)
        return
    want = list(inspect.signature(ref).parameters)
    got = list(inspect.signature(getattr(type(r), method)).parameters)
    assert got == want, f"Renderer.{method}{got} != reference {want}"


def test_xla_only_pipeline_api():
    r = _renderer()
    assert r.pipeline_decisions == {}
    assert r.wait_pipeline_optimization() is True
    assert r.wait_pipeline_optimization(timeout=0.5) is True


@pytest.mark.parametrize("name", sorted(REF_FIELDS))
def test_reference_config_keyword_is_accepted(name):
    """Every reference keyword at its reference default builds the port's
    config; defaults agree."""
    field = REF_FIELDS[name]
    default = (field.default if field.default is not dataclasses.MISSING
               else field.default_factory())
    cfg = port_renderer.RendererConfig(**{name: default})
    assert getattr(cfg, name) == default
    port_default = port_renderer.RendererConfig.__dataclass_fields__[name]
    assert port_default.default == default


@pytest.mark.parametrize("name,value", [
    ("debug", True), ("watch_kernels", True), ("use_pallas", False),
    ("compilation_cache_dir", "unused-cache-dir"), ("pipeline_mode", "fused"),
    ("cold_compile_effort", None), ("async_resize", False),
    ("bg_compile", "thread"), ("gbuffer_packed", True),
])
def test_xla_only_knob_has_no_effect(name, value):
    """An XLA-only knob changes nothing: the same frame, and nothing is
    written (a cache directory is never created)."""
    assert name in port_renderer.XLA_ONLY_OPTIONS

    def frame(**kw):
        r = port_render.Renderer(
            port_render.HeadlessSurface(24, 16),
            port_render.RendererConfig(shadow_resolution=64, shadow_tile=64,
                                       **kw),
            device="cpu")
        r.set_mesh(ash_tpu_torch.Mesh.create_cube())
        cam = ash_tpu_torch.Camera.new([3.0, 2.0, 4.0], [0, 0, 0], 1.5)
        r.render_frame(cam.view_matrix(), cam.projection_matrix(),
                       cam.position)
        return r.read_back()

    np.testing.assert_array_equal(frame(**{name: value}), frame())
    assert not os.path.exists("unused-cache-dir")


@pytest.mark.parametrize("name,value", [
    ("pipeline_mode", "eager"), ("bg_compile", "process")])
def test_xla_only_knob_is_validated(name, value):
    with pytest.raises(ValueError, match=name):
        port_renderer.RendererConfig(**{name: value})
    with pytest.raises(ValueError, match=name):
        ref_renderer.RendererConfig(**{name: value})


@pytest.mark.parametrize("name,value,item", [
    ("max_draws_per_chunk", 64, "A16"),
])
def test_unported_option_raises_with_its_item(name, value, item):
    """Named for the refusal naming its ROADMAP item (here A16) that this
    option met before chunked geometry was ported: it now reaches the
    renderer, whose frame renders in chunks of that many draws."""
    cfg = port_renderer.RendererConfig(**{name: value})
    r = port_render.Renderer(port_render.HeadlessSurface(24, 16), cfg,
                             device="cpu")
    assert getattr(r.config, name) == value
    assert item == "A16" and not r._chunked()


@pytest.mark.parametrize("name,value,field", [
    ("msaa_resolve", "edge", "msaa_resolve"),
    ("msaa_edge_capacity", 0.25, "msaa_edge_capacity"),
])
def test_a15_option_reaches_the_frame(name, value, field):
    """The MSAA options that raised before A15 reach the frame."""
    r = port_render.Renderer(
        port_render.HeadlessSurface(24, 16),
        port_renderer.RendererConfig(shadow_resolution=64, shadow_tile=64,
                                     **{name: value}), device="cpu")
    r.set_mesh(ash_tpu_torch.Mesh.create_cube())
    r.set_msaa_preset("x2")
    cam = ash_tpu_torch.Camera.new([3.0, 2.0, 4.0], [0, 0, 0], 1.5)
    inputs = r.prepare_frame(cam.view_matrix(), cam.projection_matrix(),
                             cam.position)
    assert getattr(inputs.config, field) == value
    assert (inputs.config.ssaa_x, inputs.config.ssaa_y) == (2, 1)


def test_unported_items_are_a16_only():
    """Named for the state after A15 and A17, when the refusals named only
    chunked geometry (A16). With A16 ported nothing refuses: no name, no
    method and no option is left unported."""
    assert port_render.UNPORTED_NAMES == {}
    assert port_renderer.UNPORTED_METHODS == {}
    assert not hasattr(port_renderer, "_UNPORTED_OPTIONS")


@pytest.mark.parametrize("name,value,field", [
    ("shade_dtype", "bf16", "shade_dtype"),
    ("lod_cull_threshold", 0.01, "lod_cull_threshold"),
])
def test_a14_option_reaches_the_frame(name, value, field):
    r = port_render.Renderer(
        port_render.HeadlessSurface(24, 16),
        port_renderer.RendererConfig(shadow_resolution=64, shadow_tile=64,
                                     **{name: value}), device="cpu")
    r.set_mesh(ash_tpu_torch.Mesh.create_cube())
    cam = ash_tpu_torch.Camera.new([3.0, 2.0, 4.0], [0, 0, 0], 1.5)
    inputs = r.prepare_frame(cam.view_matrix(), cam.projection_matrix(),
                             cam.position)
    assert getattr(inputs.config, field) == value


def test_register_mesh_descriptor():
    cube = ash_tpu_torch.Mesh.create_cube()
    desc = ash_tpu_torch.MeshDescriptor(key="tri", vertices=cube.vertices,
                                        indices=cube.indices)
    r = _renderer()
    r.register_mesh_descriptor(3, desc)
    mesh = r.mesh_registry[r.mesh_handles[3]]
    assert mesh.num_triangles == cube.num_triangles
    np.testing.assert_array_equal(mesh.triangle_indices, cube.triangle_indices)
