"""What the frames hand the bloom, light, shadow, G-buffer and shading
kernels, checked on the CPU.

The entries (ops/bloom_cuda.py:bloom_pyramid, ops/lights_cuda.py:add_lights,
ops/shadow_cuda.py:shadow_pcf16 and shadow_pcf16_csm,
ops/gbuffer_cuda.py:interpolate_gbuffer, ops/shade_cuda.py:shade_pbr) run
their argument checks only on the card: on CPU tensors they run the plain
versions, which take any float dtype. The shading entry's check runs in
front of the calls whose arguments take its kernels (f32 without IBL); the
bf16 frames take its eager path. Here each check is patched in front of every CPU
call of its entry, over the small bench frames (96x64,
16 cubes) in the configurations that reach the kernels on the card: the
rich frame, alone and with bf16 shading, glass, textures, render_scale 0.7,
SSAA x4, edge MSAA x4 and edge x8 in bf16; the lit frame in bf16, and lit
and textured at edge x4. A frame that would hand the card an input the
kernels refuse fails here without a card. The entries themselves are not
changed.
"""

import pytest
import torch

from ash_tpu_torch.ops import (bloom_cuda, gbuffer_cuda, lights_cuda,
                               shade_cuda, shadow_cuda)
from ash_tpu_torch.render import bench_scene

torch.set_num_threads(1)

# name -> (build_bench_renderer keywords, MSAA preset or None).
FRAMES = {
    "rich": (dict(rich=True), None),
    "rich bf16": (dict(rich=True, shade_dtype="bf16"), None),
    "rich glass": (dict(rich=True, glass=True), None),
    "rich textured": (dict(rich=True, textured=True), None),
    "rich render_scale 0.7": (dict(rich=True, render_scale=0.7), None),
    "rich ssaa x4": (dict(rich=True, msaa_resolve="ssaa"), "x4"),
    "rich edge x4": (dict(rich=True, msaa_resolve="edge"), "x4"),
    "rich edge x8 bf16": (dict(rich=True, msaa_resolve="edge",
                               shade_dtype="bf16"), "x8"),
    "lit bf16": (dict(lights=32, shade_dtype="bf16"), None),
    "lit textured edge x4": (dict(lights=32, textured=True,
                                  msaa_resolve="edge"), "x4"),
}


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_frames_hand_the_kernels_what_they_take(name, monkeypatch):
    kw, preset = FRAMES[name]
    checked = {"bloom": 0, "lights": 0, "shadow": 0, "gbuffer": 0,
               "shade": 0}
    real_bloom = bloom_cuda.bloom_pyramid
    real_lights = lights_cuda.add_lights
    real_pcf = shadow_cuda.shadow_pcf16
    real_csm = shadow_cuda.shadow_pcf16_csm
    real_gbuffer = gbuffer_cuda.interpolate_gbuffer
    real_shade = shade_cuda.shade_pbr

    def bloom_pyramid(hdr, *args, **kwargs):
        bloom_cuda.check_inputs(hdr, *args, **kwargs)
        checked["bloom"] += 1
        return real_bloom(hdr, *args, **kwargs)

    def add_lights(*args):
        lights_cuda.check_inputs(*args)
        checked["lights"] += 1
        return real_lights(*args)

    def shadow_pcf16(*args):
        shadow_cuda.check_inputs(*args)
        checked["shadow"] += 1
        return real_pcf(*args)

    def shadow_pcf16_csm(*args, **kwargs):
        shadow_cuda.check_inputs_csm(*args, **kwargs)
        checked["shadow"] += 1
        return real_csm(*args, **kwargs)

    def interpolate_gbuffer(*args, **kwargs):
        gbuffer_cuda.check_inputs(*args, **kwargs)
        checked["gbuffer"] += 1
        return real_gbuffer(*args, **kwargs)

    def shade_pbr(*args, **kwargs):
        if not shade_cuda.eager(kwargs.get("dtype", torch.float32),
                                kwargs.get("ibl")):
            shade_cuda.check_inputs(*args, **kwargs)
            checked["shade"] += 1
        return real_shade(*args, **kwargs)

    monkeypatch.setattr(bloom_cuda, "bloom_pyramid", bloom_pyramid)
    monkeypatch.setattr(lights_cuda, "add_lights", add_lights)
    monkeypatch.setattr(shadow_cuda, "shadow_pcf16", shadow_pcf16)
    monkeypatch.setattr(shadow_cuda, "shadow_pcf16_csm", shadow_pcf16_csm)
    monkeypatch.setattr(gbuffer_cuda, "interpolate_gbuffer",
                        interpolate_gbuffer)
    monkeypatch.setattr(shade_cuda, "shade_pbr", shade_pbr)
    r, _, cam, _ = bench_scene.build_bench_renderer(96, 64, 16, "cpu", **kw)
    if preset is not None:
        r.set_msaa_preset(preset)
    for _ in range(2):
        out = r.render_frame(cam.view_matrix(), cam.projection_matrix(),
                             cam.position)
    assert bool(torch.isfinite(out.color).all())
    # Two frames: a rich frame blooms once each, and every frame here shades
    # its lights and its shadow at least once each (edge MSAA twice:
    # centres, worklist), each shaded layer after one G-buffer fetch and,
    # in f32, through the shading kernels.
    assert checked["bloom"] == (2 if kw.get("rich") else 0)
    assert checked["lights"] >= 2
    assert checked["shadow"] == checked["lights"]
    assert checked["gbuffer"] == checked["lights"]
    bf16 = kw.get("shade_dtype") == "bf16"
    assert checked["shade"] == (0 if bf16 else checked["lights"])
