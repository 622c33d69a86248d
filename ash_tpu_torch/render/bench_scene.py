"""The standard frame's scene: 1000 instanced PBR cubes, one directional
light with a shadow map, frustum culling; and the glass standard frame.

The same recipe as bench.py:build_bench_renderer (seed 7, the same grid,
scales, materials, shadow bounds and camera), rebuilt on this package so a
run of the port needs no jax. Heights below 512 use the reference's small
smoke config (8x32 tiles, 256^2 shadow map).

The glass standard frame changes only this: every fourth draw (i % 4 == 0)
has base colour alpha 0.5, so the frame blends through a 4-layer depth
peel. The random sequence, and every other material, is the standard
frame's.
"""

from __future__ import annotations

import numpy as np

from ..core import Camera, Material, Mesh
from .renderer import RenderCommand, Renderer, RendererConfig
from .surface import HeadlessSurface

GLASS_EVERY = 4  # draws i with i % GLASS_EVERY == 0 are glass
GLASS_ALPHA = 0.5
GLASS_LAYERS = 4


def bench_draws(n_objects: int, glass: bool = False):
    """-> ([(model (4, 4) f32, Material)], extent): the cube grid's draws,
    built from numpy and this package's core only; the reference renderer
    draws the same list rebuilt with ash_tpu.core's classes."""
    rng = np.random.default_rng(7)
    side = int(round(n_objects ** (1 / 3)))
    while side**3 < n_objects:
        side += 1
    draws = []
    for i in range(n_objects):
        z, rem = divmod(i, side * side)
        y, x = divmod(rem, side)
        pos = (np.array([x, y, z], np.float32) - (side - 1) / 2) * 3.0
        scale = 0.4 + 0.4 * rng.random()
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] *= scale
        m[:3, 3] = pos
        alpha = GLASS_ALPHA if glass and i % GLASS_EVERY == 0 else 1.0
        mat = Material(
            color=(float(0.3 + 0.7 * rng.random()),
                   float(0.3 + 0.7 * rng.random()),
                   float(0.3 + 0.7 * rng.random()), alpha),
            metallic=float(rng.random()),
            roughness=float(0.2 + 0.8 * rng.random()),
        )
        draws.append((m, mat))
    return draws, side * 3.0


def bench_config(height: int, glass: bool = False, shadow_resolution=2048,
                 **cfg_overrides) -> dict:
    """RendererConfig keyword arguments of the bench scene (the same names
    in the reference's RendererConfig)."""
    if height < 512:
        cfg = dict(
            tile_h=8, tile_w=32, max_tris_per_tile=64,
            shadow_resolution=256, shadow_tile=64,
            shadow_max_tris_per_tile=64,
        )
    else:
        cfg = dict(shadow_resolution=shadow_resolution)
    if glass:
        cfg["transparency_layers"] = GLASS_LAYERS
    cfg.update(cfg_overrides)
    return cfg


def bench_camera(width: int, height: int, extent: float) -> Camera:
    cam = Camera.new(
        position=np.array([extent * 1.1, extent * 0.8, extent * 1.3], np.float32),
        target=np.zeros(3, np.float32),
        aspect=width / height,
    )
    cam.far = extent * 6.0
    return cam


def build_bench_renderer(width, height, n_objects, device,
                         shadow_resolution=2048, glass=False, **cfg_overrides):
    """-> (renderer, surface, camera, extent) for an n_objects cube grid;
    glass=True draws the glass standard frame."""
    surface = HeadlessSurface(width, height)
    cfg = RendererConfig(**bench_config(height, glass, shadow_resolution,
                                        **cfg_overrides))
    r = Renderer(surface, cfg, device=device)
    r.register_mesh_handle(0, Mesh.create_cube())
    draws, extent = bench_draws(n_objects, glass)
    commands = []
    for i, (m, mat) in enumerate(draws):
        r.register_material_handle(i + 1, mat)
        commands.append(RenderCommand(mesh=0, transform=m, material=i + 1))
    r.submit_render_commands(commands)
    r.shadow_feature.set_scene_bounds([0, 0, 0], extent)
    return r, surface, bench_camera(width, height, extent), extent
