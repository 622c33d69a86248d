"""The golden scenes of the ported paths, built on this package.

The same recipes as tests/golden_scenes.py's `cube_pbr`, `flat_cube` and
`k_layer_stack` (192x128, 8x64 tiles), whose committed PNGs in tests/golden/
the reference is held to at PSNR >= 40 dB; the port is held to the same
images.
"""

from __future__ import annotations

import numpy as np

from ..core import Camera, Material, Mesh
from .renderer import RenderCommand, Renderer, RendererConfig
from .surface import HeadlessSurface

SIZE = (192, 128)  # (W, H)


def scene_cube_pbr(device) -> HeadlessSurface:
    """Red metallic cube with a shadow map."""
    surface = HeadlessSurface(*SIZE)
    r = Renderer(
        surface,
        RendererConfig(tile_h=8, tile_w=64, max_tris_per_tile=32,
                       shadow_resolution=256, shadow_tile=64,
                       shadow_max_tris_per_tile=32),
        device=device,
    )
    r.set_mesh(Mesh.create_cube())
    r.set_material(Material(color=(0.8, 0.2, 0.2, 1.0), metallic=0.5,
                            roughness=0.5))
    cam = Camera.new([3.0, 2.2, 4.0], [0, 0, 0], SIZE[0] / SIZE[1])
    r.render_frame(cam.view_matrix(), cam.projection_matrix(), cam.position)
    return surface


def scene_flat_cube(device) -> HeadlessSurface:
    """Flat vertex colours, no shadows."""
    surface = HeadlessSurface(*SIZE)
    r = Renderer(
        surface,
        RendererConfig(tile_h=8, tile_w=64, max_tris_per_tile=32,
                       shadows_enabled=False, shading="flat"),
        device=device,
    )
    r.set_mesh(Mesh.create_cube())
    cam = Camera.new([2.5, 1.8, 4.0], [0, 0, 0], SIZE[0] / SIZE[1])
    r.render_frame(cam.view_matrix(), cam.projection_matrix(), cam.position)
    return surface


def scene_k_layer_stack(device) -> HeadlessSurface:
    """Three half-transparent panes over an opaque floor through the
    4-layer depth peel."""
    surface = HeadlessSurface(*SIZE)
    r = Renderer(
        surface,
        RendererConfig(tile_h=8, tile_w=64, max_tris_per_tile=32,
                       shadows_enabled=False, transparency_layers=4),
        device=device,
    )
    r.register_mesh_handle(0, Mesh.create_plane("pane", size=1.6))
    colors = [(1, 0.2, 0.2, 0.45), (0.2, 1, 0.2, 0.45),
              (0.2, 0.2, 1, 0.45), (0.9, 0.9, 0.9, 1.0)]
    commands = []
    for i, col in enumerate(colors):
        r.register_material_handle(i + 1, Material(color=col, roughness=0.5))
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = [0.15 * i - 0.2, 1.5 - 0.5 * i, 0]
        commands.append(RenderCommand(mesh=0, transform=m, material=i + 1))
    r.submit_render_commands(commands)
    cam = Camera.new([0.6, 4.6, 0.9], [0, 0.2, 0], SIZE[0] / SIZE[1])
    r.render_frame(cam.view_matrix(), cam.projection_matrix(), cam.position)
    return surface


SCENES = {
    "cube_pbr": scene_cube_pbr,
    "flat_cube": scene_flat_cube,
    "k_layer_stack": scene_k_layer_stack,
}
