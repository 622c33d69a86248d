"""The golden scenes of the ported paths, built on this package.

The same recipes as tests/golden_scenes.py's seven scenes (`cube_pbr`,
`flat_cube`, `full_frame`, `textured`, `glass_and_lights`, `k_layer_stack`
and `aniso16`; 192x128, 8x64 tiles), whose committed PNGs in tests/golden/
the reference is held to at PSNR >= 40 dB; the port is held to the same
images.
"""

from __future__ import annotations

import numpy as np

from ..core import Camera, Material, Mesh, TextureData, maths
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


def scene_full_frame(device) -> HeadlessSurface:
    """The full frame: an instanced grid with an emissive cube, a point
    light, bloom, ACES and TAA over three frames."""
    surface = HeadlessSurface(*SIZE)
    r = Renderer(
        surface,
        RendererConfig(tile_h=8, tile_w=64, max_tris_per_tile=64,
                       shadow_resolution=256, shadow_tile=64,
                       shadow_max_tris_per_tile=64),
        device=device,
    )
    r.register_mesh_handle(0, Mesh.create_cube())
    rng = np.random.default_rng(5)
    commands = []
    for i in range(27):
        z, rem = divmod(i, 9)
        y, x = divmod(rem, 3)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] *= 0.5
        m[:3, 3] = (np.array([x, y, z], np.float32) - 1.0) * 2.5
        mat = Material(
            color=(*(0.3 + 0.7 * rng.random(3)), 1.0),
            metallic=float(rng.random()),
            roughness=float(0.2 + 0.8 * rng.random()),
            emissive=(3.0, 1.5, 0.3, 1.0) if i == 13 else (0, 0, 0, 1),
        )
        r.register_material_handle(i + 1, mat)
        commands.append(RenderCommand(mesh=0, transform=m, material=i + 1))
    r.submit_render_commands(commands)
    r.shadow_feature.set_scene_bounds([0, 0, 0], 8.0)
    r.add_point_light([0, 4, 4], color=(1, 0.9, 0.7), intensity=6, radius=16)
    r.initialize_hdr()
    r.set_taa_enabled(True)
    cam = Camera.new([6.0, 4.5, 7.0], [0, 0, 0], SIZE[0] / SIZE[1])
    for _ in range(3):
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


def scene_textured(device) -> HeadlessSurface:
    """Checkerboard-albedo cube through the bindless pool, at the default
    16x anisotropy."""
    surface = HeadlessSurface(*SIZE)
    r = Renderer(
        surface,
        RendererConfig(tile_h=8, tile_w=64, max_tris_per_tile=32,
                       shadows_enabled=False),
        device=device,
    )
    mesh = Mesh.create_named_cube("TexturedCube")
    mesh.texture_data = TextureData.checkerboard(size=64, cell=8)
    r.set_mesh(mesh)
    r.set_material(Material(color=(1.0, 0.9, 0.8, 1.0), roughness=0.6))
    cam = Camera.new([2.6, 1.8, 3.4], [0, 0, 0], SIZE[0] / SIZE[1])
    r.render_frame(cam.view_matrix(), cam.projection_matrix(), cam.position)
    return surface


def scene_glass_and_lights(device) -> HeadlessSurface:
    """A transparent pane over a cube, lit by a point and a spot light:
    two-layer blending and the Forward+ light loop."""
    surface = HeadlessSurface(*SIZE)
    r = Renderer(
        surface,
        RendererConfig(tile_h=8, tile_w=64, max_tris_per_tile=64,
                       shadows_enabled=False),
        device=device,
    )
    r.register_mesh_handle(0, Mesh.create_cube())
    r.register_mesh_handle(1, Mesh.create_plane("pane", size=2.0))
    r.register_material_handle(1, Material(color=(0.85, 0.3, 0.2, 1.0),
                                           roughness=0.4))
    r.register_material_handle(2, Material(color=(0.4, 0.7, 1.0, 0.35),
                                           roughness=0.1))
    cube = np.eye(4, dtype=np.float32)
    cube[:3, 3] = [0, 0, -1.5]
    pane = (
        maths.mat4_translation([0, 0, 1.2])
        @ maths.mat4_from_quat(
            maths.quat_from_axis_angle([1, 0, 0], np.pi / 2)
        )
    ).astype(np.float32)
    r.submit_render_commands([
        RenderCommand(mesh=0, transform=cube, material=1),
        RenderCommand(mesh=1, transform=pane, material=2),
    ])
    r.add_point_light([2, 2, 2], color=(1, 0.9, 0.7), intensity=4, radius=12)
    r.add_spot_light([-2, 2, 3], direction=[0.5, -0.5, -1],
                     color=(0.4, 0.6, 1.0), intensity=6, radius=15,
                     inner_cone_angle=0.3, outer_cone_angle=0.6)
    cam = Camera.new([1.5, 1.2, 5.0], [0, 0, 0], SIZE[0] / SIZE[1])
    r.render_frame(cam.view_matrix(), cam.projection_matrix(), cam.position)
    return surface


def scene_aniso16(device) -> HeadlessSurface:
    """A checkered ground plane seen at a grazing angle with 16x
    anisotropy: the footprint is about 16:1 along v, where the taps keep
    the checker rows that trilinear filtering blurs."""
    surface = HeadlessSurface(*SIZE)
    r = Renderer(
        surface,
        RendererConfig(tile_h=8, tile_w=64, max_tris_per_tile=32,
                       shadows_enabled=False, max_anisotropy=16),
        device=device,
    )
    mesh = Mesh.create_plane("Ground", size=24.0)
    mesh.texture_data = TextureData.checkerboard(size=256, cell=8)
    r.set_mesh(mesh)
    r.set_material(Material(color=(1.0, 1.0, 1.0, 1.0), roughness=0.8))
    cam = Camera.new([0.0, 0.35, 6.0], [0, 0.0, -6.0], SIZE[0] / SIZE[1])
    r.render_frame(cam.view_matrix(), cam.projection_matrix(), cam.position)
    return surface


SCENES = {
    "cube_pbr": scene_cube_pbr,
    "flat_cube": scene_flat_cube,
    "full_frame": scene_full_frame,
    "textured": scene_textured,
    "glass_and_lights": scene_glass_and_lights,
    "k_layer_stack": scene_k_layer_stack,
    "aniso16": scene_aniso16,
}
