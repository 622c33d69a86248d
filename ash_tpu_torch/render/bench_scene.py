"""The standard frame's scene: 1000 instanced PBR cubes, one directional
light with a shadow map, frustum culling; and its glass, textured, lit and
rich variants.

The same recipe as bench.py:build_bench_renderer (seed 7, the same grid,
scales, materials, shadow bounds and camera), rebuilt on this package so a
run of the port needs no jax. Heights below 512 use the reference's small
smoke config (8x32 tiles, 256^2 shadow map).

- Glass: every fourth draw (i % 4 == 0) has base colour alpha 0.5, so the
  frame blends through a 4-layer depth peel.
- Textured: four cube meshes, draw i using mesh i % 4, each carrying all
  five maps at 256x256 made from a seed (`bench_texture_maps`). Mesh 1's
  base colour alpha is a 0/255 checker and its draws have alpha_cutoff
  0.5, which switches on the alpha test in the main and the shadow pass.
  Anisotropy stays at the renderer's default of 16.
- Lit: the standard frame plus bench.py's `--lights N` point lights (seed
  11, positions in [-10, 10)^3, random colours, intensity 2, radius 6).
- Rich: bench.py's `--rich`, the path a maxed-out application runs: the HDR
  post chain with bloom and ACES, TAA, a 3-cascade shadow map with a tile
  cap of 512 in place of the single map, and the 32 point lights. The
  cascades are 1024^2 (256^2 in the small config).

In every variant the random sequence, and every other material, is the
standard frame's.
"""

from __future__ import annotations

import numpy as np

from .. import core as port_core
from ..core import Camera, Material
from .csm import CsmConfig
from .renderer import RenderCommand, Renderer, RendererConfig
from .surface import HeadlessSurface

GLASS_EVERY = 4  # draws i with i % GLASS_EVERY == 0 are glass
GLASS_ALPHA = 0.5
GLASS_LAYERS = 4
TEXTURED_MESHES = 4  # draw i uses textured mesh i % TEXTURED_MESHES
CUTOUT_MESH = 1  # the mesh whose albedo alpha is a 0/255 checker
CUTOUT_ALPHA = 0.5  # alpha_cutoff of the cutout mesh's draws
RICH_LIGHTS = 32
TEXTURE_SIZE = 256
# (Mesh attribute, sRGB) of the five maps, in bench_texture_maps' order.
MAPS = (
    ("texture_data", True),
    ("normal_texture_data", False),
    ("metallic_roughness_texture_data", False),
    ("occlusion_texture_data", False),
    ("emissive_texture_data", True),
)


def bench_draws(n_objects: int, glass: bool = False, textured: bool = False,
                cutoff: float = CUTOUT_ALPHA):
    """-> ([(model (4, 4) f32, Material)], extent): the cube grid's draws,
    built from numpy and this package's core only; the reference renderer
    draws the same list rebuilt with ash_tpu.core's classes. With
    `textured`, draw i uses mesh i % TEXTURED_MESHES, and the cutout mesh's
    draws get alpha_cutoff `cutoff` (0 = no alpha test)."""
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
        cutout = textured and i % TEXTURED_MESHES == CUTOUT_MESH
        mat = Material(
            color=(float(0.3 + 0.7 * rng.random()),
                   float(0.3 + 0.7 * rng.random()),
                   float(0.3 + 0.7 * rng.random()), alpha),
            metallic=float(rng.random()),
            roughness=float(0.2 + 0.8 * rng.random()),
            alpha_cutoff=cutoff if cutout else 0.0,
        )
        draws.append((m, mat))
    return draws, side * 3.0


def bench_texture_maps(size: int = TEXTURE_SIZE):
    """-> [[(H, W, 4) uint8 pixels of each map in MAPS order]] for the
    TEXTURED_MESHES meshes, from np.random.default_rng(13): a checkerboard
    albedo with a different cell on each mesh (its alpha a 0/255 checker on
    CUTOUT_MESH), a normal map of a sine height field, metallic-roughness
    noise in 32-px cells, an occlusion gradient, and an emissive map that
    is black but for a few 16-px cells."""
    rng = np.random.default_rng(13)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    meshes = []
    for m in range(TEXTURED_MESHES):
        cell = (8, 16, 32, 64)[m]
        checker = ((yy // cell + xx // cell) % 2).astype(bool)
        c0, c1 = rng.integers(40, 240, (2, 3))
        albedo = np.full((size, size, 4), 255, np.uint8)
        albedo[..., :3] = np.where(checker[..., None], c1, c0)
        if m == CUTOUT_MESH:
            albedo[..., 3] = np.where(checker, 255, 0)

        period = float(rng.choice([32, 64, 128]))
        k = 2.0 * np.pi / period
        amp = 0.5 / k  # slopes up to 0.5
        dhdx = amp * k * np.cos(k * xx) * np.sin(k * yy)
        dhdy = amp * k * np.sin(k * xx) * np.cos(k * yy)
        n = np.stack([-dhdx, -dhdy, np.ones_like(dhdx)], -1)
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        normal = np.full((size, size, 4), 255, np.uint8)
        normal[..., :3] = np.round((n * 0.5 + 0.5) * 255.0).astype(np.uint8)

        cells = size // 32
        noise = rng.random((cells, cells, 2))
        noise = np.kron(noise, np.ones((32, 32, 1)))
        mr = np.full((size, size, 4), 255, np.uint8)
        mr[..., 0] = 0
        mr[..., 1] = np.round((0.2 + 0.8 * noise[..., 0]) * 255.0)  # roughness
        mr[..., 2] = np.round(noise[..., 1] * 255.0)  # metallic

        occ = np.full((size, size, 4), 255, np.uint8)
        occ[..., :3] = np.round(128.0 + 127.0 * yy / (size - 1))[..., None]

        lit = np.kron(rng.random((size // 16, size // 16)) < 0.05,
                      np.ones((16, 16))).astype(bool)
        glow = np.kron(rng.integers(0, 256, (size // 16, size // 16, 3)),
                       np.ones((16, 16, 1)))
        emissive = np.zeros((size, size, 4), np.uint8)
        emissive[..., :3] = np.where(lit[..., None], glow, 0)
        emissive[..., 3] = 255
        meshes.append([albedo, normal, mr, occ, emissive])
    return meshes


def bench_meshes(core=port_core):
    """The textured frame's TEXTURED_MESHES cube meshes, each with its five
    maps, built with `core`'s Mesh and TextureData (this package's, or the
    reference's for a side-by-side render). Each renderer needs meshes of
    its own: registration writes the pool indices into the Mesh."""
    meshes = []
    for m, maps in enumerate(bench_texture_maps()):
        mesh = core.Mesh.create_named_cube(f"bench_cube_{m}")
        for (attr, srgb), px in zip(MAPS, maps):
            setattr(mesh, attr, core.TextureData(px.shape[1], px.shape[0],
                                                 px, srgb=srgb))
        meshes.append(mesh)
    return meshes


def bench_lights(n: int):
    """bench.py's `--lights n`: [(position, colour)], intensity 2, radius 6."""
    rng = np.random.default_rng(11)
    lights = []
    for _ in range(n):
        pos = (rng.random(3) * 20 - 10).tolist()
        lights.append((pos, rng.random(3).tolist()))
    return lights


def rich_overrides(height: int) -> dict:
    """The rich frame's config beyond the standard frame's, less the csm:
    {"csm": (cascade_count, resolution), ...}. The nearest cascade gathers
    the scene into fewer texels than the single map does, hence the cap."""
    return dict(csm=(3, 1024 if height >= 512 else 256),
                shadow_max_tris_per_tile=512)


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
                         shadow_resolution=2048, glass=False, textured=False,
                         lights=0, cutoff=CUTOUT_ALPHA, rich=False,
                         **cfg_overrides):
    """-> (renderer, surface, camera, extent) for an n_objects cube grid;
    glass=True draws the glass standard frame, textured=True the textured
    one (`cutoff` is its cutout draws' alpha_cutoff), lights=N adds
    bench.py's N point lights, and rich=True builds the rich frame (HDR
    post, TAA, cascaded shadow maps, RICH_LIGHTS lights unless given)."""
    if rich:
        over = rich_overrides(height)
        over["csm"] = CsmConfig(cascade_count=over["csm"][0],
                                resolution=over["csm"][1])
        cfg_overrides = {**over, **cfg_overrides}
        lights = lights or RICH_LIGHTS
    surface = HeadlessSurface(width, height)
    cfg = RendererConfig(**bench_config(height, glass, shadow_resolution,
                                        **cfg_overrides))
    r = Renderer(surface, cfg, device=device)
    meshes = bench_meshes() if textured else [port_core.Mesh.create_cube()]
    for handle, mesh in enumerate(meshes):
        r.register_mesh_handle(handle, mesh)
    draws, extent = bench_draws(n_objects, glass, textured, cutoff)
    commands = []
    for i, (m, mat) in enumerate(draws):
        r.register_material_handle(i + 1, mat)
        commands.append(RenderCommand(mesh=i % len(meshes), transform=m,
                                      material=i + 1))
    r.submit_render_commands(commands)
    r.shadow_feature.set_scene_bounds([0, 0, 0], extent)
    if rich:
        r.initialize_hdr()
        r.set_taa_enabled(True)
    for pos, color in bench_lights(lights):
        r.add_point_light(pos, color=color, intensity=2.0, radius=6.0)
    return r, surface, bench_camera(width, height, extent), extent
