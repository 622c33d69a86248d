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
- Animated: bench.py's `--animate`, the standard frame with every cube
  spinning about Y at its own phase (`animated_models`, or its TRS form
  `animated_models_trs` for `update_transforms_trs`) under an orbiting
  camera (`orbit_camera`); `animate=True` returns bench.py's `anim` dict in
  place of the extent. The shadow map re-renders every frame.

In every variant the random sequence, and every other material, is the
standard frame's.

The mega frame (`build_mega_renderer`) is bench.py's `--mega`: a
1,002,528-triangle displaced sphere (`build_sphere_grid(709)`, a copy of
examples/08_million_tris.py's) drawn through `set_mesh` with 32x128 tiles,
tile caps of 8192 and the "nearest" drop policy; above 32768 padded
triangles the frame bins in two levels.

The scenes of examples 06 and 07, at the examples' own sizes:

- Instancing (`build_instancing_renderer`): 65,536 cubes scaled 0.35 on a
  40-wide grid, batched by the InstancingManager, 1920x1080, 8x128 tiles
  with a cap of 2048, Hi-Z occlusion culling on, shadows as the default
  config has them; 786,432 triangles, so two-level binning.
- LOD (`build_lod_renderer`): 400 spheres (48x32 segments) with two
  coarser levels (20x14 below 2% coverage, 8x6 below 0.3%), 1080p, a tile
  cap of 1024, seen from `lod_camera(15)` and `lod_camera(30)`.
- IBL (`build_ibl_renderer`): a 5x5 grid of spheres sweeping metallic
  (columns) and roughness (rows) under `sky_environment`, 640x400, HDR on,
  shadows off, a tile cap of 2048.

Example 02's scene (`build_cube_example`, `cube_example_camera`): a red
metallic cube under a camera orbiting at radius 5, 640x480, a 1024^2
shadow map, as examples/02_cube.py draws it.

The multi-device and chunked examples: `example_scene` is the port's copy
of __graft_entry__._example_scene (the frame functions' inputs: scene
buffers and uniforms on a device, with a texture pool and two lights when
rich); `example05_config` is examples/05_multichip.py's frame, and
`example09_config`, `example09_uniforms` and `example09_taa` are
examples/09_animation_farm.py's orbit with TAA; `build_mega_instancing_
renderer` is examples/10_mega_instancing.py's default scene (10,000
instances of a 98x49 UV sphere, 96,040,000 triangles, 312 draws a chunk,
8x128 tiles with K=2048, "nearest", no shadows, 1920x1080).

The `fill_*` helpers take either package's core and RenderCommand, so the
reference renderer can draw the same scene in a test.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import core as port_core
from ..core import Camera, Material, maths
from . import instancing
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
    draws, anim = _bench_grid(n_objects, glass, textured, cutoff)
    return draws, anim["extent"]


def _bench_grid(n_objects, glass=False, textured=False, cutoff=CUTOUT_ALPHA):
    """-> (bench_draws' draws, bench.py's anim dict: the cubes' positions
    and scales, a spin phase each from the same generator, the extent)."""
    rng = np.random.default_rng(7)
    side = int(round(n_objects ** (1 / 3)))
    while side**3 < n_objects:
        side += 1
    draws = []
    positions = np.zeros((n_objects, 3), np.float32)
    scales = np.zeros(n_objects, np.float32)
    for i in range(n_objects):
        z, rem = divmod(i, side * side)
        y, x = divmod(rem, side)
        pos = (np.array([x, y, z], np.float32) - (side - 1) / 2) * 3.0
        scale = 0.4 + 0.4 * rng.random()
        positions[i], scales[i] = pos, scale
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
    extent = side * 3.0
    anim = {"positions": positions, "scales": scales,
            "phases": rng.random(n_objects).astype(np.float32) * 6.2832,
            "extent": extent}
    return draws, anim


def animated_models(anim, t):
    """(N, 4, 4) model matrices at time t: every cube spins about Y at its
    own phase (bench.py:animated_models)."""
    n = anim["positions"].shape[0]
    a = anim["phases"] + np.float32(t)
    c, s = np.cos(a), np.sin(a)
    sc = anim["scales"]
    m = np.zeros((n, 4, 4), np.float32)
    m[:, 0, 0] = c * sc
    m[:, 0, 2] = s * sc
    m[:, 1, 1] = sc
    m[:, 2, 0] = -s * sc
    m[:, 2, 2] = c * sc
    m[:, 3, 3] = 1.0
    m[:, :3, 3] = anim["positions"]
    return m


def animated_models_trs(anim, t):
    """The same animation as translations, xyzw quaternions and uniform
    scales for update_transforms_trs: a spin by a about Y is the quaternion
    (0, sin(a/2), 0, cos(a/2)) (bench.py:animated_models_trs)."""
    a = (anim["phases"] + np.float32(t)) * np.float32(0.5)
    n = anim["positions"].shape[0]
    q = np.zeros((n, 4), np.float32)
    q[:, 1] = np.sin(a)
    q[:, 3] = np.cos(a)
    return anim["positions"], q, anim["scales"]


def orbit_camera(cam, extent, t):
    """Move `cam` on its orbit to time t; -> its view matrix
    (bench.py:orbit_camera)."""
    ang = 0.02 * t
    cam.position = np.array(
        [extent * 1.1 * np.cos(ang) - extent * 1.3 * np.sin(ang),
         extent * 0.8,
         extent * 1.1 * np.sin(ang) + extent * 1.3 * np.cos(ang)],
        np.float32,
    )
    return cam.view_matrix()


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
                         animate=False, occlusion=False, **cfg_overrides):
    """-> (renderer, surface, camera, extent) for an n_objects cube grid;
    glass=True draws the glass standard frame, textured=True the textured
    one (`cutoff` is its cutout draws' alpha_cutoff), lights=N adds
    bench.py's N point lights, and rich=True builds the rich frame (HDR
    post, TAA, cascaded shadow maps, RICH_LIGHTS lights unless given).
    animate=True returns bench.py's anim dict (positions, scales, phases,
    extent) in place of the extent, for animated_models[_trs] and
    orbit_camera. occlusion=True switches on Hi-Z occlusion culling;
    shade_dtype="bf16" (a RendererConfig keyword) is bench.py's --bf16."""
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
    draws, anim = _bench_grid(n_objects, glass, textured, cutoff)
    extent = anim["extent"]
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
    r.set_occlusion_culling(occlusion)
    for pos, color in bench_lights(lights):
        r.add_point_light(pos, color=color, intensity=2.0, radius=6.0)
    return (r, surface, bench_camera(width, height, extent),
            anim if animate else extent)


MEGA_GRID = 709  # build_sphere_grid(709): 1,002,528 triangles


def build_sphere_grid(n: int, core=port_core):
    """An n x n displaced sphere grid, 2 (n - 1)^2 triangles, built with
    `core`'s Mesh and VertexArrays (a copy of
    examples/08_million_tris.py:build_sphere_grid; seed 1)."""
    rng = np.random.default_rng(1)
    theta = np.linspace(0.25, np.pi - 0.25, n, dtype=np.float32)
    phi = np.linspace(0.0, 2 * np.pi, n, dtype=np.float32)
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    r = 1.0 + 0.05 * rng.standard_normal((n, n)).astype(np.float32)
    pos = np.stack(
        [r * np.sin(tt) * np.cos(pp), r * np.cos(tt),
         r * np.sin(tt) * np.sin(pp)], axis=-1,
    ).reshape(-1, 3)
    ii, jj = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="ij")
    v00 = (ii * n + jj).reshape(-1)
    v01, v10 = v00 + 1, v00 + n
    v11 = v10 + 1
    idx = np.stack(
        [np.stack([v00, v10, v01], 1), np.stack([v01, v10, v11], 1)], axis=1
    ).reshape(-1, 3).astype(np.uint32)
    nrm = pos / np.linalg.norm(pos, axis=1, keepdims=True)
    nv = pos.shape[0]
    return core.Mesh(
        name="mega",
        vertices=core.VertexArrays(
            position=pos, normal=nrm,
            uv=np.zeros((nv, 2), np.float32),
            color=np.ones((nv, 3), np.float32),
            tangent=np.tile(np.array([1, 0, 0, 1], np.float32), (nv, 1)),
        ),
        indices=idx.reshape(-1),
    )


def mega_config(**cfg_overrides) -> dict:
    """RendererConfig keyword arguments of the mega frame (bench.py:162-167):
    at about one triangle a pixel the silhouette stacks thousands of
    sub-pixel triangles into one tile, so 32x128 tiles with caps of 8192,
    and an overflowing tile drops its farthest triangles."""
    cfg = dict(max_tris_per_tile=8192, shadow_max_tris_per_tile=8192,
               binning_policy="nearest", tile_h=32, tile_w=128)
    cfg.update(cfg_overrides)
    return cfg


def mega_material(core=port_core):
    return core.Material(color=(0.7, 0.6, 0.5, 1.0), roughness=0.35)


def mega_camera(width: int, height: int, core=port_core):
    return core.Camera.new([0, 0.4, 2.9], [0, 0, 0], width / height)


def build_mega_renderer(width, height, device, grid=MEGA_GRID,
                        **cfg_overrides):
    """-> (renderer, surface, camera, triangle count) of bench.py's mega
    frame (build_mega_renderer): the sphere grid through set_mesh."""
    mesh = build_sphere_grid(grid)
    surface = HeadlessSurface(width, height)
    r = Renderer(surface, RendererConfig(**mega_config(**cfg_overrides)),
                 device=device)
    r.set_mesh(mesh)
    r.set_material(mega_material())
    return r, surface, mega_camera(width, height), mesh.num_triangles


INSTANCES = 65536  # MAX_INSTANCES_PER_BATCH
INSTANCE_SIDE = 40  # 40^3 = 64,000 on the grid; the rest stack above


def instancing_manager(n=INSTANCES, module=instancing):
    """Example 07's batch: n cubes scaled 0.35 at 1.2 spacing on a 40x40
    layered grid, mesh handle 0 and material handle 1, in `module`'s
    InstancingManager (this package's, or the reference's)."""
    side = INSTANCE_SIDE
    mgr = module.InstancingManager()
    base = np.eye(4, dtype=np.float32)
    base[:3, :3] *= 0.35
    for i in range(n):
        m = base.copy()
        z, rem = divmod(i, side * side)
        y, x = divmod(rem, side)
        m[:3, 3] = [(x - side / 2) * 1.2, (y - side / 2) * 1.2,
                    (z - side / 2) * 1.2]
        if not mgr.add_instance(0, 1, module.InstanceData(model=m)):
            raise ValueError(f"instance {i} over the batch limit")
    return mgr


def instancing_config(**cfg_overrides) -> dict:
    """Example 07's RendererConfig keywords: small tiles for sub-tile
    instances, and a tile cap of 2048."""
    return {"tile_h": 8, "max_tris_per_tile": 2048, **cfg_overrides}


def instancing_camera(width, height):
    ext = INSTANCE_SIDE * 1.2
    cam = Camera.new([ext, ext * 0.8, ext * 1.4], [0, 0, 0], width / height)
    cam.far = ext * 6
    return cam


def fill_instancing_scene(r, mgr, core=port_core):
    """Register example 07's cube and material on r and submit mgr."""
    r.register_mesh_handle(0, core.Mesh.create_cube())
    r.register_material_handle(1, core.Material(color=(0.75, 0.3, 0.2, 1.0),
                                                roughness=0.4))
    mgr.to_draw_items(r)


def build_instancing_renderer(width, height, device, n=INSTANCES,
                              occlusion=True, mgr=None, **cfg_overrides):
    """-> (renderer, surface, camera, seconds the InstancingManager took)
    of example 07's instancing frame; `mgr` reuses a batch already built
    (0 seconds)."""
    t0 = time.perf_counter()
    if mgr is None:
        mgr = instancing_manager(n)
    host_s = time.perf_counter() - t0
    surface = HeadlessSurface(width, height)
    r = Renderer(surface, RendererConfig(**instancing_config(**cfg_overrides)),
                 device=device)
    r.set_occlusion_culling(occlusion)
    fill_instancing_scene(r, mgr)
    return r, surface, instancing_camera(width, height), host_s


LOD_SPHERES = 400


def lod_ball(core=port_core):
    """Example 07's sphere with its 3-level chain."""
    ball = core.Mesh.create_sphere("ball", segments=48, rings=32)
    ball.add_lod(core.Mesh.create_sphere("l1", segments=20, rings=14), 0.02)
    ball.add_lod(core.Mesh.create_sphere("l2", segments=8, rings=6), 0.003)
    return ball


def fill_lod_scene(r, core=port_core, command=RenderCommand, n=LOD_SPHERES):
    """Example 07's LOD scene on r: n spheres on a 20-wide, 3-spaced grid."""
    r.register_mesh_handle(0, lod_ball(core))
    r.register_material_handle(1, core.Material(color=(0.2, 0.5, 0.8, 1.0)))
    cmds = []
    for i in range(n):
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = [(i % 20 - 10) * 3.0, 0, (i // 20 - 10) * 3.0]
        cmds.append(command(mesh=0, transform=m, material=1))
    r.submit_render_commands(cmds)


def lod_camera(dist, width, height):
    """Example 07's LOD camera at distance `dist` (15 near, 30 far)."""
    cam = Camera.new([0, dist * 0.5, dist], [0, 0, 0], width / height)
    cam.far = 600.0
    return cam


def lod_config(**cfg_overrides) -> dict:
    return {"max_tris_per_tile": 1024, **cfg_overrides}


def build_lod_renderer(width, height, device, n=LOD_SPHERES,
                       **cfg_overrides):
    """-> (renderer, surface) of example 07's LOD scene."""
    surface = HeadlessSurface(width, height)
    r = Renderer(surface, RendererConfig(**lod_config(**cfg_overrides)),
                 device=device)
    fill_lod_scene(r, n=n)
    return r, surface


IBL_GRID = 5


def sky_environment(h=64, w=128) -> np.ndarray:
    """Example 06's equirect sky: a blue gradient over a brown ground, and a
    sun of radiance 10."""
    env = np.zeros((h, w, 3), np.float32)
    v = np.linspace(0, 1, h)[:, None, None]
    env[:] = np.where(
        v < 0.5,
        np.array([0.25, 0.45, 1.1]) * (1.2 - v),
        np.array([0.4, 0.32, 0.22]) * np.ones_like(v),
    )
    env[6:12, 18:30] = [10.0, 9.0, 7.0]
    return env


def ibl_config(**cfg_overrides) -> dict:
    return {"shadows_enabled": False, "max_tris_per_tile": 2048,
            **cfg_overrides}


def fill_ibl_scene(r, core=port_core, command=RenderCommand, segments=32,
                   rings=16, environment=True):
    """Example 06's scene on r: the sphere grid, metallic i/4 by column and
    roughness max(j/4, 0.05) by row, the sky (unless environment=False)
    and HDR."""
    r.register_mesh_handle(0, core.Mesh.create_sphere(segments=segments,
                                                      rings=rings))
    n = IBL_GRID
    commands = []
    for i in range(n):
        for j in range(n):
            m = np.eye(4, dtype=np.float32)
            m[:3, :3] *= 0.8
            m[:3, 3] = [(i - (n - 1) / 2) * 2.1, ((n - 1) / 2 - j) * 2.1, 0]
            mid = i * n + j + 1
            r.register_material_handle(mid, core.Material(
                color=(0.9, 0.6, 0.3, 1.0), metallic=i / (n - 1),
                roughness=max(j / (n - 1), 0.05)))
            commands.append(command(mesh=0, transform=m, material=mid))
    r.submit_render_commands(commands)
    if environment:
        r.set_environment_map(sky_environment())
    r.initialize_hdr()


def ibl_camera(width, height):
    return Camera.new([0, 0, 13.5], [0, 0, 0], width / height)


def build_ibl_renderer(width, height, device, environment=True,
                       **cfg_overrides):
    """-> (renderer, surface, camera) of example 06's frame."""
    surface = HeadlessSurface(width, height)
    r = Renderer(surface, RendererConfig(**ibl_config(**cfg_overrides)),
                 device=device)
    fill_ibl_scene(r, environment=environment)
    return r, surface, ibl_camera(width, height)


def build_cube_example(device, width=640, height=480, surface=None):
    """-> (renderer, surface) of examples/02_cube.py's scene: one cube,
    colour (0.8, 0.2, 0.2), metallic and roughness 0.5, a 1024^2 shadow
    map; on a HeadlessSurface unless `surface` is given."""
    if surface is None:
        surface = HeadlessSurface(width, height)
    r = Renderer(surface, RendererConfig(shadow_resolution=1024),
                 device=device)
    r.set_mesh(port_core.Mesh.create_cube())
    r.set_material(Material(color=(0.8, 0.2, 0.2, 1.0), metallic=0.5,
                            roughness=0.5))
    return r, surface


def cube_example_camera(i, width=640, height=480):
    """(view, proj, camera_pos) of examples/02_cube.py's frame i: radius 5,
    height 2, t = i / 30, a 45 degree lens with the Vulkan Y flip."""
    t = i / 30.0
    pos = np.array([5.0 * np.sin(t), 2.0, 5.0 * np.cos(t)], np.float32)
    view = maths.look_at_rh(pos, [0, 0, 0], [0, 1, 0])
    proj = maths.perspective_rh(np.deg2rad(45), width / height, 0.5, 100.0)
    proj[1, 1] *= -1.0
    return view, proj, pos


def example_scene(n_cubes: int = 8, rich: bool = False, lod: bool = False,
                  device="cuda"):
    """The port's copy of __graft_entry__._example_scene (seed 3, the same
    cubes, camera 4:3 at (6, 4, 8), light and materials), built from this
    package on `device` -> (SceneBuffers, FrameUniforms) for the frame
    functions; rich=True adds a texture pool and two Forward+ point lights,
    every even draw textured with a 16x16 checker and draw 1 at alpha 0.5,
    two CSM cascades, and returns (scene, uniforms, {"pool", "lights"}).
    lod=True makes every third draw a 16x12 sphere with two coarser levels
    (8x6 below 5% coverage, 5x4 below 1%)."""
    from ..core.texture import TextureData
    from ..core.uniform import MaterialUniform
    from .bindless import BindlessTextureManager
    from .features import GpuLight, PointLight
    from .frame import FrameUniforms
    from .scene import DrawItem, build_models, build_scene
    from .shadow_map import directional_light_matrix

    meshes = {"Cube": port_core.Mesh.create_cube()}
    if lod:
        ball = port_core.Mesh.create_sphere("Ball", segments=16, rings=12)
        ball.add_lod(port_core.Mesh.create_sphere("Ball_l1", segments=8,
                                                  rings=6), 0.05)
        ball.add_lod(port_core.Mesh.create_sphere("Ball_l2", segments=5,
                                                  rings=4), 0.01)
        meshes["Ball"] = ball
    rng = np.random.default_rng(3)
    extras, tex_index = {}, -1
    if rich:
        mgr = BindlessTextureManager(device=device)
        checker = np.zeros((16, 16, 4), np.uint8)
        yy, xx = np.mgrid[0:16, 0:16]
        checker[..., 0] = ((yy // 4 + xx // 4) % 2) * 255
        checker[..., 1] = 128
        checker[..., 2] = 255 - checker[..., 0]
        checker[..., 3] = 255
        tex_index = mgr.add_sampled_image(TextureData(16, 16, checker))
        extras["pool"] = mgr.pool()
        extras["lights"] = torch.from_numpy(np.stack([
            GpuLight.from_point_light(PointLight(
                position=np.array(p, np.float32), intensity=3.0, radius=8.0,
                color=np.array(c, np.float32))).flat()
            for p, c in (((2.0, 2.0, 2.0), (1, 0.3, 0.2)),
                         ((-2.0, 1.0, -1.0), (0.2, 0.4, 1.0)))
        ]).astype(np.float32)).to(device)
    items = []
    for i in range(n_cubes):
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = (rng.random(3) - 0.5) * 8.0
        m[:3, :3] *= 0.6
        mu = MaterialUniform.default()
        alpha = 0.5 if (rich and i == 1) else 1.0
        mu.base_color_factor = np.array([*rng.random(3), alpha], np.float32)
        if rich and i % 2 == 0:
            mu.base_color_index = tex_index
        key = "Ball" if (lod and i % 3 == 0) else "Cube"
        items.append(DrawItem(mesh_key=key, model=m, material=mu))
    built = build_scene(items, meshes, device)
    models = build_models(items, built.buffers.num_draws)
    cam = Camera.new([6.0, 4.0, 8.0], [0, 0, 0], 4 / 3)
    view, proj = cam.view_matrix(), cam.projection_matrix()
    ld = np.array([-0.35, -1.0, -0.25], np.float32)
    host = dict(
        view_proj=(proj @ view).astype(np.float32),
        camera_pos=np.asarray(cam.position, np.float32),
        light_direction=(ld / np.linalg.norm(ld)).astype(np.float32),
        light_color=np.full(3, 1.5, np.float32),
        ambient_color=np.full(3, 0.35, np.float32),
        light_space_matrix=directional_light_matrix(ld, [0, 0, 0], 10.0),
        models=models,
        view=view.astype(np.float32),
        projection=proj.astype(np.float32),
    )
    if rich:
        host["cascade_matrices"] = np.stack([
            directional_light_matrix(ld, [0, 0, 0], 6.0),
            directional_light_matrix(ld, [0, 0, 0], 12.0),
        ]).astype(np.float32)
        host["cascade_splits"] = np.array([6.0, 30.0, 0.0, 0.0], np.float32)
    uni = FrameUniforms(**{k: torch.from_numpy(np.asarray(v, np.float32))
                           .to(device) for k, v in host.items()})
    if rich:
        return built.buffers, uni, extras
    return built.buffers, uni


def example05_config(n_devices: int):
    """examples/05_multichip.py's FrameConfig for an n-band mesh: 512 x
    max(16 n, 384), 16x128 tiles with K=64, a shadow map of whole 16-row
    tiles per band; its scene is example_scene(n_cubes=12)."""
    from .frame import FrameConfig

    n = n_devices
    return FrameConfig(
        width=512, height=max(16 * n, 384), tile_h=16, tile_w=128,
        max_tris_per_tile=64,
        shadow_resolution=16 * n * max(1, 256 // (16 * n)),
        shadow_tile=16, shadow_max_tris_per_tile=64,
    )


def example09_config():
    """examples/09_animation_farm.py's FrameConfig: 256x192, 16x128 tiles
    with K=64, a 256^2 shadow map, HDR post with 3 bloom mips, TAA."""
    from .frame import FrameConfig

    return FrameConfig(
        width=256, height=192, tile_h=16, tile_w=128, max_tris_per_tile=64,
        shadow_resolution=256, shadow_tile=64, shadow_max_tris_per_tile=64,
        post_enabled=True, bloom_mips=3, reinhard=False, taa_enabled=True,
    )


def example09_uniforms(uni0, frame_idx: int, total: int, width=256,
                       height=192):
    """Frame `frame_idx` of example 09's orbit of `total` frames (radius 8,
    height 4) as uniforms over example_scene(n_cubes=12)'s, on their
    device."""
    th = 2 * np.pi * frame_idx / total
    pos = np.array([8 * np.cos(th), 4.0, 8 * np.sin(th) + 1e-4], np.float32)
    cam = Camera.new(pos, [0, 0, 0], width / height)
    view, proj = cam.view_matrix(), cam.projection_matrix()

    def dev(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(
            uni0.models.device)

    return uni0._replace(view_proj=dev(proj @ view), camera_pos=dev(pos),
                         view=dev(view), projection=dev(proj))


def example09_taa(frame_idx: int):
    """Example 09's TaaParams of frame `frame_idx`: history weight 0.9 (0 on
    the first frame), colour clamp on, velocity rejection off, no jitter."""
    from ..ops.taa import TaaParams

    return TaaParams(
        blend_factor=np.float32(0.0 if frame_idx == 0 else 0.9),
        color_clamp=np.float32(1.0), velocity_rejection=np.float32(0.0),
        jitter=np.zeros(2, np.float32), prev_jitter=np.zeros(2, np.float32))


# examples/10_mega_instancing.py's default scene.
MEGA_INSTANCES = 10_000
MEGA_SPHERE = (98, 49)  # segments, rings: 4,950 vertices, 9,604 triangles


def mega_instancing_config(tris_per_mesh: int, **cfg_overrides) -> dict:
    """Example 10's RendererConfig keywords: 8x128 tiles, K=2048, no
    shadows, the "nearest" drop policy, and about 3M triangles a chunk."""
    return {**dict(tile_h=8, max_tris_per_tile=2048, shadows_enabled=False,
                   max_draws_per_chunk=max(1, int(3e6 / tris_per_mesh)),
                   binning_policy="nearest"), **cfg_overrides}


def mega_instancing_commands(n: int = MEGA_INSTANCES):
    """-> (commands, extent): example 10's instances on a cube grid of side
    ceil(n^(1/3)), spaced 1.3 and scaled 0.45, mesh handle 0, material 1."""
    side = int(round(n ** (1 / 3)))
    while side**3 < n:
        side += 1
    base = np.eye(4, dtype=np.float32)
    base[:3, :3] *= 0.45
    cmds = []
    for i in range(n):
        m = base.copy()
        z, rem = divmod(i, side * side)
        y, x = divmod(rem, side)
        m[:3, 3] = [(x - side / 2) * 1.3, (y - side / 2) * 1.3,
                    (z - side / 2) * 1.3]
        cmds.append(RenderCommand(mesh=0, transform=m, material=1))
    return cmds, side * 1.3


def build_mega_instancing_renderer(width, height, device, n=MEGA_INSTANCES,
                                   **cfg_overrides):
    """-> (renderer, surface, camera, triangles) of example 10's default
    frame: n instances of the 98x49 UV sphere through the chunked path
    (312 draws a chunk: 33 chunks at n = 10,000)."""
    mesh = port_core.Mesh.create_sphere("heavy", segments=MEGA_SPHERE[0],
                                        rings=MEGA_SPHERE[1])
    tris = len(mesh.indices) // 3
    surface = HeadlessSurface(width, height)
    r = Renderer(surface, RendererConfig(
        **mega_instancing_config(tris, **cfg_overrides)), device=device)
    r.register_mesh_handle(0, mesh)
    r.register_material_handle(1, Material(color=(0.3, 0.55, 0.8, 1.0),
                                           roughness=0.5))
    cmds, extent = mega_instancing_commands(n)
    r.submit_render_commands(cmds)
    cam = Camera.new([extent, extent * 0.8, extent * 1.4], [0, 0, 0],
                     width / height)
    cam.far = extent * 6
    return r, surface, cam, n * tris
