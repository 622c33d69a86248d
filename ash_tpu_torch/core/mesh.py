"""Mesh and vertex data — the geometry side of the scene API.

TPU-native re-design of reference src/renderer/resources/mesh.rs. The reference
keeps an AoS `Vertex{position, normal, uv, color, tangent}` (60 bytes,
mesh.rs:13-21) in Vulkan vertex buffers. Here vertex data is **SoA numpy
arrays** — the natural layout for TPU, where the vertex stage is a batched
matmul over contiguous (V, 3) position arrays (MXU) instead of a hardware
vertex fetch.

`create_cube` reproduces the reference cube exactly: 24 vertices / 36 indices,
per-face colors (red/green/blue/yellow/cyan/magenta) and tangents
(mesh.rs:149-373), so golden-frame comparisons line up. `create_sphere` /
`create_plane` are provided as extensions (the reference README advertises them
but the Rust code never implemented them — README.md:96-101).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from .material import MaterialProperties
from .texture import TextureData


@dataclasses.dataclass
class VertexArrays:
    """SoA vertex buffers: the TPU-native `Vertex` layout.

    position (V,3) f32, normal (V,3) f32, uv (V,2) f32, color (V,3) f32,
    tangent (V,4) f32 (xyz direction + w handedness) — same attributes and
    semantics as reference mesh.rs:13-21 / attribute layout mesh.rs:78-111.
    """

    position: np.ndarray
    normal: np.ndarray
    uv: np.ndarray
    color: np.ndarray
    tangent: np.ndarray

    def __post_init__(self):
        v = len(self.position)
        self.position = np.asarray(self.position, np.float32).reshape(v, 3)
        self.normal = np.asarray(self.normal, np.float32).reshape(v, 3)
        self.uv = np.asarray(self.uv, np.float32).reshape(v, 2)
        self.color = np.asarray(self.color, np.float32).reshape(v, 3)
        self.tangent = np.asarray(self.tangent, np.float32).reshape(v, 4)

    def __len__(self) -> int:
        return int(self.position.shape[0])

    @staticmethod
    def concatenate(parts: list["VertexArrays"]) -> "VertexArrays":
        return VertexArrays(
            position=np.concatenate([p.position for p in parts]),
            normal=np.concatenate([p.normal for p in parts]),
            uv=np.concatenate([p.uv for p in parts]),
            color=np.concatenate([p.color for p in parts]),
            tangent=np.concatenate([p.tangent for p in parts]),
        )


@dataclasses.dataclass
class Mesh:
    """A named mesh with optional PBR texture maps.

    Mirrors the reference `Mesh` (mesh.rs:114-145) minus the Vulkan buffer
    handles: upload happens when the renderer builds its packed scene arrays
    (see ash_tpu_torch.render.scene). The five texture slots and the bindless index
    fields match mesh.rs:119-142.
    """

    name: str
    vertices: VertexArrays
    indices: Optional[np.ndarray] = None  # (T*3,) uint32
    texture_data: Optional[TextureData] = None
    normal_texture_data: Optional[TextureData] = None
    metallic_roughness_texture_data: Optional[TextureData] = None
    occlusion_texture_data: Optional[TextureData] = None
    emissive_texture_data: Optional[TextureData] = None
    material_properties: Optional[MaterialProperties] = None

    # Bindless pool indices, assigned at registration (mesh.rs:138-142).
    texture_index: Optional[int] = None
    normal_texture_index: Optional[int] = None
    metallic_roughness_texture_index: Optional[int] = None
    occlusion_texture_index: Optional[int] = None
    emissive_texture_index: Optional[int] = None

    # LOD chain: lower-detail levels + the screen-coverage threshold below
    # which each kicks in (reference LodMesh/LodLevel, lod_system.rs:35-59;
    # selection semantics lod_system.rs:317-337). This mesh is level 0.
    lods: list = dataclasses.field(default_factory=list)  # [(Mesh, float)]

    def __post_init__(self):
        if self.indices is not None:
            self.indices = np.asarray(self.indices, np.uint32).reshape(-1)
        if self.material_properties is None:
            self.material_properties = MaterialProperties()

    def add_lod(self, mesh: "Mesh", screen_threshold: float) -> "Mesh":
        """Append a lower-detail level: used when the draw's projected
        screen coverage drops below `screen_threshold` (and stays above the
        next level's threshold). Thresholds must be added in decreasing
        order. Returns self for chaining."""
        if self.lods and screen_threshold >= self.lods[-1][1]:
            raise ValueError("LOD thresholds must decrease per level")
        self.lods.append((mesh, float(screen_threshold)))
        return self

    @property
    def triangle_indices(self) -> np.ndarray:
        """(T, 3) int32 triangle list (non-indexed meshes get an iota)."""
        if self.indices is not None:
            return self.indices.reshape(-1, 3).astype(np.int32)
        return np.arange(len(self.vertices), dtype=np.int32).reshape(-1, 3)

    @property
    def num_triangles(self) -> int:
        return int(self.triangle_indices.shape[0])

    def bounds(self) -> tuple[np.ndarray, np.ndarray]:
        """(center, half_extents) of the axis-aligned bounding box."""
        lo = self.vertices.position.min(axis=0)
        hi = self.vertices.position.max(axis=0)
        return ((lo + hi) * 0.5).astype(np.float32), ((hi - lo) * 0.5).astype(
            np.float32
        )

    # ------------------------------------------------------------------
    # Constructors
    # ------------------------------------------------------------------

    @staticmethod
    def create_cube() -> "Mesh":
        """Reference mesh.rs:149-151."""
        return Mesh.create_named_cube("Cube")

    @staticmethod
    def create_named_cube(name: str) -> "Mesh":
        """The reference's 24-vertex colored cube, bit-exact
        (mesh.rs:153-373): per-face normals/colors/tangents, uv quad
        (0,0)->(1,1), indices 0,1,2,2,3,0 per face."""
        # (normal, color, tangent, 4 corner positions in CCW uv order)
        faces = [
            # front (red)
            ((0, 0, 1), (1, 0, 0), (1, 0, 0, 1),
             [(-1, -1, 1), (1, -1, 1), (1, 1, 1), (-1, 1, 1)]),
            # back (green)
            ((0, 0, -1), (0, 1, 0), (-1, 0, 0, 1),
             [(1, -1, -1), (-1, -1, -1), (-1, 1, -1), (1, 1, -1)]),
            # top (blue)
            ((0, 1, 0), (0, 0, 1), (1, 0, 0, 1),
             [(-1, 1, 1), (1, 1, 1), (1, 1, -1), (-1, 1, -1)]),
            # bottom (yellow)
            ((0, -1, 0), (1, 1, 0), (1, 0, 0, 1),
             [(-1, -1, -1), (1, -1, -1), (1, -1, 1), (-1, -1, 1)]),
            # right (cyan)
            ((1, 0, 0), (0, 1, 1), (0, 0, -1, 1),
             [(1, -1, 1), (1, -1, -1), (1, 1, -1), (1, 1, 1)]),
            # left (magenta)
            ((-1, 0, 0), (1, 0, 1), (0, 0, 1, 1),
             [(-1, -1, -1), (-1, -1, 1), (-1, 1, 1), (-1, 1, -1)]),
        ]
        uvs = [(0, 0), (1, 0), (1, 1), (0, 1)]
        pos, nrm, uv, col, tan, idx = [], [], [], [], [], []
        for fi, (n, c, t, corners) in enumerate(faces):
            base = fi * 4
            for ci, p in enumerate(corners):
                pos.append(p)
                nrm.append(n)
                uv.append(uvs[ci])
                col.append(c)
                tan.append(t)
            idx += [base, base + 1, base + 2, base + 2, base + 3, base]
        return Mesh(
            name=name,
            vertices=VertexArrays(pos, nrm, uv, col, tan),
            indices=np.asarray(idx, np.uint32),
        )

    @staticmethod
    def create_plane(name: str = "Plane", size: float = 1.0) -> "Mesh":
        """XZ plane, +Y normal (extension; advertised by reference README)."""
        s = size
        pos = [(-s, 0, -s), (s, 0, -s), (s, 0, s), (-s, 0, s)]
        return Mesh(
            name=name,
            vertices=VertexArrays(
                position=pos,
                normal=[(0, 1, 0)] * 4,
                uv=[(0, 0), (1, 0), (1, 1), (0, 1)],
                color=[(1, 1, 1)] * 4,
                tangent=[(1, 0, 0, 1)] * 4,
            ),
            indices=np.asarray([0, 2, 1, 0, 3, 2], np.uint32),
        )

    @staticmethod
    def create_sphere(
        name: str = "Sphere", segments: int = 32, rings: int = 16, radius: float = 1.0
    ) -> "Mesh":
        """UV sphere (extension; advertised by reference README)."""
        phi = np.linspace(0.0, np.pi, rings + 1, dtype=np.float32)
        theta = np.linspace(0.0, 2 * np.pi, segments + 1, dtype=np.float32)
        pp, tt = np.meshgrid(phi, theta, indexing="ij")
        x = np.sin(pp) * np.cos(tt)
        y = np.cos(pp)
        z = np.sin(pp) * np.sin(tt)
        n = np.stack([x, y, z], axis=-1).reshape(-1, 3)
        pos = (n * radius).astype(np.float32)
        u = (tt / (2 * np.pi)).reshape(-1, 1)
        v = (pp / np.pi).reshape(-1, 1)
        # Tangent = d(pos)/d(theta), normalized; poles fall back to +X.
        tx = -np.sin(tt) * np.sin(pp)
        tz = np.cos(tt) * np.sin(pp)
        tanv = np.stack([tx, np.zeros_like(tx), tz], axis=-1).reshape(-1, 3)
        ln = np.linalg.norm(tanv, axis=-1, keepdims=True)
        tanv = np.where(ln > 1e-5, tanv / np.maximum(ln, 1e-8), [1.0, 0.0, 0.0])
        tangent = np.concatenate([tanv, np.ones((len(tanv), 1))], axis=-1)
        idx = []
        stride = segments + 1
        for r in range(rings):
            for s_ in range(segments):
                a = r * stride + s_
                b = a + stride
                # Outward-facing winding, matching the cube's convention
                # (front = CCW seen from outside). The previous order wound
                # inside-out: back-face culling kept the FAR hemisphere, so
                # lighting came from interpolated inward normals (caught by
                # tests/test_analytic_oracle.py's ray-traced oracle).
                idx += [a, a + 1, b, b, a + 1, b + 1]
        return Mesh(
            name=name,
            vertices=VertexArrays(
                position=pos,
                normal=n.astype(np.float32),
                uv=np.concatenate([u, v], axis=-1).astype(np.float32),
                color=np.ones((len(pos), 3), np.float32),
                tangent=tangent.astype(np.float32),
            ),
            indices=np.asarray(idx, np.uint32),
        )

    @staticmethod
    def from_descriptor(desc: "MeshDescriptor") -> "Mesh":
        """Build from a CPU descriptor (reference: mesh.rs `from_descriptor`)."""
        return Mesh(
            name=desc.key,
            vertices=desc.vertices,
            indices=desc.indices,
            texture_data=desc.texture,
            normal_texture_data=desc.normal_texture,
            metallic_roughness_texture_data=desc.metallic_roughness_texture,
            occlusion_texture_data=desc.occlusion_texture,
            emissive_texture_data=desc.emissive_texture,
            material_properties=desc.material_properties,
        )

    @staticmethod
    def from_gltf(path: str) -> "Mesh":
        """Load the first mesh of a .glb file with its 5 PBR texture maps and
        material factors (reference: mesh.rs:376-490 via archetype_asset)."""
        from . import gltf

        return gltf.load_glb_mesh(path)


@dataclasses.dataclass
class MeshDescriptor:
    """CPU-side mesh payload ready for registration
    (reference: mesh.rs:24-35)."""

    key: str
    vertices: VertexArrays
    indices: Optional[np.ndarray] = None
    texture: Optional[TextureData] = None
    normal_texture: Optional[TextureData] = None
    metallic_roughness_texture: Optional[TextureData] = None
    occlusion_texture: Optional[TextureData] = None
    emissive_texture: Optional[TextureData] = None
    material_properties: Optional[MaterialProperties] = None
