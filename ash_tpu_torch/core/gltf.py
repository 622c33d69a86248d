"""Minimal GLB (binary glTF 2.0) loader.

TPU counterpart of the reference's `Mesh::from_gltf` (mesh.rs:376-490, via
the external `archetype_asset` crate): loads the FIRST mesh of a .glb with
positions/normals/uvs/tangents/colors, indices, PBR material factors and the
five texture maps (base color, normal, metallic-roughness, occlusion,
emissive). Self-contained: GLB container + accessors parsed here, image
payloads decoded with PIL.

Missing attributes get the same defaults the reference applies: white vertex
color, zero tangent (the shading path substitutes a safe +X tangent,
frag.frag:136), uv (0,0).
"""

from __future__ import annotations

import io
import json
import struct
from typing import Dict, Optional

import numpy as np

from ..errors import InvalidOperation
from .material import MaterialProperties
from .texture import TextureData

_MAGIC = 0x46546C67  # 'glTF'
_JSON_CHUNK = 0x4E4F534A
_BIN_CHUNK = 0x004E4942

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {
    "SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
    "MAT2": 4, "MAT3": 9, "MAT4": 16,
}


def parse_glb(data: bytes):
    """-> (gltf_json: dict, bin_chunk: bytes)."""
    if len(data) < 12:
        raise InvalidOperation("GLB too short")
    magic, version, _length = struct.unpack_from("<III", data, 0)
    if magic != _MAGIC:
        raise InvalidOperation("not a GLB file (bad magic)")
    if version != 2:
        raise InvalidOperation(f"unsupported GLB version {version}")
    offset = 12
    gltf = None
    binary = b""
    while offset + 8 <= len(data):
        clen, ctype = struct.unpack_from("<II", data, offset)
        offset += 8
        chunk = data[offset : offset + clen]
        offset += clen + (-clen % 4)
        if ctype == _JSON_CHUNK:
            gltf = json.loads(chunk.decode("utf-8"))
        elif ctype == _BIN_CHUNK:
            binary = chunk
    if gltf is None:
        raise InvalidOperation("GLB missing JSON chunk")
    return gltf, binary


def read_accessor(gltf: dict, binary: bytes, index: int) -> np.ndarray:
    acc = gltf["accessors"][index]
    n = _TYPE_COUNTS[acc["type"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    count = acc["count"]
    bv = gltf["bufferViews"][acc["bufferView"]]
    base = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = bv.get("byteStride") or n * np.dtype(dtype).itemsize
    item = n * np.dtype(dtype).itemsize
    raw = binary[base : base + stride * (count - 1) + item]
    if stride == item:
        out = np.frombuffer(raw, dtype=dtype, count=count * n).reshape(count, n)
    else:
        # Interleaved vertex buffer: decode all elements in one shot
        # (a per-vertex Python loop cost seconds on million-vertex GLBs).
        # The LAST element's row is allowed to end at `item` rather than a
        # full stride (the glTF byte range is stride*(count-1)+item); any
        # shorter means a truncated/malformed buffer — raise, do not
        # fabricate zero geometry.
        need = stride * (count - 1) + item
        if len(raw) < need:
            raise InvalidOperation(
                f"accessor {index}: buffer truncated "
                f"({len(raw)} < {need} bytes)"
            )
        raw = raw + b"\x00" * (stride * count - len(raw))  # pad tail row
        out = (
            np.frombuffer(raw, np.uint8)
            .reshape(count, stride)[:, :item]
            .copy()
            .view(dtype)
        )
    if acc.get("normalized") and dtype != np.float32:
        # glTF normalization: c / max, clamped to -1 for signed types
        # (value -2^(b-1) would otherwise decode past -1.0).
        out = np.maximum(out.astype(np.float32) / np.iinfo(dtype).max, -1.0)
    return out


def _decode_image(gltf: dict, binary: bytes, image_index: int, srgb: bool) -> TextureData:
    from PIL import Image

    img = gltf["images"][image_index]
    if "bufferView" not in img:
        raise InvalidOperation("external glTF images not supported (GLB only)")
    bv = gltf["bufferViews"][img["bufferView"]]
    base = bv.get("byteOffset", 0)
    payload = binary[base : base + bv["byteLength"]]
    pil = Image.open(io.BytesIO(payload)).convert("RGBA")
    return TextureData(
        width=pil.width, height=pil.height,
        pixels=np.asarray(pil, np.uint8), srgb=srgb,
    )


def _texture_image(gltf: dict, tex_index: int) -> int:
    return gltf["textures"][tex_index]["source"]


def load_glb_mesh(path_or_bytes) -> "Mesh":  # noqa: F821
    """Load the first mesh's first primitive, like the reference
    (mesh.rs:386-389 takes model.meshes.first())."""
    from .mesh import Mesh, VertexArrays

    if isinstance(path_or_bytes, (str, bytes)):
        data = (
            path_or_bytes
            if isinstance(path_or_bytes, bytes)
            else open(path_or_bytes, "rb").read()
        )
    else:
        data = path_or_bytes.read()
    gltf, binary = parse_glb(data)

    meshes = gltf.get("meshes") or []
    if not meshes:
        raise InvalidOperation("no meshes found in GLB")
    prim = meshes[0]["primitives"][0]
    attrs: Dict[str, int] = prim["attributes"]
    if "POSITION" not in attrs:
        raise InvalidOperation("mesh missing POSITION attribute")

    pos = read_accessor(gltf, binary, attrs["POSITION"]).astype(np.float32)
    v = len(pos)

    def attr(name, default, width):
        if name in attrs:
            a = read_accessor(gltf, binary, attrs[name]).astype(np.float32)
            if a.shape[1] > width:
                a = a[:, :width]
            elif a.shape[1] < width:
                a = np.pad(a, ((0, 0), (0, width - a.shape[1])),
                           constant_values=1.0)
            return a
        return np.tile(np.asarray(default, np.float32), (v, 1))

    normal = attr("NORMAL", [0, 0, 1], 3)
    uv = attr("TEXCOORD_0", [0, 0], 2)
    color = attr("COLOR_0", [1, 1, 1], 3)
    tangent = attr("TANGENT", [0, 0, 0, 1], 4)

    indices = None
    if "indices" in prim:
        indices = read_accessor(gltf, binary, prim["indices"]).reshape(-1)
        indices = indices.astype(np.uint32)

    # Material factors + textures (mesh.rs:signature of 5 PBR maps).
    # No material reference = the glTF DEFAULT MATERIAL (spec 3.9.6:
    # metallic 1.0, roughness 1.0) — the same factors an empty material
    # object decodes to below, so the two "unspecified" spellings shade
    # identically.
    props = MaterialProperties(metallic_factor=1.0, roughness_factor=1.0)
    tex = {}
    mat_index = prim.get("material")
    if mat_index is not None:
        mat = gltf["materials"][mat_index]
        pbr = mat.get("pbrMetallicRoughness", {})
        props = MaterialProperties(
            base_color_factor=tuple(pbr.get("baseColorFactor", [1, 1, 1, 1])),
            metallic_factor=pbr.get("metallicFactor", 1.0),
            roughness_factor=pbr.get("roughnessFactor", 1.0),
            emissive_factor=tuple(mat.get("emissiveFactor", [0, 0, 0]) + [1.0]),
            occlusion_strength=mat.get("occlusionTexture", {}).get("strength", 1.0),
            normal_scale=mat.get("normalTexture", {}).get("scale", 1.0),
        )
        # glTF alphaMode MASK -> alpha-test cutoff (default 0.5 per spec).
        if mat.get("alphaMode") == "MASK":
            props.alpha_cutoff = mat.get("alphaCutoff", 0.5)
        if "baseColorTexture" in pbr:
            tex["texture_data"] = _decode_image(
                gltf, binary, _texture_image(gltf, pbr["baseColorTexture"]["index"]), True)
        if "metallicRoughnessTexture" in pbr:
            tex["metallic_roughness_texture_data"] = _decode_image(
                gltf, binary,
                _texture_image(gltf, pbr["metallicRoughnessTexture"]["index"]), False)
        if "normalTexture" in mat:
            tex["normal_texture_data"] = _decode_image(
                gltf, binary, _texture_image(gltf, mat["normalTexture"]["index"]), False)
        if "occlusionTexture" in mat:
            tex["occlusion_texture_data"] = _decode_image(
                gltf, binary, _texture_image(gltf, mat["occlusionTexture"]["index"]), False)
        if "emissiveTexture" in mat:
            tex["emissive_texture_data"] = _decode_image(
                gltf, binary, _texture_image(gltf, mat["emissiveTexture"]["index"]), True)

    name = meshes[0].get("name", "gltf_mesh")
    return Mesh(
        name=name,
        vertices=VertexArrays(pos, normal, uv, color, tangent),
        indices=indices,
        material_properties=props,
        **tex,
    )
