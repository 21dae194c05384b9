"""Minimal glTF 2.0 / GLB parser — NumPy only, no third-party loaders.

A copy of ``raytracer_tpu/utils/gltf.py``: importing any module of the JAX
package imports JAX, which the PyTorch port must run without.

Replaces the reference's THREE.js ``GLTFLoader`` dependency
(reference ``src/libs/Scene.js:1-2,19-32``). Only what the triangle-soup
pipeline needs is implemented:

* GLB container (magic ``glTF``, version 2, JSON + BIN chunks)
* plain ``.gltf`` JSON with external/URI-embedded buffers
* node hierarchy with ``matrix`` or TRS, world-matrix baking
  (the analog of THREE ``updateMatrixWorld(true)`` — Scene.js:49)
* mesh primitives: POSITION accessor + optional indices, mode TRIANGLES
* accessor de-interleaving via bufferView byteStride

Returns world-space de-indexed triangle vertices as float32 arrays — the same
data THREE's ``toNonIndexed()`` + ``applyMatrix4`` walk produces
(Scene.js:59-86).
"""

from __future__ import annotations

import base64
import json
import struct
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

__all__ = ["GLTFDocument", "load_gltf", "parse_glb_bytes", "extract_triangles"]

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}

_TYPE_COUNTS = {
    "SCALAR": 1,
    "VEC2": 2,
    "VEC3": 3,
    "VEC4": 4,
    "MAT2": 4,
    "MAT3": 9,
    "MAT4": 16,
}

_MODE_TRIANGLES = 4


@dataclass
class GLTFDocument:
    """Parsed glTF: the raw JSON tree plus resolved binary buffers."""

    json: dict
    buffers: list[bytes] = field(default_factory=list)

    # -- accessors ----------------------------------------------------------

    def accessor_array(self, accessor_index: int) -> np.ndarray:
        """Decode accessor → (count, components) ndarray in its native dtype."""
        acc = self.json["accessors"][accessor_index]
        count = acc["count"]
        ncomp = _TYPE_COUNTS[acc["type"]]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        itemsize = np.dtype(dtype).itemsize

        if "bufferView" not in acc:  # sparse-only / zero-filled accessor
            out = np.zeros((count, ncomp), dtype=dtype)
        else:
            bv = self.json["bufferViews"][acc["bufferView"]]
            buf = self.buffers[bv.get("buffer", 0)]
            base = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
            stride = bv.get("byteStride", 0) or ncomp * itemsize
            if stride == ncomp * itemsize:
                flat = np.frombuffer(buf, dtype=dtype, count=count * ncomp, offset=base)
                out = flat.reshape(count, ncomp).copy()
            else:  # interleaved: slice each element out by stride
                raw = np.frombuffer(buf, dtype=np.uint8)
                idx = base + stride * np.arange(count)[:, None] + np.arange(ncomp * itemsize)[None, :]
                out = raw[idx].copy().view(dtype).reshape(count, ncomp)

        if "sparse" in acc:
            out = self._apply_sparse(out, acc["sparse"])
        return out

    def _apply_sparse(self, out: np.ndarray, sparse: dict) -> np.ndarray:
        n = sparse["count"]
        idx_info = sparse["indices"]
        val_info = sparse["values"]
        idx_dtype = _COMPONENT_DTYPES[idx_info["componentType"]]
        bv = self.json["bufferViews"][idx_info["bufferView"]]
        buf = self.buffers[bv.get("buffer", 0)]
        off = bv.get("byteOffset", 0) + idx_info.get("byteOffset", 0)
        indices = np.frombuffer(buf, dtype=idx_dtype, count=n, offset=off).astype(np.int64)

        bv = self.json["bufferViews"][val_info["bufferView"]]
        buf = self.buffers[bv.get("buffer", 0)]
        off = bv.get("byteOffset", 0) + val_info.get("byteOffset", 0)
        vals = np.frombuffer(buf, dtype=out.dtype, count=n * out.shape[1], offset=off)
        out[indices] = vals.reshape(n, out.shape[1])
        return out

    # -- node transforms -----------------------------------------------------

    def node_local_matrix(self, node: dict) -> np.ndarray:
        if "matrix" in node:
            # glTF matrices are column-major 16-float lists
            return np.asarray(node["matrix"], dtype=np.float64).reshape(4, 4).T
        t = np.asarray(node.get("translation", [0.0, 0.0, 0.0]), dtype=np.float64)
        q = np.asarray(node.get("rotation", [0.0, 0.0, 0.0, 1.0]), dtype=np.float64)
        s = np.asarray(node.get("scale", [1.0, 1.0, 1.0]), dtype=np.float64)
        x, y, z, w = q
        rot = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ],
            dtype=np.float64,
        )
        m = np.eye(4, dtype=np.float64)
        m[:3, :3] = rot * s[None, :]
        m[:3, 3] = t
        return m

    def iter_mesh_instances(self):
        """Yield (mesh_index, world_matrix 4x4 float64) for every node with a
        mesh, walking the default scene (or all nodes if no scene is given)."""
        nodes = self.json.get("nodes", [])
        scenes = self.json.get("scenes", [])
        scene_idx = self.json.get("scene", 0 if scenes else None)
        if scene_idx is not None and scenes:
            roots = scenes[scene_idx].get("nodes", [])
        else:
            child_set = {c for nd in nodes for c in nd.get("children", [])}
            roots = [i for i in range(len(nodes)) if i not in child_set]

        stack = [(r, np.eye(4)) for r in reversed(roots)]
        while stack:
            idx, parent_m = stack.pop()
            node = nodes[idx]
            world = parent_m @ self.node_local_matrix(node)
            if "mesh" in node:
                yield node["mesh"], world
            for c in reversed(node.get("children", [])):
                stack.append((c, world))


def parse_glb_bytes(data: bytes) -> GLTFDocument:
    """Parse a binary .glb container (magic/version/chunks per glTF 2.0 spec)."""
    if len(data) < 12:
        raise ValueError("GLB too short")
    magic, version, length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:  # 'glTF'
        raise ValueError("not a GLB file (bad magic)")
    if version != 2:
        raise ValueError(f"unsupported GLB version {version}")

    offset = 12
    gltf_json = None
    bin_chunk = b""
    while offset + 8 <= min(length, len(data)):
        chunk_len, chunk_type = struct.unpack_from("<II", data, offset)
        offset += 8
        chunk = data[offset : offset + chunk_len]
        offset += chunk_len
        if chunk_type == 0x4E4F534A:  # 'JSON'
            gltf_json = json.loads(chunk.decode("utf-8"))
        elif chunk_type == 0x004E4942:  # 'BIN\0'
            bin_chunk = bytes(chunk)
    if gltf_json is None:
        raise ValueError("GLB missing JSON chunk")

    doc = GLTFDocument(json=gltf_json)
    doc.buffers = _resolve_buffers(gltf_json, bin_chunk, base_dir=None)
    return doc


def _resolve_buffers(gltf_json: dict, bin_chunk: bytes, base_dir: Path | None) -> list[bytes]:
    buffers: list[bytes] = []
    for i, buf in enumerate(gltf_json.get("buffers", [])):
        uri = buf.get("uri")
        if uri is None:
            buffers.append(bin_chunk)
        elif uri.startswith("data:"):
            b64 = uri.split(",", 1)[1]
            buffers.append(base64.b64decode(b64))
        else:
            if base_dir is None:
                raise ValueError(f"external buffer uri {uri!r} needs a base directory")
            buffers.append((base_dir / uri).read_bytes())
    return buffers


def load_gltf(path: str | Path) -> GLTFDocument:
    """Load .glb or .gltf from disk."""
    path = Path(path)
    data = path.read_bytes()
    if data[:4] == b"glTF":
        return parse_glb_bytes(data)
    gltf_json = json.loads(data.decode("utf-8"))
    doc = GLTFDocument(json=gltf_json)
    doc.buffers = _resolve_buffers(gltf_json, b"", base_dir=path.parent)
    return doc


def extract_triangles(doc: GLTFDocument) -> np.ndarray:
    """World-space de-indexed triangle soup, shape (N, 3, 3) float32.

    Mirrors the reference walk (Scene.js:53-98): for each mesh node, de-index
    the geometry, apply the world matrix to every vertex, and emit triangles
    in primitive order. Non-triangle primitive modes are skipped.
    """
    tri_blocks: list[np.ndarray] = []
    meshes = doc.json.get("meshes", [])
    for mesh_idx, world in doc.iter_mesh_instances():
        for prim in meshes[mesh_idx].get("primitives", []):
            if prim.get("mode", _MODE_TRIANGLES) != _MODE_TRIANGLES:
                continue
            attrs = prim.get("attributes", {})
            if "POSITION" not in attrs:
                continue
            pos = doc.accessor_array(attrs["POSITION"]).astype(np.float64)
            if "indices" in prim:
                idx = doc.accessor_array(prim["indices"]).reshape(-1).astype(np.int64)
                pos = pos[idx]
            ntri = len(pos) // 3
            if ntri == 0:
                continue
            pos = pos[: ntri * 3]
            # bake world matrix (applyMatrix4 semantics, w=1)
            baked = pos @ world[:3, :3].T + world[:3, 3][None, :]
            tri_blocks.append(baked.reshape(ntri, 3, 3).astype(np.float32))
    if not tri_blocks:
        return np.zeros((0, 3, 3), dtype=np.float32)
    return np.concatenate(tri_blocks, axis=0)
