"""Procedural test geometry + minimal GLB writer (host, NumPy).

A copy of the parts of ``raytracer_tpu/utils/procgen.py`` that make the
port's test and smoke scenes; each function returns the same triangles as
its JAX-package twin:

* :func:`make_cube`, :func:`make_quad` — a cube and a quad;
* :func:`make_icosphere` — smooth test mesh, 20·4^s triangles;
* :func:`make_trefoil` — the displaced torus-knot tube (the earlier
  871,200-triangle stand-in);
* :func:`make_dragon_stand_in` — the 871,200-triangle benchmark scene;
* :func:`make_cornell_box` — the low-poly interior box of the apps' ``--scene
  cornell``;
* :func:`write_glb` — emit a valid GLB so ingest runs end to end.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np

__all__ = ["make_cube", "make_quad", "make_icosphere", "make_trefoil", "make_cornell_box",
           "make_interior_hall", "make_dragon_solid", "make_dragon_stand_in", "write_glb"]


def _dedupe_to_soup(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """(V,3) verts + (F,3) int faces → de-indexed (F,3,3) float32 soup."""
    return verts[faces].astype(np.float32)


def make_cube(size: float = 1.0) -> np.ndarray:
    """Axis-aligned cube centered at origin, 12 triangles, (12,3,3) f32."""
    s = size / 2.0
    v = np.array(
        [[x, y, z] for x in (-s, s) for y in (-s, s) for z in (-s, s)],
        dtype=np.float32,
    )
    faces = np.array(
        [
            [0, 1, 3], [0, 3, 2],  # -x
            [4, 6, 7], [4, 7, 5],  # +x
            [0, 4, 5], [0, 5, 1],  # -y
            [2, 3, 7], [2, 7, 6],  # +y
            [0, 2, 6], [0, 6, 4],  # -z
            [1, 5, 7], [1, 7, 3],  # +z
        ],
        dtype=np.int64,
    )
    return _dedupe_to_soup(v, faces)


def make_quad(size: float = 1.0, y: float = 0.0) -> np.ndarray:
    """Horizontal quad (2 tris) in the XZ plane at height y."""
    s = size / 2.0
    v = np.array(
        [[-s, y, -s], [s, y, -s], [s, y, s], [-s, y, s]], dtype=np.float32
    )
    faces = np.array([[0, 1, 2], [0, 2, 3]], dtype=np.int64)
    return _dedupe_to_soup(v, faces)


def make_icosphere(subdivisions: int = 4, radius: float = 1.0) -> np.ndarray:
    """Icosphere via midpoint subdivision: 20 * 4**subdivisions triangles."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    for _ in range(subdivisions):
        vlist = list(verts)
        cache: dict[tuple[int, int], int] = {}

        def midpoint(a: int, b: int) -> int:
            key = (a, b) if a < b else (b, a)
            if key in cache:
                return cache[key]
            m = vlist[a] + vlist[b]
            m = m / np.linalg.norm(m)
            vlist.append(m)
            cache[key] = len(vlist) - 1
            return cache[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, dtype=np.int64)
    return _dedupe_to_soup(verts * radius, faces)


def _grid_faces(nu: int, nv: int, wrap_u: bool = True, wrap_v: bool = True) -> np.ndarray:
    """Triangulate an (nu, nv) parametric grid into 2*nu*nv triangles."""
    iu = np.arange(nu)
    iv = np.arange(nv)
    u0, v0 = np.meshgrid(iu, iv, indexing="ij")
    u1 = (u0 + 1) % nu if wrap_u else u0 + 1
    v1 = (v0 + 1) % nv if wrap_v else v0 + 1
    idx = lambda u, v: u * nv + v  # noqa: E731
    a, b, c, d = idx(u0, v0), idx(u1, v0), idx(u1, v1), idx(u0, v1)
    t1 = np.stack([a, b, c], axis=-1).reshape(-1, 3)
    t2 = np.stack([a, c, d], axis=-1).reshape(-1, 3)
    return np.concatenate([t1, t2], axis=0).astype(np.int64)


def make_trefoil(
    nu: int = 660,
    nv: int = 660,
    tube_radius: float = 0.34,
    bump_amp: float = 0.08,
    bump_freq: tuple[int, int] = (9, 7),
    p: int = 2,
    q: int = 3,
) -> np.ndarray:
    """Displaced (p,q) torus-knot tube — 2*nu*nv triangles.

    Defaults give 871,200 triangles ≈ the Stanford Dragon's 871,414, with the
    knot's self-occlusion and the sinusoidal displacement supplying dragon-like
    surface detail for BVH traversal depth.
    """
    u = np.linspace(0.0, 2.0 * np.pi, nu, endpoint=False)
    v = np.linspace(0.0, 2.0 * np.pi, nv, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")

    # torus-knot center curve
    r = np.cos(q * uu) + 2.0
    cx = r * np.cos(p * uu)
    cy = r * np.sin(p * uu)
    cz = -np.sin(q * uu)
    center = np.stack([cx, cy, cz], axis=-1)

    # tangent via analytic derivative
    dr = -q * np.sin(q * uu)
    tx = dr * np.cos(p * uu) - p * r * np.sin(p * uu)
    ty = dr * np.sin(p * uu) + p * r * np.cos(p * uu)
    tz = -q * np.cos(q * uu)
    tangent = np.stack([tx, ty, tz], axis=-1)
    tangent /= np.linalg.norm(tangent, axis=-1, keepdims=True)

    # stable frame: project world-up out of the tangent
    ref = np.broadcast_to(np.array([0.0, 0.0, 1.0]), tangent.shape)
    n1 = np.cross(tangent, ref)
    n1 /= np.maximum(np.linalg.norm(n1, axis=-1, keepdims=True), 1e-12)
    n2 = np.cross(tangent, n1)

    rad = tube_radius * (1.0 + bump_amp * np.sin(bump_freq[0] * uu) * np.cos(bump_freq[1] * vv))
    pts = (
        center
        + n1 * (rad * np.cos(vv))[..., None]
        + n2 * (rad * np.sin(vv))[..., None]
    )
    verts = pts.reshape(-1, 3)
    faces = _grid_faces(nu, nv, wrap_u=True, wrap_v=True)
    return _dedupe_to_soup(verts, faces)


def make_dragon_solid(nu: int = 660, nv: int = 660) -> np.ndarray:
    """Solid crumpled blob — 2*nu*nv triangles (defaults: 871,200).

    A closed, multi-octave-displaced sphere standing in for the Stanford
    Dragon: a SOLID surface that fills the frame when framed. The pole
    quads' collapsed triangles are zero-area (MT-inert, point AABBs) and
    keep the count exact.
    """
    th = np.linspace(0.0, np.pi, nu + 1)[:-1] + np.pi / (2 * (nu + 1))
    ph = np.linspace(0.0, 2.0 * np.pi, nv, endpoint=False)
    tt, pp = np.meshgrid(th, ph, indexing="ij")

    r = (
        1.0
        + 0.18 * np.sin(6.0 * tt) * np.cos(5.0 * pp)
        + 0.12 * np.sin(11.0 * tt + 1.7) * np.sin(8.0 * pp + 0.6)
        + 0.07 * np.sin(23.0 * tt + 0.9) * np.cos(17.0 * pp + 2.1)
        + 0.04 * np.sin(41.0 * tt) * np.sin(31.0 * pp)
    )
    x = r * np.sin(tt) * np.cos(pp) * 1.30   # elongate: dragon-ish aspect
    y = r * np.cos(tt) * 0.78
    z = r * np.sin(tt) * np.sin(pp) * 0.95
    verts = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    faces = _grid_faces(nu, nv, wrap_u=False, wrap_v=True)
    # close the poles: clamp the out-of-range top row index to the last row
    faces = np.clip(faces, 0, nu * nv - 1)
    return _dedupe_to_soup(verts, faces)


def make_dragon_stand_in() -> np.ndarray:
    """The Dragon-benchmark substitute: 871,200 tris, deterministic."""
    return make_dragon_solid()


def make_cornell_box(inner: float = 2.0) -> np.ndarray:
    """Cornell-box-style low-poly interior: 5 walls + 2 boxes (~34 tris).

    Geometry only (the reference pipeline carries no materials/colors —
    triangles are 9 floats, PathTracer.js:79-84).
    """
    s = inner / 2.0
    tris = []

    def wall(v0, v1, v2, v3):
        v = np.array([v0, v1, v2, v3], dtype=np.float32)
        tris.append(v[[0, 1, 2]])
        tris.append(v[[0, 2, 3]])

    # floor / ceiling / back / left / right (open front)
    wall([-s, -s, -s], [s, -s, -s], [s, -s, s], [-s, -s, s])
    wall([-s, s, -s], [-s, s, s], [s, s, s], [s, s, -s])
    wall([-s, -s, -s], [-s, s, -s], [s, s, -s], [s, -s, -s])
    wall([-s, -s, -s], [-s, -s, s], [-s, s, s], [-s, s, -s])
    wall([s, -s, -s], [s, s, -s], [s, s, s], [s, -s, s])

    def box(cx, cz, w, h, d, yaw):
        c, sn = np.cos(yaw), np.sin(yaw)
        rot = np.array([[c, 0, sn], [0, 1, 0], [-sn, 0, c]], dtype=np.float32)
        cube = make_cube(1.0) * np.array([w, h, d], dtype=np.float32)
        cube = cube @ rot.T
        cube = cube + np.array([cx, -s + h / 2.0, cz], dtype=np.float32)
        tris.extend(cube)

    box(-0.35 * s, -0.3 * s, 0.55 * s, 1.1 * s, 0.55 * s, 0.3)
    box(0.45 * s, 0.35 * s, 0.5 * s, 0.5 * s, 0.5 * s, -0.25)
    return np.stack(tris, axis=0).astype(np.float32)


def make_interior_hall() -> np.ndarray:
    """The interior hall of the JAX benchmark's config 4
    (``bench_suite.py:300-309``), before its cube normalization: the Cornell
    box of side 4, a colonnade of 8 cubes of side 0.3 and an icosphere(4)
    of radius 0.7 — 5,250 triangles, with walls that span the scene."""
    parts = [make_cornell_box(4.0)]
    for i in range(8):
        parts.append(make_cube(0.3) + np.array(
            [(-1.5 + 0.4 * i), -1.6, (-1.2 if i % 2 else 1.2)], np.float32))
    parts.append(make_icosphere(4, radius=0.7))
    return np.concatenate(parts).astype(np.float32)


def write_glb(path: str | Path, tris: np.ndarray, *, indexed: bool = True) -> None:
    """Write a triangle soup (N,3,3) as a minimal valid GLB 2.0 file.

    With ``indexed=True``, vertices are deduplicated and an index accessor is
    emitted, which exercises the parser's de-indexing path.
    """
    tris = np.asarray(tris, dtype=np.float32).reshape(-1, 3, 3)
    flat = tris.reshape(-1, 3)

    if indexed and len(flat) > 0:
        verts, inverse = np.unique(flat, axis=0, return_inverse=True)
        indices = inverse.astype(np.uint32)
    else:
        verts = flat
        indices = None

    vert_bytes = np.ascontiguousarray(verts, dtype=np.float32).tobytes()
    buffers = [vert_bytes]
    buffer_views = [
        {"buffer": 0, "byteOffset": 0, "byteLength": len(vert_bytes), "target": 34962}
    ]
    accessors = [
        {
            "bufferView": 0,
            "componentType": 5126,
            "count": int(len(verts)),
            "type": "VEC3",
            "min": verts.min(axis=0).tolist() if len(verts) else [0, 0, 0],
            "max": verts.max(axis=0).tolist() if len(verts) else [0, 0, 0],
        }
    ]
    primitive: dict = {"attributes": {"POSITION": 0}, "mode": 4}

    if indices is not None:
        idx_bytes = indices.tobytes()
        offset = len(vert_bytes)
        pad = (-offset) % 4
        buffers.append(b"\x00" * pad + idx_bytes)
        buffer_views.append(
            {
                "buffer": 0,
                "byteOffset": offset + pad,
                "byteLength": len(idx_bytes),
                "target": 34963,
            }
        )
        accessors.append(
            {
                "bufferView": 1,
                "componentType": 5125,
                "count": int(len(indices)),
                "type": "SCALAR",
            }
        )
        primitive["indices"] = 1

    bin_chunk = b"".join(buffers)
    bin_chunk += b"\x00" * ((-len(bin_chunk)) % 4)

    gltf = {
        "asset": {"version": "2.0", "generator": "raytracer_tpu_torch.procgen"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [primitive]}],
        "buffers": [{"byteLength": len(bin_chunk)}],
        "bufferViews": buffer_views,
        "accessors": accessors,
    }
    json_chunk = json.dumps(gltf, separators=(",", ":")).encode("utf-8")
    json_chunk += b" " * ((-len(json_chunk)) % 4)

    total = 12 + 8 + len(json_chunk) + 8 + len(bin_chunk)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(json_chunk), 0x4E4F534A))
        f.write(json_chunk)
        f.write(struct.pack("<II", len(bin_chunk), 0x004E4942))
        f.write(bin_chunk)
