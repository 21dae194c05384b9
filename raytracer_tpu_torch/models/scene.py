"""Scene: GLB → triangle-soup ingest with normalization (host, NumPy).

A copy of ``raytracer_tpu/models/scene.py``. Triangles stay a host
``(N, 3, 3) float32`` array; ``PathTracer`` moves them to its device. Cube
normalization, the centroids, the Morton pre-sort and the flat export are
bit-equal to the JAX package's.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..utils.gltf import extract_triangles, load_gltf

__all__ = ["Scene"]


class Scene:
    """Triangle-soup scene container.

    * ``load_glb(path, normalize=False, mode="cube")`` — parse + optional
      normalization.
    * ``normalize_mesh`` — cube: longest AABB dimension scaled to [-1, 1]
      (scale = 2 / maxDim); sphere: scale = 1 / (maxDim / 2), both centered
      on the AABB midpoint.
    * ``sort_triangles`` — the optional Morton pre-sort (not called by
      default, as in the reference).
    * ``get_triangles_float32`` — flat (9N,) float32 v0 v1 v2 layout.
    """

    def __init__(self) -> None:
        self.triangles: np.ndarray = np.zeros((0, 3, 3), dtype=np.float32)
        self._normalize_enabled = False
        self._normalize_mode = "cube"

    def load_glb(self, path: str | Path, *, normalize: bool = False, mode: str = "cube") -> "Scene":
        self._normalize_enabled = bool(normalize)
        self._normalize_mode = mode
        doc = load_gltf(path)
        self.triangles = extract_triangles(doc)
        if self._normalize_enabled:
            self.normalize_mesh()
        return self

    def set_triangles(self, tris: np.ndarray) -> "Scene":
        """Install a raw triangle array, shape (N, 3, 3) or flat (9N,)."""
        tris = np.asarray(tris, dtype=np.float32)
        if tris.ndim == 1:
            tris = tris.reshape(-1, 3, 3)
        self.triangles = tris
        return self

    @property
    def num_triangles(self) -> int:
        return int(self.triangles.shape[0])

    def centroids(self) -> np.ndarray:
        """Per-triangle centroid (mean of the 3 vertices), shape (N, 3)."""
        if self.num_triangles == 0:
            return np.zeros((0, 3), dtype=np.float32)
        return self.triangles.mean(axis=1, dtype=np.float32)

    def normalize_mesh(self) -> None:
        """Center on the AABB midpoint and rescale."""
        if self.num_triangles == 0:
            return
        verts = self.triangles.reshape(-1, 3)
        mn = verts.min(axis=0)
        mx = verts.max(axis=0)
        center = (mn + mx) * np.float32(0.5)
        max_dim = np.float32((mx - mn).max())
        if self._normalize_mode == "sphere":
            scale = np.float32(1.0) / (max_dim * np.float32(0.5))
        else:  # "cube"
            scale = np.float32(2.0) / max_dim
        self.triangles = ((self.triangles - center[None, None, :]) * scale).astype(np.float32)

    def sort_triangles(self) -> None:
        """Spatially sort triangles by 30-bit Morton code of normalized
        centroids. Port of the reference's (unused) Scene.sortTriangles
        (Scene.js:170-225), kept for parity; note the reference app never
        calls it (Scene.js:41 is commented out).
        """
        if self.num_triangles == 0:
            return
        c = self.centroids().astype(np.float64)
        mn = c.min(axis=0)
        ext = c.max(axis=0) - mn
        ext = np.where(ext == 0.0, 1.0, ext)
        q = np.clip((c - mn) / ext * 1024.0, 0.0, 1023.0).astype(np.uint32)

        def expand(v: np.ndarray) -> np.ndarray:
            v = (v * np.uint32(0x00010001)) & np.uint32(0xFF0000FF)
            v = (v * np.uint32(0x00000101)) & np.uint32(0x0F00F00F)
            v = (v * np.uint32(0x00000011)) & np.uint32(0xC30C30C3)
            v = (v * np.uint32(0x00000005)) & np.uint32(0x49249249)
            return v

        code = expand(q[:, 0]) | (expand(q[:, 1]) << np.uint32(1)) | (expand(q[:, 2]) << np.uint32(2))
        order = np.argsort(code, kind="stable")
        self.triangles = self.triangles[order]

    def get_triangles_float32(self) -> np.ndarray:
        """Flat (9N,) float32 — v0.xyz v1.xyz v2.xyz per triangle."""
        return np.ascontiguousarray(self.triangles, dtype=np.float32).reshape(-1)

    def get_triangles(self) -> np.ndarray:
        return self.triangles
