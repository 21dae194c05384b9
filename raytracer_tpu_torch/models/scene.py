"""Scene: GLB → triangle-soup ingest with normalization (host, NumPy).

A copy of the ingest half of ``raytracer_tpu/models/scene.py``. Triangles
stay a host ``(N, 3, 3) float32`` array; ``PathTracer`` moves them to its
device. Cube normalization is bit-equal to the JAX package's.
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

    def get_triangles(self) -> np.ndarray:
        return self.triangles
