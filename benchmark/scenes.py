"""The benchmark's scenes, made on the host from fixed parameters.

Frozen copies of the generators that the project's own suite runs
(``make_dragon_solid`` / ``make_dragon_stand_in`` and ``make_icosphere`` of
``raytracer_tpu_torch/utils/procgen.py``, and ``Scene.normalize_mesh``'s cube
mode), so that a later change to the program cannot change the yardstick's
inputs. Both the program and the reference get the triangles made here.

A configuration names its generator in ``scene.generator``: one of the two
built-ins above, or a module ``generators/<name>.py`` that a configuration
brings as a new file. Such a module

* is a frozen copy of the project generator it stands for;
* imports numpy and ``scenes`` only, never ``raytracer_tpu_torch``,
  ``raytracer_tpu`` or JAX, so that a later change to the program cannot move
  the yardstick;
* defines ``make(**args)``, returning the (T, 3, 3) float32 soup; it is
  deterministic and takes no seed (the seed moves the traffic only);
* may read data files placed beside it, located from its own ``__file__``.

``normalize`` then applies to its triangles as to a built-in's.
"""

from __future__ import annotations

import numpy as np

from common import HERE, load_module

__all__ = ["make_scene", "generator_of", "make_dragon_solid", "make_icosphere",
           "normalize_cube"]

GENERATORS_DIR = HERE / "generators"


def _soup(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """(V, 3) vertices + (F, 3) faces → the de-indexed (F, 3, 3) f32 soup."""
    return verts[faces].astype(np.float32)


def _grid_faces(nu: int, nv: int, wrap_u: bool, wrap_v: bool) -> np.ndarray:
    """Two triangles for each cell of an (nu, nv) parametric grid."""
    u0, v0 = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    u1 = (u0 + 1) % nu if wrap_u else u0 + 1
    v1 = (v0 + 1) % nv if wrap_v else v0 + 1

    def idx(u, v):
        return u * nv + v

    a, b, c, d = idx(u0, v0), idx(u1, v0), idx(u1, v1), idx(u0, v1)
    t1 = np.stack([a, b, c], axis=-1).reshape(-1, 3)
    t2 = np.stack([a, c, d], axis=-1).reshape(-1, 3)
    return np.concatenate([t1, t2], axis=0).astype(np.int64)


def make_dragon_solid(nu: int = 660, nv: int = 660) -> np.ndarray:
    """The dragon stand-in: a closed, multi-octave displaced sphere of
    2·nu·nv triangles (871,200 at the defaults); the pole rows' collapsed
    triangles have zero area and keep the count exact."""
    th = np.linspace(0.0, np.pi, nu + 1)[:-1] + np.pi / (2 * (nu + 1))
    ph = np.linspace(0.0, 2.0 * np.pi, nv, endpoint=False)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    r = (1.0
         + 0.18 * np.sin(6.0 * tt) * np.cos(5.0 * pp)
         + 0.12 * np.sin(11.0 * tt + 1.7) * np.sin(8.0 * pp + 0.6)
         + 0.07 * np.sin(23.0 * tt + 0.9) * np.cos(17.0 * pp + 2.1)
         + 0.04 * np.sin(41.0 * tt) * np.sin(31.0 * pp))
    x = r * np.sin(tt) * np.cos(pp) * 1.30
    y = r * np.cos(tt) * 0.78
    z = r * np.sin(tt) * np.sin(pp) * 0.95
    verts = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    faces = np.clip(_grid_faces(nu, nv, wrap_u=False, wrap_v=True), 0, nu * nv - 1)
    return _soup(verts, faces)


def make_icosphere(subdivisions: int = 4, radius: float = 1.0) -> np.ndarray:
    """Icosphere by midpoint subdivision: 20·4^subdivisions triangles."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                      [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                      [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], dtype=np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                      [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                      [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                      [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
                     dtype=np.int64)
    for _ in range(subdivisions):
        vlist = list(verts)
        cache: dict[tuple[int, int], int] = {}

        def midpoint(a: int, b: int) -> int:
            key = (a, b) if a < b else (b, a)
            if key not in cache:
                m = vlist[a] + vlist[b]
                vlist.append(m / np.linalg.norm(m))
                cache[key] = len(vlist) - 1
            return cache[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, dtype=np.int64)
    return _soup(verts * radius, faces)


def normalize_cube(tris: np.ndarray) -> np.ndarray:
    """Centre on the box midpoint and scale the longest side to [-1, 1], in
    f32 as the project's scene loader does (``normalize=True, mode="cube"``)."""
    verts = tris.reshape(-1, 3)
    mn, mx = verts.min(axis=0), verts.max(axis=0)
    center = (mn + mx) * np.float32(0.5)
    scale = np.float32(2.0) / np.float32((mx - mn).max())
    return ((tris - center[None, None, :]) * scale).astype(np.float32)


_BUILTIN = {"dragon_solid": make_dragon_solid, "icosphere": make_icosphere}


def generator_of(name: str):
    """The generator ``name``: a built-in, else ``make`` of
    ``generators/<name>.py``; a KeyError names both places looked in."""
    if name in _BUILTIN:
        return _BUILTIN[name]
    path = GENERATORS_DIR / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no scene generator {name!r}: not a built-in of scenes.py "
                       f"({', '.join(sorted(_BUILTIN))}) and no file {path}")
    return load_module(path, f"generator_{name}").make


def make_scene(spec: dict) -> np.ndarray:
    """The triangles (T, 3, 3) f32 that a configuration's ``scene`` names:
    ``{"generator": name, "args": {...}, "normalize": "cube" | null}``."""
    tris = generator_of(spec["generator"])(**spec.get("args", {}))
    if tris.dtype != np.float32 or tris.ndim != 3 or tris.shape[1:] != (3, 3):
        raise ValueError(f"generator {spec['generator']!r} made {tris.dtype} "
                         f"{tris.shape}, not a (T, 3, 3) float32 soup")
    return normalize_cube(tris) if spec.get("normalize") == "cube" else tris
