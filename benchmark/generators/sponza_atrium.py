"""Scene generator ``sponza_atrium``: a frozen copy of
``make_sponza_atrium`` of ``raytracer_tpu_torch/utils/procgen.py`` (with the
helpers it calls), so that a later change to the program cannot move the
yardstick's scene. ``make(detail)`` returns the (T, 3, 3) float32 soup:
261,720 triangles at the configuration's ``detail`` 4, 18,178 at the toy
size's 1. Deterministic; no seed."""

from __future__ import annotations

import numpy as np

__all__ = ["make"]


# -- the Sponza-class atrium ------------------------------------------------------
# Lengths in metres, y up. The courtyard's arcade lines run at |x| = 6 and
# |z| = 15; the galleries behind them reach the outer walls at |x| = 9.5 and
# |z| = 18.5. Bays are 3 m from column to column.
_ATRIUM_ARCADE = (6.0, 15.0)
_ATRIUM_OUTER = (9.5, 18.5)
_ATRIUM_BAY = 3.0
_ATRIUM_TOP = 14.0
# (floor, capital top = arch springing, arch radius, panel top, slab top) a storey
_ATRIUM_STOREYS = ((0.0, 4.6, 1.1, 6.0, 6.4), (6.4, 10.3, 1.1, 12.0, 12.4))
_ATRIUM_VASES = ((-4.3, -11.25), (4.3, -11.25), (-4.3, -3.75), (4.3, -3.75),
                 (-4.3, 3.75), (4.3, 3.75), (-4.3, 11.25), (4.3, 11.25))
# (r, y) outlines of a column (base, fluted shaft, capital; y over its
# storey's floor and scaled to its capital top) and of a vase
_COLUMN_BASE = ((0.52, 0.0), (0.52, 0.12), (0.47, 0.18), (0.50, 0.27), (0.44, 0.36),
                (0.38, 0.42), (0.36, 0.5))
_COLUMN_CAPITAL = ((0.31, 4.0), (0.35, 4.05), (0.31, 4.12), (0.38, 4.3), (0.50, 4.45),
                   (0.55, 4.48), (0.55, 4.6))
_VASE = ((0.30, 0.0), (0.38, 0.08), (0.50, 0.25), (0.58, 0.5), (0.55, 0.75), (0.42, 0.95),
         (0.34, 1.1), (0.40, 1.22), (0.46, 1.3), (0.42, 1.33), (0.36, 1.26), (0.30, 1.16),
         (0.0, 1.16))


def _sheet(pts: np.ndarray) -> np.ndarray:
    """(nu + 1, nv + 1, 3) grid points → (2·nu·nv, 3, 3), two triangles a cell."""
    a, b, c, d = pts[:-1, :-1], pts[1:, :-1], pts[1:, 1:], pts[:-1, 1:]
    return np.concatenate([np.stack([a, b, c], axis=-2).reshape(-1, 3, 3),
                           np.stack([a, c, d], axis=-2).reshape(-1, 3, 3)])


def _rect(origin, u, v, nu: int, nv: int) -> np.ndarray:
    """The parallelogram origin + s·u + t·v (s, t in [0, 1]) as nu × nv cells."""
    s = np.linspace(0.0, 1.0, nu + 1)[:, None, None]
    t = np.linspace(0.0, 1.0, nv + 1)[None, :, None]
    return _sheet(np.asarray(origin, float) + s * np.asarray(u, float) + t * np.asarray(v, float))


def _cells(length: float, detail: int) -> int:
    """Cells along ``length`` metres: one per 2 / detail metres, at least one."""
    return max(1, int(round(length * detail / 2.0)))


def _resample(outline, rings: int) -> np.ndarray:
    """``rings`` (r, y) points spaced evenly along the outline's length."""
    pts = np.asarray(outline, float)
    run = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(pts, axis=0), axis=1))])
    at = np.linspace(0.0, run[-1], rings)
    return np.stack([np.interp(at, run, pts[:, 0]), np.interp(at, run, pts[:, 1])], axis=1)


def _lathe(base, ry: np.ndarray, sides: int, flutes: np.ndarray | None = None) -> np.ndarray:
    """The surface of revolution of the (r, y) rings about the vertical
    through ``base``: 2·sides·(rings − 1) triangles. ``flutes`` (one depth a
    ring) cuts 16 grooves into the radius."""
    phi = 2.0 * np.pi * np.arange(sides + 1) / sides
    r = np.repeat(ry[:, :1], sides + 1, axis=1)
    if flutes is not None:
        r = r * (1.0 - flutes[:, None] * 0.5 * (1.0 + np.cos(16.0 * phi))[None, :])
    pts = np.stack([r * np.cos(phi), np.repeat(ry[:, 1:], sides + 1, axis=1),
                    r * np.sin(phi)], axis=-1)
    pts[:, -1] = pts[:, 0]  # close the seam exactly
    return _sheet(pts + np.asarray(base, float))


def _column(x: float, z: float, storey, detail: int) -> np.ndarray:
    """A column on a storey's floor: base, fluted shaft and capital."""
    floor, top = storey[0], storey[1]
    scale = (top - floor) / _COLUMN_CAPITAL[-1][1]
    shaft = ((0.36, 0.5), (0.34, 2.2), (0.31, 4.0))
    parts = [_resample(_COLUMN_BASE, 2 * detail + 1), _resample(shaft, 3 * detail + 1)[1:],
             _resample(_COLUMN_CAPITAL, 3 * detail + 1)[1:]]
    ry = np.concatenate(parts)
    flutes = np.zeros(len(ry))
    flutes[len(parts[0]):len(parts[0]) + len(parts[1])] = 0.06
    ry[:, 1] = floor + ry[:, 1] * scale
    return _lathe((x, 0.0, z), ry, 8 * detail, flutes)


def _arch_panel(centre, along, across, storey, detail: int) -> np.ndarray:
    """The wall of one bay above its columns' capitals, 0.6 m thick, pierced
    by a round arch: both faces as strips from the arch out to the panel's
    edges, and the arch's soffit. ``centre`` is the bay's centre on the
    arcade line at floor level; ``along`` runs with the arcade, ``across``
    into the gallery."""
    _, y0, radius, y1, _ = storey
    half, height, n_r = _ATRIUM_BAY / 2.0, y1 - y0, detail
    corner = np.arctan2(height, half)
    th = np.sort(np.concatenate([np.linspace(0.0, np.pi, 6 * detail + 1),
                                 [corner, np.pi - corner]]))
    cos, sin = np.cos(th), np.sin(th)
    with np.errstate(divide="ignore"):
        reach = np.minimum(np.where(np.abs(cos) > 1e-9, half / np.abs(cos), np.inf),
                           np.where(sin > 1e-9, height / np.maximum(sin, 1e-300), np.inf))
    k = np.linspace(0.0, 1.0, n_r + 1)[None, :]
    s = (radius + (reach - radius)[:, None] * k) * cos[:, None]
    y = (radius + (reach - radius)[:, None] * k) * sin[:, None]
    along, across = np.asarray(along, float), np.asarray(across, float)
    up = np.array([0.0, 1.0, 0.0])
    base = np.asarray(centre, float) + up * y0

    def face(w):
        return _sheet(base + s[..., None] * along + y[..., None] * up + w * across)

    soffit = base + (s[:, :1, None] * along + y[:, :1, None] * up
                     + np.array([-0.3, 0.3])[None, :, None] * across)
    return np.concatenate([face(-0.3), face(0.3), _sheet(soffit)])


def _box_faces(lo, hi, faces: str, detail: int) -> np.ndarray:
    """Faces of the axis-aligned box [lo, hi], gridded at 2 / detail m:
    ``faces`` picks them, "x-" "x+" "y-" "y+" "z-" "z+" each as one letter
    pair (e.g. "y-y+x-")."""
    lo, hi = np.asarray(lo, float), np.asarray(hi, float)
    ext = hi - lo
    out = []
    for i in range(0, len(faces), 2):
        axis, side = "xyz".index(faces[i]), faces[i + 1]
        u_ax, v_ax = [a for a in range(3) if a != axis]
        origin = lo.copy()
        if side == "+":
            origin[axis] = hi[axis]
        u, v = np.zeros(3), np.zeros(3)
        u[u_ax], v[v_ax] = ext[u_ax], ext[v_ax]
        out.append(_rect(origin, u, v, _cells(ext[u_ax], detail), _cells(ext[v_ax], detail)))
    return np.concatenate(out)


def _drape(plane: float, mid: float, facing: float, axis: int, bay: int,
           detail: int) -> np.ndarray:
    """A cloth hung behind an upper bay: a grid of 6·detail × 9·detail cells,
    2.5 m wide and 4.1 m long, folded about the hanging plane (up to 0.14 m)
    with its hem sagging. ``axis`` 2: hung in the plane x = ``plane``,
    spanning z about ``mid``; ``axis`` 0: in z = ``plane``, spanning x."""
    u = np.linspace(0.0, 1.0, 6 * detail + 1)[:, None]
    v = np.linspace(0.0, 1.0, 9 * detail + 1)[None, :]
    fold = 0.14 * (0.35 + 0.65 * v) * np.sin(2.0 * np.pi * 3.5 * u + 0.9 * bay)
    y = 11.9 - 4.1 * v - 0.15 * np.sin(np.pi * u) * v
    s = np.broadcast_to(mid + (u - 0.5) * 2.5, y.shape)
    depth = plane + facing * fold
    return _sheet(np.stack([depth, y, s] if axis == 2 else [s, y, depth], axis=-1))


def _plant(x: float, z: float, detail: int) -> np.ndarray:
    """A vase on the floor (a lathe of 12·detail sides) with twelve arching
    leaves, each a strip of 2·detail × 2 cells."""
    parts = [_lathe((x, 0.0, z), _resample(_VASE, 6 * detail), 12 * detail)]
    s = np.linspace(0.0, 1.0, 2 * detail + 1)[:, None, None]
    t = np.linspace(-1.0, 1.0, 3)[None, :, None]
    for i in range(12):
        a = 2.0 * np.pi * i / 12.0 + 0.4 * (i % 3)
        out = np.array([np.cos(a), 0.0, np.sin(a)])
        side = np.array([-np.sin(a), 0.0, np.cos(a)])
        reach = 0.8 + 0.15 * (i % 4)
        spine = (np.array([x, 1.2, z]) + out * (0.15 + reach * s)
                 + np.array([0.0, 1.0, 0.0]) * (0.6 * s - 0.55 * s * s))
        parts.append(_sheet(spine + side * (0.03 + 0.15 * np.sin(np.pi * s)) * t))
    return np.concatenate(parts)


def make_sponza_atrium(detail: int = 4) -> np.ndarray:
    """A Sponza-class atrium (the size of Crytek Sponza, McGuire Computer
    Graphics Archive: about 262k triangles), made of the parts Sponza has,
    in metres, y up: a courtyard 12 × 30 m whose long axis is z, ringed on
    all four sides by two storeys of arcades (bays of 3 m; fluted columns
    with base, shaft and capital; a round arch in the wall above each bay;
    the gallery floor and a roof slab behind), the outer walls and an attic
    wall on the arcade lines up to 14 m, and the courtyard open to +y. A
    drape hangs behind each upper bay, eight vases with plants stand on the
    courtyard floor, and the floor's 0.25-m tiles run under the galleries.

    ``detail`` sets every part's tessellation and nothing else: the parts
    keep their places and shapes. At the default 4 the soup has 261,720
    triangles: columns 114,688 (43.8%: 56 of 32 sides and 32 bands), drapes
    48,384 (18.5%: 28 of 24 × 36 cells), arch panels 26,208 (10.0%: 56),
    the floor 22,496 (8.6%), vases and plants 20,736 (7.9%: 8), gallery
    and roof slabs 13,192 (5.0%), outer walls 12,544 (4.8%), the attic
    2,352 (0.9%) and the parapets 1,120 (0.4%). At 1, 18,178. Deterministic;
    no seed.

    The program's sun, normalize(1, 1.5, 1), stands 46.7° high. The attic
    shades the courtyard floor but for the corner farthest from the sun
    (10% of it lit). The galleries on the sun's sides (+x, +z) stay dark;
    on the other two the sun falls through the ground arches onto a band of
    gallery floor behind them, and the drapes shade the upper galleries
    (of the gallery floors, 17% lit in the ground storey, 8% upstairs)."""
    ax, az = _ATRIUM_ARCADE
    ox, oz = _ATRIUM_OUTER
    top = _ATRIUM_TOP
    parts = [_box_faces((-ox, 0.0, -oz), (ox, 0.0, oz), "y+", 2 * detail)]  # the tiles
    # columns on the arcade lines: 11 along each long side, 3 between on each end
    posts = [(sx * ax, z) for sx in (-1.0, 1.0) for z in np.arange(-az, az + 1e-9, _ATRIUM_BAY)]
    posts += [(x, sz * az) for sz in (-1.0, 1.0) for x in (-3.0, 0.0, 3.0)]
    for storey in _ATRIUM_STOREYS:
        parts += [_column(x, z, storey, detail) for x, z in posts]
        for sx in (-1.0, 1.0):
            for zc in np.arange(-az + _ATRIUM_BAY / 2.0, az, _ATRIUM_BAY):
                parts.append(_arch_panel((sx * ax, 0.0, zc), (0.0, 0.0, 1.0), (sx, 0.0, 0.0),
                                         storey, detail))
        for sz in (-1.0, 1.0):
            for xc in np.arange(-ax + _ATRIUM_BAY / 2.0, ax, _ATRIUM_BAY):
                parts.append(_arch_panel((xc, 0.0, sz * az), (1.0, 0.0, 0.0), (0.0, 0.0, sz),
                                         storey, detail))
        # the slab over the storey's galleries: the long sides whole, the ends between
        y0, y1 = storey[3], storey[4]
        for sx in (-1.0, 1.0):
            x0, x1 = sorted((sx * (ax - 0.3), sx * ox))
            parts.append(_box_faces((x0, y0, -oz), (x1, y1, oz),
                                    "y-y+" + ("x-" if sx > 0 else "x+"), detail))
        for sz in (-1.0, 1.0):
            z0, z1 = sorted((sz * (az - 0.3), sz * oz))
            parts.append(_box_faces((-(ax - 0.3), y0, z0), (ax - 0.3, y1, z1),
                                    "y-y+" + ("z-" if sz > 0 else "z+"), detail))
    # the upper storey's parapet between its columns
    floor = _ATRIUM_STOREYS[1][0]
    for sx in (-1.0, 1.0):
        for zc in np.arange(-az + _ATRIUM_BAY / 2.0, az, _ATRIUM_BAY):
            parts.append(_box_faces((sx * ax - 0.15, floor, zc - 1.1),
                                    (sx * ax + 0.15, floor + 1.0, zc + 1.1), "x-x+y+", detail))
    for sz in (-1.0, 1.0):
        for xc in np.arange(-ax + _ATRIUM_BAY / 2.0, ax, _ATRIUM_BAY):
            parts.append(_box_faces((xc - 1.1, floor, sz * az - 0.15),
                                    (xc + 1.1, floor + 1.0, sz * az + 0.15), "z-z+y+", detail))
    # the attic wall on the arcade lines, above the roof slab
    roof = _ATRIUM_STOREYS[1][4]
    for sx in (-1.0, 1.0):
        parts.append(_box_faces((sx * ax - 0.3, roof, -(az + 0.3)), (sx * ax + 0.3, top, az + 0.3),
                                "x-x+y+", detail))
    for sz in (-1.0, 1.0):
        parts.append(_box_faces((-(ax - 0.3), roof, sz * az - 0.3), (ax - 0.3, top, sz * az + 0.3),
                                "z-z+y+", detail))
    # the outer walls
    parts += [_box_faces((-ox, 0.0, -oz), (ox, top, oz), "x-x+z-z+", detail)]
    # drapes behind every upper bay, 0.75 m into the gallery
    bay = 0
    for sx in (-1.0, 1.0):
        for zc in np.arange(-az + _ATRIUM_BAY / 2.0, az, _ATRIUM_BAY):
            parts.append(_drape(sx * (ax + 0.75), zc, sx, 2, bay, detail))
            bay += 1
    for sz in (-1.0, 1.0):
        for xc in np.arange(-ax + _ATRIUM_BAY / 2.0, ax, _ATRIUM_BAY):
            parts.append(_drape(sz * (az + 0.75), xc, sz, 0, bay, detail))
            bay += 1
    parts += [_plant(x, z, detail) for x, z in _ATRIUM_VASES]
    return np.concatenate(parts).astype(np.float32)


def make(detail: int = 4) -> np.ndarray:
    return make_sponza_atrium(detail)
