"""Shared inputs and the traversal tolerance rule of the PyTorch port's tests.

Imports neither JAX nor the JAX package, so the tests of the CUDA kernel can
run on a machine that has only the port.

The rule for every closest-hit traversal comparison, on rays from one
camera origin or from per-ray origins:
* tri is exact, except for ties — a ray where both triangles are accepted
  hits of it and their t values agree within rtol 1e-6; ties are counted
  and must be <= 0.1% of rays;
* t within rtol 1e-5 on hits, exactly 1e30 on misses;
* normals unit within 1e-4 on hits and zero on misses, and within atol 1e-5
  of the reference's.

Under per-tile depth bounds (K1d) a ray that finds no hit below its tile's
bound reports tri = −1, a zero normal and t = the bound:
:func:`tile_bounds` makes such bounds from a seed and
:func:`expected_under_bounds` says what an unbounded image becomes under
them.
"""

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.models.scene import Scene
from raytracer_tpu_torch.ops.camera import INF, primary_dirs
from raytracer_tpu_torch.ops.cuda.traverse import trace_rays_reference
from raytracer_tpu_torch.ops.trace import WideBVH, moller_trumbore
from raytracer_tpu_torch.ops.cuda.wave import cosine_sample
from raytracer_tpu_torch.utils import procgen

CAM_POS = (0.15, -0.1, 2.5)
CAM_QUAT = (0.0, 0.1, 0.0, 0.9949874)
FOV = 70.0
NEAR = (0.0, 0.0, 1.2)   # the cube-normalized sphere fills the frame: every ray hits
UPRIGHT = (0.0, 0.0, 0.0, 1.0)
T_RTOL, TIE_RTOL, MAX_TIE_SHARE = 1e-5, 1e-6, 1e-3
UNIT_ATOL, NORMAL_ATOL = 1e-4, 1e-5
SEED = 7


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test, where a test file imports this fixture: the
    tier-1 run's workers share the host's cores, and the plain versions'
    many small ops, each split over the threads of every worker, slow down
    tens to hundreds of times when those threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_scene(subdivisions: int) -> np.ndarray:
    """Cube-normalized icosphere under a seeded random rotation and
    anisotropic scale (watertight: shared vertices stay shared)."""
    rng = np.random.default_rng(SEED + subdivisions)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    m = q @ np.diag(rng.uniform(0.6, 1.6, size=3))
    tris = (procgen.make_icosphere(subdivisions).astype(np.float64) @ m.T).astype(np.float32)
    scene = Scene().set_triangles(tris)
    scene._normalize_enabled, scene._normalize_mode = True, "cube"
    scene.normalize_mesh()
    return scene.triangles


def room_scene() -> np.ndarray:
    """An open-front room (floor, ceiling, back and side walls of a 2-unit
    box, two triangles each, as in the Cornell box) around an icosphere(2):
    a scene where bounce rays hit something."""
    s = 1.0
    walls = [
        [[-s, -s, -s], [s, -s, -s], [s, -s, s], [-s, -s, s]],
        [[-s, s, -s], [-s, s, s], [s, s, s], [s, s, -s]],
        [[-s, -s, -s], [-s, s, -s], [s, s, -s], [s, -s, -s]],
        [[-s, -s, -s], [-s, -s, s], [-s, s, s], [-s, s, -s]],
        [[s, -s, -s], [s, s, -s], [s, s, s], [s, -s, s]],
    ]
    quads = np.asarray(walls, np.float32)
    tris = np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]])
    ball = procgen.make_icosphere(2, 0.35) + np.float32([0.2, -0.3, 0.1])
    return np.concatenate([tris, ball]).astype(np.float32)


ROOM_CAM = (0.0, 0.1, 2.2)


def ray_buffer(qnodes: torch.Tensor, leaf_k: int, n: int, seed: int = SEED):
    """(origins, dirs) (n, 3) f32 of two kinds, from a seed: bounce-like
    rays — from the hit points of camera rays into the room, offset 1e-4
    along the ray-facing normal, in cosine-sampled directions — then rays
    from a sphere of radius 3 outside the scene toward points inside it."""
    rng = np.random.default_rng(seed)
    m = n // 2
    d = (rng.normal(size=(m, 3)) * [0.3, 0.3, 0.1] + [0.0, 0.0, -1.0]).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.broadcast_to(np.float32(ROOM_CAM), (m, 3)).copy()
    t, nx, ny, nz, tri = trace_rays_reference(qnodes.cpu(), torch.from_numpy(o),
                                              torch.from_numpy(d), leaf_k=leaf_k)
    hit = (tri >= 0).numpy()
    nrm = torch.stack([nx, ny, nz], -1).numpy()
    nrm *= np.where((nrm * d).sum(-1, keepdims=True) > 0, -1.0, 1.0).astype(np.float32)
    p = o + d * t.numpy()[:, None] + nrm * np.float32(1e-4)
    u1, u2 = (torch.from_numpy(rng.random(m).astype(np.float32)) for _ in range(2))
    bd = cosine_sample(torch.from_numpy(nrm), u1, u2).numpy()
    k = n - int(hit.sum())
    oo = rng.normal(size=(k, 3))
    oo = oo / np.linalg.norm(oo, axis=1, keepdims=True) * 3.0
    od = rng.uniform(-0.8, 0.8, size=(k, 3)) - oo
    od /= np.linalg.norm(od, axis=1, keepdims=True)
    origins = np.concatenate([p[hit], oo]).astype(np.float32)
    dirs = np.concatenate([bd[hit], od]).astype(np.float32)
    return origins, dirs


def flat_records(qn) -> np.ndarray:
    """The JAX package's (M, recw / 128, 128) records as (M, recw) numpy."""
    a = np.array(qn)
    return a.reshape(a.shape[0], -1)


def wide_from_numpy(arrays, device="cpu") -> WideBVH:
    """The five arrays of a wide tree of the JAX package, as numpy and in its
    field order (cmn, cmx, cref, root_mn, root_mx) → the port's ``WideBVH`` on
    ``device``: both packages then compute on one tree."""
    cmn, cmx, cref, root_mn, root_mx = (np.array(a) for a in arrays)

    def f32(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    return WideBVH(f32(cmn), f32(cmx), torch.from_numpy(cref.astype(np.int32)).to(device),
                   f32(root_mn), f32(root_mx))


TILE = 32
BOUND_KINDS = ("none", "generous", "under")


def tile_bounds(t, tri, seed: int = SEED):
    """Per-tile depth bounds for an image whose unbounded (H, W) planes are
    ``t`` and ``tri`` → (bounds (⌈H/32⌉, ⌈W/32⌉) f32, kinds (same shape) as
    indices into BOUND_KINDS), from ``seed``. A tile gets no bound (1e30), a
    generous one (1.5 × its farthest hit + 0.1: cuts nothing) or an
    underestimate (halfway between its nearest and farthest hit: cuts the
    farther hits). The first three tiles take the three kinds in turn, so
    every kind occurs; a tile without a hit never gets "under"."""
    t, tri = np.asarray(t, np.float32), np.asarray(tri)
    h, w = t.shape
    nty, ntx = -(-h // TILE), -(-w // TILE)
    rng = np.random.default_rng(seed)
    kinds = rng.integers(0, 3, size=(nty, ntx))
    kinds.reshape(-1)[:3] = (0, 1, 2)
    bounds = np.full((nty, ntx), INF, np.float32)
    for ty in range(nty):
        for tx in range(ntx):
            blk = (slice(ty * TILE, (ty + 1) * TILE), slice(tx * TILE, (tx + 1) * TILE))
            hits = t[blk][tri[blk] >= 0]
            if hits.size == 0:
                kinds[ty, tx] = min(kinds[ty, tx], 1)
                hits = np.float32([1.0])
            if kinds[ty, tx] == 1:
                bounds[ty, tx] = hits.max() * np.float32(1.5) + np.float32(0.1)
            elif kinds[ty, tx] == 2:
                bounds[ty, tx] = np.float32(0.5) * (hits.min() + hits.max())
    return bounds, kinds


def expected_under_bounds(planes, bounds: np.ndarray):
    """What the unbounded (t, nx, ny, nz, tri) planes (H, W) become under the
    per-tile ``bounds``: a pixel whose hit is not nearer than its tile's
    bound reports no hit, a zero normal and t = the bound."""
    t, nx, ny, nz, tri = (np.asarray(p).copy() for p in planes)
    h, w = t.shape
    bpix = np.repeat(np.repeat(bounds, TILE, 0), TILE, 1)[:h, :w]
    cut = ~((tri >= 0) & (t < bpix))
    t[cut] = bpix[cut]
    for n in (nx, ny, nz):
        n[cut] = 0.0
    tri[cut] = -1
    return t, nx, ny, nz, tri


def image_dirs(w: int, h: int, quat=CAM_QUAT) -> torch.Tensor:
    py, px = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    return primary_dirs(px.reshape(-1), py.reshape(-1), w, h, quat, FOV)


def assert_hits_parity(t, tri, ref_t, ref_tri, tris: np.ndarray, dirs: torch.Tensor,
                       origins=CAM_POS, max_tie_share: float = MAX_TIE_SHARE):
    """tri and t of the port against a reference's, by the rule above, for
    rays from ``origins`` — one point (3,) for all rays, or (R, 3) — along
    ``dirs`` (R, 3); returns the mask of rays whose tri agree. A scene seen
    along its own symmetry planes ties on more rays: its caller may raise
    ``max_tie_share`` and says why."""
    t, tri = np.asarray(t).reshape(-1), np.asarray(tri).reshape(-1)
    ref_t, ref_tri = np.asarray(ref_t).reshape(-1), np.asarray(ref_tri).reshape(-1)
    diff = np.nonzero(tri != ref_tri)[0]
    if diff.size:
        assert (tri[diff] >= 0).all() and (ref_tri[diff] >= 0).all(), \
            "hit/miss disagreement is never a tie"
        tt = torch.from_numpy(tris)
        o = torch.as_tensor(np.asarray(origins, np.float32))
        o = o[torch.from_numpy(diff)] if o.dim() == 2 else o

        def mt(ids):
            v = tt[torch.from_numpy(ids).long()]
            return moller_trumbore(o, dirs[diff], v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])

        (ta, oka), (tb, okb) = mt(tri[diff]), mt(ref_tri[diff])
        assert bool((oka & okb).all()), "a tri mismatch must be two accepted hits"
        assert torch.allclose(ta, tb, rtol=TIE_RTOL, atol=0.0), \
            f"tie: t of both triangles within rtol {TIE_RTOL}"
    assert diff.size <= max_tie_share * tri.size, \
        f"{diff.size} ties > {max_tie_share:.2%} of pixels"
    same = tri == ref_tri
    hit = same & (tri >= 0)
    np.testing.assert_allclose(t[hit], ref_t[hit], rtol=T_RTOL, atol=0,
                               err_msg=f"t within rtol {T_RTOL} on hits")
    assert (t[tri < 0] == np.float32(INF)).all(), "t is 1e30 on misses"
    return same


def assert_trace_parity(ours, ref_t, ref_tri, ref_n, tris: np.ndarray, dirs: torch.Tensor,
                        origins=CAM_POS):
    """The rule above on the port's (t, nx, ny, nz, tri) planes against a
    reference's t, tri and (optional) normals, for rays from ``origins``
    (one point or (R, 3)) along ``dirs``."""
    tri = ours[4].reshape(-1).numpy()
    same = assert_hits_parity(ours[0].numpy(), tri, ref_t, ref_tri, tris, dirs, origins)
    n = np.stack([p.reshape(-1).numpy() for p in ours[1:4]], -1)
    ln = np.linalg.norm(n, axis=-1)
    np.testing.assert_allclose(ln[tri >= 0], 1.0, atol=UNIT_ATOL, err_msg="unit normals on hits")
    assert (n[tri < 0] == 0).all(), "zero normals on misses"
    if ref_n is not None:
        hit = same & (tri >= 0)
        np.testing.assert_allclose(n[hit], np.asarray(ref_n).reshape(-1, 3)[hit],
                                   atol=NORMAL_ATOL, rtol=0, err_msg="normals within atol 1e-5")


def deep_records(width: int, depth: int = 32, n: int = 4096, seed: int = SEED,
                 chain_slot: int | None = None, leaf_k: int = 1):
    """Synthetic records whose stacks overflow 64 entries, and ``n`` rays
    through them → (records (M, recw) f32, origins, dirs (n, 3) f32). The
    records have room for ``leaf_k`` triangles a leaf (K) and hold one in
    each leaf, so every K lays out the same tree.

    Record i < ``depth`` is a chain node: one slot holds chain node i + 1,
    the nearest box along the rays, the others dead ends, internal nodes
    whose first slot is a leaf with one triangle across the rays and whose
    other slots are empty. A ray pushes the far dead ends and the near chain
    child at every level (w − 1 entries net), so its stack passes 64 after
    ≈ 64 / (w − 1) levels and the nearest pushes are dropped; the last chain
    node holds the nearest triangle, which only a ray whose chain pushes all
    fit reaches. Boxes are shrunk at random in x and y, so the rays (down
    −z, origins in [−0.9, 0.9]², small tilts) take many depths; pairs of
    dead ends share a box and a triangle height, so keys and t tie.
    ``chain_slot`` puts the chain child in that slot at every level (the
    last slot: a traversal in slot order pushes it last, on top of the dead
    ends, so its stacks overflow too); by default a seeded slot a level."""
    from raytracer_tpu_torch.ops.cuda.traverse import EMPTY_REF, rec_layout

    rng = np.random.default_rng(seed + width)
    vbase, ibase, recw = rec_layout(leaf_k, width)
    n_dead = depth * (width - 1)
    rec = np.zeros((depth + 1 + n_dead, recw), np.float32)
    tri_id = iter(range(1 << 20))

    def empty(row, k):
        rec[row, 6 * k:6 * k + 3] = np.inf
        rec[row, 6 * k + 3:6 * k + 6] = -np.inf
        rec[row, 6 * width + k] = EMPTY_REF

    def leaf(row, k, z):
        rec[row, 6 * k:6 * k + 6] = [-2, -2, z - 0.001, 2, 2, z + 0.001]
        rec[row, 6 * width + k] = -1.0
        rec[row, 7 * width + k] = 1.0
        v0, e1, e2 = np.float32([-4, -4, z]), np.float32([12, 0, 0]), np.float32([0, 12, 0])
        at = vbase + 12 * k * leaf_k
        rec[row, at:at + 12] = np.concatenate([v0, e1, e2, np.cross(e1, e2)])
        rec[row, ibase + k * leaf_k] = next(tri_id)

    def box(lo_z, hi_z):
        lo = -1.0 + rng.uniform(0.0, 0.5, size=2)
        hi = 1.0 - rng.uniform(0.0, 0.5, size=2)
        return [lo[0], lo[1], lo_z, hi[0], hi[1], hi_z]

    dead = depth + 1
    for i in range(depth):
        top = 9.0 - 0.1 * i
        chain = int(rng.integers(width)) if chain_slot is None else chain_slot
        shared = None
        for k in range(width):
            if k == chain:
                rec[i, 6 * k:6 * k + 6] = box(-5.0, top)
                rec[i, 6 * width + k] = i + 1
                continue
            if shared is None or rng.random() < 0.5:
                shared = (box(-5.0, top - 0.05 * (1 + rng.integers(3))),
                          top - 0.05 * (1 + rng.integers(3)) - 0.01)
            bx, z = shared
            rec[i, 6 * k:6 * k + 6] = bx
            rec[i, 6 * width + k] = dead
            leaf(dead, 0, z)
            for kk in range(1, width):
                empty(dead, kk)
            dead += 1
    leaf(depth, 0, 9.5)
    for k in range(1, width):
        empty(depth, k)
    o = np.concatenate([rng.uniform(-0.9, 0.9, size=(n, 2)), np.full((n, 1), 10.0)], 1)
    d = np.concatenate([rng.normal(0.0, 0.02, size=(n, 2)), -np.ones((n, 1))], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(rec), o.astype(np.float32), d.astype(np.float32)


def decode_png(data: bytes) -> np.ndarray:
    """(H, W, C) uint8 array of a PNG as ``utils.image.encode_png`` writes
    it: 8-bit samples, no interlace, filter 0 on every row."""
    import struct
    import zlib

    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG file"
    pos, idat, ihdr = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    w, h, depth, color_type = ihdr[:4]
    channels = {0: 1, 4: 2, 2: 3, 6: 4}[color_type]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * channels)
    assert depth == 8 and not (raw[:, 0] != 0).any(), "8-bit rows of filter 0 only"
    return raw[:, 1:].reshape(h, w, channels)


def sharding_rank(mesh, case: dict) -> dict:
    """One rank of the sharding tests (``tests/test_torch_parallel.py``, run
    by ``parallel.mesh.run_ranks``): every sharding of ``parallel/mesh.py`` on
    ``case``'s records → host arrays. ``spp_seeds`` / ``pt_seeds`` are lists
    of seed lists, one call each (a 1-rank mesh takes one seed a call);
    ``pt_uniforms``, where given, one list of per-rank draws per call."""
    from raytracer_tpu_torch.parallel import mesh as pm

    qn = torch.from_numpy(case["qn"]).to(mesh.device)
    tris = torch.from_numpy(case["tris"]).to(mesh.device)
    pos, quat, k = case["pos"], case["quat"], case["leaf_k"]
    w, h = case["size"]
    out = {"rank": mesh.rank, "size": mesh.size}
    out["tiles"] = [p.cpu().numpy() for p in pm.render_tiles_sharded(
        qn, tris, pos, quat, w, h, mesh, FOV, leaf_k=k)]
    out["spp"] = [pm.render_spp_sharded(qn, tris, pos, quat, s, w, h, mesh, FOV, leaf_k=k)
                  .cpu().numpy() for s in case["spp_seeds"]]
    cpos, cquat, cw, ch = case["cams"]
    out["cams"] = pm.render_cameras_sharded(qn, tris, cpos, cquat, cw, ch, mesh, FOV,
                                            leaf_k=k).cpu().numpy()
    pw, ph = case["pt_size"]
    uniforms = case.get("pt_uniforms") or [None] * len(case["pt_seeds"])
    out["pt"] = [pm.render_pt_spp_sharded(qn, tris, pos, quat, s, pw, ph, mesh,
                                          bounces=case["bounces"], fov_degrees=FOV, leaf_k=k,
                                          uniforms=u).cpu().numpy()
                 for s, u in zip(case["pt_seeds"], uniforms)]
    try:
        pm.make_mesh(mesh.size + 2, "cpu")
        out["bigger_mesh_raised"] = False
    except ValueError:
        out["bigger_mesh_raised"] = True
    return out
