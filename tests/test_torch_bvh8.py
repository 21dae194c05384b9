"""The PyTorch port's 8-wide tree (BVH8) and visits plane against the JAX
package: ``collapse_lbvh2_to_bvh8``, the ``promote`` and ``bvh2`` wideners,
8-wide records, and the plain 8-wide traversals.

Same inputs, made with numpy from a fixed seed, go through the JAX function
and its port. The collapse, the wideners and the records are integer or
bit-level stages: each comparison is exact (bit-equal). The traversals
follow the rule of ``torch_parity`` (tri exact except ties <= 0.1%, t rtol
1e-5, normals unit within 1e-4 and within atol 1e-5; the occlusion mask
equal for any hit); ray directions of the Pallas kernel agree with the
port's within 2·2^-23 (``test_torch_trace.py``). The visits plane is defined
by the port's kernel and has no JAX counterpart: it is held against the
traversal's own counts.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytracer_tpu.ops import collapse as jax_collapse
from raytracer_tpu.ops.cluster import build_lbvh2_clustered as jax_build_lbvh2_clustered
from raytracer_tpu.ops.cluster import build_sah2_clustered as jax_build_sah2_clustered
from raytracer_tpu.ops.cluster import refit_lbvh2_clustered as jax_refit
from raytracer_tpu.ops.lbvh import build_lbvh2 as jax_build_lbvh2
from raytracer_tpu.ops.pallas.traverse import make_qnodes as jax_make_qnodes
from raytracer_tpu.ops.pallas.traverse import trace_rays_pallas, trace_tiles_pallas
from raytracer_tpu.ops.trace import make_wide_bvh as jax_make_wide_bvh
from raytracer_tpu_torch.ops import collapse
from raytracer_tpu_torch.ops.cluster import ClusteredScene, records_pipeline
from raytracer_tpu_torch.ops.collapse import INVALID, LBVH2, LEAF_FLAG
from raytracer_tpu_torch.ops.cuda import traverse
from raytracer_tpu_torch.ops.trace import make_wide_bvh, trace_rays_brute
from raytracer_tpu_torch.utils.fp16 import unpack_bounds
from torch_parity import (CAM_POS, CAM_QUAT, FOV, assert_trace_parity, image_dirs, ray_buffer,
                          room_scene, seeded_scene)

SEED = 20261104


def u32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def plane_scene() -> np.ndarray:
    """A seeded icosphere(2) resting on triangles that lie flat in the plane
    y = 0 (their boxes pack to ±0 and to fp16 subnormals after the
    conservative step), some with x extents below 2^-14 on both sides of 0."""
    rng = np.random.default_rng(SEED)
    ball = seeded_scene(2) * np.float32(0.5) + np.float32([0.0, 0.5, 0.0])
    flat = rng.uniform(-1.0, 1.0, size=(96, 3, 3)).astype(np.float32)
    flat[:, :, 1] = 0.0
    flat[-16:, :, 0] *= np.float32(1e-6)
    flat[-8:, :, 2] = -np.abs(flat[-8:, :, 2]) * np.float32(1e-7)
    return np.concatenate([ball, flat]).astype(np.float32)


SCENES = {"ico": lambda: seeded_scene(2), "plane0": plane_scene}


def jax_tree(kind: str, tris: np.ndarray):
    """(JAX LBVH2, sweeps, JAX ClusteredScene or None, K) of one builder."""
    if kind == "lbvh-K1":
        return jax_build_lbvh2(jnp.asarray(tris)), None, None, 1
    if kind == "morton-K8":
        cs = jax_build_lbvh2_clustered(jnp.asarray(tris[:-3]), 8)  # tail cluster trimmed
        return cs.bvh2, None, cs, 8
    if kind == "refit-K8":
        cs = jax_build_lbvh2_clustered(jnp.asarray(tris[:-3]), 8)
        moved = (tris[:-3] * np.float32(0.9)).astype(np.float32)
        cs = jax_refit(cs, jnp.asarray(moved))
        return cs.bvh2, None, cs, 8
    cs, height = jax_build_sah2_clustered(jnp.asarray(tris), 8)
    return cs.bvh2, height + 2, cs, 8


def to_port(bvh2) -> LBVH2:
    return LBVH2(*(u32(getattr(bvh2, f)) for f in LBVH2._fields))


@pytest.fixture(scope="module",
                params=[(k, s) for k in ("lbvh-K1", "morton-K8", "sah-K8", "refit-K8")
                        for s in SCENES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def tree(request):
    kind, scene = request.param
    tris = SCENES[scene]()
    bvh2, sweeps, cs, k = jax_tree(kind, tris)
    return bvh2, to_port(bvh2), sweeps


def assert_bvh_equal(ours, ref):
    assert ours.num_nodes == int(ref.num_nodes)
    for name in ("bounds_u32", "children", "meta"):
        a, b = getattr(ours, name), u32(getattr(ref, name))
        assert a.shape == b.shape and torch.equal(a, b), f"{name}: tolerance: bit-equal"


def test_collapse8_matches_jax(tree):
    """(a) bounds_u32, children, meta and num_nodes of the 8-wide collapse,
    padding rows included."""
    jbvh2, bvh2, sweeps = tree
    ref = jax_collapse.collapse_lbvh2_to_bvh8(jbvh2, sweeps=sweeps)
    ours = collapse.collapse_lbvh2_to_bvh8(bvh2, sweeps=sweeps)
    assert ours.children.shape == (bvh2.num_nodes, 8)
    assert_bvh_equal(ours, ref)
    assert (ours.children[ours.num_nodes:] == INVALID).all()


def test_collapse8_signed_zeros_and_subnormals_occur():
    """The plane scene does hold what it is for: decoded boxes with −0, and
    fp16 subnormal halfwords that the truncating re-pack flushes."""
    jbvh2, _, _, _ = jax_tree("morton-K8", plane_scene())
    bvh2 = to_port(jbvh2)
    mn, mx = unpack_bounds(bvh2.bounds_u32)
    both = torch.cat([mn, mx])
    assert bool(((both == 0) & torch.signbit(both)).any()), "a −0 bound"
    half = torch.cat([bvh2.bounds_u32 & 0xFFFF, bvh2.bounds_u32 >> 16])
    assert bool((((half & 0x7C00) == 0) & ((half & 0x03FF) != 0)).any()), "a subnormal halfword"
    ours = collapse.collapse_lbvh2_to_bvh8(bvh2)
    inner = ours.meta[:ours.num_nodes] == 0
    h8 = torch.cat([ours.bounds_u32[:ours.num_nodes][inner] & 0xFFFF,
                    ours.bounds_u32[:ours.num_nodes][inner] >> 16])
    assert not bool((((h8 & 0x7C00) == 0) & ((h8 & 0x03FF) != 0)).any()), "flushed on internal rows"


def test_collapse8_structure(tree):
    """Every emitted row is reached once from the root, every leaf of the
    BVH2 appears once, internal nodes keep 2 to 8 children, and each box
    contains its children's within 2^-14: the truncating re-pack flushes the
    fp16 subnormals of internal rows to zero, leaf rows keep theirs."""
    _, bvh2, sweeps = tree
    b8 = collapse.collapse_lbvh2_to_bvh8(bvh2, sweeps=sweeps)
    n = b8.num_nodes
    kids, meta = b8.children[:n], b8.meta[:n]
    leaf = (meta & LEAF_FLAG) != 0
    valid = kids != INVALID
    nkids = valid.sum(dim=1)
    assert bool((nkids[leaf] == 0).all())
    assert bool(((nkids[~leaf] >= 2) & (nkids[~leaf] <= 8)).all())
    seen = torch.bincount(kids[valid], minlength=n)
    assert seen[0] == 0 and bool((seen[1:] == 1).all())
    assert int(leaf.sum()) == bvh2.num_internal + 1
    assert torch.equal(torch.sort(meta[leaf]).values,
                       torch.sort(bvh2.meta[(bvh2.meta & LEAF_FLAG) != 0]).values)
    mn, mx = unpack_bounds(b8.bounds_u32[:n])
    ki = kids.clamp(0, n - 1)
    inside = (mn[:, None, :] <= mn[ki] + 2.0 ** -14) & (mx[:, None, :] >= mx[ki] - 2.0 ** -14)
    assert bool(inside.all(dim=-1)[valid].all())


@pytest.mark.parametrize("name", ["promote_lbvh2_to_bvh4_wide", "bvh2_as_bvh4"])
def test_index_preserving_wideners_match_jax(tree, name):
    """(b) the promote and bvh2 wideners, bit-equal."""
    jbvh2, bvh2, _ = tree
    assert_bvh_equal(getattr(collapse, name)(bvh2), getattr(jax_collapse, name)(jbvh2))


def test_single_node_tree():
    one = LBVH2(u32([[1, 2, 3]]), u32([0]), u32([0]), u32([LEAF_FLAG | 0]), u32([INVALID]))
    b8 = collapse.collapse_lbvh2_to_bvh8(one)
    assert b8.num_nodes == 1 and b8.children.shape == (1, 8) and (b8.children == INVALID).all()
    assert torch.equal(b8.bounds_u32, one.bounds_u32) and torch.equal(b8.meta, one.meta)


def cluster_state(cs, tris: np.ndarray) -> ClusteredScene:
    """A JAX ClusteredScene as the port's, on the CPU."""
    order = u32(cs.tri_order)
    return ClusteredScene(to_port(cs.bvh2), torch.from_numpy(np.asarray(tris))[order], order,
                          int(cs.leaf_size))


@pytest.fixture(scope="module", params=[1, 8, 32], ids=lambda k: f"K{k}")
def records8(request):
    """(triangles, JAX 8-wide records, the port's) of one tree: Karras K = 1
    on icosphere(2), SAH clusters K = 8 on icosphere(2) and K = 32 on
    icosphere(3)."""
    k = request.param
    tris = seeded_scene(3 if k == 32 else 2)
    if k == 1:
        jbvh2 = jax_build_lbvh2(jnp.asarray(tris))
        ref = jax_make_qnodes(jax_make_wide_bvh(jax_collapse.collapse_lbvh2_to_bvh8(jbvh2)),
                              jnp.asarray(tris))
        wide = make_wide_bvh(collapse.collapse_lbvh2_to_bvh8(to_port(jbvh2)))
        ours = traverse.make_qnodes(wide, torch.from_numpy(tris))
    else:
        cs, height = jax_build_sah2_clustered(jnp.asarray(tris), k)
        b8 = jax_collapse.collapse_lbvh2_to_bvh8(cs.bvh2, sweeps=height + 2)
        ref = jax_make_qnodes(jax_make_wide_bvh(b8), cs.tris_sorted, tri_ids=cs.tri_order,
                              leaf_size=k)
        ours = records_pipeline(cluster_state(cs, tris), height=height, width=8)
    ref = np.asarray(ref)
    return k, tris, ref.reshape(ref.shape[0], -1), ours


def test_records8_byte_equal(records8):
    """(c) make_wide_bvh + make_qnodes of an 8-wide tree: rows of
    rec_layout(K, 8) words (header 64 words; 3,456-word rows at K = 32),
    byte-equal to the JAX package's."""
    k, _, ref, ours = records8
    vbase, _, recw = traverse.rec_layout(k, 8)
    assert vbase == 64 and ours.shape == ref.shape and ours.shape[1] == recw
    assert traverse.infer_rec_width(k, recw) == 8
    if k == 32:
        assert recw == 3456
    assert np.array_equal(ours.numpy().view(np.uint32), ref.view(np.uint32)), \
        "tolerance: byte-equal"


def brute(tris: np.ndarray, o: torch.Tensor, d: torch.Tensor):
    return trace_rays_brute(torch.from_numpy(tris), o, d)


def test_plain_tiles8_match_brute(records8):
    """(d) the plain 8-wide tile traversal against brute force, 96×64."""
    k, tris, _, qn = records8
    w, h = 96, 64
    ours = traverse.trace_tiles(qn, CAM_POS, CAM_QUAT, w, h, FOV, leaf_k=k)
    dirs = image_dirs(w, h)
    origins = torch.tensor(CAM_POS).expand(w * h, 3).contiguous()
    bt, btri = brute(tris, origins, dirs)
    assert_trace_parity(ours, bt, btri, None, tris, dirs)
    assert 0.1 < float((ours[4] >= 0).float().mean()) < 0.9


@pytest.fixture(scope="module")
def room8():
    """8-wide K = 8 records of the room scene and a seeded ray buffer."""
    from raytracer_tpu_torch.ops.cluster import build_sah2_clustered

    tris = room_scene()
    cs, height = build_sah2_clustered(tris, 8, "cpu")
    qn8 = records_pipeline(cs, height=height, width=8)
    qn4 = records_pipeline(cs)
    o, d = ray_buffer(qn4, 8, 2048)
    return tris, qn4, qn8, torch.from_numpy(o), torch.from_numpy(d)


def test_plain_rays8_match_brute(room8):
    """(d) the plain 8-wide ray traversal against brute force: closest hit
    by the traversal rule, the any-hit occlusion mask equal."""
    tris, _, qn8, o, d = room8
    ours = traverse.trace_rays(qn8, o, d, leaf_k=8)
    bt, btri = brute(tris, o, d)
    assert_trace_parity(ours, bt, btri, None, tris, d, o.numpy())
    occ = traverse.trace_rays(qn8, o, d, any_hit=True, leaf_k=8)
    assert torch.equal(occ[4] >= 0, btri >= 0)
    assert bool((occ[0][occ[4] >= 0] == 0).all()) and bool((occ[0][occ[4] < 0] == 1e30).all())
    assert 0.1 < float((btri >= 0).float().mean()) < 0.95


def test_plain_versions8_match_pallas_interpret():
    """(e) the plain 8-wide traversals against the Pallas kernels in
    interpret mode on the same K = 1 records: the tile kernel at 64×32, the
    ray kernel on 512 rays for closest hit and any hit."""
    tris = seeded_scene(2)
    jbvh2 = jax_build_lbvh2(jnp.asarray(tris))
    qn = jax_make_qnodes(jax_make_wide_bvh(jax_collapse.collapse_lbvh2_to_bvh8(jbvh2)),
                         jnp.asarray(tris))
    qn_t = torch.from_numpy(np.array(qn).reshape(qn.shape[0], -1))
    w, h = 64, 32
    ref = trace_tiles_pallas(qn, jnp.asarray(CAM_POS, jnp.float32),
                             jnp.asarray(CAM_QUAT, jnp.float32), w, h, FOV, interpret=True,
                             leaf_k=1)
    ours = traverse.trace_tiles(qn_t, CAM_POS, CAM_QUAT, w, h, FOV, leaf_k=1)
    dirs = image_dirs(w, h)
    assert_trace_parity(ours, ref[0], ref[4], np.stack([np.asarray(p) for p in ref[1:4]], -1),
                        tris, dirs)
    assert 0.1 < float((ours[4] >= 0).float().mean()) < 0.9

    o = torch.tensor(CAM_POS).expand(512, 3).contiguous()
    d = dirs[torch.arange(512) * (w * h // 512)].contiguous()
    rref = trace_rays_pallas(qn, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), interpret=True,
                             leaf_k=1)
    rours = traverse.trace_rays(qn_t, o, d, leaf_k=1)
    assert_trace_parity(rours, rref[0], rref[4],
                        np.stack([np.asarray(p) for p in rref[1:4]], -1), tris, d)
    aref = trace_rays_pallas(qn, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), interpret=True,
                             leaf_k=1, any_hit=True)
    aours = traverse.trace_rays(qn_t, o, d, any_hit=True, leaf_k=1)
    assert np.array_equal(aours[4].numpy() >= 0, np.asarray(aref[4]) >= 0)


@pytest.mark.parametrize("jitter", [False, True], ids=["centre", "jitter"])
def test_visits_plane_of_the_plain_version(room8, jitter):
    """(f) the visits plane: at least 1 everywhere (the root), its sum equal
    to TraversalCounts.visits, the five other planes unchanged by stats, at
    both widths; and fewer visits in total on the 8-wide tree than on the
    4-wide tree of the same BVH2."""
    _, qn4, qn8, _, _ = room8
    w, h = 48, 40
    totals = {}
    for qn in (qn4, qn8):
        counts = traverse.TraversalCounts()
        kw = dict(leaf_k=8, jitter=jitter, jitter_seed=11)
        plain = traverse.trace_tiles_reference(qn, (0.0, 0.1, 2.2), CAM_QUAT, w, h, FOV,
                                               counts=counts, **kw)
        with_stats = traverse.trace_tiles(qn, (0.0, 0.1, 2.2), CAM_QUAT, w, h, FOV, stats=True,
                                          **kw)
        assert len(with_stats) == 6 and len(plain) == 5
        assert all(torch.equal(a, b) for a, b in zip(with_stats[:5], plain))
        visits = with_stats[5]
        assert visits.dtype == torch.float32 and visits.shape == (h, w)
        assert bool((visits >= 1).all()) and bool((visits == visits.round()).all())
        assert int(visits.sum()) == counts.visits
        assert counts.width == traverse.infer_rec_width(8, qn.shape[1])
        totals[counts.width] = counts.visits
    assert totals[8] < totals[4]


def test_visits_plane_of_a_batch(room8):
    """trace_tiles_batch(stats=True): each frame's six planes equal
    trace_tiles(stats=True) for its camera, on 8-wide records."""
    _, _, qn8, _, _ = room8
    pos = np.float32([[0.0, 0.1, 2.2], [0.3, 0.0, 2.0]])
    quat = np.float32([CAM_QUAT, [0.0, 0.0, 0.0, 1.0]])
    batch = traverse.trace_tiles_batch(qn8, pos, quat, 24, 16, FOV, leaf_k=8, stats=True)
    assert len(batch) == 6 and batch[5].shape == (2, 16, 24)
    for f in range(2):
        single = traverse.trace_tiles(qn8, pos[f], quat[f], 24, 16, FOV, leaf_k=8, stats=True)
        assert all(torch.equal(b[f], s) for b, s in zip(batch, single))


def test_counts_refuse_mixed_widths(room8):
    _, qn4, qn8, o, d = room8
    counts = traverse.TraversalCounts()
    traverse.trace_rays_reference(qn4, o[:8], d[:8], leaf_k=8, counts=counts)
    assert counts.unique_record_bytes() >= 128
    with pytest.raises(ValueError):
        traverse.trace_rays_reference(qn8, o[:8], d[:8], leaf_k=8, counts=counts)
