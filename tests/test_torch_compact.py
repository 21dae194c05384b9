"""Wavefront compaction and traversal without near-first order in the
PyTorch port, against the JAX package.

* ``ops/partition.py``: the permutations and positions equal the JAX
  package's on every case of ``tests/test_partition.py`` (exact).
* The compaction key: word for word the JAX package's expression
  (``raytracer_tpu/render_pt.py:419-446``) on seeded origins, directions
  and liveness, for both key forms.
* ``pt_sample_frame(compact=True)`` with the JAX package's uniforms
  injected, against JAX's ``pt_sample_frame(brute=True, compact=True)``
  (``RT_COMPACT`` = argsort and partition): the tolerances of
  ``test_torch_progressive.py`` — radiance within atol 1e-5 on >= 99% of
  pixels and the ``stats`` counts equal — for the port's brute-force path
  and its records path (plain versions, K = 8).
* ``trace_rays_reference(ordered=False)``: closest-hit planes bit-equal to
  the ordered traversal's, any-hit masks equal, the visits counted; a
  sample with both orders off equal to the ordered one bit for bit.
* ``render_progressive`` on the CPU equals ``pt_sample_frame`` with the
  compaction default and the same generator, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu.render_pt as jax_render_pt
from raytracer_tpu.ops.morton import morton3d as jax_morton3d
from raytracer_tpu.ops.partition import bucket_partition_perm as jax_partition_perm
from raytracer_tpu.ops.partition import bucket_positions as jax_positions
from raytracer_tpu.utils import procgen as jax_procgen
from raytracer_tpu_torch import PathTracer, Scene, pt_sample_frame
from raytracer_tpu_torch import pathtracer as torch_pathtracer
from raytracer_tpu_torch.ops.cuda import traverse
from raytracer_tpu_torch.ops.partition import bucket_partition_perm, bucket_positions
from raytracer_tpu_torch.render_pt import compaction_key
from test_torch_progressive import ROOM_POS, ROOM_QUAT, jax_uniforms
from test_torch_trace import jax_records
from torch_parity import deep_records, ray_buffer, room_scene

SUN = (np.float32([1.0, 1.5, 1.0]) / np.linalg.norm([1.0, 1.5, 1.0])).astype(np.float32)
W, H = 40, 24


@pytest.mark.parametrize("r,b", [(1000, 2), (4096, 16), (100000, 256), (257, 16), (31, 256)])
def test_partition_matches_jax(r, b):
    keys = np.random.default_rng(r + b).integers(0, b, size=r).astype(np.int32)
    pos = bucket_positions(torch.from_numpy(keys), b)
    perm = bucket_partition_perm(torch.from_numpy(keys), b)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jax_positions(jnp.asarray(keys), b)))
    np.testing.assert_array_equal(perm.numpy(),
                                  np.asarray(jax_partition_perm(jnp.asarray(keys), b)))
    assert torch.equal(perm, torch.argsort(torch.from_numpy(keys), stable=True))


def jax_key(o, d, alive, impl: str) -> np.ndarray:
    """The JAX package's compaction key (render_pt.py:419-446), verbatim."""
    o, d, alive = jnp.asarray(o), jnp.asarray(d), jnp.asarray(alive)
    q = jnp.clip((o + 2.0) * (1023.0 / 4.0), 0.0, 1023.0).astype(jnp.uint32)
    m = jax_morton3d(q[:, 0], q[:, 1], q[:, 2])
    octant = ((d[:, 0] < 0).astype(jnp.uint32) * 4 + (d[:, 1] < 0).astype(jnp.uint32) * 2
              + (d[:, 2] < 0).astype(jnp.uint32))
    if impl == "argsort":
        key = ((~alive).astype(jnp.uint32) << jnp.uint32(31) | (octant << jnp.uint32(28))
               | (m >> jnp.uint32(2)))
    else:
        key = ((~alive).astype(jnp.int32) << 7 | (octant.astype(jnp.int32) << 4)
               | ((m >> jnp.uint32(26)).astype(jnp.int32) & 0xF))
    return np.asarray(jax.jit(lambda k: k)(key)).astype(np.int64)


@pytest.mark.parametrize("impl", ["argsort", "partition"])
def test_compaction_key_matches_jax(impl):
    """Origins spread over and beyond the quantised cube [-2, 2] (clipped
    lanes), on cell boundaries, signed zeros in the directions."""
    rng = np.random.default_rng(3)
    r = 20000
    o = (rng.random((r, 3)) * 5.0 - 2.5).astype(np.float32)
    o[:500] = (np.round(o[:500] * 255.75) / np.float32(255.75)).astype(np.float32)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d[:300, 1] = np.float32(-0.0)
    d[300:600, 2] = np.float32(0.0)
    alive = rng.random(r) < 0.6
    ours = compaction_key(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(alive), impl)
    np.testing.assert_array_equal(ours.numpy(), jax_key(o, d, alive, impl))
    perm = torch.argsort(ours, stable=True)
    assert torch.equal(perm, torch.from_numpy(np.argsort(jax_key(o, d, alive, impl),
                                                         kind="stable")))


def test_compaction_impls_group_alike():
    """As tests/test_partition.py::test_compaction_impl_equivalence: the
    partition groups the lanes by the small key stably, and each group is
    the set of lanes that the argsort key puts there."""
    rng = np.random.default_rng(7)
    r = 8192
    o = torch.from_numpy((rng.random((r, 3)) * 4.0 - 2.0).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(r, 3)).astype(np.float32))
    alive = torch.from_numpy(rng.random(r) < 0.7)
    small = compaction_key(o, d, alive, "partition")
    full = compaction_key(o, d, alive, "argsort")
    perm = bucket_partition_perm(small, 256)
    assert bool((small[perm].diff() >= 0).all())
    by_full = torch.argsort(full, stable=True)
    assert torch.equal(small[by_full], small[perm])
    assert torch.equal(full >> 24, small)


def jax_compacted_sample(tris, key, bounces: int, impl: str):
    """The JAX package's brute-force compacted sample under RT_COMPACT =
    ``impl`` (the module global it reads; a fresh jit traces with it)."""
    saved = jax_render_pt._COMPACT_IMPL
    jax_render_pt._COMPACT_IMPL = impl

    def sample(*args, **kw):  # a function of its own: jit caches by function
        return jax_render_pt.pt_sample_frame.__wrapped__(*args, **kw)

    try:
        fn = jax.jit(sample, static_argnames=("width", "height", "bounces", "brute", "compact",
                                              "stats"))
        return fn(None, jnp.asarray(tris), jnp.asarray(ROOM_POS, jnp.float32),
                  jnp.asarray(ROOM_QUAT, jnp.float32), key, width=W, height=H,
                  bounces=bounces, brute=True, compact=True, stats=True)
    finally:
        jax_render_pt._COMPACT_IMPL = saved


@pytest.fixture(scope="module")
def cornell():
    tris = jax_procgen.make_cornell_box()
    return tris, torch.from_numpy(jax_records(tris, 8))


def assert_close_sample(ours, stats, ref, ref_stats, what: str) -> None:
    assert ours.shape == (H, W, 3) and ours.dtype == torch.float32
    err = np.abs(ours.numpy() - np.asarray(ref)).max(-1)
    share = float((err <= 1e-5).mean())
    assert share >= 0.99, f"{what}: {share:.4f} of pixels within 1e-5 (max |Δ| {err.max()})"
    assert int(stats["alive_rays"]) == int(ref_stats["alive_rays"]), what
    assert int(stats["lane_rays"]) == int(ref_stats["lane_rays"]), what


@pytest.mark.parametrize("impl", ["argsort", "partition"])
@pytest.mark.parametrize("bounces", [2, 3])
def test_compacted_sample_matches_jax_brute(cornell, bounces, impl):
    """pt_sample_frame(compact=True) with JAX's uniforms: by brute force,
    and through the records with the plain versions, against JAX's
    brute-force compacted sample of the same key."""
    tris, qn = cornell
    key = jax.random.key(11)
    ref, ref_stats = jax_compacted_sample(tris, key, bounces, impl)
    uniforms = jax_uniforms(key, W, H, bounces)
    kw = dict(bounces=bounces, uniforms=uniforms, stats=True, compact=True, compact_impl=impl)
    brute = pt_sample_frame(None, torch.from_numpy(tris), ROOM_POS, ROOM_QUAT, W, H,
                            brute=True, **kw)
    assert_close_sample(*brute, ref, ref_stats, f"brute, {impl}, {bounces} bounces")
    records = pt_sample_frame(qn, torch.from_numpy(tris), ROOM_POS, ROOM_QUAT, W, H,
                              leaf_k=8, **kw)
    assert_close_sample(*records, ref, ref_stats, f"records, {impl}, {bounces} bounces")
    # without compaction the same draws meet other pixels from the second
    # bounce wave on; at 2 bounces that wave's draws set directions that no
    # wave traces, so the image is the same
    plain = pt_sample_frame(qn, torch.from_numpy(tris), ROOM_POS, ROOM_QUAT, W, H, leaf_k=8,
                            bounces=bounces, uniforms=uniforms)
    assert torch.equal(plain, records[0]) == (bounces == 2)


def test_compact_impl_is_checked(cornell):
    tris, qn = cornell
    with pytest.raises(ValueError, match="compact_impl"):
        pt_sample_frame(qn, torch.from_numpy(tris), ROOM_POS, ROOM_QUAT, 8, 8, leaf_k=8,
                        generator=torch.Generator().manual_seed(0), compact=True,
                        compact_impl="bitonic")


@pytest.mark.parametrize("k", [1, 8])
def test_unordered_reference_matches_ordered(k):
    """The plain version without near-first order: the same nearest hits
    (every plane bit-equal), the same occlusion masks, more visits; the
    wrapper on the CPU runs it and launches nothing."""
    from test_torch_kernel import records_of

    qn = records_of(room_scene(), k, 4, "cpu")
    o, d = (torch.from_numpy(a) for a in ray_buffer(qn, k, 2048))
    sun = torch.from_numpy(SUN).expand_as(d).contiguous()
    before = dict(traverse.LAUNCHES)
    visits = {}
    for ordered in (True, False):
        counts = traverse.TraversalCounts()
        closest = traverse.trace_rays_reference(qn, o, d, leaf_k=k, counts=counts,
                                                ordered=ordered)
        visits[ordered] = counts.visits
        occl = traverse.trace_rays_reference(qn, o, sun, any_hit=True, leaf_k=k,
                                             ordered=ordered)
        wrapped = traverse.trace_rays(qn, o, d, leaf_k=k, ordered=ordered)
        assert all(torch.equal(a, b) for a, b in zip(wrapped, closest))
        if ordered:
            ref_closest, ref_occl = closest, occl
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(closest, ref_closest))
    assert torch.equal(occl[4] >= 0, ref_occl[4] >= 0)
    assert bool((occl[4] >= 0).any())
    assert visits[False] > visits[True] > 0
    assert traverse.LAUNCHES == before


def test_unordered_reference_drops_in_slot_order():
    """Records whose stacks pass 64 entries: the unordered walk drops the
    later slots' pushes, counted, and still returns the miss values or a
    hit of the scene on every ray."""
    qn, o, d = deep_records(4, n=512, chain_slot=3)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    counts = traverse.TraversalCounts()
    t, *_, tri = traverse.trace_rays_reference(qn, o, d, leaf_k=1, counts=counts, ordered=False)
    assert counts.dropped > 0 and counts.max_depth == 64
    assert bool(((tri >= 0) == (t < 1e30)).all())


def test_unordered_sample_equals_ordered(cornell):
    """Both orders off (the JAX package's RT_WAVE_ORDERED_CH / _AH = 0):
    the same sample, bit for bit, compacted or not."""
    tris, qn = cornell
    for compact in (False, True):
        kw = dict(leaf_k=8, bounces=3, compact=compact)
        ref = pt_sample_frame(qn, torch.from_numpy(tris), ROOM_POS, ROOM_QUAT, W, H,
                              generator=torch.Generator().manual_seed(4), **kw)
        ours = pt_sample_frame(qn, torch.from_numpy(tris), ROOM_POS, ROOM_QUAT, W, H,
                               generator=torch.Generator().manual_seed(4), ordered_ch=False,
                               ordered_ah=False, **kw)
        assert torch.equal(ours, ref), compact


@pytest.mark.parametrize("compact", [torch_pathtracer.COMPACT_WAVES, True])
def test_render_progressive_equals_its_sample(monkeypatch, compact):
    """The first render_progressive sample on the CPU is pt_sample_frame
    with COMPACT_WAVES (the default, and compaction on), the tile-kernel
    camera wave and a generator seeded with frame_count 0."""
    monkeypatch.setattr(torch_pathtracer, "COMPACT_WAVES", compact)
    tris = jax_procgen.make_cornell_box()
    pt = PathTracer(W, H, builder="sah", leaf_size=8, device="cpu")
    pt.set_scene(Scene().set_triangles(tris))
    pt.set_camera_position(*ROOM_POS)
    pt.set_camera_quaternion(*ROOM_QUAT)
    accum = pt.render_progressive(bounces=3)
    sample = pt_sample_frame(pt._qnodes, pt._tris_dev, ROOM_POS, ROOM_QUAT, W, H, bounces=3,
                             fov_degrees=pt.fov_degrees, leaf_k=8, tile_primary=True,
                             generator=torch.Generator().manual_seed(0),
                             compact=compact)
    assert torch.equal(accum, sample)
