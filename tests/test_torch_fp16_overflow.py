"""Boxes beyond the fp16 range (|x| > 65504) in the PyTorch port's builds,
against the JAX package.

The conservative pack steps a box's ±inf (the fp16 rounding of anything
beyond 65504) to the fp16 NaN 0x7C01 / 0xFC01, and the bounds sweeps carry
such NaNs up the tree through f32 min / max. Every word must equal the JAX
package's (tolerance: bit-equal): the fp16 → f32 decode of all 65,536
patterns, the f32 → fp16 encode of NaNs, and the BVH2 of a seeded soup
scaled by 1e20 through ``build_lbvh2``, ``refit_lbvh2``, ``build_ploc2``
and the Morton cluster build and its refit, and of soups that end just
inside the fp16 range. The clustered refit's one ``minimum`` a sweep must
give the tree that ``f16_union_key`` gives union by union, NaNs of any
payload included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_records import seeded_mesh

from raytracer_tpu.ops import cluster as jax_cluster
from raytracer_tpu.ops import fp16_jax
from raytracer_tpu.ops import lbvh as jax_lbvh
from raytracer_tpu.ops import ploc as jax_ploc
from raytracer_tpu_torch.ops import cluster, lbvh, ploc
from raytracer_tpu_torch.ops.lbvh import LEAF_FLAG, f16_order, f16_union_key, f16_unorder
from raytracer_tpu_torch.utils import fp16

SOUP_TRIANGLES = 300


def soup(scale: float, seed: int = 11) -> np.ndarray:
    """A seeded triangle soup of extent ``scale``, a third of it shrunk by
    1e-16 so that boxes within and beyond the fp16 range meet in one tree."""
    rng = np.random.default_rng(seed)
    tris = ((rng.random((SOUP_TRIANGLES, 3, 3)) - 0.5) * 2 * scale).astype(np.float32)
    tris[: SOUP_TRIANGLES // 3] *= np.float32(1e-16)
    return tris


def nan_halfwords(bounds) -> int:
    b = np.asarray(bounds).astype(np.int64)
    h = np.concatenate([b & 0xFFFF, b >> 16], axis=1)
    return int((((h & 0x7C00) == 0x7C00) & ((h & 0x3FF) != 0)).sum())


def assert_same_tree(ref, ours, what: str) -> None:
    for field, a, b in zip(("bounds", "left", "right", "meta", "parent"), ref, ours):
        a = np.asarray(a).astype(np.int64)
        assert a.shape == tuple(b.shape), (what, field)
        diff = int((a != b.numpy()).sum())
        assert diff == 0, f"{what}: {field} differs from the JAX package in {diff} words"


def test_f16_decode_of_every_pattern_bit_equal_to_jax():
    bits = np.arange(1 << 16, dtype=np.uint32)
    ref = np.asarray(fp16_jax.f16_bits_to_f32(jnp.asarray(bits))).view(np.uint32)
    # the three lanes of a short tensor take torch's scalar path, the rest
    # its vector path: the decode must not depend on which
    for sl in (slice(None), slice(0x7C01, 0x7C04), slice(0xFE00, 0xFE03)):
        ours = fp16._f16_bits_to_f32_t(torch.from_numpy(bits[sl].astype(np.int64)))
        np.testing.assert_array_equal(ours.numpy().view(np.uint32), ref[sl])


def test_f16_encode_of_nans_bit_equal_to_jax():
    words = np.array([0x7FC02000, 0xFFC02000, 0x7FC00000, 0x7F800001, 0x7FFFFFFF, 0xFFFFFFFF,
                      0x7FDFE000, 0xFF801234, 0x7F800000, 0xFF800000], np.uint32)
    x = np.repeat(words, 7).view(np.float32)  # long enough for the vector path too
    ref = np.asarray(fp16_jax.f32_to_f16_bits(jnp.asarray(x))).astype(np.int64)
    np.testing.assert_array_equal(fp16.f32_to_f16_bits(torch.from_numpy(x)).numpy(), ref)


@pytest.fixture(scope="module")
def trees():
    tris = soup(1e20)
    ref = jax_lbvh.build_lbvh2(jnp.asarray(tris))
    assert nan_halfwords(ref.bounds_u32) > 0, "the soup must reach NaN halfwords"
    return tris, ref, lbvh.build_lbvh2(torch.from_numpy(tris))


def test_lbvh_of_1e20_soup_word_equal(trees):
    _, ref, ours = trees
    assert_same_tree(ref, ours, "build_lbvh2")


def test_refit_of_1e20_soup_word_equal(trees):
    tris, ref, ours = trees
    moved = (tris[::-1] * np.float32(1.3)).astype(np.float32)
    assert_same_tree(jax_lbvh.refit_lbvh2(ref, jnp.asarray(moved)),
                     lbvh.refit_lbvh2(ours, torch.from_numpy(moved)), "refit_lbvh2")


def test_ploc_of_1e20_soup_word_equal():
    tris = soup(1e20, seed=12)
    ref = jax_ploc.build_ploc2(jnp.asarray(tris))
    assert nan_halfwords(ref.bounds_u32) > 0
    assert_same_tree(ref, ploc.build_ploc2(torch.from_numpy(tris)), "build_ploc2")


def test_clustered_build_and_refit_of_1e20_soup_word_equal():
    tris = soup(1e20, seed=13)
    moved = (tris * np.float32(-0.7)).astype(np.float32)
    ref = jax_cluster.build_lbvh2_clustered(jnp.asarray(tris), 4)
    ours = cluster.build_lbvh2_clustered(torch.from_numpy(tris), 4)
    assert nan_halfwords(ref.bvh2.bounds_u32) > 0
    assert_same_tree(ref.bvh2, ours.bvh2, "build_lbvh2_clustered")
    assert_same_tree(jax_cluster.refit_lbvh2_clustered(ref, jnp.asarray(moved)).bvh2,
                     cluster.refit_lbvh2_clustered(ours, torch.from_numpy(moved)).bvh2,
                     "refit_lbvh2_clustered")


@pytest.mark.parametrize("extent", [6.0e4, 6.4e4, 6.5e4, 65504.0])
def test_lbvh_at_the_fp16_limit_word_equal(extent):
    """Soups whose boxes end within a few ULPs of ±65504, where a build's
    sweeps step some ancestors to ±inf or NaN and others not: every word
    equals the JAX package's, whichever rule the sweeps take."""
    rng = np.random.default_rng(int(extent))
    tris = ((rng.random((SOUP_TRIANGLES, 3, 3)) - 0.5) * 2).astype(np.float32)
    tris[rng.integers(0, SOUP_TRIANGLES, 4), 0] = np.float32(extent) * np.float32([[1, -1, 1]])
    ref = jax_lbvh.build_lbvh2(jnp.asarray(tris))
    assert_same_tree(ref, lbvh.build_lbvh2(torch.from_numpy(tris)), f"build_lbvh2 at {extent}")


@pytest.mark.parametrize("kind", ["sah", "morton"])
def test_clustered_refit_sweeps_follow_the_pairwise_nan_rule(kind):
    """NaN coordinates of many payloads and both signs, and boxes beyond the
    fp16 range, in a deformed mesh: the internal rows of the clustered
    refit equal, word for word, the sweeps that take ``f16_union_key`` union
    by union from the same leaf rows, in the SAH (pre-order) and the Morton
    (Karras) layout."""
    tris = seeded_mesh(2)
    if kind == "sah":
        cs, height = cluster.build_sah2_clustered(tris, 8, "cpu")
    else:
        cs = cluster.build_lbvh2_clustered(torch.from_numpy(tris), 8)
        height = cluster.tree_height(cs.bvh2)
    rng = np.random.default_rng(5)
    moved = tris.copy()
    moved[rng.random(len(moved)) < 0.3] *= np.float32(1e20)
    words = moved.view(np.uint32)
    nan = rng.random(words.shape) < 0.02
    words[nan] = (rng.integers(0, 2, nan.sum()).astype(np.uint32) << 31) | 0x7F800000 \
        | rng.integers(1, 1 << 23, nan.sum()).astype(np.uint32)
    bounds = cluster.refit_lbvh2_clustered(cs, torch.from_numpy(moved), height + 2).bvh2.bounds_u32
    assert nan_halfwords(bounds) > 0

    bvh = cs.bvh2
    leaf = ((bvh.meta & LEAF_FLAG) != 0)[:, None]
    h = torch.cat([bounds & 0xFFFF, bounds >> 16], dim=1)[:, [0, 3, 1, 4, 2, 5]]
    key = torch.where(leaf, f16_order(h), f16_order(torch.zeros_like(h)))
    for _ in range(height + 2):
        kl, kr = key[bvh.left], key[bvh.right]
        union = torch.cat([f16_union_key(kl[:, :3], kr[:, :3], False),
                           f16_union_key(kl[:, 3:], kr[:, 3:], True)], dim=1)
        key = torch.where(leaf, key, union)
    h = f16_unorder(key)
    pairwise = torch.stack([h[:, 0] | (h[:, 1] << 16), h[:, 2] | (h[:, 3] << 16),
                            h[:, 4] | (h[:, 5] << 16)], dim=1)
    diff = int((pairwise != bounds).sum())
    assert diff == 0, f"{kind}: {diff} words differ from the pairwise NaN rule (tolerance: bit-equal)"
