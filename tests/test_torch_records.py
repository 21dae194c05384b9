"""The PyTorch port's host layer and records against the JAX package.

Same inputs, made with numpy from a fixed seed, go through the JAX function
and its port; every stage here is integer or bit-level, so each comparison
is exact (bit-equal).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytracer_tpu import PathTracer as JaxPathTracer
from raytracer_tpu.models.scene import Scene as JaxScene
from raytracer_tpu.ops.cluster import build_sah2_clustered as jax_build_sah2_clustered
from raytracer_tpu.ops.collapse import collapse_lbvh2_to_bvh4 as jax_collapse
from raytracer_tpu.ops.pallas.traverse import make_qnodes as jax_make_qnodes
from raytracer_tpu.ops.trace import make_wide_bvh as jax_make_wide_bvh
from raytracer_tpu.utils import procgen as jax_procgen
from raytracer_tpu_torch import PathTracer, Scene
from raytracer_tpu_torch.ops.cluster import state_from_numpy
from raytracer_tpu_torch.ops.collapse import INVALID, collapse_lbvh2_to_bvh4
from raytracer_tpu_torch.ops.cuda.traverse import EMPTY_REF, make_qnodes, rec_layout
from raytracer_tpu_torch.ops.trace import make_wide_bvh
from raytracer_tpu_torch.utils import procgen

SEED = 20261016


def seeded_mesh(subdivisions: int) -> np.ndarray:
    """Icosphere under a seeded random rotation, anisotropic scale and shift
    (shared vertices stay shared, so the mesh stays watertight)."""
    rng = np.random.default_rng(SEED + subdivisions)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    m = q @ np.diag(rng.uniform(0.5, 2.0, size=3))
    tris = procgen.make_icosphere(subdivisions).astype(np.float64)
    return (tris @ m.T + rng.uniform(-3, 3, size=3)).astype(np.float32)


def checkpoint_arrays(cs, tris: np.ndarray) -> dict:
    """The JAX ClusteredScene as the arrays of its npz checkpoint."""
    b = cs.bvh2
    return {"triangles": tris, "tri_order": np.asarray(cs.tri_order),
            "leaf_size": np.asarray([cs.leaf_size], np.int32),
            "bvh2_bounds": np.asarray(b.bounds_u32), "bvh2_left": np.asarray(b.left),
            "bvh2_right": np.asarray(b.right), "bvh2_meta": np.asarray(b.meta),
            "bvh2_parent": np.asarray(b.parent)}


@pytest.fixture(scope="module", params=[(2, 8), (3, 32)], ids=["ico2-K8", "ico3-K32"])
def trees(request):
    """(JAX bvh4, wide, qnodes; port state) for one SAH-clustered scene."""
    sub, k = request.param
    scene = JaxScene().set_triangles(seeded_mesh(sub))
    scene._normalize_enabled, scene._normalize_mode = True, "cube"
    scene.normalize_mesh()
    cs, height = jax_build_sah2_clustered(jnp.asarray(scene.triangles), k)
    bvh4 = jax_collapse(cs.bvh2, sweeps=height + 2)
    wide = jax_make_wide_bvh(bvh4)
    qn = jax_make_qnodes(wide, cs.tris_sorted, tri_ids=cs.tri_order, leaf_size=k)
    state = state_from_numpy(checkpoint_arrays(cs, scene.triangles), "cpu")
    return bvh4, wide, np.asarray(qn), state, k


@pytest.mark.parametrize("mode", ["cube", "sphere"])
def test_scene_normalization_bit_equal(tmp_path, mode):
    """Scene.load_glb with normalization is bit-equal to the JAX Scene."""
    path = tmp_path / "mesh.glb"
    procgen.write_glb(path, seeded_mesh(2))
    ours = Scene().load_glb(path, normalize=True, mode=mode).get_triangles()
    ref = JaxScene().load_glb(path, normalize=True, mode=mode).get_triangles()
    assert ours.dtype == ref.dtype == np.float32
    assert np.array_equal(ours.view(np.uint32), ref.view(np.uint32)), "tolerance: bit-equal"


def test_unpack_bounds_every_fp16_pattern():
    """The torch fp16 bounds decoder against the numpy codec (a copy of the
    JAX package's) on every fp16 bit pattern in every word position:
    bit-equal, except that a NaN need only stay a NaN (torch quiets
    signaling NaNs; packed bounds never hold one)."""
    from raytracer_tpu.utils.fp16 import unpack_bounds_u32 as jax_unpack_bounds_u32
    from raytracer_tpu_torch.utils.fp16 import unpack_bounds, unpack_bounds_u32

    rng = np.random.default_rng(SEED)
    lo = np.arange(1 << 16, dtype=np.uint32)
    words = np.stack([lo | (rng.permutation(lo) << 16) for _ in range(3)], -1)
    mn_t, mx_t = unpack_bounds(torch.from_numpy(words.astype(np.int64)))
    mn, mx = unpack_bounds_u32(words)
    ref_mn, ref_mx = jax_unpack_bounds_u32(words)
    for ours, np_ours, ref in ((mn_t, mn, ref_mn), (mx_t, mx, ref_mx)):
        ours, nan = ours.numpy(), np.isnan(ref)
        assert np.array_equal(np.isnan(ours), nan)
        assert np.array_equal(ours[~nan].view(np.uint32), ref[~nan].view(np.uint32))
        assert np.array_equal(np_ours.view(np.uint32), ref.view(np.uint32)), \
            "tolerance: bit-equal"


def test_procgen_meshes_equal_jax():
    """The copied generators make the JAX package's triangles."""
    assert np.array_equal(procgen.make_icosphere(3), jax_procgen.make_icosphere(3))
    assert np.array_equal(procgen.make_dragon_solid(24, 20),
                          jax_procgen.make_dragon_solid(24, 20)), "tolerance: bit-equal"


def test_collapse_matches_jax(trees):
    """Native collapse + padding equals the JAX device collapse, padding rows
    (bounds 0, children INVALID, meta 0) included."""
    bvh4, _, _, state, _ = trees
    ours = collapse_lbvh2_to_bvh4(state.bvh2)
    assert ours.num_nodes == int(bvh4.num_nodes)
    assert ours.bounds_u32.shape[0] == state.bvh2.num_nodes > ours.num_nodes
    for name in ("bounds_u32", "children", "meta"):
        ref = np.asarray(getattr(bvh4, name)).astype(np.int64)
        assert np.array_equal(getattr(ours, name).numpy(), ref), f"{name}: tolerance: exact"
    assert (ours.children[ours.num_nodes:] == INVALID).all()


def test_make_wide_bvh_exact(trees):
    bvh4, wide, _, state, _ = trees
    ours = make_wide_bvh(collapse_lbvh2_to_bvh4(state.bvh2))
    for name in ("cmn", "cmx", "cref", "root_mn", "root_mx"):
        assert np.array_equal(getattr(ours, name).numpy(), np.asarray(getattr(wide, name))), \
            f"{name}: tolerance: exact"


def test_make_qnodes_byte_equal(trees):
    """Records byte-equal (as uint32) to the JAX make_qnodes, including the
    empty slots' wrapped payload: K copies of triangle 0, count K."""
    _, _, qn_ref, state, k = trees
    wide = make_wide_bvh(collapse_lbvh2_to_bvh4(state.bvh2))
    ours = make_qnodes(wide, state.tris_sorted, tri_ids=state.tri_order, leaf_size=k).numpy()
    ref = qn_ref.reshape(qn_ref.shape[0], -1)
    assert ours.shape == ref.shape
    assert np.array_equal(ours.view(np.uint32), ref.view(np.uint32)), "tolerance: byte-equal"

    vbase, ibase, _ = rec_layout(k, 4)
    row, slot = np.argwhere(ours[:, 24:28] == EMPTY_REF)[0]
    assert ours[row, 28 + slot] == k
    tri0 = ours[row, vbase + slot * k * 12: vbase + (slot * k + 1) * 12]
    payload = ours[row, vbase + slot * k * 12: vbase + (slot + 1) * k * 12].reshape(k, 12)
    assert np.array_equal(payload, np.broadcast_to(tri0, (k, 12)))
    assert np.array_equal(tri0[0:3], state.tris_sorted[0, 0].numpy())
    ids = ours[row, ibase + slot * k: ibase + (slot + 1) * k]
    assert (ids == float(state.tri_order[0])).all()


def test_load_checkpoint_reproduces_qnodes(tmp_path):
    """A checkpoint the JAX PathTracer writes loads into the same records."""
    tris = seeded_mesh(3)
    jpt = JaxPathTracer(64, 32, builder="sah", leaf_size=8)
    jpt.build_bvh(tris)
    ckpt = tmp_path / "scene.npz"
    jpt.save_checkpoint(ckpt)

    pt = PathTracer(64, 32, builder="sah", leaf_size=32, device="cpu")
    pt.load_checkpoint(ckpt)
    assert pt.leaf_size == 8
    ref = np.asarray(jpt._qnodes)
    ref = ref.reshape(ref.shape[0], -1)
    assert np.array_equal(pt._qnodes.numpy().view(np.uint32), ref.view(np.uint32)), \
        "tolerance: byte-equal"
    assert np.array_equal(pt._tris_dev.numpy(), tris)


def test_state_from_numpy_matches_native_build():
    """The port's own build equals the JAX build's arrays taken through
    state_from_numpy: same tree, same cluster order."""
    from raytracer_tpu_torch.ops.cluster import build_sah2_clustered

    tris = seeded_mesh(2)
    ours, h_ours = build_sah2_clustered(tris, 8, "cpu")
    cs, h_ref = jax_build_sah2_clustered(jnp.asarray(tris), 8)
    ref = state_from_numpy(checkpoint_arrays(cs, tris), "cpu")
    assert h_ours == h_ref and ours.leaf_size == ref.leaf_size == 8
    for a, b in zip(ours.bvh2, ref.bvh2):
        assert torch.equal(a, b)
    assert torch.equal(ours.tri_order, ref.tri_order)
    assert torch.equal(ours.tris_sorted, ref.tris_sorted)
