"""The record placements of the PyTorch port's ray-buffer wrapper,
``trace_rays(..., tree_space="hbm"|"vmem"|"smem")`` (K2a / K2b with the
records in device memory, pinned in L2, or in each block's shared memory on
the card), against the JAX package's ``trace_rays_pallas(...,
tree_space="smem")`` in interpret mode; the name check; and the fit check at
an H100's limits.

Two Pallas interpret-mode calls, closest hit and any hit, at K = 8 and
4,096 rays (one program of the TPU kernel) on the room scene of
``torch_parity``. Tolerances: closest hit by the traversal rule of
``torch_parity`` with per-ray origins (tri exact except ties <= 0.1%, t
rtol 1e-5, normals within atol 1e-5); any hit by its contract, the
occlusion mask, equal on every ray. On the CPU every placement runs the one
plain version, so the port's three names give the same words.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytracer_tpu.ops.pallas.traverse import trace_rays_pallas
from raytracer_tpu_torch.models.scene import Scene
from raytracer_tpu_torch.ops.cluster import build_sah2_clustered, records_pipeline
from raytracer_tpu_torch.ops.collapse import bvh2_as_bvh4
from raytracer_tpu_torch.ops.cuda import traverse
from raytracer_tpu_torch.ops.lbvh import build_lbvh2
from raytracer_tpu_torch.ops.trace import make_wide_bvh
from raytracer_tpu_torch.utils import procgen
from test_torch_trace import jax_records
from torch_parity import assert_trace_parity, ray_buffer, room_scene

K, RAYS = 8, 4096
SUN = (np.float32([1.0, 1.5, 1.0]) / np.linalg.norm([1.0, 1.5, 1.0])).astype(np.float32)
# traverse.tree_space_limits of an NVIDIA H100 80GB HBM3 (700 W), read on
# the card by tools_torch/mb_tree_space.py
H100_LIMITS = {"smem_optin": 232_448, "persisting_l2": 32_768_000, "access_window": 134_217_728}
# the dragon stand-in's SAH K = 32 records: (54,449, 1,792) f32, as
# chip_smoke.py's phase 3 builds them on the card
DRAGON_RECORD_BYTES = 54_449 * 1_792 * 4


@pytest.fixture(scope="module")
def room():
    tris = room_scene()
    qn = jax_records(tris, K)
    qt = torch.from_numpy(qn.reshape(qn.shape[0], -1))
    origins, dirs = ray_buffer(qt, K, RAYS)
    return tris, qn, qt, origins, dirs


def port_planes(qt, origins, dirs, any_hit):
    """The port's planes under each placement name; all equal on the CPU."""
    o, d = torch.from_numpy(origins), torch.from_numpy(dirs)
    outs = [traverse.trace_rays(qt, o, d, any_hit=any_hit, leaf_k=K, tree_space=space)
            for space in traverse.TREE_SPACES]
    for out in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(out, outs[0]))
    return outs[0]


def test_closest_hit_matches_pallas_smem(room):
    """Closest hit: the port under "hbm", "vmem" and "smem" against
    trace_rays_pallas(tree_space="smem") in interpret mode, by the traversal
    rule."""
    tris, qn, qt, origins, dirs = room
    ours = port_planes(qt, origins, dirs, False)
    ref = trace_rays_pallas(jnp.asarray(qn), jnp.asarray(origins), jnp.asarray(dirs),
                            interpret=True, leaf_k=K, tree_space="smem")
    ref_n = np.stack([np.asarray(p) for p in ref[1:4]], -1)
    assert_trace_parity(ours, ref[0], ref[4], ref_n, tris, torch.from_numpy(dirs), origins)
    assert 0.6 < float((ours[4] >= 0).float().mean()) < 0.95


def test_any_hit_mask_matches_pallas_smem(room):
    """Any hit (shadow rays toward the sun): the occlusion mask of the port
    under each name equals trace_rays_pallas(any_hit=True, tree_space="smem")
    on every ray, with t = 0 where occluded."""
    _, qn, qt, origins, _ = room
    sun = np.broadcast_to(SUN, origins.shape).copy()
    ours = port_planes(qt, origins, sun, True)
    ref = trace_rays_pallas(jnp.asarray(qn), jnp.asarray(origins), jnp.asarray(sun),
                            interpret=True, any_hit=True, leaf_k=K, tree_space="smem")
    occ = (ours[4] >= 0).numpy()
    np.testing.assert_array_equal(occ, np.asarray(ref[4]) >= 0)
    assert 0.1 < occ.mean() < 0.9
    assert (ours[0].numpy()[occ] == 0.0).all()


def test_tree_space_name_is_checked_on_cpu(room):
    """An unknown placement raises the JAX function's ValueError, on the CPU
    as on the card. Nothing is launched."""
    _, qn, qt, origins, dirs = room
    o, d = torch.from_numpy(origins[:64]), torch.from_numpy(dirs[:64])
    before = dict(traverse.LAUNCHES)
    with pytest.raises(ValueError, match="hbm|vmem|smem"):
        trace_rays_pallas(jnp.asarray(qn), jnp.asarray(origins), jnp.asarray(dirs),
                          interpret=True, leaf_k=K, tree_space="l2")
    for bad in ("l2", "HBM", "", "vmem+smem"):
        with pytest.raises(ValueError, match=r"tree_space must be hbm\|vmem\|smem"):
            traverse.trace_rays(qt, o, d, leaf_k=K, tree_space=bad)
        with pytest.raises(ValueError, match=r"tree_space must be hbm\|vmem\|smem"):
            traverse.check_tree_space(1, bad, H100_LIMITS)
    out = traverse.trace_rays(qt, o, d, leaf_k=K, tree_space="smem")
    assert all(torch.equal(a, b) for a, b in zip(out, traverse.trace_rays(qt, o, d, leaf_k=K)))
    assert traverse.LAUNCHES == before
    assert traverse.TREE_SPACES == ("hbm", "vmem", "smem")


def normalized(tris: np.ndarray) -> np.ndarray:
    scene = Scene().set_triangles(tris)
    scene._normalize_enabled, scene._normalize_mode = True, "cube"
    scene.normalize_mesh()
    return scene.triangles


def test_fit_at_the_h100_limits():
    """What fits where on an H100: config 4's hall (SAH K = 32, 2,358,272
    bytes) fits "vmem" but not "smem"; config 1's Cornell box (its Morton
    LBVH at K = 1, and SAH K = 32) fits both; the dragon stand-in's records
    fit neither; "hbm" takes any size."""
    hall = normalized(procgen.make_interior_hall())
    cs, height = build_sah2_clustered(hall, 32, "cpu")
    hall_bytes = records_pipeline(cs, height=height).numel() * 4
    box = torch.from_numpy(normalized(procgen.make_cornell_box()))
    lbvh_bytes = traverse.make_qnodes(make_wide_bvh(bvh2_as_bvh4(build_lbvh2(box))),
                                      box).numel() * 4
    cs, height = build_sah2_clustered(box.numpy(), 32, "cpu")
    sah_bytes = records_pipeline(cs, height=height).numel() * 4
    assert (hall_bytes, lbvh_bytes, sah_bytes) == (2_358_272, 34_304, 21_504)
    for nbytes in (hall_bytes, lbvh_bytes, sah_bytes, DRAGON_RECORD_BYTES):
        traverse.check_tree_space(nbytes, "hbm", H100_LIMITS)
    for nbytes in (hall_bytes, lbvh_bytes, sah_bytes):
        traverse.check_tree_space(nbytes, "vmem", H100_LIMITS)
    for nbytes in (lbvh_bytes, sah_bytes, H100_LIMITS["smem_optin"]):
        traverse.check_tree_space(nbytes, "smem", H100_LIMITS)
    for nbytes in (hall_bytes, DRAGON_RECORD_BYTES, H100_LIMITS["smem_optin"] + 4):
        with pytest.raises(ValueError, match=f"records of {nbytes} bytes exceed one block"):
            traverse.check_tree_space(nbytes, "smem", H100_LIMITS)
    for nbytes in (DRAGON_RECORD_BYTES, H100_LIMITS["persisting_l2"] + 4):
        with pytest.raises(ValueError, match=f"records of {nbytes} bytes exceed the card's"):
            traverse.check_tree_space(nbytes, "vmem", H100_LIMITS)
    narrow = dict(H100_LIMITS, access_window=1 << 20)
    with pytest.raises(ValueError, match="access-policy window"):
        traverse.check_tree_space(hall_bytes, "vmem", narrow)
