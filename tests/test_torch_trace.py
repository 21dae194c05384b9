"""The PyTorch port's ray generation and primary-ray traversal against the
JAX package: the Pallas kernel in interpret mode and the brute-force tracer.

Tolerances: the traversal rule of ``torch_parity`` (tri exact except ties
<= 0.1%, t rtol 1e-5, normals unit within 1e-4 and within atol 1e-5).
The CUDA kernel's own tests, which need no JAX, are in test_torch_kernel.py.
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from raytracer_tpu.ops.cluster import build_sah2_clustered as jax_build_sah2_clustered
from raytracer_tpu.ops.collapse import collapse_lbvh2_to_bvh4 as jax_collapse
from raytracer_tpu.ops.pallas.traverse import (
    _rotate_quat,
    make_qnodes as jax_make_qnodes,
    trace_tiles_pallas,
)
from raytracer_tpu.ops.trace import make_wide_bvh as jax_make_wide_bvh
from raytracer_tpu.ops.trace import trace_rays_brute as jax_trace_rays_brute
from raytracer_tpu_torch.ops.camera import generate_rays_jittered
from raytracer_tpu_torch.ops.cluster import build_sah2_clustered, records_pipeline
from raytracer_tpu_torch.ops.cuda import traverse
from raytracer_tpu_torch.ops.trace import trace_rays_brute
from torch_parity import (CAM_POS, CAM_QUAT, FOV, assert_hits_parity, assert_trace_parity,
                          image_dirs, seeded_scene)

def jax_records(tris: np.ndarray, k: int) -> np.ndarray:
    cs, height = jax_build_sah2_clustered(jnp.asarray(tris), k)
    wide = jax_make_wide_bvh(jax_collapse(cs.bvh2, sweeps=height + 2))
    return np.array(jax_make_qnodes(wide, cs.tris_sorted, tri_ids=cs.tri_order, leaf_size=k))


def test_ray_directions_match_jax_rsqrt():
    """The port's directions (1/sqrt, IEEE) against the JAX kernel's
    rsqrt-normalized ones (traverse.py:721-728): within 2 ulp of the unit
    vector's scale, i.e. |Δ| <= 2·2^-23 per component."""
    w, h = 64, 64
    ours = image_dirs(w, h).numpy()

    @jax.jit
    def jax_dirs(q):
        py, px = jnp.meshgrid(jnp.arange(h), jnp.arange(w), indexing="ij")
        focal = jnp.float32(1.0 / math.tan(0.5 * math.radians(FOV)))
        u = (px.astype(jnp.float32) + 0.5) / jnp.float32(w) * 2.0 - 1.0
        v = (py.astype(jnp.float32) + 0.5) / jnp.float32(h) * 2.0 - 1.0
        dx, dy, dz = u * jnp.float32(w / h), v, jnp.full(u.shape, -focal)
        inv_len = jax.lax.rsqrt(dx * dx + dy * dy + dz * dz)
        return jnp.stack(_rotate_quat(q[0], q[1], q[2], q[3], dx * inv_len,
                                      dy * inv_len, dz * inv_len), axis=-1)

    ref = np.asarray(jax_dirs(jnp.asarray(CAM_QUAT, jnp.float32))).reshape(-1, 3)
    err = np.abs(ours - ref).max()
    assert err <= 2 * np.spacing(np.float32(1.0)), f"max |Δ| {err} > 2 ulp(1)"
    np.testing.assert_allclose(np.linalg.norm(ours, axis=-1), 1.0, atol=1e-6)


@pytest.mark.parametrize("jitter,size", [(False, 64), (True, 32)], ids=["k1a", "k1b"])
def test_reference_matches_pallas_interpret(jitter, size):
    """trace_tiles_reference vs the Pallas kernel (interpret mode) on the
    same K=8 records: 64×64 at the pixel centres (K1a), 32×32 jittered with
    a 22-bit seed (K1b)."""
    tris = seeded_scene(3)
    qn = jax_records(tris, 8)
    w = h = size
    seed = (1 << 22) - 3
    ref = trace_tiles_pallas(jnp.asarray(qn), jnp.asarray(CAM_POS, jnp.float32),
                             jnp.asarray(CAM_QUAT, jnp.float32), w, h, FOV,
                             interpret=True, leaf_k=8, jitter=jitter, jitter_seed=seed)
    ours = traverse.trace_tiles_reference(torch.from_numpy(qn), CAM_POS, CAM_QUAT, w, h,
                                          FOV, leaf_k=8, jitter=jitter, jitter_seed=seed)
    assert all(p.shape == (h, w) for p in ours) and ours[4].dtype == torch.int32
    ref_n = np.stack([np.asarray(p) for p in ref[1:4]], -1)
    dirs = image_dirs(w, h)
    if jitter:
        dirs = generate_rays_jittered(w, h, CAM_POS, CAM_QUAT, seed, FOV,
                                      device="cpu")[1].reshape(-1, 3)
    assert_trace_parity(ours, ref[0], ref[4], ref_n, tris, dirs)
    assert 0.2 < float((ours[4] >= 0).float().mean()) < 0.9


def test_reference_matches_brute_k32():
    """trace_tiles_reference on the port's own K=32 build vs the JAX brute
    tracer fed the same rays, 128×64; and the port's brute tracer vs JAX's."""
    tris = seeded_scene(3)
    cs, _ = build_sah2_clustered(tris, 32, "cpu")
    qn = records_pipeline(cs)
    w, h = 128, 64
    ours = traverse.trace_tiles_reference(qn, CAM_POS, CAM_QUAT, w, h, FOV, leaf_k=32)
    dirs = image_dirs(w, h)
    origins = np.broadcast_to(np.asarray(CAM_POS, np.float32), (w * h, 3))
    bt, btri = jax_trace_rays_brute(jnp.asarray(tris), jnp.asarray(origins),
                                    jnp.asarray(dirs.numpy()))
    assert_trace_parity(ours, bt, btri, None, tris, dirs)

    pt_t, pt_tri = trace_rays_brute(torch.from_numpy(tris), torch.from_numpy(origins.copy()),
                                    dirs)
    assert pt_tri.dtype == torch.int32
    assert_hits_parity(pt_t, pt_tri, bt, btri, tris, dirs)
