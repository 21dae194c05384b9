"""The plain versions of the ray-buffer kernels K2a (closest hit) and K2b (any
hit) against the JAX package's Pallas ray-buffer kernel in interpret mode.

One Pallas interpret-mode call per test, at K = 8 and 4,096 rays (one
program of the TPU kernel), on the room scene of ``torch_parity``: half the
rays are bounce-like (from surface points, offset 1e-4 along the normal, in
cosine-sampled directions), half come from outside the scene.

Tolerances: K2a by the traversal rule of ``torch_parity`` with per-ray
origins (tri exact except ties <= 0.1%, t rtol 1e-5, normals within atol
1e-5); K2b by its contract, the occlusion mask, equal on every ray.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytracer_tpu.ops.pallas.traverse import trace_rays_pallas
from raytracer_tpu.ops.trace import trace_rays_brute as jax_trace_rays_brute
from raytracer_tpu_torch.ops.cuda import traverse
from raytracer_tpu_torch.ops.trace import trace_rays_brute
from test_torch_trace import jax_records
from torch_parity import assert_hits_parity, assert_trace_parity, ray_buffer, room_scene

K, RAYS = 8, 4096


@pytest.fixture(scope="module")
def room():
    tris = room_scene()
    qn = jax_records(tris, K)
    origins, dirs = ray_buffer(torch.from_numpy(qn.reshape(qn.shape[0], -1)), K, RAYS)
    return tris, qn, origins, dirs


def test_closest_hit_reference_matches_pallas_interpret(room):
    """K2a's plain version vs trace_rays_pallas (interpret) and vs the
    port's and the JAX package's brute-force tracers on the same rays."""
    tris, qn, origins, dirs = room
    o, d = torch.from_numpy(origins), torch.from_numpy(dirs)
    ours = traverse.trace_rays_reference(torch.from_numpy(qn), o, d, leaf_k=K)
    assert all(p.shape == (RAYS,) for p in ours) and ours[4].dtype == torch.int32
    ref = trace_rays_pallas(jnp.asarray(qn), jnp.asarray(origins), jnp.asarray(dirs),
                            interpret=True, leaf_k=K)
    ref_n = np.stack([np.asarray(p) for p in ref[1:4]], -1)
    assert_trace_parity(ours, ref[0], ref[4], ref_n, tris, d, origins)
    hit_rate = float((ours[4] >= 0).float().mean())
    assert 0.6 < hit_rate < 0.95, hit_rate

    bt, btri = trace_rays_brute(torch.from_numpy(tris), o, d)
    assert_hits_parity(ours[0], ours[4], bt, btri, tris, d, origins)
    jt, jtri = jax_trace_rays_brute(jnp.asarray(tris), jnp.asarray(origins), jnp.asarray(dirs))
    assert_hits_parity(ours[0], ours[4], jt, jtri, tris, d, origins)


def test_any_hit_mask_matches_pallas_interpret(room):
    """K2b's plain version: the occlusion mask of shadow rays toward the sun
    equals trace_rays_pallas(any_hit=True) on every ray, t is 0 on
    occluded rays, and lanes masked inactive return the miss values even
    when their ray is NaN."""
    tris, qn, origins, _ = room
    sun = np.float32([1.0, 1.5, 1.0]) / np.linalg.norm([1.0, 1.5, 1.0]).astype(np.float32)
    sun_dirs = np.broadcast_to(sun, origins.shape).copy()
    qt = torch.from_numpy(qn)
    ours = traverse.trace_rays_reference(qt, torch.from_numpy(origins),
                                         torch.from_numpy(sun_dirs), any_hit=True, leaf_k=K)
    ref = trace_rays_pallas(jnp.asarray(qn), jnp.asarray(origins), jnp.asarray(sun_dirs),
                            interpret=True, any_hit=True, leaf_k=K)
    occ = (ours[4] >= 0).numpy()
    np.testing.assert_array_equal(occ, np.asarray(ref[4]) >= 0)
    assert 0.1 < occ.mean() < 0.9, occ.mean()
    assert (ours[0].numpy()[occ] == 0.0).all() and (ours[0].numpy()[~occ] == np.float32(1e30)).all()

    rng = np.random.default_rng(5)
    active = torch.from_numpy(rng.random(RAYS) < 0.5)
    o_nan = torch.from_numpy(origins.copy())
    o_nan[~active] = float("nan")
    masked = traverse.trace_rays_reference(qt, o_nan, torch.from_numpy(sun_dirs), any_hit=True,
                                           leaf_k=K, active=active)
    for a, b in zip(masked, ours):
        assert torch.equal(a[active], b[active])
    assert (masked[0][~active] == 1e30).all() and (masked[4][~active] == -1).all()
    assert all((p[~active] == 0).all() for p in masked[1:4])
