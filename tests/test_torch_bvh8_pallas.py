"""The PyTorch port's plain 8-wide traversals against the JAX package's
Pallas kernels in interpret mode (three calls in this file), on K = 1
records of the JAX package's 8-wide collapse. Kept apart from
``test_torch_bvh8.py`` so that the test run can give the two files to two
workers.

Tolerances: the rule of ``torch_parity`` (tri exact except ties <= 0.1%, t
rtol 1e-5, normals unit within 1e-4 and within atol 1e-5; the occlusion mask
equal for any hit).
"""

import numpy as np
import jax.numpy as jnp
import torch

from raytracer_tpu.ops import collapse as jax_collapse
from raytracer_tpu.ops.lbvh import build_lbvh2 as jax_build_lbvh2
from raytracer_tpu.ops.pallas.traverse import make_qnodes as jax_make_qnodes
from raytracer_tpu.ops.pallas.traverse import trace_rays_pallas, trace_tiles_pallas
from raytracer_tpu.ops.trace import make_wide_bvh as jax_make_wide_bvh
from raytracer_tpu_torch.ops.cuda import traverse
from torch_parity import (CAM_POS, CAM_QUAT, FOV, assert_trace_parity, image_dirs,
                          seeded_scene)


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
