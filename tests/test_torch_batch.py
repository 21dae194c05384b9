"""The PyTorch port's frame-batch entry ``trace_tiles_batch`` (kernel K1c on
the card) against the JAX package's ``trace_tiles_batch_pallas`` in
interpret mode, against per-frame ``trace_tiles``, and its input checks.

Tolerances: the traversal rule of ``torch_parity`` against JAX (tri exact
except ties <= 0.1%, t rtol 1e-5, normals unit within 1e-4 and within atol
1e-5); exact equality against per-frame calls of the port.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytracer_tpu.ops.pallas.traverse import trace_tiles_batch_pallas
from raytracer_tpu_torch.ops.camera import generate_rays_jittered
from raytracer_tpu_torch.ops.cuda import traverse
from test_torch_trace import jax_records
from torch_parity import CAM_POS, CAM_QUAT, FOV, assert_trace_parity, seeded_scene

POSS = np.float32([CAM_POS, [0.45, 0.1, 2.2], [-0.3, -0.2, 2.8]])
QUATS = np.float32([CAM_QUAT, [0.0, 0.0, 0.0, 1.0], [0.05, -0.1, 0.02, 0.9934]])
SEEDS = [(1 << 22) - 3, 17, 123457]


@pytest.fixture(scope="module")
def records():
    tris = seeded_scene(3)
    return tris, jax_records(tris, 8)


def test_batch_matches_pallas_interpret(records):
    """One call of each: F = 3 distinct cameras, 32×32, K = 8, jittered
    with per-frame seeds; each frame by the traversal rule on its own
    jittered rays."""
    tris, qn = records
    w = h = 32
    ref = trace_tiles_batch_pallas(jnp.asarray(qn), jnp.asarray(POSS), jnp.asarray(QUATS), w, h,
                                   FOV, interpret=True, jitter=True,
                                   jitter_seeds=jnp.asarray(SEEDS, jnp.float32), leaf_k=8)
    ours = traverse.trace_tiles_batch(torch.from_numpy(qn), POSS, QUATS, w, h, FOV, leaf_k=8,
                                      jitter=True, jitter_seeds=SEEDS)
    assert all(p.shape == (3, h, w) for p in ours) and ours[4].dtype == torch.int32
    for f in range(3):
        dirs = generate_rays_jittered(w, h, POSS[f], QUATS[f], SEEDS[f], FOV,
                                      device="cpu")[1].reshape(-1, 3)
        ref_n = np.stack([np.asarray(p[f]) for p in ref[1:4]], -1)
        assert_trace_parity([p[f] for p in ours], np.asarray(ref[0][f]), np.asarray(ref[4][f]),
                            ref_n, tris, dirs, POSS[f])
        assert 0.05 < float((ours[4][f] >= 0).float().mean()) < 0.95


@pytest.mark.parametrize("jitter", [False, True], ids=["k1a", "k1b"])
def test_batch_equals_per_frame_trace_tiles(records, jitter):
    """Each frame of a batch equals trace_tiles for its camera (and seed),
    exactly; so does a window of every frame. Nothing is launched on the
    CPU."""
    _, qn = records
    qn = torch.from_numpy(qn)
    w, h = 40, 24
    before = dict(traverse.LAUNCHES)
    seeds = SEEDS if jitter else None
    batch = traverse.trace_tiles_batch(qn, POSS, QUATS, w, h, FOV, leaf_k=8, jitter=jitter,
                                       jitter_seeds=seeds)
    win = traverse.trace_tiles_batch(qn, POSS, QUATS, 16, 8, FOV, leaf_k=8, jitter=jitter,
                                     jitter_seeds=seeds, raygen_size=(w, h), row_offset=9,
                                     col_offset=20)
    for f in range(3):
        single = traverse.trace_tiles(qn, POSS[f], QUATS[f], w, h, FOV, leaf_k=8, jitter=jitter,
                                      jitter_seed=SEEDS[f] if jitter else 0)
        for b, s, v in zip(batch, single, win):
            assert torch.equal(b[f], s) and torch.equal(v[f], s[9:17, 20:36])
    assert traverse.LAUNCHES == before


def test_batch_reference_on_pixels(records):
    """The plain version on a pixel list gives those pixels of its frames."""
    _, qn = records
    qn = torch.from_numpy(qn)
    pix = torch.tensor([0, 5, 77, 31 * 32 + 31])
    full = traverse.trace_tiles_batch_reference(qn, POSS[:2], QUATS[:2], 32, 32, FOV, leaf_k=8)
    part = traverse.trace_tiles_batch_reference(qn, POSS[:2], QUATS[:2], 32, 32, FOV, leaf_k=8,
                                                pixels=pix)
    for a, b in zip(part, full):
        assert a.shape == (2, 4) and torch.equal(a, b.reshape(2, -1)[:, pix])


def test_batch_stats_adds_the_visits_plane(records):
    """stats=True appends each pixel's visit count (f32, >= 1: the root) and
    leaves the five other planes as they are without it."""
    _, qn = records
    qn = torch.from_numpy(qn)
    plain = traverse.trace_tiles_batch(qn, POSS, QUATS, 24, 16, FOV, leaf_k=8)
    counts = traverse.TraversalCounts()
    ref = traverse.trace_tiles_batch_reference(qn, POSS, QUATS, 24, 16, FOV, leaf_k=8,
                                               counts=counts, stats=True)
    out = traverse.trace_tiles_batch(qn, POSS, QUATS, 24, 16, FOV, leaf_k=8, stats=True)
    assert len(plain) == 5 and len(out) == len(ref) == 6
    assert all(torch.equal(a, b) for a, b in zip(out[:5], plain))
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert out[5].dtype == torch.float32 and out[5].shape == (3, 16, 24)
    assert bool((out[5] >= 1).all()) and int(out[5].sum()) == counts.visits


def test_batch_rejects_bad_inputs():
    qn = torch.zeros((4, traverse.rec_layout(8, 4)[2]), dtype=torch.float32)
    pos, quat = POSS[:2], QUATS[:2]
    for seeds in ([1 << 24, 0], [-1, 0], [1.5, 0], [3]):
        with pytest.raises(ValueError):
            traverse.trace_tiles_batch(qn, pos, quat, 8, 8, leaf_k=8, jitter=True,
                                       jitter_seeds=seeds)
    for p, q in ((pos[:, :2], quat), (pos, quat[:1]), (pos[0], quat[0]),
                 (np.zeros((0, 3)), np.zeros((0, 4)))):
        with pytest.raises(ValueError):
            traverse.trace_tiles_batch(qn, p, q, 8, 8, leaf_k=8)
    with pytest.raises(ValueError):
        traverse.trace_tiles_batch(qn, pos, quat, 8, 8, leaf_k=8, raygen_size=(8, 8),
                                   row_offset=1)
    with pytest.raises(ValueError, match="matches no supported child count"):
        traverse.trace_tiles_batch(qn[:, :256].contiguous(), pos, quat, 8, 8, leaf_k=8,
                                   stats=True)
    with pytest.raises(TypeError):
        traverse.trace_tiles_batch(qn.double(), pos, quat, 8, 8, leaf_k=8)
    with pytest.raises(ValueError):
        traverse.trace_tiles_batch(qn.to("meta"), pos, quat, 8, 8, leaf_k=8)
    with pytest.raises(ValueError):
        traverse.trace_tiles(qn, CAM_POS, CAM_QUAT, 8, 8, leaf_k=8, jitter=True, jitter_seed=2.5)
