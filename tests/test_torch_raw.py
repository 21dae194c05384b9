"""The raw tile layout of the PyTorch port's frame batch,
``trace_tiles_batch(..., raw=True)`` (kernel K1c raw on the card), against
the JAX package's ``trace_tiles_batch_pallas(..., raw=True)`` in interpret
mode, against the port's own image planes, and its input checks.

One Pallas interpret-mode call: a small sphere at 64×64 with 2 cameras
(2 × 4 tiles). Tolerances: planes 0–4 by the traversal rule of
``torch_parity`` (tri exact except ties <= 0.1%, t rtol 1e-5, normals within
atol 1e-5: the TPU kernel normalizes its directions with rsqrt, the port
with IEEE 1/sqrt, so t and the normals differ by ulps), read out of the raw
layout word by word; the port's raw layout bit-equal to
:func:`tiles_layout` of its image planes. Plane 5 is the port's own (the
TPU kernel writes its tile's visit count there): zeros without ``stats``,
each pixel's visits with it.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytracer_tpu.ops.pallas.traverse import trace_tiles_batch_pallas
from raytracer_tpu_torch.ops.camera import primary_dirs
from raytracer_tpu_torch.ops.cuda import traverse
from test_torch_trace import jax_records
from torch_parity import CAM_POS, CAM_QUAT, FOV, assert_trace_parity, seeded_scene

K, W, H = 8, 64, 64
POSS = np.float32([CAM_POS, [0.3, 0.1, 2.4]])
QUATS = np.float32([CAM_QUAT, [0.0, 0.0, 0.0, 1.0]])


@pytest.fixture(scope="module")
def records():
    tris = seeded_scene(2)
    qn = jax_records(tris, K)
    return tris, qn, torch.from_numpy(qn.reshape(qn.shape[0], -1))


def image_of(raw, plane: int, f: int) -> np.ndarray:
    """Plane ``plane`` of frame ``f`` of a raw (F, tiles, 6, 8, 128) array
    as an (H, W) image: tiles row-major, each tile's pixels row-major."""
    tiles = np.asarray(raw)[f, :, plane].reshape(H // 32, W // 32, 32, 32)
    return tiles.transpose(0, 2, 1, 3).reshape(H, W)


def test_raw_matches_pallas_interpret(records):
    """The port's raw layout on the CPU against trace_tiles_batch_pallas(raw=True):
    the same shape, and on every word of planes 0–4 the traversal rule."""
    tris, qn, qt = records
    ref = np.asarray(trace_tiles_batch_pallas(jnp.asarray(qn), jnp.asarray(POSS),
                                              jnp.asarray(QUATS), W, H, FOV, interpret=True,
                                              leaf_k=K, raw=True))
    ours = traverse.trace_tiles_batch(qt, POSS, QUATS, W, H, FOV, leaf_k=K, raw=True)
    assert ours.shape == ref.shape == (2, (H // 32) * (W // 32), 6, 8, 128)
    assert ours.dtype == torch.float32
    py, px = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    for f in range(2):
        planes = [torch.from_numpy(image_of(ours, p, f)) for p in range(5)]
        planes[4] = planes[4].to(torch.int32)
        dirs = primary_dirs(px.reshape(-1), py.reshape(-1), W, H, QUATS[f], FOV)
        ref_n = np.stack([image_of(ref, p, f) for p in (1, 2, 3)], -1)
        assert_trace_parity(planes, image_of(ref, 0, f), image_of(ref, 4, f).astype(np.int32),
                            ref_n, tris, dirs, POSS[f])
        # the per-frame hit counts bench_suite.py takes from the raw layout
        assert int((ours[f, :, 4] >= 0).sum()) == int((ref[f, :, 4] >= 0).sum())
    assert bool((ours[:, :, 5] == 0).all())


@pytest.mark.parametrize("jitter", [False, True], ids=["k1c", "jittered"])
def test_raw_is_the_image_planes_in_tile_order(records, jitter):
    """Planes 0–4 of the raw layout equal tiles_layout of the image planes
    bit for bit (tri as f32, −1 on a miss), plane 5 is 0 without ``stats``
    and each pixel's visits with it, and the per-frame hit counts of the
    two layouts agree. Nothing is launched on the CPU."""
    _, _, qt = records
    before = dict(traverse.LAUNCHES)
    seeds = [5, 123457] if jitter else None
    kw = dict(leaf_k=K, jitter=jitter, jitter_seeds=seeds)
    image = traverse.trace_tiles_batch(qt, POSS, QUATS, W, H, FOV, **kw)
    raw = traverse.trace_tiles_batch(qt, POSS, QUATS, W, H, FOV, raw=True, **kw)
    assert torch.equal(raw, traverse.tiles_layout(image))
    assert bool((raw[:, :, 5] == 0).all())
    stats = traverse.trace_tiles_batch(qt, POSS, QUATS, W, H, FOV, stats=True, **kw)
    raw_stats = traverse.trace_tiles_batch(qt, POSS, QUATS, W, H, FOV, stats=True, raw=True, **kw)
    assert torch.equal(raw_stats, traverse.tiles_layout(stats))
    assert torch.equal(raw_stats[:, :, :5], raw[:, :, :5]) and bool((raw_stats[:, :, 5] >= 1).all())
    for f in range(2):
        for p in range(6):
            plane = stats[p][f].float()
            assert torch.equal(torch.from_numpy(image_of(raw_stats, p, f)), plane), (f, p)
    hits = (raw[:, :, 4] >= 0).sum(dim=(1, 2, 3))
    assert torch.equal(hits, (image[4] >= 0).sum(dim=(1, 2)))
    assert 0 < int(hits.min()) and int(hits.max()) < W * H
    assert traverse.LAUNCHES == before


def test_raw_rejects_what_it_does_not_take(records):
    """A side that is not a multiple of 32 raises ValueError, as the JAX
    function does; so does a window of a larger frame."""
    _, qn, qt = records
    with pytest.raises(ValueError, match="TILE-aligned"):
        trace_tiles_batch_pallas(jnp.asarray(qn), jnp.asarray(POSS), jnp.asarray(QUATS), 48, 64,
                                 FOV, interpret=True, leaf_k=K, raw=True)
    for w, h in ((48, 64), (64, 40)):
        with pytest.raises(ValueError, match="multiples of 32"):
            traverse.trace_tiles_batch(qt, POSS, QUATS, w, h, FOV, leaf_k=K, raw=True)
    with pytest.raises(ValueError, match="whole frames"):
        traverse.trace_tiles_batch(qt, POSS, QUATS, 32, 32, FOV, leaf_k=K, raw=True,
                                   raygen_size=(64, 64), row_offset=32)
    with pytest.raises(ValueError, match="multiples of 32"):
        traverse.tiles_layout([torch.zeros(1, 40, 64)] * 5)
    out = traverse.trace_tiles_batch(qt, POSS, QUATS, 32, 32, FOV, leaf_k=K, raw=True,
                                     raygen_size=(32, 32))
    assert out.shape == (2, 1, 6, 8, 128)
