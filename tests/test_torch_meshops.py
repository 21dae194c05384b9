"""``utils/meshops.py::split_large_triangles`` of the PyTorch port against
the JAX package, on the interior hall of the JAX benchmark's config 4
(``bench_suite.py:291-381``).

Tolerances: the fragments and their ids array-equal to the JAX function's at
two extents; the split scene rendered through ``make_qnodes(wide, frags,
tri_ids=orig_ids)`` (plain K1a on the CPU) has the unsplit scene's ``tri``
plane, except at shared-edge ties (the tie rule of ``tests/torch_parity.py``,
on at most 0.5% of the pixels: see HALL_TIE_SHARE), and its ``t`` within
rtol 1e-5.
"""

import numpy as np
import pytest
import torch

from raytracer_tpu.utils import meshops as jax_meshops
from raytracer_tpu.utils import procgen as jax_procgen
from raytracer_tpu_torch.models.scene import Scene
from raytracer_tpu_torch.ops.collapse import collapse_lbvh2_to_bvh4
from raytracer_tpu_torch.ops.cuda.traverse import make_qnodes, trace_tiles
from raytracer_tpu_torch.ops.camera import primary_dirs
from raytracer_tpu_torch.ops.lbvh import build_lbvh2
from raytracer_tpu_torch.ops.trace import make_wide_bvh
from raytracer_tpu_torch.utils import meshops, procgen
from torch_parity import FOV, assert_hits_parity, one_torch_thread  # noqa: F401

EXTENTS = (0.5, 0.2)
HALL_CAM, HALL_QUAT = (0.0, 0.0, 0.8), (0.0, 0.0, 0.0, 1.0)  # bench_suite.py:312-313
SIZE = 64
# The camera sits on the hall's symmetry planes, where pixel rays meet shared
# edges: the unsplit frame itself ties with brute force on 17 of its 4,096
# pixels (0.42%), so ties may take 0.5% here, not the rule's 0.1%.
HALL_TIE_SHARE = 0.005


@pytest.fixture(scope="module")
def hall() -> np.ndarray:
    """The hall, cube-normalized as config 4's ``_scene`` normalizes it."""
    raw = procgen.make_interior_hall()
    parts = [jax_procgen.make_cornell_box(4.0)]
    for i in range(8):
        parts.append(jax_procgen.make_cube(0.3) + np.array(
            [(-1.5 + 0.4 * i), -1.6, (-1.2 if i % 2 else 1.2)], np.float32))
    parts.append(jax_procgen.make_icosphere(4, radius=0.7))
    np.testing.assert_array_equal(raw, np.concatenate(parts).astype(np.float32))
    scene = Scene().set_triangles(raw)
    scene.normalize_mesh()
    return scene.triangles


@pytest.mark.parametrize("extent", EXTENTS)
def test_split_equals_jax(hall, extent):
    frags, ids = meshops.split_large_triangles(hall, extent)
    ref_frags, ref_ids = jax_meshops.split_large_triangles(hall, extent)
    assert len(frags) > len(hall), "the hall's walls must split"
    np.testing.assert_array_equal(frags, ref_frags)
    np.testing.assert_array_equal(ids, ref_ids)
    assert frags.dtype == np.float32 and ids.dtype == np.int32
    ext = (frags.max(axis=1) - frags.min(axis=1)).max(axis=1)
    assert (ext <= extent).all()


def render_tri(tris: np.ndarray, tri_ids=None):
    """(t, tri) of a 64×64 frame of the hall from config 4's camera through
    the Morton LBVH of ``tris`` (plain K1a on the CPU)."""
    tt = torch.from_numpy(tris)
    wide = make_wide_bvh(collapse_lbvh2_to_bvh4(build_lbvh2(tt)))
    ids = None if tri_ids is None else torch.from_numpy(tri_ids.astype(np.int64))
    qn = make_qnodes(wide, tt, tri_ids=ids)
    t, _, _, _, tri = trace_tiles(qn, HALL_CAM, HALL_QUAT, SIZE, SIZE, FOV, leaf_k=1)
    return t.numpy(), tri.numpy()


@pytest.mark.parametrize("extent", EXTENTS)
def test_split_scene_renders_the_unsplit_tri_plane(hall, extent):
    frags, ids = meshops.split_large_triangles(hall, extent)
    t0, tri0 = render_tri(hall)
    t1, tri1 = render_tri(frags, ids)
    assert (tri0 >= 0).all(), "every ray of the closed hall hits"
    py, px = torch.meshgrid(torch.arange(SIZE), torch.arange(SIZE), indexing="ij")
    dirs = primary_dirs(px.reshape(-1), py.reshape(-1), SIZE, SIZE, HALL_QUAT, FOV)
    assert_hits_parity(t1, tri1, t0, tri0, hall, dirs, origins=HALL_CAM,
                       max_tie_share=HALL_TIE_SHARE)
