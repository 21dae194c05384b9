"""The PyTorch port's shardings (``parallel/mesh.py`` on ``torch.distributed``)
in gloo processes on the CPU, against the JAX package's on the virtual CPU
mesh.

Three spawns (``run_ranks``: spawned processes, a ``FileStore`` rendezvous,
the group's and the join's timeout 60 s, one torch thread a rank), each
running every sharding once (``tests/torch_parity.py::sharding_rank``):

* 2 ranks against the JAX functions on ``make_mesh(2)``, their XLA branch
  (the port has one branch, the records through the plain K1a / K1b / K1c /
  K2 versions on the CPU): ``tri`` by the tie rule of ``torch_parity``, ``t``
  within rtol 1e-5, rgb within atol 1e-5; the path-traced mean, given the
  JAX-drawn uniforms of each seed, within atol 1e-6 on every pixel (not bit
  for bit: the port's normals come from the records, the XLA branch's from
  the vertices; measured max |d| 1.2e-7, 89% of the pixels equal);
* 4 ranks against the port's own 1-rank results: the bands and the cameras
  equal, the spp and path-traced means (one 1-rank call a seed, averaged
  here) within 1e-6;
* every rank sees the same result, and ``make_mesh`` of more ranks than the
  group has raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.ops.collapse import collapse_lbvh2_to_bvh4
from raytracer_tpu.ops.lbvh import build_lbvh2
from raytracer_tpu.ops.trace import make_wide_bvh
from raytracer_tpu.parallel import mesh as jax_mesh
from raytracer_tpu.utils import procgen
from raytracer_tpu_torch.ops.camera import primary_dirs
from raytracer_tpu_torch.ops.cuda.traverse import make_qnodes
from raytracer_tpu_torch.parallel import mesh
from test_torch_progressive import jax_uniforms
from torch_parity import FOV, assert_hits_parity, sharding_rank, wide_from_numpy

POS = (0.0, 0.0, 3.5)
QUAT = (0.0, 0.0, 0.0, 1.0)
W = H = 64
CAMS, CAM_SIZE = 4, 32
PT_SIZE, BOUNCES = 32, 1
TIMEOUT = 60.0


@pytest.fixture(scope="module")
def scene():
    tris = procgen.make_icosphere(2)
    wide = make_wide_bvh(collapse_lbvh2_to_bvh4(build_lbvh2(jnp.asarray(tris))))
    qn = make_qnodes(wide_from_numpy(wide), torch.from_numpy(tris))
    cpos = np.tile(np.float32(POS), (CAMS, 1))
    cpos[:, 0] = np.linspace(-0.5, 0.5, CAMS)
    cquat = np.tile(np.float32(QUAT), (CAMS, 1))
    case = {"qn": qn.numpy(), "tris": tris, "leaf_k": 1, "pos": POS, "quat": QUAT,
            "size": (W, H), "cams": (cpos, cquat, CAM_SIZE, CAM_SIZE), "pt_size": (PT_SIZE,
                                                                               PT_SIZE),
            "bounces": BOUNCES}
    return wide, tris, case


def spawn(case: dict, n: int) -> list[dict]:
    outs = mesh.run_ranks(sharding_rank, n, (case,), device="cpu", timeout=TIMEOUT)
    for r, o in enumerate(outs):
        assert (o["rank"], o["size"], o["bigger_mesh_raised"]) == (r, n, True)
    return outs


@pytest.fixture(scope="module")
def two_ranks(scene):
    """The 2-rank run; rank 1's outputs, after checking rank 0 has the same."""
    _, _, case = scene
    seeds = [0, 1]
    case = {**case, "spp_seeds": [seeds], "pt_seeds": [seeds],
            "pt_uniforms": [[jax_uniforms(jax.random.key(s), PT_SIZE, PT_SIZE, BOUNCES)
                             for s in seeds]]}
    outs = spawn(case, 2)
    for key in ("tiles", "spp", "cams", "pt"):
        for a, b in zip(outs[0][key], outs[1][key]):
            np.testing.assert_array_equal(a, b, err_msg=f"{key}: the ranks disagree")
    return outs[1]


@pytest.fixture(scope="module")
def jax_mesh2():
    return jax_mesh.make_mesh(2)


def test_tiles_sharded_2_ranks_match_jax(scene, two_ranks, jax_mesh2):
    wide, tris, _ = scene
    rgb, t, tri = (np.asarray(a) for a in jax_mesh.render_tiles_sharded(
        wide, jnp.asarray(tris), np.float32(POS), np.float32(QUAT), W, H, jax_mesh2))
    ours_rgb, ours_t, ours_tri = two_ranks["tiles"]
    assert ours_rgb.shape == (H, W, 3) and ours_tri.dtype == np.int32
    py, px = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    dirs = primary_dirs(px.reshape(-1), py.reshape(-1), W, H, QUAT, FOV)
    same = assert_hits_parity(ours_t, ours_tri, t, tri, tris, dirs, origins=POS)
    np.testing.assert_allclose(ours_rgb.reshape(-1, 3)[same], rgb.reshape(-1, 3)[same],
                               atol=1e-5, rtol=0)


def test_spp_sharded_2_ranks_match_jax(scene, two_ranks, jax_mesh2):
    wide, tris, _ = scene
    ref = np.asarray(jax_mesh.render_spp_sharded(
        wide, jnp.asarray(tris), np.float32(POS), np.float32(QUAT), np.arange(2, dtype=np.int32),
        W, H, jax_mesh2))
    (ours,) = two_ranks["spp"]
    assert ours.shape == (H, W, 3)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)


def test_cameras_sharded_2_ranks_match_jax(scene, two_ranks, jax_mesh2):
    wide, tris, case = scene
    cpos, cquat, cw, ch = case["cams"]
    ref = np.asarray(jax_mesh.render_cameras_sharded(
        wide, jnp.asarray(tris), cpos, cquat, cw, ch, jax_mesh2))
    ours = two_ranks["cams"]
    assert ours.shape == (CAMS, ch, cw, 3)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)
    assert not np.array_equal(ours[0], ours[-1])


def test_pt_spp_sharded_2_ranks_match_jax(scene, two_ranks, jax_mesh2):
    wide, tris, _ = scene
    ref = np.asarray(jax_mesh.render_pt_spp_sharded(
        wide, jnp.asarray(tris), np.float32(POS), np.float32(QUAT),
        np.arange(2, dtype=np.int32), PT_SIZE, PT_SIZE, jax_mesh2, bounces=BOUNCES))
    (ours,) = two_ranks["pt"]
    assert ours.shape == (PT_SIZE, PT_SIZE, 3) and ours.max() > 0
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)


def test_4_ranks_match_1_rank(scene):
    _, _, case = scene
    seeds = [3, 5, 7, 11]
    four = spawn({**case, "spp_seeds": [seeds], "pt_seeds": [seeds]}, 4)
    (one,) = spawn({**case, "spp_seeds": [[s] for s in seeds],
                    "pt_seeds": [[s] for s in seeds]}, 1)
    for o in four[1:]:
        for key in ("tiles", "spp", "cams", "pt"):
            for a, b in zip(four[0][key], o[key]):
                np.testing.assert_array_equal(a, b, err_msg=f"{key}: the ranks disagree")
    got = four[0]
    for a, b in zip(got["tiles"], one["tiles"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got["cams"], one["cams"])
    for key in ("spp", "pt"):
        np.testing.assert_allclose(got[key][0], np.mean(one[key], axis=0), atol=1e-6, rtol=0,
                                   err_msg=key)


def test_make_mesh_without_a_group_raises():
    with pytest.raises(ValueError):
        mesh.make_mesh(1, "cpu")
