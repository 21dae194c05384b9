"""The traversal kernel K1a's wrapper, and K1a against its plain torch version.

Needs neither JAX nor the JAX package, so the tests marked ``cuda`` run on
a machine with a card and only the port:

    python -m pytest --noconftest -m cuda tests/test_torch_kernel.py

(``--noconftest``: the suite's conftest.py configures JAX). Without a card
they skip; the wrapper's CPU path and checks are tested everywhere.
Tolerances: the traversal rule of ``torch_parity``.
"""

import pytest
import torch

from raytracer_tpu_torch.ops.cluster import build_sah2_clustered, records_pipeline
from raytracer_tpu_torch.ops.cuda import traverse
from torch_parity import CAM_POS, CAM_QUAT, FOV, assert_trace_parity, image_dirs, seeded_scene


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1a has no CPU mode")
    return torch.device("cuda")


def test_cpu_records_run_the_plain_version():
    """On the CPU the wrapper returns the plain version's planes and
    launches nothing."""
    tris = seeded_scene(2)
    qn = records_pipeline(build_sah2_clustered(tris, 8, "cpu")[0])
    before = traverse.LAUNCHES
    planes = traverse.trace_tiles(qn, CAM_POS, CAM_QUAT, 48, 32, FOV, leaf_k=8)
    ref = traverse.trace_tiles_reference(qn, CAM_POS, CAM_QUAT, 48, 32, FOV, leaf_k=8)
    assert traverse.LAUNCHES == before
    assert all(torch.equal(a, b) for a, b in zip(planes, ref))


def test_trace_tiles_window_matches_full_frame():
    """A window (raygen_size + offsets) traces the same pixels of the frame."""
    tris = seeded_scene(2)
    qn = records_pipeline(build_sah2_clustered(tris, 8, "cpu")[0])
    full = traverse.trace_tiles(qn, CAM_POS, CAM_QUAT, 96, 64, FOV, leaf_k=8)
    win = traverse.trace_tiles(qn, CAM_POS, CAM_QUAT, 40, 24, FOV, leaf_k=8,
                               raygen_size=(96, 64), row_offset=30, col_offset=17)
    for a, b in zip(win, full):
        assert torch.equal(a, b[30:54, 17:57])
    with pytest.raises(ValueError):
        traverse.trace_tiles(qn, CAM_POS, CAM_QUAT, 40, 24, FOV, leaf_k=8,
                             raygen_size=(96, 64), row_offset=50)


def test_trace_tiles_rejects_bad_records():
    qn = torch.zeros((4, traverse.rec_layout(8, 4)[2]), dtype=torch.float32)
    with pytest.raises(TypeError):
        traverse.trace_tiles(qn.double(), CAM_POS, CAM_QUAT, 8, 8, leaf_k=8)
    with pytest.raises(ValueError):
        traverse.trace_tiles(qn[:, ::2], CAM_POS, CAM_QUAT, 8, 8, leaf_k=8)
    with pytest.raises(ValueError):
        traverse.trace_tiles(qn, CAM_POS, CAM_QUAT, 8, 8, leaf_k=2)
    with pytest.raises(NotImplementedError):
        traverse.trace_tiles(torch.zeros((4, traverse.rec_layout(8, 8)[2])),
                             CAM_POS, CAM_QUAT, 8, 8, leaf_k=8)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [8, 32])
def test_kernel_matches_reference_on_card(cuda_device, k):
    """K1a vs its plain torch version on the card, whole frame and a window."""
    tris = seeded_scene(4)
    w, h = 192, 128
    qn = records_pipeline(build_sah2_clustered(tris, k, cuda_device)[0])
    before = traverse.LAUNCHES
    ours = traverse.trace_tiles(qn, CAM_POS, CAM_QUAT, w, h, FOV, leaf_k=k)
    torch.cuda.synchronize()
    assert traverse.LAUNCHES == before + 1
    ref = traverse.trace_tiles_reference(qn, CAM_POS, CAM_QUAT, w, h, FOV, leaf_k=k)
    ours, ref = [p.cpu() for p in ours], [p.cpu() for p in ref]
    assert_trace_parity(ours, ref[0], ref[4], torch.stack(ref[1:4], -1).numpy(),
                        tris, image_dirs(w, h))
    win = traverse.trace_tiles(qn, CAM_POS, CAM_QUAT, 50, 40, FOV, leaf_k=k,
                               raygen_size=(w, h), row_offset=70, col_offset=33)
    for a, b in zip(win, ours):
        assert torch.equal(a.cpu(), b[70:110, 33:83])


@pytest.mark.cuda
def test_kernel_refuses_strided_records(cuda_device):
    """The wrapper checks the records' layout on the card too."""
    qn = torch.zeros((4, traverse.rec_layout(8, 4)[2]), device=cuda_device)
    with pytest.raises(ValueError):
        traverse.trace_tiles(qn[:, ::2], CAM_POS, CAM_QUAT, 8, 8, leaf_k=8)
