"""The frozen visit and test counter against a hand count and against the
program's plain counter."""

import numpy as np
import pytest
import torch
import workcount


def _records(leaf_k: int) -> torch.Tensor:
    """A root whose slot 0 is a leaf of two triangles in the plane z = 0 and
    whose slot 1 is record 1, a leaf of one triangle at z = −1; slots 2, 3
    empty."""
    w = 4
    vbase, ibase, words = workcount.rec_layout(leaf_k, w)
    rec = torch.zeros((2, words))
    empty = [float("inf")] * 3 + [-float("inf")] * 3

    def tri(r, k, j, v0, v1, v2, tid):
        v0, v1, v2 = (np.asarray(v, np.float32) for v in (v0, v1, v2))
        e1, e2 = v1 - v0, v2 - v0
        at = vbase + (k * leaf_k + j) * 12
        rec[r, at:at + 12] = torch.tensor(np.concatenate([v0, e1, e2, np.cross(e1, e2)]))
        rec[r, ibase + k * leaf_k + j] = tid

    boxes = [[-1, -1, -0.1, 1, 1, 0.1], [-1, -1, -1.1, 1, 1, -0.9], empty, empty]
    rec[0, 0:24] = torch.tensor(boxes, dtype=torch.float32).reshape(-1)
    rec[0, 24:28] = torch.tensor([-1.0, 1.0, -float(1 << 28), -float(1 << 28)])
    rec[0, 28:32] = torch.tensor([2.0, 0.0, 0.0, 0.0])
    tri(0, 0, 0, (-1, -1, 0), (1, -1, 0), (1, 1, 0), 0)
    tri(0, 0, 1, (-1, -1, 0), (1, 1, 0), (-1, 1, 0), 1)
    rec[1, 0:24] = torch.tensor([[-1, -1, -1.1, 1, 1, -0.9]] + [empty] * 3).reshape(-1)
    rec[1, 24:28] = torch.tensor([-3.0, -float(1 << 28), -float(1 << 28), -float(1 << 28)])
    rec[1, 28:32] = torch.tensor([1.0, 0.0, 0.0, 0.0])
    tri(1, 0, 0, (-1, -1, -1), (1, -1, -1), (0, 1, -1), 2)
    return rec


def test_hand_count_closest_and_any_hit():
    qn = _records(2)
    o = torch.tensor([[0.25, -0.5, 1.0], [0.0, 0.0, 1.0]])
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, 1.0]])  # the second points away
    w = workcount.Work(4)
    t, n, hit = workcount.traverse(qn, o, d, 2, False, w)
    # ray 0: root (the leaf's 2 tests, hit at t = 1), then record 1 is culled
    # by its key 1.9 > 1; ray 1: the root only, no box passes
    assert hit.tolist() == [True, False] and t[0] == pytest.approx(1.0)
    assert (w.rays, w.visits, w.tests) == (2, 2, 2)
    assert w.flops() == 2 * 25 * 4 + 2 * 54
    assert w.record_bytes() == 32 * 4 + 2 * 48
    a = workcount.Work(4)
    workcount.traverse(qn, o[:1], d[:1], 2, True, a)
    assert (a.visits, a.tests) == (1, 1)  # stops at its first accepted triangle


def test_equals_the_program_plain_counter_on_a_sphere():
    from raytracer_tpu_torch import PathTracer
    from raytracer_tpu_torch.ops.camera import generate_rays
    from raytracer_tpu_torch.ops.cuda import traverse

    import scenes

    pt = PathTracer(48, 32, "collapse", "sah", 8, device="cpu")
    pt.build_bvh(scenes.normalize_cube(scenes.make_icosphere(3)))
    o, d = generate_rays(48, 32, (0.3, 0.2, 2.5), (0.0, 0.0, 0.0, 1.0), device="cpu")
    o, d = o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()
    for any_hit in (False, True):
        ours = workcount.Work(4)
        workcount.traverse(pt._qnodes, o, d, 8, any_hit, ours)
        theirs = traverse.TraversalCounts()
        traverse._traverse(pt._qnodes, o, d, 8, any_hit, theirs)
        assert (ours.visits, ours.tests) == (theirs.visits, theirs.mt_tests)
        assert ours.record_bytes() == theirs.unique_record_bytes()
