"""The plain reference against a brute-force walk and the documented stream."""

import numpy as np
import pytest
import scenes
import torch
from reference import camera, render
from reference.intersect import Triangles, any_hit, closest_hit, hit_pairs


def _walk(tris: np.ndarray, o: np.ndarray, d: np.ndarray):
    """One ray at a time, one triangle at a time, in f64."""
    best, idx = 1e30, -1
    for i, (a, b, c) in enumerate(tris.astype(np.float64)):
        e1, e2 = b - a, c - a
        p = np.cross(d, e2)
        det = e1 @ p
        if abs(det) < 1e-7:
            continue
        s = o - a
        u = (s @ p) / det
        q = np.cross(s, e1)
        v = (d @ q) / det
        t = (e2 @ q) / det
        if u >= 0 and v >= 0 and u + v <= 1 and t > 1e-7 and t < best:
            best, idx = t, i
    return best, idx


def test_closest_and_any_hit_equal_a_walk_on_a_toy_scene():
    tris = scenes.normalize_cube(scenes.make_dragon_solid(10, 12))
    rng = np.random.default_rng(5)
    o = rng.uniform(-0.3, 0.3, (200, 3)) + np.array([0.0, 0.0, 2.0])
    d = rng.normal(size=(200, 3)) * 0.25 + np.array([0.0, 0.0, -1.0])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tri = Triangles(torch.from_numpy(tris))
    t, idx = closest_hit(tri, torch.from_numpy(o).float(), torch.from_numpy(d).float())
    occ = any_hit(tri, torch.from_numpy(o).float(), torch.from_numpy(d).float())
    hits = 0
    for j in range(200):
        tw, iw = _walk(tris, o[j].astype(np.float32), d[j].astype(np.float32))
        assert int(idx[j]) == iw and bool(occ[j]) == (iw >= 0)
        if iw >= 0:
            hits += 1
            assert float(t[j]) == pytest.approx(tw, rel=1e-5)
    assert hits > 50
    tp, ok = hit_pairs(tri, idx, torch.from_numpy(o).float(), torch.from_numpy(d).float())
    assert bool((ok == (idx >= 0)).all()) and torch.allclose(tp[idx >= 0], t[idx >= 0])


def test_camera_hash_and_lanes_follow_the_documented_stream():
    from raytracer_tpu_torch.ops.camera import primary_dirs, subpixel_hash01
    from raytracer_tpu_torch.ops.lanes import lane_of_pixel

    w, h = 70, 45
    py, px = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    px, py = px.reshape(-1), py.reshape(-1)
    np.testing.assert_array_equal(camera.lane_of_pixel(px, py, w, h),
                                  lane_of_pixel(w, h, "cpu").numpy())
    for seed in (0, 7, 2 * 4194303 + 1, 2 * 2147483713):
        np.testing.assert_array_equal(camera.subpixel_hash01(px, py, seed),
                                      subpixel_hash01(torch.from_numpy(px),
                                                      torch.from_numpy(py), seed).numpy())
    q = (0.1, -0.2, 0.05, 0.97)
    q = tuple(np.asarray(q) / np.linalg.norm(q))
    ours = camera.primary_dirs(torch.from_numpy(px), torch.from_numpy(py), w, h, q, 70.0)
    theirs = primary_dirs(torch.from_numpy(px), torch.from_numpy(py), w, h, q, 70.0)
    assert torch.allclose(ours, theirs, atol=1e-6)


def test_sample_equals_the_program_first_sample():
    from raytracer_tpu_torch import PathTracer

    tris = scenes.normalize_cube(scenes.make_icosphere(2))
    w, h, pos = 40, 36, (0.2, 0.1, 2.8)
    pt = PathTracer(w, h, "collapse", "sah", 8, device="cpu")
    pt.build_bvh(tris)
    pt.set_camera_position(*pos)
    img = pt.render_progressive(3)  # the first sample after a camera move: frame_count 0
    px, py = np.arange(w * h) % w, np.arange(w * h) // w
    quat = (0.0, 0.0, 0.0, 1.0)
    ref = render.sample_pixels(Triangles(torch.from_numpy(tris)), pos, quat, w, h, 70.0, 3, 0,
                               px, py, "cpu")
    gap = (ref - img.reshape(-1, 3)).abs().amax(dim=-1)
    assert float((gap > 1e-3).double().mean()) < 0.01
    low = render.sample_pixels(Triangles(torch.from_numpy(tris), torch.bfloat16), pos, quat, w,
                               h, 70.0, 3, 0, px, py, "cpu")
    assert float(((low.float() - img.reshape(-1, 3)).abs().amax(-1) > 1e-3).double().mean()) > 0.1


def test_accumulate_and_present():
    acc = torch.rand(5, 3)
    s = torch.rand(5, 3)
    out = render.accumulate(acc, s, 7)
    assert torch.allclose(out, (acc * 7 + s) / 8)
    img = render.present(torch.tensor([[0.0, 1.0, 1e9]]))
    assert img.tolist() == [[0, round((0.5 ** (1 / 2.2)) * 255), 255, 255]]
