"""The port's spans and counters (``raytracer_tpu_torch/utils/profiling.py``)
on the CPU, with a small scene whose waves go through ``trace_rays``: off,
they record nothing and change no op and no pixel; on, the span trees of
the entry calls, the K2 counters against ``pt_sample_frame``'s ``stats``,
and the spans' ranges on the profiler's clock. On the card (``cuda``:
``python -m pytest --noconftest -m cuda tests/test_torch_tracing.py``), the
counters and ``stats`` of a sample through the wave kernels against those
through their plain versions."""

import json
from collections import Counter

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from raytracer_tpu_torch import PathTracer, pt_sample_frame
from raytracer_tpu_torch.utils import profiling
from torch_parity import CAM_POS, CAM_QUAT, one_torch_thread, seeded_scene  # noqa: F401

W, H = 16, 12
BOUNCES = 2


@pytest.fixture(scope="module")
def tracer():
    tris = seeded_scene(1)
    assert len(tris) > 8  # not the brute-force scene: the waves run trace_rays
    pt = PathTracer(W, H, builder="lbvh", leaf_size=4, device="cpu")
    pt.build_bvh(tris)
    pt.set_camera_position(*CAM_POS)
    pt.set_camera_quaternion(*CAM_QUAT)
    return pt


@pytest.fixture(autouse=True)
def nothing_left():
    profiling.collect()
    yield
    profiling.collect()


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _sample(pt, stats=False, bounces=BOUNCES):
    return pt_sample_frame(pt._qnodes, pt._tris_dev, CAM_POS, CAM_QUAT, W, H, bounces=bounces,
                           leaf_k=pt.leaf_size, tile_primary=True, stats=stats,
                           generator=torch.Generator().manual_seed(11))


def _ops(fn) -> Counter:
    with _Ops() as mode:
        fn()
    return mode.ops


def test_off_records_nothing_counts_only_with_stats_and_changes_no_pixel(tracer):
    """With tracing off no span or counter is kept. stats=False issues the
    ops of stats=True less its counting: one zeros, a sum and an add for the
    live lanes and for the shadow lanes of each bounce, the lane_rays fill.
    The sample is bit-equal with spans and counters on."""
    off = _sample(tracer)
    assert profiling.collect() == {"spans": [], "counters": {}}
    without = _ops(lambda: _sample(tracer))
    with_stats = _ops(lambda: _sample(tracer, stats=True))

    lanes = torch.ones(W * H, dtype=torch.bool)

    def counting():
        n = torch.zeros((), dtype=torch.int64)
        for _ in range(2 * BOUNCES):
            n = n + lanes.sum()
        torch.full((), 1.0)

    assert with_stats - without == _ops(counting) and not without - with_stats
    with profiling.tracing():
        on = _sample(tracer)
    assert profiling.collect()["spans"]
    assert torch.equal(on, off)


def _tree(spans):
    """{span id: (name, [child names in start order])} of recorded spans."""
    kids = {s.id: [] for s in spans}
    for s in sorted(spans, key=lambda s: s.start_ns):
        if s.parent:
            kids[s.parent].append(s.name)
    return {s.id: (s.name, kids[s.id]) for s in spans}


def test_span_trees_of_the_entry_calls(tracer):
    """render_progressive: camera > k1, each bounce > k2, each wave > shadow
    > k2, then accumulate; present_progressive and render (> k1) are roots;
    refit_bvh's four stages in order. Each span nests in its parent's time
    and carries its root's id."""
    with profiling.tracing(counters=False):
        tracer.render_progressive(BOUNCES)
        tracer.present_progressive()
        tracer.render()
        tracer.refit_bvh(tracer.triangles_data * np.float32(1.01))
    spans = profiling.collect()["spans"]
    tree = _tree(spans)
    by_id = {s.id: s for s in spans}
    roots = [tree[s.id] for s in sorted(spans, key=lambda s: s.start_ns) if not s.parent]
    assert roots == [
        ("rt/render_progressive", ["rt/pt/camera"] + ["rt/pt/bounce"] * (BOUNCES - 1)
         + ["rt/accumulate"]),
        ("rt/present_progressive", []),
        ("rt/render", ["rt/k1"]),
        ("rt/refit_bvh", ["rt/refit/upload", "rt/refit/sweeps", "rt/refit/gather",
                          "rt/refit/records"])]
    waves = {"rt/pt/camera": ["rt/k1", "rt/pt/shadow"], "rt/pt/bounce": ["rt/k2", "rt/pt/shadow"],
             "rt/pt/shadow": ["rt/k2"]}
    for s in spans:
        if s.name in waves:
            assert tree[s.id][1] == waves[s.name]
        if s.parent:
            parent = by_id[s.parent]
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
            assert s.root == parent.root
        else:
            assert s.root == s.id
    assert Counter(s.name for s in spans)["rt/k2"] == 2 * BOUNCES - 1


def test_k2_counters_against_the_sample_stats(tracer):
    """rt/k2/active = stats' alive_rays − H·W (the camera wave, all alive,
    goes through K1); rt/k2/lanes = H·W for each of the 2·bounces − 1 K2
    waves. The NEE shadow rays cast, which the shadow waves carry, are
    among K2's active lanes, and those blocked among them."""
    with profiling.tracing(spans=False):
        _, stats = _sample(tracer, stats=True)
    got = profiling.collect()
    assert got["spans"] == []
    counters = got["counters"]
    assert set(counters) == {"rt/k2/active", "rt/k2/lanes", "rt/pt/shadow/cast",
                             "rt/pt/shadow/blocked"}
    assert {k: counters[k] for k in ("rt/k2/active", "rt/k2/lanes")} == {
        "rt/k2/active": int(stats["alive_rays"]) - W * H, "rt/k2/lanes": (2 * BOUNCES - 1) * W * H}
    assert 0 < counters["rt/k2/active"] < counters["rt/k2/lanes"]
    assert 0 <= counters["rt/pt/shadow/blocked"] <= counters["rt/pt/shadow/cast"]
    assert 0 < counters["rt/pt/shadow/cast"] < counters["rt/k2/active"]


@pytest.mark.cuda
def test_shadow_counters_and_stats_equal_through_the_wave_kernels_on_card(monkeypatch):
    """On the card the sample's shading runs the wave kernels
    (ops/cuda/wave.py): the shadow counters, the K2 counters and stats read
    what they read through the plain versions of that shading."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the wave kernels have no CPU mode")
    from raytracer_tpu_torch import render_pt
    from raytracer_tpu_torch.ops.cuda import wave

    from raytracer_tpu_torch.utils import procgen

    width, height = 96, 64
    pt = PathTracer(width, height, builder="lbvh", leaf_size=4, device="cuda")
    hall = procgen.make_interior_hall()  # an interior: some shadow rays are blocked
    pt.build_bvh(hall * np.float32(1.0 / np.abs(hall).max()))

    def counted():
        with profiling.tracing(spans=False):
            img, stats = pt_sample_frame(
                pt._qnodes, pt._tris_dev, (0.0, 0.0, 0.8), CAM_QUAT, width, height, bounces=3,
                leaf_k=pt.leaf_size, tile_primary=True, stats=True,
                generator=torch.Generator(device="cuda").manual_seed(11))
        got = profiling.collect()["counters"]
        return img, {k: int(v) for k, v in stats.items()}, got

    img, stats, counters = counted()
    monkeypatch.setattr(render_pt, "wave_hit", wave.wave_hit_reference)
    monkeypatch.setattr(render_pt, "wave_bounce", wave.wave_bounce_reference)
    monkeypatch.setattr(render_pt, "wave_last", wave.wave_last_reference)
    plain_img, plain_stats, plain_counters = counted()
    assert torch.equal(img, plain_img)
    assert stats == plain_stats and counters == plain_counters
    assert 0 < counters["rt/pt/shadow/blocked"] < counters["rt/pt/shadow/cast"]


def _top_aten(prof, within=None):
    """Counter of the aten ops of a profile not nested in another aten op,
    those inside the range ``within`` = (start, end) where given."""
    ops = sorted(((e.name(), e.start_ns(), e.end_ns())
                  for e in prof.profiler.kineto_results.events() if e.name().startswith("aten::")),
                 key=lambda o: (o[1], -o[2]))
    top, end = [], -np.inf
    for o in ops:
        if o[1] >= end:
            top.append(o)
            end = o[2]
    lo, hi = within or (-np.inf, np.inf)
    return Counter(n for n, s, e in top if lo <= s and e <= hi)


def test_spans_on_the_profilers_clock(tracer):
    """Under torch.profiler each span is also a range of the profiler's
    trace, and the aten ops issued inside the span lie inside its range:
    every op of render_progressive, and in rt/accumulate's range exactly
    the ops accumulate issues alone."""
    from torch.profiler import ProfilerActivity, profile

    from raytracer_tpu_torch.render_pt import accumulate

    with profiling.tracing(counters=False), profile(activities=[ProfilerActivity.CPU]) as prof:
        tracer.render_progressive(BOUNCES)
    spans = profiling.collect()["spans"]
    events = [(e.name(), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()]
    ranges = [e for e in events if e[0].startswith("rt/")]
    assert Counter(e[0] for e in ranges) == Counter(s.name for s in spans)
    outer = next(e for e in ranges if e[0] == "rt/render_progressive")
    assert sum(_top_aten(prof).values()) == sum(_top_aten(prof, outer[1:]).values()) > 0
    acc = next(e for e in ranges if e[0] == "rt/accumulate")
    mean, sample = torch.zeros(H, W, 3), torch.ones(H, W, 3)
    with profile(activities=[ProfilerActivity.CPU]) as alone:
        accumulate(mean, sample, 1)
    assert _top_aten(prof, acc[1:]) == _top_aten(alone)


def test_trace_annotated_writes_the_spans(tracer, tmp_path):
    """trace_annotated turns spans on inside its block and writes them as
    spans.json beside the Chrome trace; the counters when they are on."""
    with profiling.tracing(spans=False, counters=True), \
            profiling.trace_annotated(tmp_path / "prof"):
        tracer.render_progressive(1)
    assert (tmp_path / "prof" / "trace.json").is_file()
    got = json.loads((tmp_path / "prof" / "spans.json").read_text())
    names = [s["name"] for s in got["spans"]]
    assert names.count("rt/render_progressive") == 1 and "rt/pt/shadow" in names
    assert set(got["spans"][0]) == set(profiling.Span._fields)
    assert got["counters"]["rt/k2/lanes"] == W * H
    assert profiling.collect() == {"spans": [], "counters": {}}
