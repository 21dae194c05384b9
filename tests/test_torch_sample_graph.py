"""The progressive sample as one CUDA graph (``render_pt.SampleGraphs``) and
the uniform block it reads on the device (``render_pt.uniform_block``).

On the CPU: which samples would replay a graph and which run op by op
(``sample_graph_eligible``), the block's packing (a row of K1c's camera
table with the mean's sample count), the plain versions of K1b and of the
camera wave's lanes fed from the row (``trace_tiles_row``,
``camera_lanes``) against the host-argument plain versions, and the
graph's body run op by op (the sample fed from the block, ``accumulate``
with the block's count, in place) against ``pt_sample_frame`` and
``accumulate`` from host arguments, word for word; a tracer on the CPU
never captures.

On the card (``cuda``; needs neither JAX nor the JAX package):

    python -m pytest --noconftest -m cuda tests/test_torch_sample_graph.py

K1b traced from the row equals K1b from host arguments, and the lanes
kernel its plain version; every mean that
``render_progressive`` returns through the graph equals the mean of the
same calls run op by op (counters on), word for word, for a bunny-class
sphere and the atrium at toy size, 1, 3 and 4 bounces, several frame
counts, a camera move and a ``set_frame_count``; a returned mean is not
changed by the next three calls; each sample adds the launches of one
sample run op by op, the replay is counted once a sample and the capture
once a key; a replay is one span and waits for nothing; counters on run op by op and count
what a tracer that never captured counts; a refit or a new frame size
captures anew and the tracer keeps at most four graphs.
"""

import pytest
import torch

from raytracer_tpu_torch import PathTracer, pathtracer, render_pt
from raytracer_tpu_torch.models.scene import Scene
from raytracer_tpu_torch.ops.cuda import traverse
from raytracer_tpu_torch.ops.cuda.camera import camera_lanes, camera_lanes_reference
from raytracer_tpu_torch.utils import procgen, profiling
from torch_parity import one_torch_thread  # noqa: F401

FOV = 70.0
POS = (0.15, -0.05, 2.6)
QUAT = (0.0, 0.0998, 0.0, 0.995)
MOVED = (0.4, 0.1, 2.4)
GRAPH_COUNTS = ("sample_graph_replay", "sample_graph_capture")


def bunny():
    """A bunny-class scene: the benchmark's stand-in, the icosphere, cut down."""
    return procgen.make_icosphere(3)


def atrium():
    """The Sponza-class atrium at the benchmark's toy detail, normalized
    into the cube as the benchmark's configuration normalizes it."""
    scene = Scene().set_triangles(procgen.make_sponza_atrium(detail=1))
    scene._normalize_enabled, scene._normalize_mode = True, "cube"
    scene.normalize_mesh()
    return scene.triangles


SCENES = {"bunny": (bunny, (0.0, 0.0, 2.8), (0.0, 0.0, 0.0, 1.0)),
          "atrium": (atrium, (0.0, -0.227, 0.6486), (0.0, 0.0, 0.0, 1.0))}


@pytest.fixture(autouse=True)
def nothing_left():
    profiling.collect()
    yield
    profiling.collect()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    return torch.device("cuda")


def tracer(tris, width, height, device, leaf=8):
    pt = PathTracer(width, height, "collapse", "sah", leaf, device=device)
    pt.fov_degrees = FOV
    pt.build_bvh(tris)
    return pt


def block_of(pos, quat, width, height, frame_count, device="cpu"):
    gen = torch.Generator().manual_seed(frame_count)
    values = render_pt.uniform_block(pos, quat, width, height, FOV,
                                     render_pt.jitter_seed(gen.initial_seed()), frame_count)
    return torch.tensor(values, dtype=torch.float32, device=device)


# -- the CPU ---------------------------------------------------------------------


@pytest.mark.parametrize("device,tile_primary,compact,counting,uniforms,want", [
    ("cuda", True, False, False, None, True),
    ("cuda:0", True, False, False, None, True),
    ("cpu", True, False, False, None, False),
    ("cuda", False, False, False, None, False),
    ("cuda", True, True, False, None, False),
    ("cuda", True, False, True, None, False),
    ("cuda", True, False, False, {"pseed": 3}, False),
])
def test_eligibility(device, tile_primary, compact, counting, uniforms, want):
    """The graph engages on CUDA records traced through K1b with no injected
    uniforms, no compaction and counters off; every other sample runs op by
    op."""
    got = render_pt.sample_graph_eligible(device, tile_primary=tile_primary, compact=compact,
                                          counting=counting, uniforms=uniforms)
    assert got is want


@pytest.mark.parametrize("frame_count", [0, 1, 511, 2**24 + 1])
def test_uniform_block_packing(frame_count):
    """The block is the camera row K1c's table holds for the sample's frame,
    camera and jitter seed, and the mean's sample count as f32 in column
    14; the seed is the one the sample's own generator gives."""
    w, h = 96, 54
    gen = torch.Generator().manual_seed(frame_count)
    pseed = render_pt._Draws(None, gen, "cpu").pseed()
    assert pseed == render_pt.jitter_seed(gen.initial_seed())
    values = render_pt.uniform_block(POS, QUAT, w, h, FOV, pseed, frame_count)
    assert len(values) == traverse.CAMERA_ROW == 16
    row = traverse.camera_row(POS, QUAT, w, h, FOV, pseed)
    assert values[:render_pt.COUNT_COLUMN] == row[:render_pt.COUNT_COLUMN]
    assert values[render_pt.COUNT_COLUMN + 1:] == [0.0]
    focal, aspect = traverse.camera_constants(w, h, FOV)
    assert row[:11] == [*POS, *QUAT, focal, aspect, float(w), float(h)]
    assert row[11] == float(pseed) and row[12:] == [0.0] * 4
    block = render_pt.camera_block(values, "cpu")
    assert torch.equal(block, torch.tensor(values, dtype=torch.float32))
    assert int(block[11]) == pseed  # below 2^22: exact in f32
    count = torch.full((), float(frame_count), dtype=torch.float32)
    assert torch.equal(block[render_pt.COUNT_COLUMN], count)


def test_k1c_table_rows_are_camera_rows():
    """trace_tiles_batch's camera table is camera_row's rows, so a block is
    one row of it."""
    pos = torch.tensor([[0.1, 0.2, 2.0], [0.0, -0.3, 2.5]])
    quat = torch.tensor([[0.0, 0.0, 0.0, 1.0], [0.0, 0.0998, 0.0, 0.995]])
    rows = [traverse.camera_row(p, q, 40, 24, FOV, s, 2, 3)
            for p, q, s in zip(pos.tolist(), quat.tolist(), (5, 9))]
    assert all(len(r) == traverse.CAMERA_ROW for r in rows)
    assert rows[1][11:14] == [9.0, 2.0, 3.0]


@pytest.mark.parametrize("width,height", [(40, 36), (64, 32)])
def test_row_fed_k1b_and_lanes_equal_host_arguments_on_cpu(width, height):
    """The plain versions of K1b and of the camera wave's lanes fed from a
    block give the host-argument path's words."""
    pt = tracer(bunny(), width, height, "cpu")
    pseed = 1_234_567
    block = torch.tensor(render_pt.uniform_block(POS, QUAT, width, height, FOV, pseed, 3),
                         dtype=torch.float32)
    before = dict(traverse.LAUNCHES)
    by_row = traverse.trace_tiles_row(pt._qnodes, block, width, height, FOV, leaf_k=8)
    by_args = traverse.trace_tiles(pt._qnodes, POS, QUAT, width, height, FOV, leaf_k=8,
                                   jitter=True, jitter_seed=pseed)
    for a, b in zip(by_row, by_args):
        assert torch.equal(a, b)
    assert bool((by_row[4] >= 0).any()) and bool((by_row[4] < 0).any())
    for a, b in zip(camera_lanes(by_row, block, width, height, FOV),
                    camera_lanes_reference(by_args, QUAT, width, height, FOV, pseed)):
        assert torch.equal(a, b)
    assert traverse.LAUNCHES == before  # the CPU launches nothing


@pytest.mark.parametrize("scene,bounces", [("bunny", 1), ("bunny", 3), ("atrium", 4)])
def test_block_sample_equals_host_sample_on_cpu(scene, bounces):
    """The graph's body run op by op (the sample fed from the block, the
    mean updated in place with the block's count) gives pt_sample_frame's
    sample from host arguments and accumulate's mean, word for word."""
    make, pos, quat = SCENES[scene]
    w, h = 48, 40
    pt = tracer(make(), w, h, "cpu", leaf=32)
    body = render_pt.SampleGraph(pt._qnodes, pt._tris_dev, w, h, bounces=bounces,
                                 fov_degrees=FOV, leaf_k=32)
    for frame_count in (0, 5):
        gen = torch.Generator().manual_seed(frame_count)
        host = render_pt.pt_sample_frame(pt._qnodes, pt._tris_dev, pos, quat, w, h,
                                         bounces=bounces, fov_degrees=FOV, leaf_k=32,
                                         tile_primary=True, generator=gen)
        prev = torch.rand((h, w, 3), generator=torch.Generator().manual_seed(9))
        want = render_pt.accumulate(prev, host, frame_count)
        body.block.copy_(block_of(pos, quat, w, h, frame_count))
        body.generator.manual_seed(frame_count)
        body.mean.copy_(prev)
        mean = body.mean
        body.run()
        assert body.mean is mean and not body.captured
        assert torch.equal(body.mean, want)


def test_block_needs_the_tile_camera_wave():
    """The camera row that feeds the tile camera wave is refused unless it
    is a contiguous (16,) f32 row on the records' device with a jitter seed
    in [0, 2^24)."""
    pt = tracer(bunny(), 32, 32, "cpu")
    block = block_of(POS, QUAT, 32, 32, 0)
    with pytest.raises(ValueError):
        traverse.trace_tiles_row(pt._qnodes, block[:8], 32, 32, FOV, leaf_k=8)
    with pytest.raises(ValueError):
        traverse.trace_tiles_row(pt._qnodes, block.double(), 32, 32, FOV, leaf_k=8)
    with pytest.raises(ValueError):
        traverse.trace_tiles_row(pt._qnodes, torch.stack([block, block], 1)[:, 0], 32, 32,
                                 FOV, leaf_k=8)
    big_seed = block.clone()
    big_seed[11] = float(1 << 24)
    with pytest.raises(ValueError):
        traverse.trace_tiles_row(pt._qnodes, big_seed, 32, 32, FOV, leaf_k=8)
    with pytest.raises(ValueError):
        render_pt.uniform_block(POS, QUAT, 32, 32, FOV, -1, 0)
    planes = traverse.trace_tiles_row(pt._qnodes, block, 32, 32, FOV, leaf_k=8)
    with pytest.raises(ValueError):
        camera_lanes(planes, block[:8], 32, 32, FOV)


def test_cpu_tracer_never_captures():
    pt = tracer(bunny(), 32, 24, "cpu")
    pt.set_camera_position(*POS)
    before = {k: traverse.LAUNCHES[k] for k in GRAPH_COUNTS}
    for _ in range(3):
        pt.render_progressive(bounces=1)
    assert {k: traverse.LAUNCHES[k] for k in GRAPH_COUNTS} == before
    assert not pt._sample_graphs._graphs
    assert pt.frame_count == 3


# -- the card --------------------------------------------------------------------


def launches_of(fn):
    """(fn's result, the launches it added, by name, those it left out)."""
    before = dict(traverse.LAUNCHES)
    out = fn()
    return out, {k: v - before[k] for k, v in traverse.LAUNCHES.items() if v != before[k]}


def calls():
    """The sequence of calls a card test runs on each tracer: samples at
    rest, a set_frame_count, samples after a camera move."""
    steps = [("sample", None)] * 4 + [("count", 17)] + [("sample", None)] * 2
    return steps + [("move", MOVED)] + [("sample", None)] * 3


def run_calls(pt, bounces, eager: bool):
    """Each mean that ``calls()`` returns, with each sample's launches; op by
    op with counters on where ``eager``."""
    means, launches = [], []
    for what, arg in calls():
        if what == "count":
            pt.set_frame_count(arg)
        elif what == "move":
            pt.set_camera_position(*arg)
        else:
            if eager:
                with profiling.tracing(spans=False, counters=True):
                    mean, added = launches_of(lambda: pt.render_progressive(bounces=bounces))
            else:
                mean, added = launches_of(lambda: pt.render_progressive(bounces=bounces))
            means.append((mean, mean.clone()))
            launches.append(added)
    torch.cuda.synchronize()
    return means, launches


@pytest.mark.cuda
@pytest.mark.parametrize("widener,leaf", [("collapse", 8), ("collapse", 32),
                                          ("collapse8", 32), ("collapse", 1)])
@pytest.mark.parametrize("width,height", [(512, 512), (1000, 600)])
def test_row_fed_kernels_equal_host_arguments_on_card(cuda_device, widener, leaf, width,
                                                      height):
    """K1b traced from a block on the device (K1c's kernel over one frame)
    gives the host-argument K1b's words and counts as it does; the camera
    wave's lanes read from the block give their plain version's words."""
    pt = PathTracer(width, height, widener, "sah", leaf, device=cuda_device)
    pt.build_bvh(bunny())
    pseed = 2_900_001
    block = torch.tensor(render_pt.uniform_block(POS, QUAT, width, height, FOV, pseed, 7),
                         dtype=torch.float32, device=cuda_device)
    by_row, added_row = launches_of(
        lambda: traverse.trace_tiles_row(pt._qnodes, block, width, height, FOV, leaf_k=leaf))
    by_args, added_args = launches_of(
        lambda: traverse.trace_tiles(pt._qnodes, POS, QUAT, width, height, FOV, leaf_k=leaf,
                                     jitter=True, jitter_seed=pseed))
    assert added_row == added_args
    lanes_row = camera_lanes(by_row, block, width, height, FOV)
    lanes_args = camera_lanes_reference(by_args, QUAT, width, height, FOV, pseed)
    torch.cuda.synchronize()
    for name, a, b in zip(("t", "nx", "ny", "nz", "tri"), by_row, by_args):
        assert torch.equal(a, b), f"{name}: {int((a != b).sum())} words differ"
    for name, a, b in zip(("d", "t", "tri", "n"), lanes_row, lanes_args):
        assert torch.equal(a, b), f"lanes {name}: {int((a != b).sum())} words differ"
    assert bool((by_row[4] >= 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("scene,bounces", [("bunny", 1), ("bunny", 3), ("atrium", 4),
                                           ("atrium", 1)])
def test_replay_equals_eager_on_card(cuda_device, scene, bounces):
    make, pos, quat = SCENES[scene]
    w, h = 200, 120
    tris = make()
    graphed, eager = (tracer(tris, w, h, cuda_device, leaf=32) for _ in range(2))
    assert torch.equal(graphed._qnodes, eager._qnodes)
    for pt in (graphed, eager):
        pt.set_camera_position(*pos)
        pt.set_camera_quaternion(*quat)
    ours, ours_launches = run_calls(graphed, bounces, eager=False)
    want, want_launches = run_calls(eager, bounces, eager=True)
    assert graphed.frame_count == eager.frame_count == 3
    for i, ((a, a_then), (b, _)) in enumerate(zip(ours, want)):
        assert torch.equal(a, b), f"mean {i}: {int((a != b).sum())} words differ"
        # what a call returned is not changed by the later calls
        assert torch.equal(a, a_then), f"mean {i} changed after it was returned"
    replays = sum(d.get("sample_graph_replay", 0) for d in ours_launches)
    captures = sum(d.get("sample_graph_capture", 0) for d in ours_launches)
    assert replays == len(ours) - 1 and captures == 1
    assert all("sample_graph_replay" not in d for d in want_launches)
    for i, (a, b) in enumerate(zip(ours_launches, want_launches)):
        kernels = {k: v for k, v in a.items() if k not in GRAPH_COUNTS}
        assert kernels == b, f"sample {i}: {kernels} against {b} op by op"
    assert set(want_launches[0]) >= {"trace_tiles_k1b", "camera_lanes", "wave_hit",
                                     "wave_bounce", "trace_rays_k2b"}


@pytest.mark.cuda
def test_returned_mean_outlives_three_calls_on_card(cuda_device):
    pt = tracer(bunny(), 128, 96, cuda_device)
    pt.set_camera_position(*POS)
    held = []
    for _ in range(8):
        mean = pt.render_progressive(bounces=1)
        held.append((mean, mean.clone()))
    torch.cuda.synchronize()
    for i, (mean, then) in enumerate(held):
        assert torch.equal(mean, then), f"mean {i} changed"
    assert len({m.data_ptr() for m, _ in held}) == len(held)


@pytest.mark.cuda
def test_counters_on_run_op_by_op_and_count_alike_on_card(cuda_device):
    """With counters on a tracer that holds a graph runs its samples op by
    op, and counts the NEE shadow rays as a tracer that never captured."""
    make, pos, quat = SCENES["atrium"]
    tris = make()
    warm, fresh = (tracer(tris, 160, 96, cuda_device, leaf=32) for _ in range(2))
    for pt in (warm, fresh):
        pt.set_camera_position(*pos)
    for _ in range(3):
        warm.render_progressive(bounces=4)
        with profiling.tracing(spans=False, counters=True):
            fresh.render_progressive(bounces=4)
    assert len(warm._sample_graphs._graphs) == 1 and not fresh._sample_graphs._graphs
    counted = {}
    for name, pt in (("warm", warm), ("fresh", fresh)):
        pt.set_frame_count(40)
        before = {k: traverse.LAUNCHES[k] for k in GRAPH_COUNTS}
        profiling.collect()
        with profiling.tracing(spans=False, counters=True):
            means = [pt.render_progressive(bounces=4) for _ in range(2)]
        counted[name] = (profiling.collect()["counters"], means)
        assert {k: traverse.LAUNCHES[k] for k in GRAPH_COUNTS} == before
    (c_warm, m_warm), (c_fresh, m_fresh) = counted["warm"], counted["fresh"]
    assert c_warm == c_fresh
    assert c_warm["rt/pt/shadow/cast"] > c_warm["rt/pt/shadow/blocked"] > 0
    for a, b in zip(m_warm, m_fresh):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_paths_the_graph_leaves_out_on_card(cuda_device, monkeypatch):
    """bounces=0, brute force and compaction run op by op: no capture, no
    replay."""
    small = tracer(procgen.make_icosphere(0)[:8], 64, 48, cuda_device, leaf=1)
    pt = tracer(bunny(), 64, 48, cuda_device)
    before = {k: traverse.LAUNCHES[k] for k in GRAPH_COUNTS}
    for _ in range(3):
        pt.render_progressive(bounces=0)
        small.render_progressive(bounces=2)
    monkeypatch.setattr(pathtracer, "COMPACT_WAVES", True)
    for _ in range(3):
        pt.render_progressive(bounces=2)
    torch.cuda.synchronize()
    assert {k: traverse.LAUNCHES[k] for k in GRAPH_COUNTS} == before
    assert not pt._sample_graphs._graphs and not small._sample_graphs._graphs


@pytest.mark.cuda
def test_replay_is_one_span_on_card(cuda_device):
    """With spans on, a replayed sample is one span rt/pt/graph inside
    rt/render_progressive, with no span of the sample's waves."""
    pt = tracer(bunny(), 96, 64, cuda_device)
    pt.set_camera_position(*POS)
    for _ in range(2):
        pt.render_progressive(bounces=2)
    profiling.collect()
    with profiling.tracing(spans=True, counters=False):
        pt.render_progressive(bounces=2)
    spans = profiling.collect()["spans"]
    assert [s.name for s in spans] == ["rt/pt/graph", "rt/render_progressive"]
    assert spans[0].parent == spans[1].id
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_replay_waits_for_nothing_on_card(cuda_device):
    pt = tracer(bunny(), 96, 64, cuda_device)
    pt.set_camera_position(*POS)
    for _ in range(2):
        pt.render_progressive(bounces=2)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(10):  # more samples than the staging rows
            pt.render_progressive(bounces=2)
        pt.set_camera_position(*MOVED)
        pt.render_progressive(bounces=2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_new_records_or_sizes_capture_anew_on_card(cuda_device):
    """A refit drops the graphs of the old records and captures anew; other
    frame sizes and bounce counts each get a graph, at most four kept."""
    tris = bunny()
    pt = tracer(tris, 64, 48, cuda_device, leaf=32)
    pt.set_camera_position(*POS)
    _, added = launches_of(lambda: [pt.render_progressive(bounces=1) for _ in range(3)])
    assert added["sample_graph_capture"] == 1 and added["sample_graph_replay"] == 2
    pt.refit_bvh(tris * 1.01)
    _, added = launches_of(lambda: [pt.render_progressive(bounces=1) for _ in range(3)])
    assert added["sample_graph_capture"] == 1 and added["sample_graph_replay"] == 2
    assert len(pt._sample_graphs._graphs) == 1
    for b in (2, 3, 4, 5, 6):
        pt.render_progressive(bounces=b)
        pt.render_progressive(bounces=b)
    assert len(pt._sample_graphs._graphs) == 4
    torch.cuda.synchronize()
