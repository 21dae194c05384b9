"""The metric readers and the trace reduction on a canned profiler table."""

from types import SimpleNamespace

import pytest
from common import reader_of
from devtrace import Trace, breakdown, busy_us, layer_of, layer_ms_per_frame, short

K1 = "void trace_tiles_kernel<4, 32, 161>(float const*, int, int, Camera)"
K2 = "void trace_rays_kernel<4, 1, 41>(float const*, int)"
GLUE = "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float> >(int)"

# two frames: each 1 ms of K1, 0.5 ms of K2, 0.25 ms of glue overlapping nothing,
# with idle gaps while the host ran an aten op or Python
TRACE = Trace(
    device=[(K1, 0.0, 1000.0), (K2, 1000.0, 1500.0), (GLUE, 1600.0, 1850.0),
            (K1, 3000.0, 4000.0), (K2, 4000.0, 4500.0), (GLUE, 4500.0, 4750.0)],
    host=[("bench/frame", -10.0, 2000.0), ("aten::nonzero", 1500.0, 1600.0),
          ("bench/frame", 2900.0, 5000.0)],
    frames=2, wall_s=0.005)


def reader(name):
    return reader_of(name)


def run_of(**kw):
    window = SimpleNamespace(frame_s=[0.002, 0.003, 0.0025, 0.004], issue_s=[0.001] * 4,
                             seconds=0.0115, frames=4)
    base = dict(setup_s=12.5, build_s=3.25, window=window, trace=TRACE, spans={},
                peaks={"f32_flops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12},
                work={"k1": {"flops": 67e9 * 0.5, "bytes": 1.0}}, rays_per_frame=1000)
    base.update(kw)
    return SimpleNamespace(**base)


def test_layers_by_kernel_name_and_short_names():
    assert [layer_of(n) for n in (K1, K2, GLUE)] == ["k1", "k2", "glue"]
    assert short(K1) == "trace_tiles_kernel<4, 32, 161>"


def test_busy_merges_overlaps_and_layer_ms():
    assert busy_us([("a", 0, 10), ("b", 5, 20), ("c", 30, 31)]) == 21
    assert layer_ms_per_frame(TRACE, "k1") == pytest.approx(1.0)
    assert layer_ms_per_frame(TRACE, "k2") == pytest.approx(0.5)
    assert layer_ms_per_frame(TRACE, "glue") == pytest.approx(0.25)
    assert layer_ms_per_frame(Trace([], [], 2, 1.0), "k1") is None


def test_breakdown_tops_and_gaps_by_host_activity():
    b = breakdown(TRACE)
    assert b["device_ops"][0] == ["trace_tiles_kernel<4, 32, 161>", pytest.approx(0.002)]
    gaps = dict(b["idle_gaps"])
    assert gaps["aten::nonzero"] == pytest.approx(100e-6)
    assert gaps["python"] == pytest.approx(1150e-6)  # between the two frames' spans


def test_end_to_end_readers():
    run = run_of()
    assert reader("mrays_per_s")(run) == pytest.approx(4 * 1000 / 0.0115 / 1e6)
    assert reader("mrays_per_s.hostbound")(run) == reader("mrays_per_s")(run)
    assert reader("frame_p95_ms")(run) == pytest.approx(3.85)
    assert reader("setup_s")(run) == 12.5


def test_per_layer_readers():
    run = run_of(spans={"refit_ms": [2.0, 4.0]})
    assert reader("host_issue_ms")(run) == pytest.approx(1.0)
    busy = (1000 + 500 + 250) * 2 / 1e3 / 2
    assert reader("device_idle_share")(run) == pytest.approx(100 * (1 - busy / 2.875))
    assert reader("glue_ms")(run) == pytest.approx(0.25)
    # 0.5 ms of f32 peak work a frame over 1 ms of K1 a frame
    assert reader("k1_roofline")(run) == pytest.approx(50.0)
    assert reader("refit_ms")(run) == 3.0 and reader("build_s")(run) == 3.25


def test_a_family_metric_reads_as_its_base_unless_it_has_a_reader_of_its_own(tmp_path,
                                                                            monkeypatch):
    import common

    run = run_of()
    assert reader("frame_p95_ms.somefamily")(run) == reader("frame_p95_ms")(run)
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "toy_ms.own.py").write_text("def read(run):\n    return 7.0\n")
    (tmp_path / "metrics" / "toy_ms.py").write_text("def read(run):\n    return 1.0\n")
    monkeypatch.setattr(common, "HERE", tmp_path)
    assert common.reader_of("toy_ms.own")(run) == 7.0
    assert common.reader_of("toy_ms.other")(run) == 1.0


def test_readers_with_nothing_to_read_return_none():
    run = run_of(trace=None, work=None, peaks=None)
    for name in ("device_idle_share", "glue_ms", "k1_roofline", "k2_roofline", "refit_ms"):
        assert reader(name)(run) is None
    assert reader("k2_roofline")(run_of()) is None  # no K2 work counted
