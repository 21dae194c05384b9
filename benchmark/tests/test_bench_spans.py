"""The reductions of the program's spans and counters (``spantrace.py``) on
canned records, the existing readers against traces with ``rt/`` ranges in
them, and the two stretches of ``spans.py`` on a toy cell on the CPU."""

from types import SimpleNamespace

import pytest
from common import reader_of
from conftest import BENCH, toy_overrides
from devtrace import breakdown, from_profiler
from spantrace import (OUTSIDE, Event, attribute, glue_issue_ms, host_table, k2_alive_share,
                       refit_gather_ms, refit_issue_ms)
from test_bench_readers import GLUE, K1, K2, run_of

from raytracer_tpu_torch.utils.profiling import Span

MS = 1_000_000  # ns


def _span(name, id_, parent, root, start_ms, end_ms):
    return Span(name, id_, parent, root, 1, int(start_ms * MS), int(end_ms * MS))


def _later(spans, frame):
    """``spans`` as frame ``frame`` after them: new ids, 20 ms later."""
    move = 100 * frame
    return [s._replace(id=s.id + move, parent=s.parent and s.parent + move, root=s.root + move,
                       start_ns=s.start_ns + 20 * frame * MS, end_ns=s.end_ns + 20 * frame * MS)
            for s in spans]


# one frame: a sample (camera wave: K1, then its shadow wave: K2), the mean, the present
FRAME = [
    _span("rt/render_progressive", 1, 0, 1, 0.0, 10.0),
    _span("rt/pt/camera", 2, 1, 1, 1.0, 5.0),
    _span("rt/k1", 3, 2, 1, 2.0, 4.0),
    _span("rt/pt/shadow", 4, 2, 1, 4.25, 5.0),
    _span("rt/k2", 5, 4, 1, 4.5, 5.0),
    _span("rt/accumulate", 6, 1, 1, 6.0, 7.0),
    _span("rt/present_progressive", 7, 0, 7, 11.0, 12.0),
]
REFIT = [
    _span("rt/refit_bvh", 10, 0, 10, 0.0, 3.0),
    _span("rt/refit/upload", 11, 10, 10, 0.0, 0.5),
    _span("rt/refit/gather", 12, 10, 10, 1.0, 2.0),
]


def test_host_table_self_time_and_the_span_metrics():
    rows = host_table(FRAME + _later(FRAME, 1), 2)
    assert rows["rt/pt/camera"] == {"calls": 1.0, "host_ms": pytest.approx(4.0),
                                    "self_ms": pytest.approx(4.0 - 2.0 - 0.75)}
    assert rows["rt/render_progressive"]["self_ms"] == pytest.approx(10.0 - 4.0 - 1.0)
    assert rows["rt/k2"]["self_ms"] == rows["rt/k2"]["host_ms"] == pytest.approx(0.5)
    # 10 + 1 ms in the two entries, less K1's 2 ms and K2's 0.5 ms
    assert glue_issue_ms(FRAME, 1) == pytest.approx(8.5)
    assert glue_issue_ms(FRAME + REFIT, 1) == pytest.approx(8.5)
    assert refit_issue_ms(REFIT, 2) == pytest.approx(1.5)
    assert k2_alive_share({"rt/k2/lanes": 200, "rt/k2/active": 50}) == 25.0


def test_no_spans_reads_none():
    """The parent commit's program records no span: every reader gives None."""
    assert glue_issue_ms([], 3) is None and refit_issue_ms([], 3) is None
    assert glue_issue_ms(REFIT, 3) is None and refit_issue_ms(FRAME, 3) is None
    assert k2_alive_share({}) is None and k2_alive_share({"rt/k2/lanes": 0}) is None
    assert refit_gather_ms(attribute([], 3)) is None


def _host(name, start, end, corr=0):
    return Event(name, False, start, end, corr, name.startswith("rt/"))


def _dev(name, start, end, corr=0, annotation=False):
    return Event(name, True, start, end, corr, annotation)


# µs; the host issues inside its ranges while the device runs behind it
TRACE_B = [
    _host("rt/render_progressive", 0, 300, corr=1),
    _host("rt/pt/camera", 5, 40, corr=2),
    _host("rt/k1", 10, 20, corr=3),
    _host("cudaLaunchKernel", 12, 13, corr=101),
    _host("rt/pt/shadow", 25, 38, corr=4),
    _host("aten::mul", 26, 28, corr=5),
    _host("cudaLaunchKernel", 26.5, 27, corr=103),
    _host("rt/k2", 30, 36, corr=6),
    _host("cudaLaunchKernel", 31, 32, corr=102),
    _host("rt/accumulate", 60, 70, corr=7),
    _host("aten::add", 61, 62, corr=8),
    _host("cuLaunchKernel", 64, 65, corr=104),
    _host("rt/refit/gather", 400, 420, corr=9),
    _host("cudaMemcpyAsync", 405, 406, corr=105),
    _dev(K1, 50, 150, corr=101),
    _dev("rt/k2", 150, 200, annotation=True),     # a range's shadow on the device
    _dev("rt/pt/shadow", 150, 210),               # the same, the flag lost
    _dev(K2, 150, 200, corr=102),
    _dev(GLUE, 200, 210, corr=103),
    _dev(GLUE, 250, 260, corr=104),
    _dev(GLUE, 260, 270, corr=8),                 # an operator's id, no runtime call's
    _dev(GLUE, 280, 290),                         # no correlation
    _dev("Memcpy HtoD", 500, 540, corr=105),
]


def test_attribution_by_correlation():
    a = attribute(TRACE_B, 2)
    assert a["matched"] == {"runtime": 5, "none": 2}
    dev = a["device"]
    assert dev["rt/k1"] == [pytest.approx(0.05), 0.5]
    assert dev["rt/k2"] == [pytest.approx(0.025), 0.5]
    assert dev["rt/pt/shadow"] == [pytest.approx(0.005), 0.5]
    assert dev["rt/accumulate"] == [pytest.approx(0.005), 0.5]
    assert dev[OUTSIDE] == [pytest.approx(0.01), 1.0]
    assert dev["rt/refit/gather"] == [pytest.approx(0.02), 0.5]
    assert refit_gather_ms(a) == pytest.approx(0.02)
    # gaps 210-250 and 270-280 lie in the sample's range, 290-500 outside any
    assert a["idle"] == {"rt/render_progressive": pytest.approx((40 + 10) / 1e3 / 2),
                         OUTSIDE: pytest.approx(210 / 1e3 / 2)}


def test_rt_device_ranges_are_no_operations():
    """Neither the flagged range nor an rt/ name on the device's timeline
    is counted: the device's total is the operations' alone."""
    a = attribute(TRACE_B, 1)
    ops = sum(c for _, c in a["device"].values())
    assert ops == 7 and sum(ms for ms, _ in a["device"].values()) == pytest.approx(
        (100 + 50 + 10 + 10 + 10 + 10 + 40) / 1e3)


class _Kineto:
    """A kineto record as ``devtrace.from_profiler`` reads it."""

    def __init__(self, name, cuda, start_us, end_us, annotation):
        from torch.autograd import DeviceType

        self._v = (name, DeviceType.CUDA if cuda else DeviceType.CPU, start_us, end_us,
                   annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2] * 1e3

    def end_ns(self):
        return self._v[3] * 1e3

    def is_user_annotation(self):
        return self._v[4]

    def is_hidden_event(self):
        return False


def _profile(records):
    events = [_Kineto(*r) for r in records]
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


BASE = [("bench/frame", False, -10.0, 2000.0, True), ("aten::nonzero", False, 1500.0, 1600.0,
                                                        False),
        (K1, True, 0.0, 1000.0, False), (K2, True, 1000.0, 1500.0, False),
        (GLUE, True, 1600.0, 1850.0, False)]
RT = [("rt/render_progressive", False, 0.0, 1900.0, True),
      ("rt/k1", False, 10.0, 20.0, True), ("rt/k1", True, 0.0, 1000.0, True),
      ("rt/k2", False, 900.0, 950.0, True), ("rt/k2", True, 1000.0, 1500.0, True)]


@pytest.mark.parametrize("name", sorted(p.stem for p in (BENCH / "metrics").glob("*.py")))
def test_existing_readers_ignore_rt_ranges(name):
    """Every existing reader reads the same with rt/ ranges added on the
    host and on the device's timeline; so do the breakdown's device ops."""
    plain = from_profiler(_profile(BASE), 1, 0.002)
    ranged = from_profiler(_profile(BASE + RT), 1, 0.002)
    assert len(ranged.host) == len(plain.host) + 3 and ranged.device == plain.device
    kw = dict(work={"k1": {"flops": 1e9, "bytes": 1.0}, "k2": {"flops": 1e9, "bytes": 1.0}})
    assert reader_of(name)(run_of(trace=ranged, **kw)) == reader_of(name)(
        run_of(trace=plain, **kw))
    assert breakdown(ranged)["device_ops"] == breakdown(plain)["device_ops"]


def test_stretches_on_a_toy_cell():
    """spans.py's stretches on the CPU: the sample's spans and K2's counters
    in A, nothing in a stretch with tracing off, no device operation in B;
    the four numbers where the cell has their spans, None elsewhere."""
    import harness
    import spans
    import spantrace
    import torch

    torch.set_num_threads(1)

    def run(cell):
        session = harness.Session(cell, "cpu", overrides=toy_overrides(cell), instrument=True)
        trial = session.trial(2147483713)
        trial.warmup(0.2)
        window = trial.run_window(0.2)
        n = spans.stretch_frames(window)
        off = spans.host_stretch(trial, n, spans=False, counters=False)
        assert off["spans"] == [] and off["counters"] == {} and off["seconds"] > 0
        a = spans.host_stretch(trial, n)
        return a, spans.profiled_stretch(trial, n)

    a, b = run("bunny.spp4")
    n = a["frames"]
    rows = spans.table(a, b)
    assert rows["rt/render_progressive"]["calls"] == 4.0 and rows["rt/k2"]["calls"] == 4.0
    assert rows["rt/present_progressive"]["calls"] == 1.0
    assert 0 < spantrace.glue_issue_ms(a["spans"], n) < rows["rt/render_progressive"][
        "host_ms"] + rows["rt/present_progressive"]["host_ms"]
    assert 0 < spantrace.k2_alive_share(a["counters"]) <= 100
    assert spantrace.refit_issue_ms(a["spans"], n) is None
    assert b["attributed"]["matched"] == {"runtime": 0, "none": 0}
    a, b = run("dragon.deform8")
    assert spantrace.refit_issue_ms(a["spans"], a["frames"]) > 0
    assert [r for r in spans.table(a, b) if r.startswith("rt/refit/")] == [
        "rt/refit/gather", "rt/refit/records", "rt/refit/sweeps", "rt/refit/upload"]
