"""The program's own spans and counters (``raytracer_tpu_torch/utils/
profiling.py``, names ``rt/...``), reduced to a table by span name and to
four per-layer numbers.

Two stretches of frames give them, each as long as the traced stretch
(``spans.py`` runs A before the traced stretch, since a process that has
traced the card once issues its kernels slower, and B after it):

* (A) spans and counters on, no profiler: the program's ``Span`` records
  on the host clock (``time.perf_counter_ns``) and its counters.
* (B) spans on, counters off, under ``torch.profiler``: each span is also a
  ``record_function`` range on the profiler's clock. A device operation
  belongs to the innermost ``rt/`` range that holds the runtime call that
  launched it, the host record with the operation's correlation id. An idle
  gap of the device belongs to the innermost ``rt/`` range open at its
  midpoint. The ranges that ``record_function`` leaves on the device's
  timeline are no operations.

Ranges of every host thread are searched together: the benchmark issues
its frames from one thread.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import NamedTuple

__all__ = ["PREFIX", "OUTSIDE", "Event", "events_of", "attribute", "host_table",
           "glue_issue_ms", "k2_alive_share", "refit_gather_ms", "refit_issue_ms"]

PREFIX = "rt/"
OUTSIDE = "(outside)"  # an idle gap, or an operation, in no rt/ range
_TRAVERSAL = ("rt/k1", "rt/k2")
_ENTRIES_GLUE = ("rt/render_progressive", "rt/present_progressive")
_REFIT_GATHERS = ("rt/refit/gather", "rt/refit/records")
_RUNTIME = ("cuda", "cu")  # CUDA API calls: cudaLaunchKernel, cudaMemcpyAsync, cuLaunchKernel


class Event(NamedTuple):
    """A profiler record, times in µs: ``corr`` its correlation id (a
    device operation's and its runtime call's are the same), ``annotation``
    a ``record_function`` range."""
    name: str
    device: bool
    start: float
    end: float
    corr: int
    annotation: bool


def events_of(prof) -> list[Event]:
    """The raw records of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if _call(e, "is_hidden_event"):
            continue
        out.append(Event(e.name(), e.device_type() == DeviceType.CUDA, e.start_ns() / 1e3,
                         e.end_ns() / 1e3, int(_call(e, "correlation_id") or 0),
                         bool(_call(e, "is_user_annotation"))))
    return out


def _call(event, name: str):
    method = getattr(event, name, None)
    return method() if callable(method) else None


class _Ranges:
    """The rt/ ranges of the host, for the innermost one around a time."""

    def __init__(self, events) -> None:
        self.ranges = sorted(((e.start, e.end, e.name) for e in events
                              if not e.device and e.name.startswith(PREFIX)))
        self.starts = [r[0] for r in self.ranges]

    def at(self, t: float) -> str:
        """The innermost range around ``t`` (the latest started that has not
        ended), or OUTSIDE."""
        for i in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            start, end, name = self.ranges[i]
            if end >= t:
                return name
        return OUTSIDE


def _is_operation(e: Event) -> bool:
    return e.device and not e.annotation and not e.name.startswith(PREFIX)


def attribute(events, frames: int) -> dict:
    """Stretch (B) → {"device": {range: [device ms a frame, operations a
    frame]}, "idle": {range: idle ms a frame}, "matched": {"runtime": n,
    "none": n}} (operations matched by their runtime call, and those with
    none, which go to OUTSIDE)."""
    ranges = _Ranges(events)
    runtime = {e.corr: e for e in events
               if not e.device and e.corr and e.name.startswith(_RUNTIME)}
    device = defaultdict(lambda: [0.0, 0])
    matched = {"runtime": 0, "none": 0}
    busy = []
    for e in events:
        if not _is_operation(e):
            continue
        busy.append((e.start, e.end))
        launch = runtime.get(e.corr) if e.corr else None
        name = OUTSIDE if launch is None else ranges.at(launch.start)
        matched["none" if launch is None else "runtime"] += 1
        device[name][0] += e.end - e.start
        device[name][1] += 1
    idle = defaultdict(float)
    merged = []
    for s, e in sorted(busy):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    for (_, end), (start, _) in zip(merged, merged[1:]):
        if start > end:
            idle[ranges.at(0.5 * (start + end))] += start - end
    n = max(frames, 1)
    return {"device": {k: [us / 1e3 / n, c / n] for k, (us, c) in device.items()},
            "idle": {k: us / 1e3 / n for k, us in idle.items()},
            "matched": matched}


def _ms(span) -> float:
    return (span.end_ns - span.start_ns) / 1e6


def host_table(spans, frames: int) -> dict:
    """Stretch (A)'s spans → {name: {"calls", "host_ms", "self_ms"}} a
    frame; self time is a span's less its children's."""
    children = defaultdict(float)
    for s in spans:
        if s.parent:
            children[s.parent] += _ms(s)
    out = defaultdict(lambda: {"calls": 0.0, "host_ms": 0.0, "self_ms": 0.0})
    n = max(frames, 1)
    for s in spans:
        row = out[s.name]
        row["calls"] += 1 / n
        row["host_ms"] += _ms(s) / n
        row["self_ms"] += (_ms(s) - children[s.id]) / n
    return dict(out)


def glue_issue_ms(spans, frames: int) -> float | None:
    """Host ms a frame inside ``rt/render_progressive`` and
    ``rt/present_progressive``, less their ``rt/k1`` and ``rt/k2``
    descendants; None without those spans."""
    roots = {s.id for s in spans if s.name in _ENTRIES_GLUE}
    if not roots or frames <= 0:
        return None
    inside = sum(_ms(s) for s in spans if s.id in roots)
    traversal = sum(_ms(s) for s in spans if s.name in _TRAVERSAL and s.root in roots)
    return (inside - traversal) / frames


def refit_issue_ms(spans, frames: int) -> float | None:
    """Host ms a frame inside ``rt/refit_bvh``; None without it."""
    refits = [_ms(s) for s in spans if s.name == "rt/refit_bvh"]
    return sum(refits) / frames if refits and frames > 0 else None


def k2_alive_share(counters: dict) -> float | None:
    """100 × ``rt/k2/active`` ÷ ``rt/k2/lanes``: the share of K2's lanes
    that carry a ray; None where K2 ran no lane."""
    lanes = counters.get("rt/k2/lanes")
    if not lanes:
        return None
    return 100.0 * counters.get("rt/k2/active", 0) / lanes


def refit_gather_ms(attributed: dict) -> float | None:
    """Device ms a frame of the operations launched inside
    ``rt/refit/gather`` or ``rt/refit/records``; None where none was."""
    rows = [attributed["device"][k] for k in _REFIT_GATHERS if k in attributed["device"]]
    return sum(r[0] for r in rows) if rows else None
