"""Profiling / metrics utilities, the counterparts of
``raytracer_tpu/utils/profiling.py``, and the program's spans and counters:

* :func:`sync` — wait for the card: ``torch.cuda.synchronize`` on the
  device of each CUDA tensor given (a CPU tensor is complete when an op
  returns it).
* :class:`FrameStats` — rolling FPS/Mrays/s with a 1 Hz report line, and
  the run's total (:meth:`FrameStats.summary`).
* :func:`span`, :func:`count`, :func:`tracing`, :func:`collect` — the
  spans and counters recorded at the layer boundaries of the frame path
  (names ``rt/...``, the same from call to call), off unless a
  :func:`tracing` block turns them on.
* :func:`trace_annotated` — a ``torch.profiler`` trace of the block, written
  as a Chrome trace with the block's spans beside it, when a profile
  directory is given (a no-op otherwise).

Spans. While spans are off, :func:`span` returns one shared no-op context
manager: a flag test, no object made, no ``record_function``. While they
are on, each span records a :class:`Span` on ``time.perf_counter_ns()``;
its parent is the innermost span open on the same thread, and the id of the
entry call at the root of its tree (``root``) is carried by every
descendant. Where a ``torch.profiler`` runs, a span also opens
``record_function(name)``, so that its range lies on the profiler's clock
beside the device's operations. A span never synchronises and never
launches device work.

Counters. :func:`count` adds to a named counter while counters are on: a
host int stays a host int, a device tensor is added on its device, without
a synchronise. Counters switch apart from spans because a counted device
value is a reduction launched on the card. :func:`collect` is the one
point that waits for the card, when it reads the device counters.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from pathlib import Path
from typing import NamedTuple

import torch

__all__ = ["FrameStats", "Span", "collect", "count", "counting", "span", "sync",
           "trace_annotated", "tracing"]


def sync(*tensors) -> None:
    """Block until the work that produces ``tensors`` is done on every CUDA
    device they live on."""
    for dev in {t.device for t in tensors
                if isinstance(t, torch.Tensor) and t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


class FrameStats:
    """Rolling frame statistics with a 1 Hz console report."""

    def __init__(self, width: int, height: int, report_every: float = 1.0) -> None:
        self.rays_per_frame = width * height
        self.report_every = report_every
        self._start = self._last = time.perf_counter()
        self._frames = 0
        self.frames = 0  # every tick since construction

    def tick(self, quiet: bool = False) -> dict | None:
        """Count a frame → the report record when the interval has passed."""
        self._frames += 1
        self.frames += 1
        now = time.perf_counter()
        dt = now - self._last
        if dt < self.report_every:
            return None
        fps = self._frames / dt
        rec = {
            "fps": round(fps, 2),
            "mrays_per_s": round(fps * self.rays_per_frame / 1e6, 2),
            "t": now,
        }
        if not quiet:
            print(f"{rec['fps']:7.1f} FPS  {rec['mrays_per_s']:8.1f} Mrays/s")
        self._last = now
        self._frames = 0
        return rec

    def summary(self) -> dict:
        """Frames, seconds, FPS and Mrays/s from construction to now (a run
        shorter than the report window prints no rolling line)."""
        secs = time.perf_counter() - self._start
        fps = self.frames / secs if secs > 0 else 0.0
        return {"frames": self.frames, "seconds": secs, "fps": fps,
                "mrays_per_s": fps * self.rays_per_frame / 1e6}


class Span(NamedTuple):
    """A recorded span: ``parent`` is the id of the innermost span open on
    the same thread when it began (0 for none), ``root`` the id of its
    tree's root (its own at a root); times are ``time.perf_counter_ns()``."""
    name: str
    id: int
    parent: int
    root: int
    thread: int
    start_ns: int
    end_ns: int


_SPANS_ON = False
_COUNTERS_ON = False
_RECORDED: list[Span] = []
_COUNTS: dict[str, int | torch.Tensor] = {}
_COUNTS_LOCK = threading.Lock()
_IDS = itertools.count(1)
_OPEN = threading.local()  # .stack: the spans open on this thread
_NO_SPAN = contextlib.nullcontext()


class _OpenSpan:
    __slots__ = ("name", "id", "parent", "root", "start", "ranged")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> "_OpenSpan":
        stack = _OPEN.__dict__.setdefault("stack", [])
        self.id = next(_IDS)
        self.parent, self.root = (stack[-1].id, stack[-1].root) if stack else (0, self.id)
        stack.append(self)
        self.ranged = None
        if torch.autograd.profiler._is_profiler_enabled:  # noqa: SLF001
            self.ranged = torch.autograd.profiler.record_function(self.name)
            self.ranged.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        if self.ranged is not None:
            self.ranged.__exit__(*exc)
        _OPEN.stack.pop()
        _RECORDED.append(Span(self.name, self.id, self.parent, self.root,
                              threading.get_ident(), self.start, end))
        return False


def span(name: str):
    """A context manager that records span ``name`` while spans are on."""
    if not _SPANS_ON:
        return _NO_SPAN
    return _OpenSpan(name)


def counting() -> bool:
    """Whether counters are on: test it before computing a counted value
    that costs device work."""
    return _COUNTERS_ON


def count(name: str, value) -> None:
    """Add ``value`` (a host int, or a device tensor added on its device) to
    counter ``name`` while counters are on."""
    if not _COUNTERS_ON:
        return
    with _COUNTS_LOCK:
        old = _COUNTS.get(name)
        _COUNTS[name] = value if old is None else old + value


@contextlib.contextmanager
def tracing(spans: bool = True, counters: bool = True):
    """Spans and counters on (or off) inside the block, as before it after."""
    global _SPANS_ON, _COUNTERS_ON
    before = _SPANS_ON, _COUNTERS_ON
    _SPANS_ON, _COUNTERS_ON = bool(spans), bool(counters)
    try:
        yield
    finally:
        _SPANS_ON, _COUNTERS_ON = before


def collect() -> dict:
    """{"spans": the spans recorded, in the order they ended, "counters":
    {name: int}} since the last collect, which both are cleared of. Reading
    a device counter waits for the card."""
    n = len(_RECORDED)
    spans = _RECORDED[:n]
    del _RECORDED[:n]
    with _COUNTS_LOCK:
        counts = dict(_COUNTS)
        _COUNTS.clear()
    return {"spans": spans, "counters": {k: int(v) for k, v in counts.items()}}


@contextlib.contextmanager
def trace_annotated(profile_dir: str | Path | None = None):
    """``torch.profiler`` over the block (host, and the card where there is
    one) with spans on, when a directory is given, else a no-op: writes
    ``profile_dir/trace.json`` (a Chrome trace, the spans' ranges in it) and
    ``profile_dir/spans.json`` ({"spans": the block's spans as objects of
    :class:`Span`'s fields, "counters": the counters recorded, while a
    :func:`tracing` block around this one keeps them on}). Spans recorded
    before the block and not collected are written with them."""
    if profile_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    with tracing(spans=True, counters=_COUNTERS_ON), profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))
    got = collect()
    (out / "spans.json").write_text(json.dumps(
        {"spans": [s._asdict() for s in got["spans"]], "counters": got["counters"]}))
