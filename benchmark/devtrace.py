"""The traced stretch of a ``--trace 1`` run, reduced to what the metric
readers need: the device's operations and the host's, with their times.

``from_profiler`` takes a finished ``torch.profiler.profile`` (CUPTI's
kernel, copy and set records on the device; the host's operator, runtime
and span records). A device operation belongs to a layer by its name:
K1 (``trace_tiles`` kernels, ``csrc/traverse_tiles.cu``), K2 (``trace_rays``
kernels, ``csrc/traverse_rays.cu``), and the glue: every other operation.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass

__all__ = ["Trace", "from_profiler", "layer_of", "busy_us", "layer_ms_per_frame",
           "breakdown", "SPAN_PREFIX"]

SPAN_PREFIX = "bench/"
_LAYERS = (("k1", "trace_tiles"), ("k2", "trace_rays"))
_NAME_CHARS = 120
_TOP = 10
_WALK = 64


@dataclass
class Trace:
    """Device and host records (name, start µs, end µs) of ``frames`` frames
    traced over ``wall_s`` seconds."""
    device: list
    host: list
    frames: int
    wall_s: float


def from_profiler(prof, frames: int, wall_s: float) -> Trace:
    """The profiler's raw records (faster to read than its event tree by
    two orders of magnitude), times in µs on one clock."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        if _flag(e, "is_hidden_event"):
            continue
        rec = (e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
        if e.device_type() != DeviceType.CUDA:
            host.append(rec)
        elif not (_flag(e, "is_user_annotation") or rec[0].startswith(SPAN_PREFIX)):
            device.append(rec)  # a span's range on the device's timeline is no operation
    return Trace(sorted(device, key=lambda r: r[1]), sorted(host, key=lambda r: r[1]),
                 frames, wall_s)


def _flag(event, name: str) -> bool:
    method = getattr(event, name, None)
    return bool(method()) if callable(method) else False


def layer_of(name: str) -> str:
    for layer, marker in _LAYERS:
        if marker in name:
            return layer
    return "glue"


def short(name: str) -> str:
    """A kernel's name without ``void``, anonymous namespaces and its
    argument list."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:_NAME_CHARS]


def _merged(ops) -> list:
    out = []
    for _, s, e in sorted(ops, key=lambda r: r[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(ops) -> float:
    """µs in which at least one of ``ops`` ran."""
    return sum(e - s for s, e in _merged(ops))


def layer_ms_per_frame(trace: Trace, layer: str) -> float | None:
    """Device ms a frame of the operations of ``layer``; None if it ran none."""
    ops = [r for r in trace.device if layer_of(r[0]) == layer]
    if not ops or trace.frames <= 0:
        return None
    return sum(e - s for _, s, e in ops) / 1e3 / trace.frames


def _host_at(trace: Trace, starts: list, t: float) -> str:
    """What the host ran at time ``t``: the innermost host record around it
    (the benchmark's own spans last), or ``python`` between records."""
    span = None
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - _WALK), -1):
        name, s, e = trace.host[j]
        if e >= t:
            if not name.startswith(SPAN_PREFIX):
                return name
            span = span or name
    return span or "python"


def breakdown(trace: Trace) -> dict:
    """The device operations that took most time, and the idle gaps between
    them summed by what the host was doing, each at most 10, in seconds."""
    by_name = defaultdict(float)
    for name, s, e in trace.device:
        by_name[short(name)] += (e - s) / 1e6
    gaps = defaultdict(float)
    starts = [r[1] for r in trace.host]
    merged = _merged(trace.device)
    for (_, end), (start, _) in zip(merged, merged[1:]):
        if start > end:
            gaps[short(_host_at(trace, starts, 0.5 * (start + end)))] += (start - end) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:_TOP]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:_TOP]
    return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in idle]}
