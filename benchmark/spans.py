"""The program's spans and counters in one cell, on the card: a set-up, a
warm-up and a window as ``run.py`` makes them, then stretches of the traced
stretch's length: one with tracing off, (A) spans and counters on with no
profiler, the traced stretch of ``run.py --trace 1``, (B) spans on under
``torch.profiler`` (``spantrace.py``), and one more with tracing off, whose
frame time against the first shows what the profiler leaves behind. A runs
before any profiler, since a process that has traced the card once issues
its kernels slower. Prints a
``[trace]`` line a span name to standard error (calls, host ms total and
self from A; device ms, device operations and idle ms from B; K1 and K2
launches from A's launch counts, all a frame) and one JSON object last on
standard output: the four numbers of ``spantrace.py``, the cell's own
per-layer metrics, the table, and what tracing costs (µs a span off, on, on
under the profiler; every stretch's frame ms).

    python3 benchmark/spans.py --workload <cell> --seed <n> [--seconds 10]
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import timeit  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

_SPAN_CALLS = 20000


def _frames(trial, count: int) -> float:
    """``count`` frames after the last one run → their seconds less the
    traffic's prepare time."""
    frames = range(trial.next_frame, trial.next_frame + count)
    prepare = 0.0
    t0 = time.perf_counter()
    for i in frames:
        q0 = time.perf_counter()
        trial.traffic.prepare(i)
        prepare += time.perf_counter() - q0
        trial.traffic.wait(trial.traffic.frame(i))
    trial.next_frame = frames.stop
    return time.perf_counter() - t0 - prepare


def host_stretch(trial, count: int, spans: bool = True, counters: bool = True) -> dict:
    """``count`` frames with spans and counters as given, no profiler: (A),
    or with both off a control → their spans, counters, launches a frame
    and seconds."""
    from raytracer_tpu_torch.ops.cuda import traverse
    from raytracer_tpu_torch.utils import profiling

    profiling.collect()
    before = dict(traverse.LAUNCHES)
    with profiling.tracing(spans=spans, counters=counters):
        seconds = _frames(trial, count)
    got = profiling.collect()
    launches = {k: (v - before.get(k, 0)) / count for k, v in traverse.LAUNCHES.items()
                if v != before.get(k, 0)}
    return {"frames": count, **got, "launches": launches, "seconds": seconds}


def profiled_stretch(trial, count: int) -> dict:
    """(B): ``count`` frames with spans on under the profiler → the
    attribution of the device's operations and idle gaps, and seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import spantrace
    from raytracer_tpu_torch.utils import profiling

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if trial.device.type == "cuda" else [])
    with profiling.tracing(spans=True, counters=False), profile(activities=acts) as prof:
        seconds = _frames(trial, count)
    profiling.collect()
    if trial.device.type == "cuda":
        torch.cuda.synchronize(trial.device)
    return {"frames": count, "seconds": seconds,
            "attributed": spantrace.attribute(spantrace.events_of(prof), count)}


def stretch_frames(window) -> int:
    """The traced stretch's frame count (``harness.Trial.run_traced``'s rule)."""
    import numpy as np

    import harness

    per = window.seconds / max(window.frames, 1)
    rule = harness._TRACE_SECONDS, harness._TRACE_FRAMES  # noqa: SLF001
    return int(np.clip(round(rule[0] / per), *rule[1]))


def span_cost_us() -> dict:
    """µs an empty span costs: off, on, on under the profiler (host only)."""
    from torch.profiler import ProfilerActivity, profile

    from raytracer_tpu_torch.utils import profiling

    def one():
        with profiling.span("rt/cost"):
            pass

    out = {"off": timeit.timeit(one, number=_SPAN_CALLS) / _SPAN_CALLS * 1e6}
    with profiling.tracing(spans=True, counters=False):
        out["on"] = timeit.timeit(one, number=_SPAN_CALLS) / _SPAN_CALLS * 1e6
        with profile(activities=[ProfilerActivity.CPU]):
            out["on_profiled"] = timeit.timeit(one, number=_SPAN_CALLS) / _SPAN_CALLS * 1e6
    profiling.collect()
    return out


def table(a: dict, b: dict) -> dict:
    """One row a span name: stretch A's host columns, B's device columns."""
    import spantrace

    rows = spantrace.host_table(a["spans"], a["frames"])
    att = b["attributed"]
    for name in sorted(set(rows) | set(att["device"]) | set(att["idle"])):
        row = rows.setdefault(name, {"calls": 0.0, "host_ms": 0.0, "self_ms": 0.0})
        row["device_ms"], row["device_ops"] = att["device"].get(name, [0.0, 0.0])
        row["idle_ms"] = att["idle"].get(name, 0.0)
        layer = {"rt/k1": "trace_tiles", "rt/k2": "trace_rays"}.get(name)
        row["launches"] = (sum(v for k, v in a["launches"].items() if k.startswith(layer))
                           if layer else 0.0)
    return dict(sorted(rows.items()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    import torch

    import harness
    import spantrace
    from common import reader_of

    if not torch.cuda.is_available():
        print("[spans] no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    session = harness.Session(args.workload, torch.device("cuda", 0), instrument=True)
    trial = session.trial(args.seed)
    trial.warmup(args.seconds)
    window = trial.run_window(args.seconds)
    n = stretch_frames(window)
    before = host_stretch(trial, n, spans=False, counters=False)
    a = host_stretch(trial, n)
    trial.run_traced()
    trial.next_frame = trial.traced.stop
    b = profiled_stretch(trial, n)
    after = host_stretch(trial, n, spans=False, counters=False)
    cost = span_cost_us()
    rows = table(a, b)
    for name, r in rows.items():
        print(f"[trace] {name} calls {r['calls']:.2f} host_ms {r['host_ms']:.4f} self_ms "
              f"{r['self_ms']:.4f} device_ms {r['device_ms']:.4f} device_ops "
              f"{r['device_ops']:.1f} idle_ms {r['idle_ms']:.4f} launches {r['launches']:.2f}",
              file=sys.stderr)
    run = harness._Readings(0.0, session.build_s, window, trial,  # noqa: SLF001
                            harness._peaks(torch.cuda.get_device_name()))  # noqa: SLF001
    cell = {m["name"]: reader_of(m["name"])(run)
            for m in harness.metrics_for(session.spec, args.workload, True)}

    def frame_ms(stretch):
        return stretch["seconds"] / stretch["frames"] * 1e3

    out = {
        "workload": args.workload, "seed": args.seed, "frames": n,
        "card": harness._power_limit(),  # noqa: SLF001
        "metrics": {"glue_issue_ms": spantrace.glue_issue_ms(a["spans"], n),
                    "k2_alive_share": spantrace.k2_alive_share(a["counters"]),
                    "refit_gather_ms": spantrace.refit_gather_ms(b["attributed"]),
                    "refit_issue_ms": spantrace.refit_issue_ms(a["spans"], n)},
        "cell_metrics": cell, "counters": a["counters"], "matched": b["attributed"]["matched"],
        "launches": a["launches"],
        "cost": {**{f"span_us_{k}": v for k, v in cost.items()},
                 "spans_a_frame": len(a["spans"]) / n,
                 "window_frame_ms": window.seconds / window.frames * 1e3,
                 "off_before_frame_ms": frame_ms(before), "a_frame_ms": frame_ms(a),
                 "traced_frame_ms": trial.trace.wall_s / trial.trace.frames * 1e3,
                 "b_frame_ms": frame_ms(b), "off_after_frame_ms": frame_ms(after)},
        "table": rows,
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
