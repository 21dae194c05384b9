"""One run of one cell: set-up, warm-up, the measured window, the traced
stretch, the comparison with the reference, and the result line.

Everything that belongs to one configuration, traffic kind, cell or metric
is found by name: ``configs/<config>.json``, ``workloads/<cell>.json``,
``traffic/<kind>.py`` and ``metrics/<metric>.py``. A run is a closed loop,
as the app's own loop is: one frame after the other, each ending in one
synchronise.

* Set-up (``setup_s``): from the process's start to the first timed frame:
  imports, the scene, the build (``build_s``: ``PathTracer.build_bvh``, which
  ends in a synchronise), and the warm-up frames of the cell's own shapes.
  The process runs one intra-op thread.
* The window: frames until ``--seconds`` have passed; each frame's time runs
  from its first call into the program to the return of its synchronise, and
  its host issue time to the return of its last call before that. The
  traffic's ``prepare(i)``, which makes frame i's input before that first
  call, lies outside both and outside the window's seconds: it is the
  benchmark's work, not the program's.
* ``--trace 1``: after the window, a stretch of frames under
  ``torch.profiler``, and the work counts of the traversal kernels.
* Then the peak device memory is read, the program's state is freed, and the
  reference judges the outputs the cell kept from the window.
"""

from __future__ import annotations

import gc
import subprocess
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

import devtrace
import scenes
from common import HERE, REPO, load_json, load_module, reader_of, sync

__all__ = ["Session", "Trial", "run_once", "spec_of", "metrics_for"]

_TRACE_SECONDS = 0.5
_TRACE_FRAMES = (3, 50)
_CONTROL_DTYPE = torch.bfloat16


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def spec_of(cell: str, spec: dict | None = None) -> tuple[dict, dict, dict, dict]:
    """(BENCHMARK.json, its workload entry, the configuration's file, the cell's file)."""
    spec = spec or load_json(REPO / "BENCHMARK.json")
    entry = next((w for w in spec["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    return spec, entry, load_json(REPO / conf["file"]), load_json(HERE / "workloads" /
                                                                   f"{cell}.json")


def metrics_for(spec: dict, cell: str, per_layer: bool) -> list[dict]:
    """The metrics a cell reports: with ``per_layer`` its per-layer ones, else
    its end-to-end ones. A metric without ``workloads`` applies to every cell
    (a per-layer one: every cell that reports the metric it moves)."""
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    if not per_layer:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names else [])]


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def _peaks(kind: str) -> dict | None:
    for name, peaks in load_json(HERE / "peaks.json")["cards"].items():
        if name in kind:
            return peaks
    return None


class Session:
    """A cell's set-up, shared by its trials: the configuration, the scene
    (the benchmark's input, handed to the program and to the reference), the
    program's tracer and its build."""

    def __init__(self, cell: str, device, *, spec: dict | None = None,
                 overrides: dict | None = None, instrument: bool = False) -> None:
        from raytracer_tpu_torch import PathTracer

        self.spec, _, cfg, cellf = spec_of(cell, spec)
        over = overrides or {}
        self.cfg = _merge(cfg, over.get("config", {}))
        self.cell = _merge(cellf, over.get("cell", {}))
        self.device = torch.device(device)
        self.instrument = instrument
        self.tris = scenes.make_scene(self.cfg["scene"])
        b = self.cfg["build"]
        self.pt = PathTracer(self.cfg["width"], self.cfg["height"], b["widener"], b["builder"],
                             b["leaf_size"], device=self.device)
        self.pt.fov_degrees = float(self.cfg["fov_degrees"])
        t0 = time.perf_counter()
        self.pt.build_bvh(self.tris)
        sync(self.device)
        self.build_s = time.perf_counter() - t0
        self.kind = load_module(HERE / "traffic" / f"{self.cell['kind']}.py",
                                f"traffic_{self.cell['kind']}")

    def trial(self, seed: int) -> "Trial":
        return Trial(self, seed)


@dataclass
class Window:
    frame_s: list = field(default_factory=list)
    issue_s: list = field(default_factory=list)
    seconds: float = 0.0   # the window's wall, less the traffic's prepare time
    prepare_s: float = 0.0

    @property
    def frames(self) -> int:
        return len(self.frame_s)


class Trial:
    """One seed's traffic on a session: warm-up, window, trace, checks."""

    def __init__(self, session: Session, seed: int) -> None:
        self.session = session
        self.seed = int(seed)
        self.rng = np.random.default_rng(self.seed % 2**64)
        self.pt = session.pt
        self.device = session.device
        self.cfg, self.cell = session.cfg, session.cell
        self.instrument = session.instrument
        self.spans: dict[str, list] = {}
        self.check_frames: set[int] = set()
        self.traffic = session.kind.Traffic(self)
        self.window = Window()
        self.trace = None
        self.work = None
        self.failed = 0
        self.next_frame = 0
        self.traced = range(0)

    def span(self, name: str, value: float) -> None:
        self.spans.setdefault(name, []).append(value)

    def _frame(self, i: int, keep: bool) -> tuple[float, float, float]:
        """Frame i → (prepare, issue, frame) seconds."""
        p0 = time.perf_counter()
        self.traffic.prepare(i)
        f0 = time.perf_counter()
        handle = self.traffic.frame(i)
        f1 = time.perf_counter()
        self.traffic.wait(handle)
        f2 = time.perf_counter()
        if keep:
            if not self.traffic.well_formed(handle):
                self.failed += 1
            self.traffic.keep(i, handle)
        return f0 - p0, f1 - f0, f2 - f0

    def warmup(self, seconds: float) -> float:
        """The cell's warm-up frames (negative indices) → mean seconds a frame
        of their second half, with its input's preparation. Then the frames
        to check are drawn from the seed: the first of the window, and others
        from its first half at the warm-up's pace."""
        n = int(self.cell["warmup_frames"])
        times = [sum(self._frame(i, False)[::2]) for i in range(-n, 0)]
        frame_s = float(np.mean(times[n // 2:]))
        half = max(2, int(seconds / frame_s) // 2)
        picks = self.rng.choice(np.arange(1, half), size=min(half - 1,
                                self.cell["check"]["frames"] - 1), replace=False)
        self.check_frames = {0, *map(int, picks)}
        self.traffic.start()
        return frame_s

    def run_window(self, seconds: float) -> Window:
        w = self.window
        w0 = time.perf_counter()
        i = 0
        while True:
            prepare, issue, frame = self._frame(i, True)
            w.prepare_s += prepare
            w.issue_s.append(issue)
            w.frame_s.append(frame)
            i += 1
            if time.perf_counter() - w0 >= seconds:
                break
        w.seconds = time.perf_counter() - w0 - w.prepare_s
        self.next_frame = i
        ends = np.cumsum(w.frame_s)
        slices = np.bincount(np.minimum(ends.astype(int), int(w.seconds)))
        q = np.percentile(w.frame_s, [5, 50, 95]) * 1e3
        log(f"[window] {w.frames} frames in {w.seconds:.4f} s (+ prepare {w.prepare_s:.4f} s); frame ms p5 {q[0]:.4f} p50 "
            f"{q[1]:.4f} p95 {q[2]:.4f}; frames in each second {slices.tolist()}")
        return w

    def run_traced(self) -> None:
        """A stretch of frames under the profiler, then the work counts. Its
        wall leaves out the traffic's prepare time, as the window's does."""
        from torch.profiler import ProfilerActivity, profile, record_function

        per = self.window.seconds / max(self.window.frames, 1)
        n = int(np.clip(round(_TRACE_SECONDS / per), *_TRACE_FRAMES))
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if self.device.type == "cuda" else [])
        self.traced = range(self.next_frame, self.next_frame + n)
        prepare = 0.0
        with profile(activities=acts) as prof:
            p0 = time.perf_counter()
            for i in self.traced:
                q0 = time.perf_counter()
                with record_function(devtrace.SPAN_PREFIX + "prepare"):
                    self.traffic.prepare(i)
                prepare += time.perf_counter() - q0
                with record_function(devtrace.SPAN_PREFIX + "frame"):
                    self.traffic.wait(self.traffic.frame(i))
            wall = time.perf_counter() - p0 - prepare
        self.trace = devtrace.from_profiler(prof, n, wall)
        self.traffic.collect()
        self.work = self.traffic.work()

    def release(self) -> None:
        """Drop the program's state; the kept outputs stay."""
        self.traffic.release()
        self.pt = None
        self.session.pt = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def checks(self, control: bool = False) -> dict:
        """The numbers compared: the kept outputs against the reference; with
        ``control``, the reference in bfloat16 put in the program's place."""
        from reference.intersect import Triangles

        tris = torch.from_numpy(self.session.tris).to(self.device)
        ref = Triangles(tris)
        ctl = Triangles(tris, _CONTROL_DTYPE) if control else None
        return self.traffic.checks(ref, ctl)


def run_once(cell: str, seed: int, seconds: float, trace: bool, device, *, t0: float,
             spec: dict | None = None, overrides: dict | None = None,
             control: bool = False) -> dict:
    """One run of ``cell`` → the result line's object."""
    torch.set_num_threads(1)
    session = Session(cell, device, spec=spec, overrides=overrides, instrument=trace)
    log(f"[bench] {cell}: {len(session.tris)} triangles, build {session.build_s:.4f} s on "
        f"{session.device}")
    trial = session.trial(seed)
    trial.warmup(seconds)
    setup_s = time.perf_counter() - t0
    window = trial.run_window(seconds)
    dev = session.device
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1,
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))
                   if dev.type == "cuda" else 0}
    t_after = time.perf_counter()
    if trace:
        trial.run_traced()
        device_info["busy_s"] = devtrace.busy_us(trial.trace.device) / 1e6
        device_info["window_s"] = trial.trace.wall_s
    device_info["power_limit"] = _power_limit() if dev.type == "cuda" else "not read"
    trial.release()
    t_check = time.perf_counter()
    numbers = trial.checks(control)
    log(f"[bench] after the window: trace and work count {t_check - t_after:.2f} s, "
        f"check {time.perf_counter() - t_check:.2f} s")
    limits = session.cell["check"]["limits"]
    checked = numbers.pop("frames_checked")
    correct = (checked > 0 and trial.failed == 0
               and all(numbers[k] <= limits[k] for k in limits))

    run = _Readings(setup_s, session.build_s, window, trial, _peaks(device_info["kind"]))
    metrics = {}
    for m in metrics_for(session.spec, cell, trace):
        value = reader_of(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": window.frames, "failed": trial.failed,
           "metrics": metrics, "device": device_info}
    if trace:
        out["breakdown"] = devtrace.breakdown(trial.trace)
    out["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    for name, value in metrics.items():
        log(f"[bench] {name} {value['value']} {value['unit']} ({device_info['power_limit']})")
    log(f"[check] frames checked {checked}, malformed window frames {trial.failed}")
    for k in limits:
        log(f"[check] {k} {numbers[k]} limit {limits[k]}")
    return out


@dataclass
class _Readings:
    """What the metric readers read."""
    setup_s: float
    build_s: float
    window: Window
    trial: Trial
    peaks: dict | None

    @property
    def trace(self):
        return self.trial.trace

    @property
    def work(self):
        return self.trial.work

    @property
    def spans(self):
        return self.trial.spans

    @property
    def rays_per_frame(self) -> int:
        return self.trial.traffic.rays_per_frame
