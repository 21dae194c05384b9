"""Profiling / metrics utilities, the counterparts of
``raytracer_tpu/utils/profiling.py``:

* :func:`sync` — wait for the card: ``torch.cuda.synchronize`` on the
  device of each CUDA tensor given (a CPU tensor is complete when an op
  returns it).
* :class:`PhaseTimer` — named wall-clock phases, each ending in a
  :func:`sync` of the tensors it names.
* :class:`FrameStats` — rolling FPS/Mrays/s with a 1 Hz report line and a
  JSON-appendable record, and the run's total (:meth:`FrameStats.summary`).
* :func:`trace_annotated` — a ``torch.profiler`` trace of the block, written
  as a Chrome trace, when a profile directory is given (a no-op otherwise).
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path

import torch

__all__ = ["PhaseTimer", "FrameStats", "trace_annotated", "sync"]


def sync(*tensors) -> None:
    """Block until the work that produces ``tensors`` is done on every CUDA
    device they live on."""
    for dev in {t.device for t in tensors
                if isinstance(t, torch.Tensor) and t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


class PhaseTimer:
    """Named wall-clock phases, printed like the reference's build report
    (PathTracer.js:745-748) and exportable as a dict."""

    def __init__(self) -> None:
        self.phases: dict[str, float] = {}
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def phase(self, name: str, *sync_tensors):
        t0 = time.perf_counter()
        yield
        sync(*sync_tensors)
        self.phases[name] = (time.perf_counter() - t0) * 1e3

    def total_ms(self) -> float:
        """Wall time since construction — the build's end-to-end total."""
        return (time.perf_counter() - self._t0) * 1e3

    def report(self, prefix: str = "") -> None:
        for name, ms in self.phases.items():
            print(f"{prefix}{name}: {ms:.2f} ms")
        print(f"{prefix}total: {self.total_ms():.2f} ms")

    def to_dict(self) -> dict:
        return dict(self.phases)


class FrameStats:
    """Rolling frame statistics with a 1 Hz console report."""

    def __init__(self, width: int, height: int, report_every: float = 1.0) -> None:
        self.rays_per_frame = width * height
        self.report_every = report_every
        self._start = self._last = time.perf_counter()
        self._frames = 0
        self.frames = 0  # every tick since construction
        self.history: list[dict] = []

    def tick(self, quiet: bool = False) -> dict | None:
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
        self.history.append(rec)
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

    def dump_json(self, path) -> None:
        Path(path).write_text(json.dumps(self.history))


@contextlib.contextmanager
def trace_annotated(profile_dir: str | Path | None = None):
    """``torch.profiler`` over the block (host, and the card where there is
    one), written to ``profile_dir/trace.json`` as a Chrome trace, when a
    directory is given; else a no-op."""
    if profile_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))
