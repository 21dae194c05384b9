"""Small helpers shared by the harness, the traffic kinds and the metric readers."""

from __future__ import annotations

import importlib.util
import json
import statistics
import sys
from pathlib import Path

import torch

__all__ = ["HERE", "REPO", "load_json", "load_module", "reader_of", "sync", "percentile",
           "roofline_share"]

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The Python file ``path`` as module ``name`` (files named with dots too)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def reader_of(name: str):
    """The ``read`` of metric ``name``: ``metrics/<name>.py``, or where there
    is no such file the reader of the name before its first dot, so that a
    family's metric (``mrays_per_s.hostbound``) reads as its base does."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        name = name.split(".", 1)[0]
        path = HERE / "metrics" / f"{name}.py"
    return load_module(path, f"metric_{name}").read


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def percentile(values, q: float) -> float:
    """The q-th percentile (0 < q < 100), interpolated between order statistics."""
    if len(values) == 1:
        return float(values[0])
    return float(statistics.quantiles(values, n=100, method="inclusive")[int(q) - 1])


def roofline_share(run, layer: str) -> float | None:
    """100 × the least time of ``layer``'s kernels a frame (the larger of
    their f32 operations over the peak rate and their bytes over the peak
    bandwidth) ÷ their traced device time a frame; None without a trace, a
    work count or the card's peaks."""
    from devtrace import layer_ms_per_frame

    work = (run.work or {}).get(layer)
    if run.trace is None or not work or not run.peaks:
        return None
    ms = layer_ms_per_frame(run.trace, layer)
    if not ms:
        return None
    bound_s = max(work["flops"] / run.peaks["f32_flops_per_s"],
                  work["bytes"] / run.peaks["hbm_bytes_per_s"])
    return 100.0 * bound_s * 1e3 / ms

