"""The benchmark's own tests: on the CPU at toy sizes, with the program's plain
versions. Tests that need a card are marked ``cuda`` and decide in a fixture.

Run from the repository root: ``python -m pytest benchmark/tests -q``; on a
machine with a card, ``python -m pytest benchmark/tests -q -m cuda`` runs
the card test alone.
"""

import json
import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
for p in (str(BENCH), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

TOYS = BENCH / "tests" / "toys"
CELL_TOY = {"warmup_frames": 2, "check": {"pixels": 256, "frames": 3}}


def toy_overrides(cell: str, *, spec: dict | None = None, **cell_over) -> dict:
    """The cell at a size a CPU test holds: the same kinds, builds and checks.
    The configuration's toy size is ``tests/toys/<config>.json``."""
    import harness

    _, entry, _, _ = harness.spec_of(cell, spec)
    path = TOYS / f"{entry['config']}.json"
    if not path.is_file():
        raise FileNotFoundError(f"configuration {entry['config']!r} has no CPU toy size: "
                                f"add {path}")
    return {"config": json.loads(path.read_text()), "cell": {**CELL_TOY, **cell_over}}


def run_toy(cell: str, *, seed: int = 2147483713, seconds: float = 1.0, trace: bool = False,
            control: bool = False, device: str = "cpu", spec: dict | None = None,
            **cell_over) -> dict:
    import harness

    return harness.run_once(cell, seed, seconds, trace, device, t0=time.perf_counter(),
                            spec=spec, overrides=toy_overrides(cell, spec=spec, **cell_over),
                            control=control)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
