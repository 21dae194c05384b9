"""The benchmark's own tests: on the CPU at toy sizes, with the program's plain
versions. Tests that need a card are marked ``cuda`` and decide in a fixture.

Run from the repository root: ``python -m pytest benchmark/tests -q``; on a
machine with a card, ``python -m pytest benchmark/tests -q -m cuda`` runs
the card test alone.
"""

import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
for p in (str(BENCH), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

DRAGON_TOY = {"scene": {"args": {"nu": 16, "nv": 16}}, "width": 64, "height": 40}
BUNNY_TOY = {"scene": {"args": {"subdivisions": 2}}, "width": 64, "height": 64}
CELL_TOY = {"warmup_frames": 2, "check": {"pixels": 256, "frames": 3}}


def toy_overrides(cell: str, **cell_over) -> dict:
    """The cell at a size a CPU test holds: the same kinds, builds and checks."""
    return {"config": BUNNY_TOY if cell.startswith("bunny") else DRAGON_TOY,
            "cell": {**CELL_TOY, **cell_over}}


def run_toy(cell: str, *, seed: int = 2147483713, seconds: float = 1.0, trace: bool = False,
            control: bool = False, device: str = "cpu", **cell_over) -> dict:
    import harness

    return harness.run_once(cell, seed, seconds, trace, device, t0=time.perf_counter(),
                            overrides=toy_overrides(cell, **cell_over), control=control)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
