"""Run one cell of the benchmark of ``raytracer_tpu_torch`` once, on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell named in ``BENCHMARK.json``, warms it up, measures for
``--seconds`` seconds, compares the window's outputs with the plain reference
and prints one JSON object as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` (with ``--trace 1`` also
``busy_s`` and ``window_s``), with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared beside its limit. Exits non-zero without a
result where there is no CUDA card, too few for the cell, or where JAX or the
JAX package was loaded. ``--control 1`` puts the reference, computed in
bfloat16, in the program's place for the comparison (the check's control).

Build and kernel caches stay inside the checkout: the program builds its
libraries into ``raytracer_tpu_torch/_build/``, and ``TORCH_EXTENSIONS_DIR``
and ``TRITON_CACHE_DIR`` point under ``.bench_cache/``.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "raytracer_tpu")


def loaded_forbidden() -> list[str]:
    """Modules whose top-level name (before the first dot) is JAX's or the
    JAX package's."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seconds <= 0:
        ap.error("--seconds must be > 0")

    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(REPO / ".bench_cache" / sub)
    sys.path[:0] = [str(HERE), str(REPO)]
    import torch

    import harness

    _, entry, _, _ = harness.spec_of(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(entry["chips"]):
        print(f"[bench] {args.workload} needs {entry['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found: "
              "no result", file=sys.stderr)
        return 2
    out = harness.run_once(args.workload, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), t0=T0, control=bool(args.control))
    found = loaded_forbidden()
    if found:
        print(f"[bench] JAX or the JAX package was loaded: {found}: no result", file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
