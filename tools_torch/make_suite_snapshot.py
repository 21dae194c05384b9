"""Collect a suite snapshot of the PyTorch / CUDA port: one fresh process
per BASELINE configuration of ``bench_suite_torch.py``.

The counterpart of ``tools/make_suite_snapshot.py``. Each configuration runs
in its own interpreter (no state shared between them: each line is what a
user measures from a fresh script, with the kernels already built by an
earlier process into the package's build directory). Configs 1, 2, 4 and
5 run in three fresh processes each and the line with the median value is
kept, with the three values in its ``detail`` and ``unresolved`` set where
they spread more than 10% (largest over smallest): the host-bound configs'
host ms move between processes with the host's speed on the same issue
work, so one process's value cannot tell two commits apart there. Config 3
(the dragon, device-bound) runs once. The lines are printed as they come
and written to the path given, one JSON object a line.

Usage, from anywhere (the suite runs from the repository root):

    python3 tools_torch/make_suite_snapshot.py SUITE_torch_r01.json [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FRESH_PROCESSES = {1: 3, 2: 3, 3: 1, 4: 3, 5: 3}
MAX_SPREAD = 1.1  # largest over smallest fresh-process value of a resolved line


def run_config(n: int, device: str) -> dict:
    """The JSON line of ``bench_suite_torch.py --config n`` run in a fresh
    interpreter; raises if the run fails or prints no line."""
    r = subprocess.run([sys.executable, str(ROOT / "bench_suite_torch.py"), "--config", str(n),
                        "--device", device], capture_output=True, text=True, cwd=ROOT)
    sys.stderr.write(r.stderr[-4000:])
    lines = [line for line in r.stdout.splitlines() if line.startswith("{")]
    if r.returncode != 0 or not lines:
        raise RuntimeError(f"config {n} exited {r.returncode} with {len(lines)} JSON lines")
    return json.loads(lines[-1])


def median_record(records: list[dict]) -> dict:
    """The record of median value among an odd number of them, with every
    value, in order, as ``detail["fresh_process_values"]`` and
    ``detail["unresolved"]`` true where they spread more than MAX_SPREAD."""
    ranked = sorted(records, key=lambda r: r["value"])
    med = ranked[len(ranked) // 2]
    values = [r["value"] for r in ranked]
    med["detail"]["fresh_process_values"] = values
    med["detail"]["unresolved"] = values[-1] > MAX_SPREAD * values[0]
    return med


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", help="the snapshot file to write")
    ap.add_argument("--device", default="cuda", help="passed to bench_suite_torch.py")
    args = ap.parse_args(argv)
    records = []
    for n, fresh in FRESH_PROCESSES.items():
        records.append(median_record([run_config(n, args.device) for _ in range(fresh)]))
        print(json.dumps(records[-1]), flush=True)
    Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in records))
    print(f"wrote {args.out} ({len(records)} configs)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
