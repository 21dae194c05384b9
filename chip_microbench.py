"""Time the microbenchmark kernels MB1–MB4 on one CUDA card.

Run from the repository root, with one card:

    python3 chip_microbench.py [--out results.json]

Each kernel runs one warp for n iterations of a primitive
(raytracer_tpu_torch/csrc/microbench.cu); the cost of one iteration is
(t(n_hi) − t(n_lo)) / (n_hi − n_lo), with t the best of 3 CUDA-event times,
and its cycles the same difference of the kernel's own clock64() counts.
Before the timings each kernel's checksum at n_lo is held against its plain
version (exactly). Printed, each beside the card's name and power limit:

* MB1 mb_walk: ns and cycles per iteration of the row walks (dependent 512 B,
  2 KB, 8 KB; 2 and 4 independent chains; 2 KB with the vector rounds;
  cp.async-pipelined 512 B and 2 KB) over tables that sit in L1 (64 KB), in
  L2 (8 MiB, the TPU scripts' 16,384 rows) and in device memory (1 GiB,
  with the L2 cache flushed before each timed launch);
* MB2 mb_scalar: the empty loop (the floor), 24 shared-memory or L1 reads,
  a word to 32 lanes by shuffle, shared or global broadcast, the k_reduce
  reduction;
* MB3 mb_visit: one traversal visit and each of its parts (slab tests,
  Möller–Trumbore, child sort, stack push / pop) at 4 and 8 slots, the
  record in registers or shared memory;
* MB4 mb_smem_probe: the largest dynamic shared memory one block can take,
  and how many 4-wide and 8-wide K = 32 records fit in it.

``--out`` also writes every result as JSON.
Exits non-zero without a card, or when a checksum disagrees.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def run(card: str) -> dict:
    from raytracer_tpu_torch.ops.cuda import microbench as mb

    dev = torch.device("cuda:0")
    results: dict = {"card": card, "walk": {}, "scalar": {}, "visit": {}}
    n_lo = 1_000
    n_hi = {"mb_walk": 100_000, "mb_scalar": 200_000, "mb_visit": 200_000}
    # written before each timed launch of the device-memory walk: 256 MiB,
    # five times the L2 cache, so that no row of the table stays in L2
    l2_flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    for v in mb.sweep(dev):
        v.prepare()
        got, ref = v.run(n_lo), v.plain(n_lo)
        if got != ref:
            raise SystemExit(f"chip_microbench FAILED: {v.kernel} {v.label}: kernel {got}, "
                             f"plain {ref}")
        flush = l2_flush if v.params.get("level") == "HBM" else None
        cost = mb.per_iteration(v.launch, n_hi[v.kernel], n_lo, flush=flush)
        results[v.kernel.removeprefix("mb_")][v.label] = vars(cost)
        what = f"[{v.kernel}] {v.label}"
        if v.kernel == "mb_walk":
            what += f" ({v.params['rows']} rows of 512 B)"
            if v.params["chains"] > 1:
                what += f" = {cost.ns / v.params['chains']:.2f} ns a chain"
        print(f"{what}: {cost.ns:9.3f} ns/iter {cost.cycles:9.2f} cycles/iter on {card}",
              flush=True)
    del l2_flush

    x = torch.arange(64 * 1024, dtype=torch.float32, device=dev)
    cap = mb.smem_capacity(x)
    if not cap["checked"]:
        raise SystemExit("chip_microbench FAILED: mb_smem_probe differs from its plain version")
    results["smem"] = cap
    print(f"[mb_smem_probe] largest dynamic shared memory of one block: {cap['max_bytes']} bytes "
          f"({cap['max_bytes'] / 1024:.1f} KiB) = {cap['records_4wide_k32']} 4-wide or "
          f"{cap['records_8wide_k32']} 8-wide K = 32 records on {card}", flush=True)
    return results


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="write the results as JSON to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_microbench FAILED: torch.cuda.is_available() is false: "
                         "the microbenchmarks need a CUDA card")
    card = card_line()
    print(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda} | python "
          f"{sys.version.split()[0]}", flush=True)
    from raytracer_tpu_torch.ops.cuda.microbench import load_microbench

    t0 = time.perf_counter()
    _, log = load_microbench()
    print(f"[build] microbench.cu ready in {time.perf_counter() - t0:.2f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "stack frame" in line or "Compiling entry" in line:
            print(f"[build] {line.strip()}", flush=True)
    results = run(card)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(results, indent=1))
        print(f"[done] {out}", flush=True)


if __name__ == "__main__":
    main()
