"""The reps of one configuration of ``bench_suite_torch.py`` in one process,
in order, to find where its host ms a frame spreads.

Builds config 2, 4 or 5 once, warms its stream up, then runs ``--reps``
rounds; each round times one stream of ``--batch`` frames under each
variant, interleaved, so that a drift over the process's life shows in
every variant alike:

* ``default``: the suite's own stream (``sample_frames`` /
  ``config5_frames``);
* ``nogc``: the same with Python's garbage collector off during the
  stream;
* ``pinned``: the same with the issuing thread pinned to one CPU;
* ``one_generator`` (configs 2 and 4): one ``torch.Generator`` re-seeded
  for each sample instead of a new one a sample.

Each stream's row holds its host ms a frame, its CUDA-event ms a frame, the
issuing thread's CPU ms a frame (``time.thread_time``: the host's own work;
wall above it is time the thread did not run or waited), the garbage
collections that ran during it, the machine's steal time during it (ms of
all CPUs that the hypervisor gave to others, from ``/proc/stat``), the mean
``cpu MHz`` of ``/proc/cpuinfo`` after it, and the allocator's reserved
bytes after it. A last stream runs under ``cProfile``; its 25 costliest
functions by own time go to stderr and to ``--profile-out``. One JSON line
on stdout holds the rows and the load average of the host before and
after.

Usage, from the repository root, on a card:

    python3 tools_torch/suite_reps.py --config 4 [--reps 8] [--batch 32]
                                      [--profile-out FILE]
"""

from __future__ import annotations

import argparse
import cProfile
import gc
import io
import itertools
import json
import os
import pstats
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import bench_suite_torch as suite  # noqa: E402
from bench_torch import resolve_device, to_host  # noqa: E402


def one_generator_frames(rec, pos, size: int, frames: int, spp: int, bounces: int):
    """``suite.sample_frames`` with one generator re-seeded for each sample."""
    dev = rec.tris.device
    calls = itertools.count()
    gen = torch.Generator(device=dev)

    def render_n():
        base = next(calls) * frames * spp
        total = torch.zeros((), dtype=torch.float32, device=dev)
        alive = torch.zeros((), dtype=torch.int64, device=dev)
        for s in range(base, base + frames * spp):
            img, st = suite.config_sample(rec, pos, size, bounces, generator=gen.manual_seed(s))
            total = total + img.sum()
            alive = alive + st["alive_rays"]
        return total, alive

    return render_n


def streams(config: int, batch: int, dev: torch.device) -> dict:
    """The variants' ``render_n`` of one configuration, built once."""
    if config == 5:
        dyn = suite.config5_build(dev)
        run = suite.config5_frames(dyn, suite.C5_SIZE, batch)
        return {"default": run, "nogc": run, "pinned": run}
    records, pos, size, spp, bounces = {
        2: (suite.config2_records, suite.C2_POS, suite.C2_SIZE, suite.C2_SPP, suite.C2_BOUNCES),
        4: (suite.config4_records, suite.C4_POS, suite.C4_SIZE, 1, suite.C4_BOUNCES)}[config]
    rec = records(dev)
    run = suite.sample_frames(rec, pos, size, batch, spp, bounces)
    return {"default": run, "nogc": run, "pinned": run,
            "one_generator": one_generator_frames(rec, pos, size, batch, spp, bounces)}


def steal_ms() -> float:
    """The steal time of all CPUs since boot, in ms (``/proc/stat``)."""
    fields = Path("/proc/stat").read_text().split("\n", 1)[0].split()
    return int(fields[8]) * 1e3 / os.sysconf("SC_CLK_TCK")


def cpu_mhz() -> float | None:
    """The mean ``cpu MHz`` that ``/proc/cpuinfo`` reports, or None."""
    mhz = [float(line.split(":")[1]) for line in Path("/proc/cpuinfo").read_text().splitlines()
           if line.startswith("cpu MHz")]
    return sum(mhz) / len(mhz) if mhz else None


def timed(run, variant: str, frames: int, dev: torch.device) -> dict:
    """One stream of ``run`` under ``variant`` → its row."""
    affinity = os.sched_getaffinity(0)
    if variant == "pinned":
        os.sched_setaffinity(0, {min(affinity)})
    if variant == "nogc":
        gc.collect()
        gc.disable()
    collections = [s["collections"] for s in gc.get_stats()]
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize(dev)
    start.record()
    s0 = steal_ms()
    t0, c0 = time.perf_counter(), time.thread_time()
    res = run()
    end.record()
    to_host(res)
    wall, cpu = time.perf_counter() - t0, time.thread_time() - c0
    steal = steal_ms() - s0
    gc.enable()
    os.sched_setaffinity(0, affinity)
    return {"variant": variant, "host_ms": wall / frames * 1e3,
            "device_ms": start.elapsed_time(end) / frames,
            "thread_cpu_ms": cpu / frames * 1e3,
            "gc_collections": [s["collections"] - c for s, c in zip(gc.get_stats(), collections)],
            "steal_ms": steal, "cpu_mhz": cpu_mhz(),
            "reserved_bytes": torch.cuda.memory_reserved(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", type=int, default=4, choices=[2, 4, 5])
    ap.add_argument("--reps", type=int, default=8, help="rounds of every variant")
    ap.add_argument("--batch", type=int, default=32, help="frames a stream")
    ap.add_argument("--profile-out", default=None, help="file for the cProfile table")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    load0 = os.getloadavg()
    runs = streams(args.config, args.batch, dev)
    for run in set(runs.values()):
        to_host(run())  # warm-up: kernel builds, caches
    rows = []
    for r in range(args.reps):
        for variant, run in runs.items():
            rows.append({"round": r, **timed(run, variant, args.batch, dev)})
            print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
    prof = cProfile.Profile()
    prof.enable()
    to_host(runs["default"]())
    prof.disable()
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(25)
    sys.stderr.write(text.getvalue())
    if args.profile_out:
        Path(args.profile_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.profile_out).write_text(text.getvalue())
    print(json.dumps({"config": args.config, "batch": args.batch, "cpus": len(
        os.sched_getaffinity(0)), "torch_threads": torch.get_num_threads(),
        "loadavg_before": load0, "loadavg_after": os.getloadavg(), "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
