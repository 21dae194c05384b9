"""The readings a cell's check limits are set from: one set-up, then for
each seed a warm-up, a short window at the cell's own load and the
comparison, the program's seeds and then the control's (the reference in
bfloat16 in the program's place). One JSON line a seed.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--seconds 3]

Not run by the benchmark's own runs; it runs on the card only.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    import torch

    import harness

    if not torch.cuda.is_available():
        print("[readings] no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    session = harness.Session(args.workload, torch.device("cuda", 0))
    print(f"[readings] set-up {time.perf_counter() - T0:.2f} s", file=sys.stderr)
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for seed in seeds:
            trial = session.trial(seed)
            trial.warmup(args.seconds)
            window = trial.run_window(args.seconds)
            numbers = trial.checks(control)
            print(json.dumps({"workload": args.workload, "seed": seed, "control": control,
                              "frames": window.frames, "seconds": window.seconds,
                              "failed": trial.failed, **numbers}), flush=True)
            trial.traffic.release()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
