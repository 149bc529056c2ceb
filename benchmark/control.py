"""The readings that set a cell's limits: the program's over many seeds and
the control's, read in one process (set-up once a seed, no card check):

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 [--seconds S] [--out FILE] [--cpu]

For each seed it runs the cell as a run does, with a window of ``--seconds``
(training cells compare set-up's training call, before the window), and computes
the control beside the program: the reference in the next lower precision
than the configuration states (training: float8 products for bfloat16;
sampling: TF32 for float32), judged by the same numbers, and for training
the reference playing each fault.  Prints one JSON line a seed and writes
them all to ``--out``.  The readings set limits, so it runs on the card and
exits non-zero without one, unless ``--cpu`` asks for the CPU.  The
benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--out")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (readings that set "
                   "no limit)")
    args = p.parse_args(argv)

    from . import run

    run.set_caches()
    import torch

    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda:0")
    else:
        print("benchmark.control: no CUDA device; --cpu runs on the CPU", file=sys.stderr)
        return 2
    rows = []
    for seed in (int(s) for s in args.seeds.split(",") if s):
        res = run.execute(args.workload, seed, args.seconds, False, device, controls=True,
                          t_start=time.perf_counter())
        out = res["out"]
        row = {"workload": args.workload, "seed": seed, "program": out["readings"],
               "control": out["control"], "correct": res["line"]["correct"],
               "metrics": res["line"]["metrics"], "reference_s": out["reference_s"],
               "device": res["line"]["device"]}
        print(json.dumps(row, default=float), flush=True)
        rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1, default=float)
    return 0


if __name__ == "__main__":
    sys.exit(main())
