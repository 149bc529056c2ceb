"""Sampling and training rates of several trees of this repo on one card,
in one process each: ``chip_smoke.py``'s phases 4 (zeus through
``fused_log_prob``), 5 (training, then zeus on the trained K=4 ensemble)
and 6 (NUTS, HMC and emcee through ``fused_log_prob``), each tree running
its own code.

    python3 compare_sampling.py [--out DIR] TREE [TREE ...]

runs the trees in the order given (give each twice, as A B B A, to see
the drift of the card between runs) and prints one JSON line a run and a
last line with the card's name and power limit and every run's rates.
The rates are seconds per 100 steps (samples for NUTS and HMC):

- ``*_wall``: ``run_ensemble``'s wall as the phase times it (phase 4 and
  5: the whole call, so a graph capture is inside it);
- ``*_loop``: the sampling loop alone, from ``run_ensemble``'s
  ``trace_rec``: ``loop`` where the tree records it (the capture apart),
  else the sum of the loop's parts (``device_wait`` + ``host`` +
  ``tau_checks``), as a tree without graphs or double-buffering times it.

Training (phase 5, K=4 f32 on 10,000 / 500 rows): ``train_ms_per_epoch``,
the ms an epoch of ``train_emulator``'s chunks (its dispatch and fetch
seconds over its epochs), and ``train_chunk_ms_per_epoch`` /
``train_chunk_busy_share``, a 10-epoch chunk timed between synchronizes
and the device's busy share of a traced one.

Needs a CUDA device; writes each run's log and ``compare_sampling.json``
under ``DIR`` (default ``.compare_sampling/`` in the repo).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# the child: phases 4, 5 and 6 of the chip_smoke.py in its working directory
CHILD = r"""
import json, os, shutil, sys, time
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as C
from linna_tpu_torch.ops import fused as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
dev = torch.device("cuda:0")
F.build()


def loop(s):
    return s["loop"] if "loop" in s else s["device_wait"] + s["host"] + s["tau_checks"]


out = {}
shutil.rmtree(C.RUN_DIR, ignore_errors=True)
t0 = time.perf_counter()
r4 = C.phase_slice(dev, os.path.join(C.RUN_DIR, "iter_0"))
steps = r4["trace"]["steps_run"]
out["zeus_wall"] = r4["s_per_100_steps"]
out["zeus_loop"] = loop(r4["trace"]["sampler"]) / steps * 100
out["zeus_capture_s"] = r4["trace"]["sampler"].get("capture", 0.0)
shutil.rmtree(C.RUN_DIR, ignore_errors=True)
r5 = C.phase_train(dev, C.RUN_DIR)
out["train_ms_per_epoch"] = r5["ms_per_epoch_in_train_emulator"]
out["train_chunk_ms_per_epoch"] = r5["chunk"]["ms_per_epoch"]
out["train_chunk_busy_share"] = r5["chunk"]["device_busy_share"]
out["k4_zeus_wall"] = r5["ensemble_sample_s"] / r5["ensemble_steps"] * 100
if "ensemble_trace" in r5:
    out["k4_zeus_loop"] = loop(r5["ensemble_trace"]["sampler"]) / r5["ensemble_steps"] * 100
    out["k4_zeus_capture_s"] = r5["ensemble_trace"]["sampler"]["capture"]
shutil.rmtree(C.RUN_DIR, ignore_errors=True)
r6, _ = C.phase_gradient(dev, C.RUN_DIR)
for m in ("nuts", "hmc", "emcee"):
    s, n = r6[m]["sampler_s"], r6[m]["steps"]
    out[m + "_loop"] = loop(s) / n * 100
    out[m + "_capture_s"] = s.get("capture", 0.0)
    out[m + "_launches_per_step"] = r6[m]["launches_per_step"]
shutil.rmtree(C.RUN_DIR, ignore_errors=True)
out["seconds"] = time.perf_counter() - t0
print("RESULT " + json.dumps(out), flush=True)
"""


def main() -> int:
    args = sys.argv[1:]
    logdir = os.path.join(ROOT, ".compare_sampling")
    if args[:1] == ["--out"]:
        logdir, args = os.path.abspath(args[1]), args[2:]
    trees = [os.path.abspath(t) for t in args]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("compare_sampling: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    os.makedirs(logdir, exist_ok=True)
    runs = []
    for i, tree in enumerate(trees):
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-c", CHILD], cwd=tree, capture_output=True,
                           text=True, timeout=1800, env=dict(os.environ, PYTHONPATH=tree))
        with open(os.path.join(logdir, f"compare_sampling_{i}.log"), "w") as f:
            f.write(p.stdout + p.stderr)
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith("RESULT ")]
        if p.returncode != 0 or not lines:
            print(p.stdout[-3000:] + p.stderr[-3000:], file=sys.stderr)
            print(f"compare_sampling: {tree} exited with {p.returncode}", file=sys.stderr)
            return 1
        run = {"tree": os.path.relpath(tree, ROOT), "process_s": time.perf_counter() - t0,
               **json.loads(lines[-1][len("RESULT "):])}
        print(json.dumps(run), flush=True)
        runs.append(run)
    result = {"card": smi, "torch": torch.__version__, "runs": runs}
    with open(os.path.join(logdir, "compare_sampling.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(f"card: {smi}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
