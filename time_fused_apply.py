#!/usr/bin/env python3
"""Time the ``fused_apply`` kernel of the linna_tpu_torch package under
``--root`` on one CUDA card, beside its plain version and its bounds; one
JSON line.

    python3 time_fused_apply.py [--root DIR] [--rows 128 256 4096]

``--root`` (default: this checkout) is a tree holding ``linna_tpu_torch/``,
for example another commit unpacked with ``git archive`` into a directory
that ``.gitignore`` lists.  Each process times one tree, so two trees are
compared on one card by alternating processes in one command: other, this,
this, other.  The kernel is first checked against its plain version at the
DES width (27 -> 457, hidden 1000) at every timed row count.  Timing and
checks are ``chip_smoke.py``'s: device events counted by torch.profiler,
rtol = atol = 2e-4.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

import chip_smoke as C  # imports the package lazily, from --root


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--rows", type=int, nargs="+", default=[128, 256, 4096])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_fused_apply: no CUDA device is available", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from linna_tpu_torch.ops import fused as F

    if not F.__file__.startswith(root + os.sep):
        raise AssertionError(f"imported {F.__file__}, not the package under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    device = torch.device("cuda:0")
    resources = C.kernel_resources(F.build()).get("fused_apply", {})
    spec, params, *_ = C.make_problem(device)
    gen = torch.Generator(device="cpu").manual_seed(7)
    res = {"root": root, "card": smi, **resources, "rows": {}}
    with torch.no_grad():
        for b in args.rows:
            x = torch.randn((b, C.NDIM), generator=gen).to(device)
            err = C.compare(F.fused_apply(spec, params, x), F.fused_apply_plain(spec, params, x),
                            f"fused_apply B={b}")
            ms, method = C.device_ms(lambda: F.fused_apply(spec, params, x),
                                     C.KERNEL_NAMES["fused_apply"])
            plain_ms, plain_method = C.device_ms(lambda: F.fused_apply_plain(spec, params, x))
            res["rows"][b] = {
                "ms": ms, "plain_ms": plain_ms, "timing": method, "plain_timing": plain_method,
                "bound": C.bound_ms("fused_apply", spec, params, b),
                "launch_shape": F.launch_shape(spec, b, "fused_apply"),
                "max_abs_err": err["abs"],
            }
            C.log(f"  B={b}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
