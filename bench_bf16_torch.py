"""bfloat16 against float32 emulator-likelihood throughput inside stretch
sampler chunks at the DES-Y1-3x2pt shape (27 -> 457), across walker counts,
through the PyTorch port.

    python bench_bf16_torch.py [--device DEV] [walkers=256,1024] [lsst=1024,4096]
        [ensemble=2,4] [reps=N] [out=FILE.json]

The counterpart of ``bench_bf16.py``: evidence for ``compute_dtype="bfloat16"``
in ``linna_tpu_torch.likelihood.make_log_prob``, measured in 100-step chunks
(replayed from the stretch step's CUDA graph on a card), with the bfloat16
against float32 log-prob deviation (median and p95 |dlogp| at 1024 walkers)
beside the speed-up.  Then the regimes where bfloat16 could pay: the K=2
and K=4 ensemble likelihood at 4096 walkers (one batched pass over the
stacked members) and the LSST-Y10 shape (40 -> 1560) at 1024 and 4096
walkers.  bfloat16 reaches no CUDA kernel in either package
(``make_log_prob`` refuses ``use_fused`` with a ``compute_dtype``): every row
is the composition, and the launch counters are read to show it.

Prints the card's name and power limit, one JSON line a row and the result
line; the result goes to ``BF16_BENCH_torch.json`` in
``$TMPDIR/linna_bench_bf16_torch/`` (see ``bench_torch_common``).
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import bench_torch_common as BC  # noqa: E402

NDIM, NDATA = BC.NDIM, BC.NDATA
LSST = (40, 1560)
CHUNK = BC.CHUNK
WALKER_COUNTS = (256, 1024, 4096, 16384)
ENSEMBLES = (2, 4)
ENSEMBLE_WALKERS = 4096
LSST_WALKERS = (1024, 4096)
ACCURACY_WALKERS = 1024
RESULT_FILE = "BF16_BENCH_torch.json"


def rate(log_prob, walkers: int, ndim: int, device, reps: int) -> float:
    """Evaluations a second: one warm chunk, then ``reps`` chunks back to
    back (``bench_bf16.py:33-46``)."""
    return BC.stretch_rate(log_prob, walkers, ndim, device, CHUNK, reps=1,
                           chunks_per_rep=reps, warm=1)["best"]


def pair_row(lp_f32, lp_bf16, walkers: int, ndim: int, device, reps: int, **keys) -> dict:
    row = {**keys, "walkers": walkers,
           "f32_chunk_evals_s": round(rate(lp_f32, walkers, ndim, device, reps), 1),
           "bf16_chunk_evals_s": round(rate(lp_bf16, walkers, ndim, device, reps), 1)}
    row["speedup"] = round(row["bf16_chunk_evals_s"] / row["f32_chunk_evals_s"], 3)
    print(json.dumps(row), flush=True)
    return row


def main(device=None, walker_counts=WALKER_COUNTS, ensembles=ENSEMBLES,
         lsst_walkers=LSST_WALKERS, reps: int = 3, out: str | None = None,
         accuracy_walkers: int = ACCURACY_WALKERS, ensemble_walkers: int = ENSEMBLE_WALKERS,
         shape=(NDIM, NDATA), lsst=LSST) -> dict:
    from linna_tpu_torch import likelihood as LK
    from linna_tpu_torch import nn as N
    from linna_tpu_torch.device import resolve_device
    from linna_tpu_torch.ops import fused as F

    device = resolve_device(device)
    out_path = BC.result_path(BC.run_dir("bench_bf16"), out, RESULT_FILE)
    card = BC.card_line(device)
    print(f"device: {card}", flush=True)
    counts0 = sum(F.launches.values()) + sum(F.plain_calls.values())
    ndim = shape[0]
    pb = BC.build_problem(*shape, device=device)
    lp_f32 = pb.log_prob
    lp_bf16 = LK.make_log_prob(pb.spec, pb.params, pb.transforms, pb.pack, pb.data, pb.inv_cov,
                               compute_dtype="bfloat16", device=device)
    x = BC.walkers(accuracy_walkers, ndim, device, seed=9)
    with torch.no_grad():
        dev = (lp_f32(x) - lp_bf16(x)).abs().double().cpu().numpy()
    accuracy = {"walkers": accuracy_walkers, "median_abs_dlogp": float(np.median(dev)),
                "p95_abs_dlogp": float(np.percentile(dev, 95))}

    rows = [pair_row(lp_f32, lp_bf16, w, ndim, device, reps) for w in walker_counts]

    extra = []
    for kmem in ensembles:
        members = [N.init_model(pb.spec, seed=100 + m, device=device) for m in range(kmem)]
        lps = [LK.make_log_prob(pb.spec, members, pb.transforms, pb.pack, pb.data, pb.inv_cov,
                                compute_dtype=cd, device=device) for cd in (None, "bfloat16")]
        extra.append(pair_row(*lps, ensemble_walkers, ndim, device, reps,
                              case=f"ensemble_K{kmem}"))
    if lsst_walkers:
        wide = BC.build_problem(*lsst, device=device)
        lp2_bf16 = LK.make_log_prob(wide.spec, wide.params, wide.transforms, wide.pack,
                                    wide.data, wide.inv_cov, compute_dtype="bfloat16",
                                    device=device)
        extra += [pair_row(wide.log_prob, lp2_bf16, w, lsst[0], device, reps,
                           case=f"lsst_{lsst[0]}x{lsst[1]}") for w in lsst_walkers]

    kernel_calls = sum(F.launches.values()) + sum(F.plain_calls.values()) - counts0
    if kernel_calls:
        raise AssertionError(f"{kernel_calls} kernel launches or plain-version calls: bf16 "
                             "inference reaches no kernel")
    result = {
        "shape": {"ndim": shape[0], "ndata": shape[1], "chunk": CHUNK},
        "device": card,
        "accuracy": accuracy,
        "rows": rows,
        "regime_rows": extra,
        "path": "cuda_graphs" if device.type == "cuda" else "eager",
        "kernels": "none: every row is the make_log_prob composition (bfloat16 reaches no "
                   "kernel in either package); 0 launches and 0 plain-version calls",
    }
    BC.write_result(out_path, result)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    dev, kv, _ = BC.parse_argv(sys.argv[1:])
    main(dev, BC.int_list(kv, "walkers", WALKER_COUNTS), BC.int_list(kv, "ensemble", ENSEMBLES),
         BC.int_list(kv, "lsst", LSST_WALKERS), reps=int(kv.get("reps", 3)), out=kv.get("out"))
