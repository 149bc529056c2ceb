"""The ``fused_log_prob`` CUDA kernel against the PyTorch composition,
measured inside 100-step stretch-move chunks and as a raw batched
evaluation, at the DES-Y1-3x2pt shape (27 parameters -> 457-point data
vector) across walker counts.

    python bench_fused_torch.py [--device DEV] [walkers=128,512] [reps=N]
        [out=FILE.json]

The counterpart of ``bench_fused.py``: the evidence for ``use_fused`` in
``linna_tpu_torch.likelihood.make_log_prob`` on the card.  On ``cuda:0`` the
fused rows launch the kernel (``linna_tpu_torch/ops/csrc/fused_mlp.cu``);
a build or launch error propagates, and the script raises where the JAX
script returns without a TPU.  ``--device cpu`` runs the kernel's plain
version in its place.

Before any walker count is timed, the fused likelihood is held against the
composition at that count and at its half (the rows a stretch chunk
evaluates at once), relative error below 5e-4.  The launch counters are
read before each count's fused rows and after them: on a card the kernel
must have launched and its plain version never run.  The chunks replay the
stretch step's CUDA graph on a card (``samplers/graphs.py``; the graph's
launches are counted a replay); the raw rate is eager calls, one
synchronize after 20.

Prints the card's name and power limit, one JSON line per walker count and
the result line; the result goes to ``FUSED_BENCH_torch.json`` in
``$TMPDIR/linna_bench_fused_torch/`` (see ``bench_torch_common``).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import bench_torch_common as BC  # noqa: E402

NDIM, NDATA = BC.NDIM, BC.NDATA
CHUNK = BC.CHUNK
WALKER_COUNTS = (128, 512, 1024, 4096, 16384)
RTOL = 5e-4  # bench_fused.py:95
RESULT_FILE = "FUSED_BENCH_torch.json"


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """``bench_fused.py``'s measure: max |a - b| / (|a| + 1)."""
    a, b = want.double().cpu().numpy(), got.double().cpu().numpy()
    return float(np.max(np.abs(a - b) / (np.abs(a) + 1.0)))


def rate_raw(log_prob, walkers: int, ndim: int, device, reps: int = 20) -> float:
    """Raw batched (W, D) -> (W,) evaluations a second, one synchronize
    after ``reps`` calls."""
    x = BC.walkers(walkers, ndim, device, seed=3)
    with torch.no_grad():
        log_prob(x)
        BC.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            log_prob(x)
        BC.synchronize(device)
    return walkers * reps / (time.perf_counter() - t0)


def rate_chunk(log_prob, walkers: int, ndim: int, device, reps: int) -> tuple:
    """Evaluations a second inside chunks: one warm chunk, then ``reps``
    back to back (``bench_fused.py:38-52``); and the timed path."""
    r = BC.stretch_rate(log_prob, walkers, ndim, device, CHUNK, reps=1, chunks_per_rep=reps,
                        warm=1)
    return r["best"], r["path"]


def check(lp_fused, lp_plain, rows: int, ndim: int, device) -> float:
    """The fused likelihood's relative error against the composition at
    ``rows`` walkers; raises above ``RTOL``."""
    x = BC.walkers(rows, ndim, device, seed=9)
    with torch.no_grad():
        err = rel_err(lp_fused(x), lp_plain(x))
    if not err < RTOL:
        raise AssertionError(f"fused and composition disagree at {rows} rows: rel err {err}")
    return err


def main(device=None, walker_counts=WALKER_COUNTS, reps: int = 3, raw_reps: int = 20,
         out: str | None = None, shape=(NDIM, NDATA)) -> dict:
    from linna_tpu_torch import likelihood as LK
    from linna_tpu_torch.device import resolve_device
    from linna_tpu_torch.ops import fused as F

    device = resolve_device(device)
    out_path = BC.result_path(BC.run_dir("bench_fused"), out, RESULT_FILE)
    card = BC.card_line(device)
    print(f"device: {card}", flush=True)
    ndim = shape[0]
    pb = BC.build_problem(*shape, device=device)
    lp_plain = pb.log_prob
    lp_fused = LK.make_log_prob(pb.spec, pb.params, pb.transforms, pb.pack, pb.data, pb.inv_cov,
                                use_fused=True, device=device)
    on_card = device.type == "cuda"
    shapes = (F.launch_shapes if on_card else F.plain_shapes)["fused_log_prob"]
    shapes_before = set(shapes)
    rows, errs = [], {}
    for w in walker_counts:
        for n in sorted({w, w // 2}):
            errs[n] = check(lp_fused, lp_plain, n, ndim, device)
        row = {"walkers": w, "max_rel_err": max(errs[w], errs[w // 2])}
        xla_chunk, path = rate_chunk(lp_plain, w, ndim, device, reps)
        before = F.launches["fused_log_prob"], F.plain_calls["fused_log_prob"]
        fused_chunk, _ = rate_chunk(lp_fused, w, ndim, device, reps)
        fused_raw = rate_raw(lp_fused, w, ndim, device, raw_reps)
        counts = {"launches": F.launches["fused_log_prob"] - before[0],
                  "plain_calls": F.plain_calls["fused_log_prob"] - before[1]}
        # the kernel on a card; its plain version stands in for it elsewhere
        if counts["launches" if on_card else "plain_calls"] == 0 or (
                on_card and counts["plain_calls"]):
            raise AssertionError(f"{w} walkers: the fused rows counted {counts}")
        row.update(
            # the JAX script's keys; "xla" is the composition here
            xla_chunk_evals_s=round(xla_chunk, 1),
            fused_chunk_evals_s=round(fused_chunk, 1),
            xla_raw_evals_s=round(rate_raw(lp_plain, w, ndim, device, raw_reps), 1),
            fused_raw_evals_s=round(fused_raw, 1),
            fused_counts=counts,
        )
        row["chunk_speedup"] = round(row["fused_chunk_evals_s"] / row["xla_chunk_evals_s"], 3)
        row["raw_speedup"] = round(row["fused_raw_evals_s"] / row["xla_raw_evals_s"], 3)
        rows.append(row)
        print(json.dumps(row), flush=True)

    ran_at = sorted(shapes - shapes_before)
    unchecked = [sh for sh in ran_at if sh[0] not in errs]
    if unchecked:
        raise AssertionError(f"fused_log_prob ran at (rows, in, out) {unchecked}, never held "
                             "against the composition")
    result = {
        "shape": {"ndim": shape[0], "ndata": shape[1], "chunk": CHUNK},
        "device": card,
        "max_rel_err_vs_xla": max(errs.values()),
        "checked_rows": sorted(errs),
        "rtol": RTOL,
        "rows": rows,
        "path": {"chunk": path, "raw": f"eager calls, one synchronize after {raw_reps}"},
        "xla": "the plain composition of make_log_prob (use_fused=False)",
        "fused": ("fused_log_prob_kernel (ops/csrc/fused_mlp.cu)" if on_card
                  else "fused_log_prob's plain version (the CPU)"),
        "shapes_launched": ran_at,
    }
    BC.write_result(out_path, result)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    dev, kv, _ = BC.parse_argv(sys.argv[1:])
    main(dev, BC.int_list(kv, "walkers", WALKER_COUNTS), reps=int(kv.get("reps", 3)),
         out=kv.get("out"))
