"""Training-phase measurement through the PyTorch port.

    python bench_train_torch.py [--device DEV] [epochs=N] [out=FILE.json]

The counterpart of ``bench_train.py``: the flagship-shaped supervised
problem (27 parameters -> 457-point data vector, 40,000 training and 2,000
validation rows from ``np.random.default_rng(0)``, batch 500: iteration 3
of the DES schedule) trained by the port's ``EnsembleTrainer``, for the
steady-state seconds an epoch of

- ``k1_f32_b500``: one member in float32;
- ``k2_f32_b500``: two members stacked in one batched pass;
- ``k2_bf16_b500``: ``compute_dtype="bfloat16"`` (float32 master weights);
- ``k2_f32_b2000``: fewer, larger steps.

Each case trains 30 epochs once to warm up, then 30 timed epochs in one
dispatch chunk, with the plots off (as in JAX).  On a card every chunk
replays the trainer's CUDA graphs of one minibatch step and one epoch end
(``train_graphs.py``), captured at the start of each training call: the
steady-state time leaves that capture out (``phase_seconds["capture"]``,
reported beside it, as the JAX script's timed call finds its program
compiled).  Prints the card's name and power limit, a line a case and the
result as one JSON line; the result goes to ``TRAIN_BENCH_torch.json`` in
``$TMPDIR/linna_bench_train_torch/`` (see ``bench_torch_common``).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import bench_torch_common as BC  # noqa: E402

NDIM, NDATA = BC.NDIM, BC.NDATA
N_TRAIN, N_VAL = BC.N_TRAIN, BC.N_VAL
EPOCHS = 30
CASES = (
    ("k1_f32_b500", 1, None, 500),
    ("k2_f32_b500", 2, None, 500),
    ("k2_bf16_b500", 2, "bfloat16", 500),
    ("k2_f32_b2000", 2, None, 2000),
)
RESULT_FILE = "TRAIN_BENCH_torch.json"


def run_case(problem, rows, k: int, compute_dtype, batch: int, epochs: int, device) -> dict:
    """One case: a warm training call, then a timed one of ``epochs``
    epochs in one chunk.  Returns seconds an epoch with and without the
    graphs' capture, the capture, and the chunk program's record."""
    from linna_tpu_torch.parallel.ensemble import EnsembleTrainer

    spec, tset, loss_state = problem
    with tempfile.TemporaryDirectory() as td:
        tr = EnsembleTrainer(spec, tset, loss_state, [f"{td}/m{m}" for m in range(k)],
                             [100 + m for m in range(k)], compute_dtype=compute_dtype,
                             device=device)
        kw = dict(batch_size=batch, auto_lr=False, initfrombest=False,
                  epochs_per_dispatch=epochs)
        tr.train(*rows, num_epochs=epochs, **kw)  # capture + warm
        BC.synchronize(device)
        t0 = time.perf_counter()
        tr.train(*rows, num_epochs=epochs, **kw)
        BC.synchronize(device)
        wall = time.perf_counter() - t0
    capture = tr.phase_seconds["capture"]
    rec = tr.graphs["epochs"]
    return {"sec_per_epoch": (wall - capture) / epochs, "wall_s": wall, "capture_s": capture,
            "epochs_run": tr.epochs_run,
            "replays_per_epoch": rec["replays"] / max(rec["epochs"], 1),
            "minibatches_per_epoch": rec["minibatches_per_epoch"], "graphed": rec["graphed"]}


def main(device=None, epochs: int = EPOCHS, n_train: int = N_TRAIN, n_val: int = N_VAL,
         ndim: int = NDIM, ndata: int = NDATA, cases=CASES, out: str | None = None) -> dict:
    from linna_tpu_torch.device import resolve_device

    device = resolve_device(device)
    out_path = BC.result_path(BC.run_dir("bench_train"), out, RESULT_FILE)
    card = BC.card_line(device)
    print(f"device: {card}", flush=True)
    rows = BC.training_set(ndim, ndata, n_train, n_val)
    problem = BC.training_problem(rows[0], rows[1], device)
    sec, detail = {}, {}
    with BC.plots_off():
        for name, k, cd, b in cases:
            detail[name] = run_case(problem, rows, k, cd, b, epochs, device)
            sec[name] = round(detail[name]["sec_per_epoch"], 4)
            print(f"{name}: {detail[name]['sec_per_epoch'] * 1e3:.1f} ms/epoch "
                  f"(capture {detail[name]['capture_s']:.2f} s)", flush=True)
    ratio = lambda a, b: round(sec[a] / sec[b], 3) if a in sec and b in sec else None
    result = {
        "device": card,
        "shape": {"ndim": ndim, "ndata": ndata, "n_train": n_train, "batch": 500,
                  "epochs_timed": epochs},
        "sec_per_epoch": sec,
        "k2_packing_overhead_vs_k1": ratio("k2_f32_b500", "k1_f32_b500"),
        "bf16_speedup_vs_f32": ratio("k2_f32_b500", "k2_bf16_b500"),
        "path": ("train_graphs: one minibatch-step graph and one epoch-end graph replayed "
                 "nb + 1 times an epoch" if device.type == "cuda"
                 else "train_graphs' eager bodies (the CPU)"),
        "sec_per_epoch_excludes": "the graphs' capture at the start of the timed call",
        "cases": detail,
    }
    BC.write_result(out_path, result)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    dev, kv, _ = BC.parse_argv(sys.argv[1:])
    main(dev, epochs=int(kv.get("epochs", EPOCHS)), out=kv.get("out"))
