"""The trainer's wall with speculative dispatch on and off, through the
PyTorch port.

    python bench_dispatch_torch.py [--device DEV] [epochs=N] [out=FILE.json]

The counterpart of ``bench_dispatch.py``: the DES flagship training shape
(27 -> 457, 40,000 rows from ``np.random.default_rng(0)``, batch 500, K=2
``EnsembleTrainer``, ``epochs_per_dispatch=50``) for 400 epochs with
``speculative_dispatch`` on (chunk k+1 enqueued before the host waits for
chunk k's metrics) and then off (the serial loop), after one warm run of
each.  What speculation hides is the host's time between chunks (the
metrics' fetch, the supervisor, the saves and plots) behind the next chunk's device
work, so the measure is the wall seconds of ``train`` for a fixed epoch
budget.  On a card the chunks replay the trainer's CUDA graphs
(``train_graphs.py``).  Prints the card's name and power limit, then one
JSON line with ``bench_dispatch.py``'s keys plus ``device``, the chunks
speculated and dropped and the graphs' record; the result goes to
``DISPATCH_BENCH_torch.json`` in ``$TMPDIR/linna_bench_dispatch_torch/`` (see
``bench_torch_common``).
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
EPOCHS = 400
K = 2
BATCH = 500
EPOCHS_PER_DISPATCH = 50
RESULT_FILE = "DISPATCH_BENCH_torch.json"


def run(problem, rows, speculative: bool, epochs: int, batch: int, device) -> dict:
    """One training run of ``epochs`` epochs, speculating or not."""
    from linna_tpu_torch.parallel.ensemble import EnsembleTrainer

    spec, tset, loss_state = problem
    with tempfile.TemporaryDirectory() as td:
        tr = EnsembleTrainer(spec, tset, loss_state, [f"{td}/m{m}" for m in range(K)],
                             list(range(K)), device=device)
        tr.speculative_dispatch = speculative
        BC.synchronize(device)
        t0 = time.perf_counter()
        tr.train(*rows, num_epochs=epochs, batch_size=batch, auto_lr=False,
                 initfrombest=False, epochs_per_dispatch=EPOCHS_PER_DISPATCH)
        BC.synchronize(device)
        wall = time.perf_counter() - t0
    return {"wall_s": round(wall, 2),
            "phases": {k: round(v, 2) for k, v in tr.phase_seconds.items()},
            "epochs_run": tr.epochs_run, "speculation": dict(tr.speculation),
            "graphs": tr.graphs["epochs"]}


def main(device=None, epochs: int = EPOCHS, n_train: int = N_TRAIN, n_val: int = N_VAL,
         ndim: int = NDIM, ndata: int = NDATA, batch: int = BATCH,
         out: str | None = None) -> dict:
    from linna_tpu_torch.device import resolve_device

    device = resolve_device(device)
    out_path = BC.result_path(BC.run_dir("bench_dispatch"), out, RESULT_FILE)
    card = BC.card_line(device)
    print(f"device: {card}", flush=True)
    rows = BC.training_set(ndim, ndata, n_train, n_val)
    problem = BC.training_problem(rows[0], rows[1], device)
    result = {"metric": "trainer_wall_dispatch_ab", "unit": "s",
              "shape": {"ndim": ndim, "ndata": ndata, "n_train": n_train, "batch": batch,
                        "k": K, "epochs": epochs, "epochs_per_dispatch": EPOCHS_PER_DISPATCH},
              "device": card,
              "path": "train_graphs" if device.type == "cuda" else "eager bodies (the CPU)"}
    # warm both modes once, then time
    for flag in (True, False):
        run(problem, rows, flag, epochs, batch, device)
    result["speculative"] = run(problem, rows, True, epochs, batch, device)
    result["serial"] = run(problem, rows, False, epochs, batch, device)
    result["speedup"] = round(result["serial"]["wall_s"] / result["speculative"]["wall_s"], 3)
    BC.write_result(out_path, result)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    dev, kv, _ = BC.parse_argv(sys.argv[1:])
    main(dev, epochs=int(kv.get("epochs", EPOCHS)), out=kv.get("out"))
