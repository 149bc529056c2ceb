"""Headline measurement through the PyTorch port: emulator-likelihood
throughput on the MCMC hot path.

    python bench_torch.py [--device DEV] [reps=N] [chunks=N] [out=FILE.json]
        [history=FILE.json]

The counterpart of ``bench.py``.  It measures stretch-move walker updates
(proposal + the batched ChtoModelv2 forward + chi^2 + prior + accept) a
second on the DES-Y1-3x2pt shape (27 parameters -> 457-point data vector,
4096 walkers, chunks of 100 steps), the likelihood the composition of
``make_log_prob``'s defaults, on ``cuda:0`` (``--device cpu`` runs it on the
host).  On a card every chunk replays the stretch step's CUDA graph, as
``run_ensemble`` samples.  The rate is the best of 9 repetitions of 5 chunks
dispatched back to back with one synchronize, with the median and IQR.

Beside it: a fixed-operation probe (a chain of 50 1024 x 1024 float32
products with tanh, TF32 off, on the same device), the host-noise control;
and the reference's architecture measured live, one walker at a time
through a torch CPU forward of the same network (``bench.py``'s
``bench_reference_style``, 4 threads, best of 3).  Nothing is read from
``reference_baseline.json``.

Prints the card's name and power limit, then one JSON line with
``bench.py``'s keys plus ``device``, ``path`` and the live baseline.  The
result goes to ``BENCH_torch.json`` in ``$TMPDIR/linna_bench_torch/`` (see
``bench_torch_common``).  The run history and its verdict (``bench.py``'s
``_classify``) are kept in ``.bench_torch/history.json`` beside this script,
a directory ``.gitignore`` lists (``history=`` moves it).
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
WALKERS = 4096
CHUNK = BC.CHUNK
HISTORY_FILE = os.path.join(HERE, ".bench_torch", "history.json")
RESULT_FILE = "BENCH_torch.json"


def bench_card(device, reps: int = 9, chunks_per_rep: int = 5, walkers: int = WALKERS,
               shape=(NDIM, NDATA)) -> dict:
    """Walker log-prob evaluations a second inside the sampler's chunks:
    the best repetition (the uncontended device rate, a property of the
    code), the median and IQR (the host's contention)."""
    pb = BC.build_problem(*shape, device=device)
    return BC.stretch_rate(pb.log_prob, walkers, shape[0], device, CHUNK, reps, chunks_per_rep)


def bench_probe(device, reps: int = 5, iters: int = 50, n: int = 1024) -> float:
    """A chain of ``iters`` n x n float32 products with tanh whose code and
    operation count never change: its best-of-``reps`` rate depends on the
    card and the host's contention only.  TF32 is off inside.  Returns
    TFLOP/s."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(0)
    c0 = torch.randn((n, n), generator=g, device=device) * 0.01

    def probe():
        c = c0
        for _ in range(iters):
            c = torch.tanh(c @ c0)
        return c

    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        probe()
        BC.synchronize(device)
        flops = 2.0 * n * n * n * iters
        best = 0.0
        for _ in range(reps):
            t0 = time.perf_counter()
            probe()
            BC.synchronize(device)
            best = max(best, flops / (time.perf_counter() - t0) / 1e12)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return best


def bench_reference_style(max_evals: int = 300, max_seconds: float = 30.0, ndim: int = NDIM,
                          ndata: int = NDATA) -> float:
    """Reference-architecture baseline measured live: single-walker torch CPU
    emulator likelihood (same ChtoModelv2 topology/widths), eval-mode
    ``torch.jit`` inference like linna/predictor_gpu.py:480-490."""
    h = 1000 if ndata > 30 else max(32, 32 * ndata)

    class ResBlock(torch.nn.Module):
        def __init__(self, n_in, ch, n_out):
            super().__init__()
            self.l1 = torch.nn.Linear(n_in, ch)
            self.l2 = torch.nn.Linear(ch, n_out)
            self.skip = torch.nn.Linear(n_in, n_out, bias=False)

        def forward(self, x):
            return torch.relu(0.1 * self.l2(torch.relu(self.l1(x))) + self.skip(x))

    class Model(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.l1 = torch.nn.Linear(ndim, h)
            self.rb1 = ResBlock(h, 16, h // 2)
            self.rb2 = ResBlock(h // 2, 32, h // 4)
            self.rb3 = ResBlock(h // 4, 64, h // 8)
            self.l6 = torch.nn.Linear(h // 8, h // 2)
            self.l7 = torch.nn.Linear(h // 2, ndata)
            self.l8 = torch.nn.Linear(ndata, ndata)

        def forward(self, x):
            s = torch.relu(self.l1(x))
            s = self.rb3(self.rb2(self.rb1(s)))
            s = torch.relu(self.l6(s))
            s = torch.relu(self.l7(s))
            return self.l8(s)

    model = Model().eval()
    try:
        model = torch.jit.optimize_for_inference(
            torch.jit.script(model)
        )  # reference's MKLDNN/TorchScript fast path
    except Exception:
        pass
    data = torch.randn(ndata)
    inv_cov = torch.eye(ndata)
    xs = [torch.randn(1, ndim) for _ in range(max_evals)]
    with torch.no_grad():
        model(xs[0])  # warmup
        n = 0
        t0 = time.perf_counter()
        for x in xs:
            m = model(x)[0]
            d = m - data
            _ = -0.5 * (d @ inv_cov @ d) - 0.5 * (x**2).sum()
            n += 1
            if time.perf_counter() - t0 > max_seconds:
                break
        dt = time.perf_counter() - t0
    return n / dt


def live_baseline(max_evals: int = 300, shape=(NDIM, NDATA), repeats: int = 3,
                  threads: int = 4) -> float:
    """``bench.py``'s pinned methodology, measured in this run: 4 torch CPU
    threads, the best of 3 repeats of up to 300 single-walker evaluations."""
    saved = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        return max(bench_reference_style(max_evals, ndim=shape[0], ndata=shape[1])
                   for _ in range(repeats))
    finally:
        torch.set_num_threads(saved)


def _update_history(entry: dict, path: str) -> list:
    """Append this run to the per-run history file (last 20 entries kept).
    Entries carry best/median/iqr/probe so later runs can classify a move as
    host noise (probe down too) or code change (probe at par)."""
    history = []
    if os.path.isfile(path):
        try:
            with open(path) as f:
                history = json.load(f)
        except (OSError, ValueError):
            history = []
    history.append(entry)
    history = history[-20:]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(history, f, indent=1)
    return history


def _classify(stats: dict, probe: float, history: list) -> str:
    """Self-classifying verdict (VERDICT r4 item 1): separate "box is busy"
    from "code got slower" using (a) the run's own IQR/median dispersion and
    (b) the fixed-FLOP probe vs its best pinned rate from history."""
    probe_pin = max(
        [h.get("probe", 0.0) for h in history[:-1] if isinstance(h, dict)]
        + [probe]
    )
    probe_frac = probe / probe_pin if probe_pin > 0 else 1.0
    disp = stats["iqr"] / stats["median"] if stats["median"] > 0 else 0.0
    best_pin = max(
        [h.get("best", h.get("value", 0.0)) for h in history[:-1]
         if isinstance(h, dict)] or [stats["best"]]
    )
    best_move = stats["best"] / best_pin - 1 if best_pin > 0 else 0.0
    noisy = probe_frac < 0.85 or disp > 0.15
    parts = [
        f"probe {probe:.2f} TFLOP/s ({probe_frac:.0%} of pinned)",
        f"IQR/median {disp:.0%}",
        f"best {best_move:+.1%} vs pinned best",
    ]
    if noisy and best_move > -0.10:
        verdict = "HOST-NOISE regime; best-of-N is the faithful device rate"
    elif noisy:
        verdict = (
            "host noisy AND best-of-N down >10% — re-run in a quiet window "
            "before reading this as a regression"
        )
    elif best_move < -0.10:
        verdict = "probe at par but best-of-N down >10%: likely CODE regression"
    else:
        verdict = "clean window, no regression"
    return verdict + " (" + "; ".join(parts) + ")"


def main(device=None, reps: int = 9, chunks_per_rep: int = 5, walkers: int = WALKERS,
         out: str | None = None, history: str = HISTORY_FILE, shape=(NDIM, NDATA),
         baseline_evals: int = 300, probe_n: int = 1024) -> dict:
    """Measure and return ``bench.py``'s result object (plus ``device``,
    ``path`` and the live baseline); ``walkers``, ``shape``,
    ``baseline_evals`` and ``probe_n`` let a test run it small."""
    from linna_tpu_torch.device import resolve_device

    device = resolve_device(device)
    out_path = BC.result_path(BC.run_dir("bench"), out, RESULT_FILE)
    card = BC.card_line(device)
    print(f"device: {card}", flush=True)
    stats = bench_card(device, reps, chunks_per_rep, walkers, shape)
    probe = bench_probe(device, n=probe_n)
    baseline = live_baseline(baseline_evals, shape)
    value = stats["best"]
    vs = value / baseline if np.isfinite(baseline) and baseline > 0 else None
    hist = _update_history(
        {"best": round(stats["best"], 1), "median": round(stats["median"], 1),
         "iqr": round(stats["iqr"], 1), "probe": round(probe, 3), "device": card},
        history,
    )
    result = {
        "metric": "emulator_loglike_evals_per_sec",
        # primary = best-of-reps x chunks windows: the uncontended device
        # rate (code property); median/iqr = this window's host behaviour
        "value": round(value, 1),
        "unit": "evals/s",
        "vs_baseline": round(vs, 1) if vs else None,
        "median": round(stats["median"], 1),
        "iqr": round(stats["iqr"], 1),
        "probe_tflops": round(probe, 3),
        "history": [h.get("best", h.get("value")) for h in hist if isinstance(h, dict)],
        "note": _classify(stats, probe, hist),
        "device": card,
        "path": stats["path"],
        "baseline_evals_per_sec": round(baseline, 2),
        "baseline": "measured live: single-walker torch CPU forward, 4 threads, best of 3",
        "shape": {"ndim": shape[0], "ndata": shape[1], "walkers": walkers, "chunk": CHUNK,
                  "reps": reps, "chunks_per_rep": chunks_per_rep},
        "rates": [round(r, 1) for r in stats["rates"]],
        "chain_finite": stats["finite"],
    }
    BC.write_result(out_path, result)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    dev, kv, _ = BC.parse_argv(sys.argv[1:])
    main(dev, reps=int(kv.get("reps", 9)), chunks_per_rep=int(kv.get("chunks", 5)),
         out=kv.get("out"), history=kv.get("history", HISTORY_FILE))
