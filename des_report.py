#!/usr/bin/env python3
"""Report a finished ``examples/des_synthetic.yaml`` run of the PyTorch port.

    python3 des_report.py <outdir> [--out FILE]

Reads the run directory that ``python -m linna_tpu_torch.driver`` wrote and
prints one JSON object:

- per iteration, from ``trace.json``: the ``train_emulator`` and ``mcmc``
  seconds, the sampler's method and steps, ms per training epoch (the
  trainer's dispatch and fetch seconds over its epochs), the compute type
  training ran in, and the sampler's wall breakdown (``precond`` is the MAP
  search);
- the final chain's integrated autocorrelation time per parameter and the
  seconds per 100 samples of its sampling loop;
- the emulator bias, computed as ``bench_full.py`` does: the mean of the
  final iteration's physical-space chain after a 20% burn-in, its distance
  to ``EXACT_POSTERIOR.json``'s exact-likelihood mean in units of the exact
  standard deviation, max and median, and whether the max passes the 0.1
  sigma gate.

Imports the port only (never JAX); the chain is read with the port's
backends, so a directory store written without h5py reads too.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GATE_SIGMA = 0.1  # bench_full.py --check


def final_chain_path(outdir: str, n_iter: int, method: str) -> str:
    from linna_tpu_torch import orchestrator as O

    return os.path.join(outdir, f"iter_{n_iter - 1}", O._chain_filename(method))


def emulator_bias(chain_path: str, method: str, exact_path: str) -> dict:
    """|chain mean - exact mean| / exact std over the chain after a 20%
    burn-in (bench_full.py:204-227)."""
    from linna_tpu_torch import orchestrator as O

    full = O._open_backend(chain_path, method).get_value("chain_transformed")
    flat = full[len(full) // 5:].reshape(-1, full.shape[-1])
    with open(exact_path) as f:
        exact = json.load(f)
    bias = np.abs(flat.mean(axis=0) - np.asarray(exact["exact_mean"])) / np.asarray(exact["exact_std"])
    return {
        "chain_steps": int(len(full)),
        "nwalkers": int(full.shape[1]),
        "bias_sigma": bias.tolist(),
        "max_emulator_bias_sigma": float(np.max(bias)),
        "median_emulator_bias_sigma": float(np.median(bias)),
        "gate_sigma": GATE_SIGMA,
        "gate_pass": bool(np.max(bias) < GATE_SIGMA),
    }


def iterations(trace: list) -> list:
    """Per-iteration records from a run's ``trace.json``."""
    out: dict = {}
    for rec in trace:
        it = rec.get("iteration")
        if it is None or rec["phase"] not in ("train_emulator", "mcmc"):
            continue
        row = out.setdefault(it, {"iteration": it})
        if rec["phase"] == "train_emulator":
            row["train_emulator_s"] = rec["seconds"]
            # an ensemble's trainer, else the first member trained alone
            tr = rec.get("trainer", rec.get("trainer_m0"))
            n = rec.get("epochs_run", rec.get("epochs_run_m0"))
            if tr and n:
                row["epochs_run"] = n
                row["ms_per_epoch"] = (tr["dispatch"] + tr["wait_fetch"]) / n * 1e3
                row["trainer_phase_s"] = tr
            row["compute_dtype"] = rec.get("compute_dtype")
        else:
            row["mcmc_s"] = rec["seconds"]
            row["method"] = rec.get("method")
            row["steps"] = rec.get("steps_run")
            row["sampler_s"] = rec.get("sampler")
            s = rec.get("sampler") or {}
            if row["steps"]:
                loop = s.get("device_wait", 0.0) + s.get("host", 0.0) + s.get("tau_checks", 0.0)
                row["s_per_100_steps"] = loop / row["steps"] * 100
    return [out[k] for k in sorted(out)]


def report(outdir: str, exact_path: str = os.path.join(ROOT, "EXACT_POSTERIOR.json")) -> dict:
    from linna_tpu_torch import orchestrator as O
    from linna_tpu_torch.samplers import convergence

    with open(os.path.join(outdir, "trace.json")) as f:
        rows = iterations(json.load(f))
    last = rows[-1]
    path = final_chain_path(outdir, len(rows), last["method"])
    chain = O._open_backend(path, last["method"]).get_chain()
    tau = convergence.integrated_time(chain[len(chain) // 5:])
    res = {
        "iterations": rows,
        "final_method": last["method"],
        "final_tau_mean": float(np.mean(tau)),
        "final_tau_max": float(np.max(tau)),
        "bias": emulator_bias(path, last["method"], exact_path),
    }
    t = os.path.join(outdir, "time.npy")
    if os.path.isfile(t):
        res["time_npy_s"] = float(np.load(t))
    return res


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="des_report.py")
    parser.add_argument("outdir")
    parser.add_argument("--out", default=None, help="also write the JSON here")
    args = parser.parse_args(argv)
    res = report(args.outdir)
    line = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
