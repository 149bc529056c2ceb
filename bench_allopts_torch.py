"""All four pipeline options together through the PyTorch port: one
DES-shaped run of ``linna_tpu_torch.ml_sampler_core`` with ``nbest``
best-point injection, ``chisqcut`` row filtering, ``ypositive`` log-space
transforms and ``nimp`` exact-theory importance sampling enabled at once.

    python bench_allopts_torch.py [--device DEV] [--resume] [out=FILE.json]

The counterpart of ``bench_allopts.py``.  The theory is the DES synthetic
survey map (``examples/des_theory.py``) composed with ``exp(0.5 * y)``, so
every data-vector entry is positive (the regime ``ypositive`` exists for);
its noise is the flagship recipe's carried through the delta method, and
the cut is ``chisqcut = 2 * SNR^2``.  The schedule is the JAX script's: 4
iterations x 2,000 rows, T^2 = 16, 4, 1, 1, zeus at 256 walkers, K=2, 800
epochs, ``nbest=200``, ``nimp=2000``, ``seed=13``, on ``cuda:0``
(``--device cpu`` runs it on the host).

Reports the JAX script's fields (wall, phase seconds, the final chain's
split R-hat, the posterior's error against the truth, the importance
sampling's ESS and weights, the option artifacts) plus ``device``; the
final chain is read through the port's backends (the directory store where
h5py is missing).  Fails unless the chain is finite and the importance ESS
is above 10.  The run goes to ``linna_allopts_bench_torch`` in the
temporary directory (``$TMPDIR``, else ``/tmp``; removed first unless
``--resume``), the result to ``FLAGSHIP_ALLOPTS_torch.json`` inside it (see
``bench_torch_common``).
"""

from __future__ import annotations

import faulthandler
import importlib
import json
import os
import shutil
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import bench_torch_common as BC  # noqa: E402

RESULT_FILE = "FLAGSHIP_ALLOPTS_torch.json"
MIN_ESS = 10.0  # bench_allopts.py:188
# the JAX script's schedule (bench_allopts.py:95-135); ``schedule`` keys of
# main() replace entries
SCHEDULE = {
    "n_iter": 4, "ntrain": 2000, "nval": 200, "nkeep": [2, 2, 5, 5], "ntimes": [5, 5, 10, 50],
    "ntautol": [0.03, 0.03, 0.02, 0.01], "meanshift": 0.2, "stdshift": 0.15,
    "temperatures": [4.0, 2.0, 1.0, 1.0], "nwalkers": 256, "epochs": 800, "batch_size": 500,
    "nensemble": 2, "epochs_per_dispatch": 50, "nimp": 2000, "nbest": 200, "seed": 13,
}


def problem(T):
    """The positive-observable problem of theory module ``T``: (truth,
    theory, data, cov, SNR^2)."""
    from linna_tpu_torch.driver import read_triplet_cov

    truth = T.fiducial() + 0.05

    def pos_vec(x):
        return np.exp(0.5 * T.data_vector(np.asarray(x, np.float64)))

    def theory(x, outdirs):
        return pos_vec(x[1])

    data = pos_vec(truth)
    # sigma_pos = |d exp(0.5 y) / dy| * sigma_raw: the posterior keeps the
    # flagship's parameter-space widths
    sigma = 0.5 * np.abs(data) * T.noise_sigma(T.data_vector(truth))
    n = len(data)
    cov = read_triplet_cov(np.stack([np.arange(n), np.arange(n), sigma**2, np.zeros(n)], 1))
    # chisqcut acts on the raw prediction's y^T C^-1 y, the total SNR^2
    snr2 = float(data @ np.linalg.inv(cov) @ data)
    return truth, theory, data, cov, snr2


def main(out: str | None = None, fresh: bool = True, device=None,
         theory_mod: str = "examples.des_theory", schedule: dict | None = None,
         outdir: str | None = None, min_ess: float | None = MIN_ESS) -> dict:
    """Run the pipeline and return the result object.  ``schedule``
    replaces entries of :data:`SCHEDULE` (a short run: ``n_iter``,
    ``ntrain``, ``epochs``, ``nimp`` ...); list entries are cut to
    ``n_iter``.  ``min_ess``: the importance ESS the run must pass (None: a
    run cut to depth, whose emulator is not trained enough for it, reports
    it only)."""
    from linna_tpu_torch import ml_sampler_core
    from linna_tpu_torch import orchestrator as O
    from linna_tpu_torch.device import resolve_device
    from linna_tpu_torch.samplers import convergence

    device = resolve_device(device)
    s = {**SCHEDULE, **(schedule or {})}
    n = s["n_iter"]
    per_iter = lambda v: list(v)[:n] if isinstance(v, (list, tuple)) else [v] * n
    outdir = outdir or BC.run_dir("allopts_bench")
    out_path = BC.result_path(outdir, out, RESULT_FILE)
    card = BC.card_line(device)
    print(f"device: {card}", flush=True)
    T = importlib.import_module(theory_mod)
    truth, theory, data, cov, snr2 = problem(T)
    ndim = len(truth)
    priors = [{"param": f"p{i}", "dist": "flat", "arg1": -1.0, "arg2": 1.0}
              for i in range(ndim)]
    if fresh and os.path.isdir(outdir):
        shutil.rmtree(outdir)

    faulthandler.dump_traceback_later(300, repeat=True, file=sys.__stderr__)
    try:
        t0 = time.time()
        chain, logp = ml_sampler_core(
            ntrainArr=[s["ntrain"]] * n, nvalArr=[s["nval"]] * n, nkeepArr=per_iter(s["nkeep"]),
            ntimesArr=per_iter(s["ntimes"]), ntautolArr=per_iter(s["ntautol"]),
            meanshiftArr=per_iter(s["meanshift"]), stdshiftArr=per_iter(s["stdshift"]),
            outdir=outdir, theory=theory, priors=priors, data=data, cov=cov,
            init=T.fiducial(), pool=None, nwalkers=s["nwalkers"], device=device,
            ypositive=True,  # log-space y transforms
            # the reference's annealing (T^2 = 16, 4, 1, 1) bridges the gap
            # from the initial point to the mode
            temperatureArr=per_iter(s["temperatures"]),
            params={"trainingoption": 1, "num_epochs": s["epochs"],
                    "batch_size": s["batch_size"], "nensemble": s["nensemble"],
                    "epochs_per_dispatch": s["epochs_per_dispatch"],
                    "nimp": s["nimp"]},  # importance-sampling post-pass
            method="zeus",
            nbest=[s["nbest"]] * n,  # the optimizer's best points injected
            chisqcut=2.0 * snr2,  # far-tail training rows dropped
            seed=s["seed"],
            verbose=True,
        )
        wall = time.time() - t0
    finally:
        faulthandler.cancel_dump_traceback_later()

    phases: dict = {}
    trace_path = os.path.join(outdir, "trace.json")
    if os.path.isfile(trace_path):
        with open(trace_path) as f:
            for rec in json.load(f):
                phases[rec["phase"]] = phases.get(rec["phase"], 0.0) + rec.get("seconds", 0.0)

    final_dir = os.path.join(outdir, f"iter_{n - 1}")
    backend = O._open_backend(os.path.join(final_dir, O._chain_filename("zeus")), "zeus")
    raw = backend.get_value("chain_transformed")
    rhat = convergence.gelman_rubin(raw[len(raw) // 5:], split=True)
    post_mean = np.mean(chain, axis=0)
    post_std = np.std(chain, axis=0)
    err_sigma = np.abs(post_mean - truth) / post_std

    logp_em, logp_true, w = np.load(os.path.join(outdir, "weight_im.npy"))
    ess = float(np.sum(w) ** 2 / np.sum(w**2))
    artifacts = {
        "best_samples": os.path.isfile(os.path.join(outdir, "iter_0", "best_samples_x.txt")),
        "samples_im": os.path.isfile(os.path.join(outdir, "samples_im.npy")),
        "weight_im": True,
    }
    result = {
        "metric": "allopts_flagship_wallclock",
        "value": round(wall, 1),
        "unit": "s",
        "options": {"nbest": s["nbest"], "chisqcut": "2*SNR^2", "ypositive": True,
                    "nimp": s["nimp"], "nensemble": s["nensemble"]},
        "phases_s": {k: round(v, 1) for k, v in phases.items()},
        "max_split_rhat": round(float(np.max(rhat)), 4),
        "max_posterior_err_sigma": round(float(np.max(err_sigma)), 3),
        "median_posterior_err_sigma": round(float(np.median(err_sigma)), 3),
        "importance_ess": round(ess, 1),
        "importance_nonzero_weights": int(np.sum(w > 0)),
        "mean_abs_dlogp_emulator_vs_true": round(
            float(np.mean(np.abs((logp_true - logp_em)[w > 0]))), 3),
        "artifacts": artifacts,
        "chain_finite": bool(np.all(np.isfinite(chain))),
        "config": (f"{n} iters x {s['ntrain']}, T^2="
                   f"{','.join(str(round(t**2)) for t in per_iter(s['temperatures']))}, zeus "
                   f"{s['nwalkers']} walkers, K={s['nensemble']}, {s['epochs']} epochs, "
                   f"positive-observable {theory_mod} shape (exp(0.5*synthetic))"),
        "device": card,
        "chain_store": type(backend).__name__ + (" (directory)" if backend.path.endswith(".d")
                                                 else ""),
    }
    BC.write_result(out_path, result)
    print(json.dumps(result), flush=True)
    if not result["chain_finite"]:
        raise AssertionError("non-finite posterior chain")
    if min_ess is not None and not ess > min_ess:
        raise AssertionError(f"importance ESS collapsed: {ess}")
    return result


if __name__ == "__main__":
    dev, kv, words = BC.parse_argv(sys.argv[1:])
    main(out=kv.get("out"), fresh="--resume" not in words, device=dev)
