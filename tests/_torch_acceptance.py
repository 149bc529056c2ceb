"""The JAX package's slow acceptance tier, through the PyTorch port.

One function for each of the JAX package's accuracy pins that is too slow
for its CPU tier, each building the same problem, priors, theory and
``ml_sampler_core`` budget as its JAX test and returning the chain and the
figures its pins read:

- :func:`posterior_accuracy_2d_gaussian`: ``tests/test_end_to_end.py:93``,
  three annealed iterations of the 2-D Gaussian; each mean within 0.25 and
  each std within 0.35 of the truncated normal's sigma;
- :func:`gaussian33_posterior_parity`: ``tests/test_gaussian33.py:16``, the
  reference README's 33-dimensional Gaussian; median mean error below 0.7
  sigma, the largest below 6.0, the median std ratio in (0.5, 4.0);
- :func:`flagship_config_posterior_parity`: ``tests/test_flagship_parity.py:40``,
  DES 3x2pt at a medium budget against ``EXACT_POSTERIOR.json``; median bias
  below 0.35 sigma, the largest below 1.2, the median width ratio in (0.8,
  1.3).

Each result holds ``pins`` ({pin: met}); :func:`missed` lists the pins
missed.  ``overrides`` replace ``ml_sampler_core`` arguments, so a test can
run a function at a tiny budget; the pins hold only at the JAX budget.
``tests/test_torch_acceptance.py`` runs them on the CPU (slow tier) and
``chip_smoke.py`` phase 15 on the card.  Imports the port only, never JAX.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# tests/test_end_to_end.py:15-21
NDIM_2D = 2
COV_2D = np.diag([0.5, 0.2])
MEANS_2D = np.array([0.1, 1.0])
PRIORS_2D = [{"param": f"test_{i}", "dist": "flat", "arg1": -2.0, "arg2": 2.0}
             for i in range(NDIM_2D)]
NDIM_33 = 33


def identity_theory(x, outdirs):
    """The identity map on the parameters (the JAX tests' ``theory``)."""
    return np.asarray(x[1], dtype=np.float64).copy()


def _run(kwargs: dict, overrides: dict, device) -> tuple:
    """``ml_sampler_core`` with ``overrides`` applied: (chain, seconds,
    the run's per-iteration record)."""
    from linna_tpu_torch import ml_sampler_core

    kwargs = {**kwargs, **overrides}
    t0 = time.perf_counter()
    chain, _ = ml_sampler_core(device=device, **kwargs)
    return chain, time.perf_counter() - t0, run_record(kwargs["outdir"])


def run_record(outdir: str) -> list:
    """Each iteration's training epochs and sampler steps, seconds and graph
    replays, from the run's ``trace.json``."""
    from linna_tpu_torch.utils.trace import TRACE_FILE

    with open(os.path.join(outdir, TRACE_FILE)) as f:
        trace = json.load(f)
    out = []
    for r in trace:
        if r["phase"] == "train_emulator":
            out.append({"iteration": r["iteration"], "phase": "train",
                        "seconds": r["seconds"], "epochs_run": r.get("epochs_run")})
        elif r["phase"] == "mcmc":
            graphs = r.get("graphs", {})
            out.append({"iteration": r["iteration"], "phase": "mcmc", "method": r["method"],
                        "seconds": r["seconds"], "steps_run": r.get("steps_run"),
                        "graph_replays": graphs.get("replays", 0),
                        "likelihood_calls_replayed": graphs.get("calls", 0)})
    return out


def missed(result: dict) -> list:
    """The pins ``result`` misses."""
    return [name for name, ok in result["pins"].items() if not ok]


def posterior_accuracy_2d_gaussian(outdir: str, device=None, **overrides) -> dict:
    """``test_posterior_accuracy_2d_gaussian``: three annealed iterations
    (600 points each, T = 4, 2, 1, K=2, 400 epochs, emcee at 32 walkers,
    seed 7) against the truncated normal on [-2, 2]."""
    from scipy.stats import truncnorm

    chain, wall, record = _run(dict(
        ntrainArr=[600, 600, 600], nvalArr=[100, 100, 100], nkeepArr=[2, 2, 8],
        ntimesArr=[10, 10, 20], ntautolArr=[0.2, 0.2, 0.1], meanshiftArr=[0.5, 0.5, 0.5],
        stdshiftArr=[0.5, 0.5, 0.5], outdir=outdir, theory=identity_theory,
        priors=PRIORS_2D, data=MEANS_2D, cov=COV_2D,
        init=np.random.default_rng(5).uniform(size=NDIM_2D), pool=None, nwalkers=32,
        dolog10index=None, ypositive=False, temperatureArr=[4.0, 2.0, 1.0], omegab2cut=None,
        params={"trainingoption": 1, "num_epochs": 400, "batch_size": 100, "nensemble": 2},
        method="emcee", seed=7), overrides, device)
    s = np.sqrt(np.diag(COV_2D))
    a, b = (-2 - MEANS_2D) / s, (2 - MEANS_2D) / s
    want_mean = truncnorm.mean(a, b, loc=MEANS_2D, scale=s)
    want_std = truncnorm.std(a, b, loc=MEANS_2D, scale=s)
    mean_err = np.abs(chain.mean(0) - want_mean) / want_std
    std_err = np.abs(chain.std(0) - want_std) / want_std
    return {"chain": chain, "wall_s": wall, "record": record,
            "mean_err_sigma": mean_err.tolist(), "std_err_sigma": std_err.tolist(),
            "pins": {"each mean within 0.25 sigma": bool(np.all(mean_err < 0.25)),
                     "each std within 0.35 sigma": bool(np.all(std_err < 0.35))}}


def gaussian33_posterior_parity(outdir: str, device=None, **overrides) -> dict:
    """``test_gaussian33_posterior_parity``: the 33-dimensional Gaussian
    (``np.random.default_rng(42)`` means, diagonal covariance and start),
    two iterations of 1,200 points, K=2, 400 epochs, zeus at 66 walkers,
    seed 42."""
    rng = np.random.default_rng(42)
    means = rng.uniform(size=NDIM_33)
    cov = np.diag(0.1 * rng.uniform(size=NDIM_33) + 0.02)
    init = rng.uniform(size=NDIM_33)
    priors = [{"param": f"test_{i}", "dist": "flat", "arg1": -5.0, "arg2": 5.0}
              for i in range(NDIM_33)]
    chain, wall, record = _run(dict(
        ntrainArr=[1200, 1200], nvalArr=[200, 200], nkeepArr=[2, 6], ntimesArr=[5, 10],
        ntautolArr=[0.3, 0.2], meanshiftArr=[0.5, 0.4], stdshiftArr=[0.5, 0.4],
        outdir=outdir, theory=identity_theory, priors=priors, data=means, cov=cov, init=init,
        pool=None, nwalkers=66, temperatureArr=[2.0, 1.0],
        params={"trainingoption": 1, "num_epochs": 400, "batch_size": 200, "nensemble": 2},
        method="zeus", seed=42), overrides, device)
    sig = np.sqrt(np.diag(cov))
    mean_err = np.abs(chain.mean(axis=0) - means) / sig
    std_ratio = chain.std(axis=0) / sig
    return {"chain": chain, "wall_s": wall, "record": record,
            "median_mean_err_sigma": float(np.median(mean_err)),
            "max_mean_err_sigma": float(np.max(mean_err)),
            "median_std_ratio": float(np.median(std_ratio)),
            "pins": {"median mean error < 0.7 sigma": bool(np.median(mean_err) < 0.7),
                     "max mean error < 6.0 sigma": bool(np.max(mean_err) < 6.0),
                     "median std ratio in (0.5, 4.0)":
                         bool(0.5 < np.median(std_ratio) < 4.0)}}


def flagship_config_posterior_parity(outdir: str, device=None, **overrides) -> dict:
    """``test_flagship_config_posterior_parity``: DES 3x2pt
    (``examples.des_theory``, 27 -> 457) with data at the fiducial + 0.05,
    two iterations of 2,000 points (T = 4, 1), K=2, 400 epochs, zeus then
    NUTS at 64 walkers, seed 11, against ``EXACT_POSTERIOR.json``."""
    from examples import des_theory as T
    from linna_tpu_torch.driver import read_triplet_cov

    with open(os.path.join(ROOT, "EXACT_POSTERIOR.json")) as f:
        exact = json.load(f)
    e_mean, e_std = np.asarray(exact["exact_mean"]), np.asarray(exact["exact_std"])
    data = T.data_vector(T.fiducial() + 0.05)
    cov = read_triplet_cov(T.cov_triplet_rows(T.noise_sigma(data)))
    priors = [{"param": f"p{i}", "dist": "flat", "arg1": -1.0, "arg2": 1.0}
              for i in range(T.NDIM)]
    chain, wall, record = _run(dict(
        ntrainArr=[2000, 2000], nvalArr=[200, 200], nkeepArr=[2, 5], ntimesArr=[5, 20],
        ntautolArr=[0.05, 0.03], meanshiftArr=[0.3, 0.3], stdshiftArr=[0.2, 0.2],
        outdir=outdir, theory=T.make_theory({}), priors=priors, data=data, cov=cov,
        init=T.fiducial(), pool=None, nwalkers=64, temperatureArr=[4.0, 1.0],
        params={"trainingoption": 1, "num_epochs": 400, "batch_size": 500, "nensemble": 2,
                "epochs_per_dispatch": 50},
        method=["zeus", "nuts"], seed=11, verbose=True), overrides, device)
    bias = np.abs(np.mean(chain, axis=0) - e_mean) / e_std
    width = np.std(chain, axis=0) / e_std
    return {"chain": chain, "wall_s": wall, "record": record,
            "median_bias_sigma": float(np.median(bias)), "max_bias_sigma": float(np.max(bias)),
            "median_width_ratio": float(np.median(width)),
            "pins": {"median bias < 0.35 sigma": bool(np.median(bias) < 0.35),
                     "max bias < 1.2 sigma": bool(np.max(bias) < 1.2),
                     "median width ratio in (0.8, 1.3)":
                         bool(0.8 < np.median(width) < 1.3)}}


# tiny budgets (pins not applied): the tier-1 tests and chip_smoke's phase 15
# rehearsal run each function so, with run_ensemble's convergence checks
# every TINY_CHECK_EVERY steps in place of 100
INF = float("inf")
TINY_CHECK_EVERY = 10


def _cut(n: int) -> dict:
    """``n`` iterations, each sampler stopped at its second convergence
    check (at ``TINY_CHECK_EVERY``-step checks: 20 steps)."""
    return {"ntimesArr": [0] * n, "ntautolArr": [INF] * n, "meanshiftArr": [INF] * n,
            "stdshiftArr": [INF] * n}


TINY_BUDGETS = {
    "posterior_accuracy_2d_gaussian": dict(
        ntrainArr=[40, 40, 40], nvalArr=[10, 10, 10], **_cut(3),
        params={"trainingoption": 1, "num_epochs": 5, "batch_size": 20, "nensemble": 2}),
    "gaussian33_posterior_parity": dict(
        ntrainArr=[80, 80], nvalArr=[20, 20], nwalkers=16, **_cut(2),
        params={"trainingoption": 1, "num_epochs": 3, "batch_size": 40, "nensemble": 2}),
    # one zeus iteration: the 457-wide emulator's range test and NUTS's MAP
    # search cost tens of seconds on one CPU thread
    "flagship_config_posterior_parity": dict(
        ntrainArr=[60], nvalArr=[20], nkeepArr=[2], temperatureArr=[4.0], method=["zeus"],
        nwalkers=16, **_cut(1),
        params={"trainingoption": 1, "num_epochs": 2, "batch_size": 30, "nensemble": 2,
                "epochs_per_dispatch": 50}),
}


ACCEPTANCE = {
    "posterior_accuracy_2d_gaussian": posterior_accuracy_2d_gaussian,
    "gaussian33_posterior_parity": gaussian33_posterior_parity,
    "flagship_config_posterior_parity": flagship_config_posterior_parity,
}
