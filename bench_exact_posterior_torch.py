"""The exact-posterior reference through the PyTorch port.

    python bench_exact_posterior_torch.py [n_steps] [theory=MODULE] [seed=K] [--device DEV]

The counterpart of ``bench_exact_posterior.py``: it samples the synthetic
analysis's EXACT posterior (the true theory, no emulator) with the port's
NUTS and records the per-parameter exact moments, the emulator-free half of
``bench_full_torch.py``'s gate:

  intrinsic skew = |exact mean - truth| / exact std
  emulator bias  = |flagship mean - exact mean| / exact std  (bench_full_torch)

The exact likelihood is the whitened-space composition the pipeline samples,
with the emulator's prediction replaced by the theory's data vector:
lp(x) = -0.5 (m(phys(x)) - d)^T C^-1 (m(phys(x)) - d) - 0.5 |x|^2, on the
covariance and priors of the class's own inputs and YAML.  The data vector
is a torch mirror of ``SyntheticSurveyTheory.data_vector`` built from the
theory module's instance, so NUTS gets its gradient from autograd.

Runs on ``cuda:0`` (``--device cpu`` on the host): 256 walkers, ``n_steps``
steps (1500 by default) with no convergence checks.  Writes the JSON that
``bench_exact_posterior.py`` writes, with the same keys, to
``linna_<tag>_exact_torch/`` in the temporary directory (``$TMPDIR``, else
``/tmp``; never at the repository root), then prints how far its moments
lie from the stored ``EXACT_POSTERIOR*.json``: the max and median of |port
mean - stored mean| / stored std, and each run's split-half Monte Carlo
error.
"""

from __future__ import annotations

import importlib
import json
import os
import shutil
import sys
import tempfile
from types import SimpleNamespace

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# post-warm-up steps kept; NUTS tau ~ 1 on this posterior, so 256 walkers
# give an ESS of a few 1e5 per parameter: ~0.002 sigma of MC error on a mean
N_STEPS = 1500
NWALKERS = 256
CHECK_EVERY = 250


def survey_theory(T):
    """The one ``SyntheticSurveyTheory`` instance among ``T``'s globals
    (``_DES``, ``_T``, ``_LSST`` in the three example modules)."""
    from examples.des_theory import SyntheticSurveyTheory

    found = {id(v): v for v in vars(T).values() if isinstance(v, SyntheticSurveyTheory)}
    if len(found) != 1:
        raise ValueError(f"{T.__name__} holds {len(found)} SyntheticSurveyTheory instances, "
                         "not one")
    return next(iter(found.values()))


def data_vector_torch(theory, device=None):
    """``theory.data_vector`` as a differentiable torch function of rows
    (..., ndim) -> (..., ndata), in the rows' dtype (float32 or float64),
    from the instance's own ``lin``, ``quad``, ``templates`` and
    ``n_templates``."""
    from linna_tpu_torch.device import resolve_device

    device = resolve_device(device)
    mats = {dt: tuple(torch.as_tensor(a, dtype=dt, device=device)
                      for a in (theory.lin.T, theory.quad.T, theory.templates))
            for dt in (torch.float32, torch.float64)}
    norm = float(np.sqrt(theory.n_templates))

    def data_vector(x: torch.Tensor) -> torch.Tensor:
        lin_t, quad_t, templates = mats[x.dtype]
        u = x @ lin_t
        amps = u + (x * x) @ quad_t + 0.2 * torch.tanh(3.0 * u)
        return (amps @ templates) / norm

    return data_vector


def exact_problem(theory_mod: str, config_yaml: str | None = None, device=None):
    """The class's exact posterior: ``log_prob`` (whitened walkers (W, D) ->
    (W,), float32), the prior pack, the truth and the module.  The priors
    come from the class's YAML (``examples/<tag>_synthetic.yaml``), the
    covariance from the inputs' own recipe."""
    from bench_common import default_config_yaml, theory_tag
    from linna_tpu_torch import priors as P
    from linna_tpu_torch.config import yaml_load
    from linna_tpu_torch.device import resolve_device
    from linna_tpu_torch.driver import read_triplet_cov
    from linna_tpu_torch.likelihood import gaussian_loglike

    device = resolve_device(device)
    T = importlib.import_module(theory_mod)
    truth = T.fiducial() + 0.05
    truth_vec = T.data_vector(truth)
    cov = read_triplet_cov(T.cov_triplet_rows(T.noise_sigma(truth_vec)))
    config_path = os.path.join(HERE, config_yaml or default_config_yaml(theory_tag(theory_mod)))
    prior_list = yaml_load(config_path, parent_dir=os.path.dirname(config_path))["sampled_params"]
    if len(prior_list) != T.NDIM:
        raise ValueError(f"{config_path} defines {len(prior_list)} priors but {theory_mod} "
                         f"has NDIM={T.NDIM}")
    pack = P.priors_from_list(prior_list, device)
    model = data_vector_torch(survey_theory(T), device)
    data = torch.as_tensor(truth_vec, dtype=torch.float32, device=device)
    inv_cov = torch.as_tensor(np.linalg.inv(cov), dtype=torch.float32, device=device)

    def log_prob(x: torch.Tensor) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        lp = gaussian_loglike(model(P.transform(pack, x)), data, inv_cov) + P.lnprior(x)
        return torch.where(torch.isnan(lp), torch.full_like(lp, -torch.inf), lp)

    return SimpleNamespace(log_prob=log_prob, pack=pack, truth=truth, T=T)


def moments(full: np.ndarray, truth: np.ndarray) -> dict:
    """``bench_exact_posterior.py``'s statistics of a (steps, walkers, dim)
    physical-space chain after a 20% burn-in: mean, std, skew against the
    truth and the split-half MC error of the mean, in sigma."""
    kept = full[len(full) // 5:]
    flat = kept.reshape(-1, full.shape[-1])
    mean, std = np.mean(flat, axis=0), np.std(flat, axis=0)
    h1, h2 = np.array_split(kept, 2)
    mc_err = np.abs(np.mean(h1.reshape(-1, full.shape[-1]), 0)
                    - np.mean(h2.reshape(-1, full.shape[-1]), 0)) / (2.0 * std)
    return {"mean": mean, "std": std, "skew": np.abs(mean - truth) / std, "mc_err": mc_err}


def compare_with_stored(result: dict, stored_path: str) -> dict:
    """|this run's exact mean - the stored exact mean| / stored exact std,
    max and median, beside each run's split-half MC error."""
    with open(stored_path) as f:
        stored = json.load(f)
    diff = np.abs(np.asarray(result["exact_mean"]) - np.asarray(stored["exact_mean"])) / (
        np.asarray(stored["exact_std"]))
    return {
        "stored": os.path.basename(stored_path),
        "max_mean_diff_sigma": float(np.max(diff)),
        "median_mean_diff_sigma": float(np.median(diff)),
        "split_half_mc_err_sigma_max": {"this_run": result["split_half_mc_err_sigma_max"],
                                        "stored": stored["split_half_mc_err_sigma_max"]},
        "n_steps": {"this_run": result["n_steps"], "stored": stored["n_steps"]},
    }


def main(
    n_steps: int = N_STEPS,
    seed: int = 7,
    theory_mod: str = "examples.des_theory",
    device=None,
    outdir: str | None = None,
    stored_path: str | None = None,
    config_yaml: str | None = None,
) -> dict:
    """Sample the exact posterior and write its JSON under ``outdir``
    (default ``linna_<tag>_exact_torch`` in the temporary directory);
    returns the result with ``bench_exact_posterior.py``'s keys, and where
    ``stored_path`` (default the repository's ``EXACT_POSTERIOR*.json`` of
    the class) exists, the comparison with it under ``against_stored``."""
    from bench_common import exact_posterior_filename, theory_tag
    from linna_tpu_torch import priors as P
    from linna_tpu_torch.device import resolve_device
    from linna_tpu_torch.samplers import run as sampler_run
    from linna_tpu_torch.samplers.backends import EmceeBackend

    device = resolve_device(device)
    tag = theory_tag(theory_mod)
    outdir = outdir or os.path.join(tempfile.gettempdir(), f"linna_{tag}_exact_torch")
    stored_path = stored_path or os.path.join(HERE, exact_posterior_filename(tag))
    prob = exact_problem(theory_mod, config_yaml, device)
    ndim = prob.T.NDIM

    rng = np.random.default_rng(seed)
    center = P.inv_transform(prob.pack, torch.as_tensor(prob.truth, dtype=torch.float32,
                                                        device=device)).cpu().numpy()
    x0 = center + 0.01 * rng.standard_normal((NWALKERS, ndim))

    if os.path.isdir(outdir):
        shutil.rmtree(outdir)
    sampler_run.run_ensemble(
        prob.log_prob,
        x0.astype(np.float32),
        outdir,
        method="nuts",
        transform=lambda c: P.transform_np(prob.pack, c),
        # a fixed length: no tau checks at all
        convergence_check=False,
        max_iterations=n_steps,
        check_every=min(CHECK_EVERY, n_steps),
        seed=seed,
        progress=True,
        device=device,
    )

    full = EmceeBackend(os.path.join(outdir, sampler_run.EMCEE_FILENAME)).get_value(
        "chain_transformed")
    m = moments(full, prob.truth)
    result = {
        "metric": "exact_posterior_reference",
        "sampler": "nuts",
        "n_steps": int(len(full)),
        "nwalkers": NWALKERS,
        "exact_mean": [round(float(v), 6) for v in m["mean"]],
        "exact_std": [round(float(v), 6) for v in m["std"]],
        "truth": [round(float(v), 6) for v in prob.truth],
        "intrinsic_skew_sigma": [round(float(v), 4) for v in m["skew"]],
        "max_intrinsic_skew_sigma": round(float(np.max(m["skew"])), 4),
        "median_intrinsic_skew_sigma": round(float(np.median(m["skew"])), 4),
        "split_half_mc_err_sigma_max": round(float(np.max(m["mc_err"])), 4),
        "note": "exact-likelihood NUTS on the flagship posterior; "
        "intrinsic_skew_sigma is what a PERFECT emulator would score on "
        "bench_full's |mean-truth|/std metric",
    }
    with open(os.path.join(outdir, exact_posterior_filename(tag)), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items() if "exact_" not in k}), flush=True)
    if os.path.isfile(stored_path):
        result["against_stored"] = compare_with_stored(result, stored_path)
        print(json.dumps({"against_stored": result["against_stored"]}), flush=True)
    return result


if __name__ == "__main__":
    # CLI: [n_steps] [theory=MODULE] [seed=K] [--device DEV]; anything else is an error
    kw = {}
    args = sys.argv[1:]
    while args:
        arg = args.pop(0)
        if arg == "--device":
            kw["device"] = args.pop(0)
        elif arg.startswith("theory="):
            kw["theory_mod"] = arg.partition("=")[2]
        elif arg.startswith("seed="):
            kw["seed"] = int(arg.partition("=")[2])
        elif arg.isdigit():
            kw["n_steps"] = int(arg)
        else:
            raise SystemExit(f"unknown argument {arg!r}; usage: bench_exact_posterior_torch.py "
                             "[n_steps] [theory=MOD] [seed=K] [--device DEV]")
    main(**kw)
