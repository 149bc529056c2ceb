"""The inputs the benchmark makes from ``--seed`` and hands to both the
program and the reference.  Nothing here imports the program.

- training rows: :mod:`benchmark.theory` (the flagship's stand-in theory),
  drawn from the ``rows`` stream here.
- :func:`sampling_problem`: what ``bench_torch_common.build_problem`` builds,
  made to stand for an analysis: flat priors from the configuration, the
  input standardization of those priors, a seeded diagonal covariance, and
  a data vector that is the emulator's own prediction at a truth point
  drawn from the seed plus noise of that covariance, so the posterior is a
  real, well-placed peak.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import reference as R

# each input draws from a generator of its own, seeded by (seed, stream)
STREAMS = {"rows": 1, "truth": 2, "start": 3, "compare": 4}


def rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng([int(seed), STREAMS[stream]])


def flat_bounds(cfg: dict) -> tuple:
    """(lo, hi) float64 arrays of the configuration's flat priors."""
    lo, hi = cfg["prior"]["arg1"], cfg["prior"]["arg2"]
    if cfg["prior"]["dist"] != "flat":
        raise ValueError("the benchmark's configurations state flat priors")
    return np.full(cfg["ndim"], float(lo)), np.full(cfg["ndim"], float(hi))


def sampling_problem(cfg: dict, members: list, temperature: float, seed: int, device) -> dict:
    """The tensors of one sampling cell, on ``device``:

    - ``lo``, ``hi``: flat prior bounds; ``x_mean``, ``x_std``: the flat
      prior's mean and standard deviation (the input standardization);
    - ``y_mean`` 0 and ``y_std`` 1 (the output destandardization);
    - ``sigma``: sqrt of a diagonal covariance, uniform on
      [``sigma_lo``, ``sigma_hi``] of the configuration; ``inv_cov`` its
      inverse (float64 in ``inv_cov64``);
    - ``truth``: whitened truth, N(0, ``truth_scale``^2) per coordinate;
    - ``data``: the members' mean prediction at the truth plus N(0, cov)
      noise, in float64 (``data64``) and float32;
    - ``temperature``, ``k_std``."""
    lo, hi = flat_bounds(cfg)
    g = rng(seed, "truth")
    ndim, ndata = cfg["ndim"], cfg["ndata"]
    cov = cfg["covariance"]
    sigma = g.uniform(cov["sigma_lo"], cov["sigma_hi"], ndata)
    truth = g.standard_normal(ndim) * cov["truth_scale"]
    noise = g.standard_normal(ndata) * sigma
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    prob = {
        "lo": f32(lo), "hi": f32(hi),
        "x_mean": f32(0.5 * (lo + hi)), "x_std": f32((hi - lo) / math.sqrt(12.0)),
        "y_mean": f32(np.zeros(ndata)), "y_std": f32(np.ones(ndata)),
        "sigma": f32(sigma), "inv_cov64": np.diag(1.0 / sigma**2),
        "temperature": float(temperature), "k_std": float(cfg["ensemble_k_std"]),
        "truth": truth,
    }
    prob["inv_cov"] = f32(prob["inv_cov64"])
    with R.full_f32(), torch.no_grad():
        phys = (0.5 * (1.0 + torch.special.erf(f32(truth) / math.sqrt(2.0)))
                * (prob["hi"] - prob["lo"]) + prob["lo"])
        x_in = ((phys - prob["x_mean"]) / prob["x_std"])[None]
        pred = torch.stack([R.forward(p, x_in)[0] for p in members]).mean(0)
    prob["data64"] = (pred * prob["sigma"]).double().cpu().numpy() + noise
    prob["data"] = f32(prob["data64"])
    return prob
