"""Both packages' NUTS on one trained emulator, on the CPU.

    JAX_PLATFORMS=cpu python tests/nuts_preconditioner_parity.py ITER_DIR
        [steps=300] [walkers=256] [theory=examples.lsst_theory]
        [yaml=examples/lsst_synthetic.yaml] [only=jax|torch] [device=cpu]

``ITER_DIR`` holds a K=2 iteration's emulator as either package writes it
(``transforms.npz``, ``best.ckpt.npz`` and ``ens_1/best.ckpt.npz``).  Its
likelihood at T = 1 goes through each package's
``run_ensemble(method="nuts")`` from the pipeline's start (the walkers at
whitened 0, jittered by 0.001, as ``ml_sampler_core`` starts them), with no
convergence checks, for ``steps`` steps.  For each package it prints the
preconditioner the MAP search gave (its unit-scale directions, the smallest
and largest scales), tau per parameter over the chain after a 20 % burn-in,
the emulator bias |chain mean - exact mean| / exact std against the stored
``EXACT_POSTERIOR*.json`` of the class, and the members' log-likelihood gap
|lp_1 - lp_2| at the MAP centre and its median over the chain's last
sample (at K=2 the ensemble's chi^2 is the larger member's, so a gap near 0
puts the centre on the kink between them); then the centres' distance.
``only=torch`` runs the port alone, on ``device`` (a card where given), and
imports no JAX.  Not a test: it runs a full-width emulator for minutes.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402


def problem(theory_mod: str, config_yaml: str):
    """(T, data, inv_cov, priors, exact) of the class: ``bench_full``'s
    inputs and the stored exact posterior."""
    import importlib

    from bench_common import exact_posterior_filename, theory_tag
    from linna_tpu_torch.config import yaml_load
    from linna_tpu_torch.driver import read_triplet_cov

    T = importlib.import_module(theory_mod)
    data = T.data_vector(T.fiducial() + 0.05)
    inv_cov = np.linalg.inv(read_triplet_cov(T.cov_triplet_rows(T.noise_sigma(data))))
    path = os.path.join(ROOT, config_yaml)
    priors = yaml_load(path, parent_dir=os.path.dirname(path))["sampled_params"]
    with open(os.path.join(ROOT, exact_posterior_filename(theory_tag(theory_mod)))) as f:
        exact = json.load(f)
    return T, data, inv_cov, priors, exact


def run_jax(d, T, data, inv_cov, priors, x0, steps, outdir, device):
    """The JAX package's run; returns (backend, members' lp on rows)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from linna_tpu import likelihood as LK
    from linna_tpu import orchestrator as O
    from linna_tpu import priors as P
    from linna_tpu.samplers import run as R

    model = O.retrieve_model(d, T.NDIM, T.NDATA)
    members = O.retrieve_ensemble_params(d, model)
    pack = P.priors_from_list(priors)
    lp = LK.make_log_prob(model.spec, members, model.transforms, pack, data, inv_cov)
    singles = [LK.make_log_prob(model.spec, m, model.transforms, pack, data, inv_cov)
               for m in members]
    backend = R.run_ensemble(lp, x0, outdir, method="nuts",
                             transform=lambda x: P.transform_np(pack, x),
                             convergence_check=False, max_iterations=steps,
                             check_every=min(100, steps), seed=0, progress=True)
    return backend, lambda x: [np.asarray(s(np.asarray(x, np.float32))) for s in singles]


def run_torch(d, T, data, inv_cov, priors, x0, steps, outdir, device):
    """The port's run on ``device``; returns (backend, members' lp on rows)."""
    import torch

    from linna_tpu_torch import likelihood as LK
    from linna_tpu_torch import orchestrator as O
    from linna_tpu_torch import priors as P
    from linna_tpu_torch.samplers import run as R

    model = O.retrieve_model(d, T.NDIM, T.NDATA, device=device)
    members = O.retrieve_ensemble_params(d, model)
    pack = P.priors_from_list(priors, device)

    def make(p):
        return LK.make_log_prob(model.spec, p, model.transforms, pack, data, inv_cov,
                                device=device)

    lp, singles = make(members), [make(m) for m in members]
    backend = R.run_ensemble(lp, x0, outdir, method="nuts",
                             transform=lambda x: P.transform_np(pack, x),
                             convergence_check=False, max_iterations=steps,
                             check_every=min(100, steps), seed=0, progress=True, device=device)

    def member_lps(x):
        with torch.no_grad():
            xt = torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)
            return [s(xt).cpu().numpy() for s in singles]

    return backend, member_lps


def report(who, outdir, backend, member_lps, exact, seconds) -> dict:
    from linna_tpu_torch.samplers import convergence

    pre = np.load(os.path.join(outdir, "precond.npz"))
    scales = np.sort(pre["scales"])
    chain = backend.get_value("chain_transformed")
    kept = chain[len(chain) // 5:]
    tau = convergence.integrated_time(kept)
    flat = kept.reshape(-1, kept.shape[-1])
    bias = np.abs(flat.mean(0) - np.asarray(exact["exact_mean"])) / np.asarray(
        exact["exact_std"])

    def gap(x):
        lp1, lp2 = member_lps(x)[:2]
        return np.abs(lp1 - lp2)

    out = {
        "package": who,
        "seconds": round(seconds, 1),
        "steps": int(len(chain)),
        "unit_scale_directions": int(np.sum(scales == 1.0)),
        "scales_min_max": [float(scales[0]), float(scales[-1])],
        "tau_min_median_max": [float(np.min(tau)), float(np.median(tau)), float(np.max(tau))],
        "bias_max_median": [float(np.max(bias)), float(np.median(bias))],
        "member_gap_at_map": float(gap(pre["center"][None])[0]),
        "member_gap_median_last": float(np.median(gap(backend.get_chain()[-1]))),
    }
    print(json.dumps(out), flush=True)
    return out


def main(argv) -> int:
    d = argv[0]
    kw = dict(a.split("=", 1) for a in argv[1:])
    steps, walkers = int(kw.get("steps", 300)), int(kw.get("walkers", 256))
    T, data, inv_cov, priors, exact = problem(kw.get("theory", "examples.lsst_theory"),
                                              kw.get("yaml", "examples/lsst_synthetic.yaml"))
    x0 = (0.001 * np.random.default_rng(0).standard_normal((walkers, T.NDIM))).astype(np.float32)
    only = kw.get("only")
    centres = {}
    for who, run in (("jax", run_jax), ("torch", run_torch)):
        if only and who != only:
            continue
        outdir = tempfile.mkdtemp(prefix=f"nuts_parity_{who}_")
        t0 = time.perf_counter()
        backend, member_lps = run(d, T, data, inv_cov, priors, x0, steps, outdir,
                                  kw.get("device", "cpu"))
        report(who, outdir, backend, member_lps, exact, time.perf_counter() - t0)
        centres[who] = np.load(os.path.join(outdir, "precond.npz"))["center"]
    if len(centres) == 2:
        print(json.dumps({"centres_max_abs_apart": float(np.max(np.abs(
            centres["jax"] - centres["torch"])))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
