"""The flagship accuracy gate through the PyTorch port: the synthetic
DES-Y1-3x2pt analysis end to end on one CUDA card.

    python bench_full_torch.py [--resume] [--check | check=X] [out=FILE.json]
        [theory=MODULE] [yaml=CONFIG] [--device DEV] [key=value ...]

The counterpart of ``bench_full.py``.  It runs ``examples/des_synthetic.yaml``
(27 parameters -> 457-point data vector, the paper's 4-iteration annealed
schedule, a 2-member emulator ensemble) through
``linna_tpu_torch.driver.run_from_config`` on ``cuda:0`` (``--device cpu``
runs the plain PyTorch versions on the host), then reports:

- the wall-clock and the per-phase seconds from ``trace.json``;
- the split Gelman-Rubin R-hat of the final iteration's chain, extended
  (the chain file resumes) until R - 1 < 0.01 or 12 polish rounds;
- the posterior accuracy: |mean - truth| / sigma per parameter (the
  synthetic truth is +0.05 in every coordinate), and where the stored
  exact-likelihood posterior exists (``EXACT_POSTERIOR.json``, or
  ``EXACT_POSTERIOR_<TAG>.json``), the emulator bias |chain mean - exact
  mean| / exact std.

``--check`` (threshold 0.1 sigma; ``check=X`` for another) exits 1 when the
max emulator bias (the posterior error where no exact posterior exists) is
above the threshold.  ``key=value`` entries override the YAML config (e.g.
``nensemble=1 use_fused=true``).  ``theory=examples.lsst_theory
yaml=examples/lsst_synthetic.yaml`` runs the LSST-Y10-6x2pt+N class (40 ->
1560), ``theory=examples.des4x2ptn_theory
yaml=examples/des4x2ptn_synthetic.yaml`` the DES 4x2pt+N class (31 -> 630).

Nothing is written at the repository root: the run goes to
``linna_<tag>_bench_torch`` in the temporary directory (``$TMPDIR``, else
``/tmp``; removed first unless ``--resume``), its inputs to
``linna_<tag>_inputs_torch`` beside it, and the result JSON to
``FLAGSHIP_torch.json`` inside the run directory (a relative ``out=`` is
taken there too).  An ``out`` outside the run directory that exists already
is refused.  Prints the card's name and power limit, then the result as one
JSON line.
"""

from __future__ import annotations

import faulthandler
import importlib
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

CHECK_SIGMA = 0.1
POLISH_TARGET = 0.01  # split R - 1 of the final chain
POLISH_ROUNDS = 12
POLISH_STEPS = 2000
RESULT_FILE = "FLAGSHIP_torch.json"


def write_inputs(T, indir: str):
    """``examples/make_des_inputs.py``'s recipe for ``T``: the noiseless data
    vector at the truth (fiducial + 0.05) and the banded covariance, as
    ``data.txt`` and ``cov_triplet.txt``.  Returns (truth, data, dense cov)."""
    from linna_tpu_torch.driver import read_triplet_cov

    os.makedirs(indir, exist_ok=True)
    truth = T.fiducial() + 0.05
    data = T.data_vector(truth)
    np.savetxt(os.path.join(indir, "data.txt"), np.stack([np.arange(T.NDATA), data], 1))
    rows = T.cov_triplet_rows(T.noise_sigma(data))
    np.savetxt(os.path.join(indir, "cov_triplet.txt"), rows)
    return truth, data, read_triplet_cov(rows)


def split_rhat(chain: np.ndarray) -> np.ndarray:
    """Split R-hat per parameter of a (steps, walkers, dim) chain after a
    20% burn-in."""
    from linna_tpu_torch.samplers import convergence

    return convergence.gelman_rubin(chain[len(chain) // 5:], split=True)


def phase_seconds(outdir: str) -> dict:
    """Seconds by phase name, summed over the iterations of ``trace.json``."""
    phases: dict = {}
    path = os.path.join(outdir, "trace.json")
    if not os.path.isfile(path):
        return phases
    try:
        with open(path) as f:
            for rec in json.load(f):
                phases[rec["phase"]] = phases.get(rec["phase"], 0.0) + rec.get("seconds", 0.0)
    except (OSError, ValueError):
        # a torn trace must not fail a finished run: the breakdown is a report
        phases = {"_corrupt_trace": 1.0}
    return phases


def precond_line(final_dir: str) -> None:
    """Print the spectrum of a gradient sampler's preconditioner in
    ``final_dir``, where there is one: the directions the MAP Hessian gave
    no positive curvature (unit scale) and the smallest and largest scales.
    A preconditioner with such directions leaves NUTS a small step size."""
    from linna_tpu_torch.samplers import run as sampler_run

    path = os.path.join(final_dir, sampler_run.PRECOND_FILENAME)
    if not os.path.isfile(path):
        return
    scales = np.sort(np.load(path)["scales"])
    print(f"preconditioner: {int(np.sum(scales == 1.0))} of {len(scales)} directions at "
          f"unit scale; scales {scales[0]:.4g} .. {scales[-1]:.4g}", flush=True)


def main(
    fresh: bool = True,
    overrides: dict | None = None,
    out: str | None = None,
    theory_mod: str = "examples.des_theory",
    config_yaml: str = "examples/des_synthetic.yaml",
    check: float | None = None,
    device=None,
    exact_path: str | None = None,
    outdir: str | None = None,
    indir: str | None = None,
    polish_rounds: int = POLISH_ROUNDS,
    polish_steps: int = POLISH_STEPS,
) -> dict:
    """Run the analysis and return ``bench_full.py``'s result object.

    ``exact_path``: the stored exact posterior (default the repository's
    file for this class); ``outdir`` / ``indir``: the run and input
    directories; ``polish_rounds`` / ``polish_steps``: the R-hat polish's
    most rounds and steps a round.  Exits 1 under ``check`` when the gate
    fails."""
    from bench_common import exact_posterior_filename, theory_tag
    from bench_torch_common import card_line
    from linna_tpu_torch import driver
    from linna_tpu_torch import orchestrator as O
    from linna_tpu_torch import priors as P
    from linna_tpu_torch.config import yaml_load
    from linna_tpu_torch.device import resolve_device
    from linna_tpu_torch.samplers import run as sampler_run

    device = resolve_device(device)
    tag = theory_tag(theory_mod)
    outdir = outdir or os.path.join(tempfile.gettempdir(), f"linna_{tag}_bench_torch")
    indir = indir or os.path.join(tempfile.gettempdir(), f"linna_{tag}_inputs_torch")
    exact_path = exact_path or os.path.join(HERE, exact_posterior_filename(tag))
    out_path = os.path.abspath(os.path.join(outdir, out or RESULT_FILE))
    if (os.path.exists(out_path)
            and os.path.commonpath([out_path, os.path.abspath(outdir)]) != os.path.abspath(outdir)):
        raise FileExistsError(f"{out_path} exists; bench_full_torch.py never overwrites a file "
                              "outside its run directory")
    print(f"device: {card_line(device)}", flush=True)

    # every 5 minutes, all threads' stacks: a phase that hangs shows where
    faulthandler.dump_traceback_later(300, repeat=True, file=sys.__stderr__)
    try:
        T = importlib.import_module(theory_mod)
        truth, data, cov = write_inputs(T, indir)
        if fresh and os.path.isdir(outdir):
            shutil.rmtree(outdir)

        config_path = config_yaml if os.path.isabs(config_yaml) else os.path.join(HERE, config_yaml)
        # include: resolves against the config's own directory
        params = yaml_load(config_path, parent_dir=os.path.dirname(config_path))
        params["outdir"] = outdir
        params["base_dir"] = indir
        params.update(overrides or {})

        t0 = time.time()
        driver.run_from_config(params, method="zeus", verbose=True, device=device)
        wall = time.time() - t0
        phases = phase_seconds(outdir)

        # the final chain, in the file its iteration's sampler writes
        last_iter = len(params["ntrainArr"]) - 1
        final_dir = os.path.join(outdir, f"iter_{last_iter}/")
        m_arr = params.get("methodArr")
        final_method = m_arr[last_iter] if m_arr else "zeus"
        backend = O._open_backend(os.path.join(final_dir, O._chain_filename(final_method)),
                                  final_method)
        rhat = split_rhat(backend.get_value("chain_transformed"))
        precond_line(final_dir)

        # the tau * ntimes criterion stops near R - 1 ~ 0.04; the chain file
        # resumes, so extend the final chain until R - 1 < 0.01, with the
        # sampler's own tau checks off and large chunks
        t_polish0 = time.time()
        rounds = 0
        log_prob = pack = None
        while np.max(rhat) - 1.0 > POLISH_TARGET and rounds < polish_rounds:
            rounds += 1
            if log_prob is None:  # the emulator and priors are fixed: built once
                # the likelihood ml_sampler_core sampled the iteration with
                log_prob, pack, _ = O.iteration_log_prob(
                    final_dir, driver.priors_and_init_from_config(params)[0], data,
                    np.linalg.inv(cov), float(params["temperatureArr"][-1]) ** 2,
                    params.get("nnmodel", "chto_v2"), params,
                    external_loglike=driver.external_loglike_from_config(params),
                    device=device)
            sampler_run.run_ensemble(
                log_prob,
                backend.get_last_sample(),
                final_dir,
                method=final_method,
                transform=lambda x, _p=pack: P.transform_np(_p, x),
                max_iterations=backend.iteration + polish_steps,
                convergence_check=False,
                check_every=min(500, polish_steps),
                seed=100 + rounds,
                device=device,
            )
            rhat = split_rhat(backend.get_value("chain_transformed"))
        polish_s = time.time() - t_polish0
    finally:
        faulthandler.cancel_dump_traceback_later()

    # accuracy on the (polished) final chain, after the same burn-in
    full = backend.get_value("chain_transformed")
    flat = full[len(full) // 5:].reshape(-1, T.NDIM)
    post_mean = np.mean(flat, axis=0)
    post_std = np.std(flat, axis=0)
    err_sigma = np.abs(post_mean - truth) / post_std

    # |mean - truth| holds the exact posterior's own skew too; against the
    # exact-likelihood moments only the emulator's part is left
    emu_bias = None
    if os.path.isfile(exact_path):
        with open(exact_path) as f:
            exact = json.load(f)
        emu_bias = np.abs(post_mean - np.asarray(exact["exact_mean"])) / np.asarray(
            exact["exact_std"])

    result = {
        "metric": f"{tag}_synthetic_wallclock",
        "value": round(wall, 1),
        "unit": "s",
        "phases_s": {k: round(v, 1) for k, v in phases.items()},
        "max_split_rhat": round(float(np.max(rhat)), 4),
        "polish_to_rhat_s": round(polish_s, 1),
        "polish_rounds": rounds,
        "max_posterior_err_sigma": round(float(np.max(err_sigma)), 3),
        "median_posterior_err_sigma": round(float(np.median(err_sigma)), 3),
        **(
            {
                "max_emulator_bias_sigma": round(float(np.max(emu_bias)), 3),
                "median_emulator_bias_sigma": round(float(np.median(emu_bias)), 3),
            }
            if emu_bias is not None
            else {}
        ),
        "final_chain_steps": int(len(full)),
        "nwalkers": int(full.shape[1]),
        "ndim": T.NDIM,
        "ndata": T.NDATA,
        # from the merged config, not a fixed schedule (yaml= is the user's)
        "config": (
            f"{config_yaml} ({len(params['ntrainArr'])} iterations x "
            f"{params['ntrainArr'][0]}, T^2="
            f"{','.join(str(round(t**2)) for t in params['temperatureArr'])}, "
            f"nensemble={params.get('nensemble', 1)}, "
            f"{params['nwalkers']} walkers)"
        )
        + (f" + overrides {overrides}" if overrides else ""),
    }
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)

    if check is not None:
        if emu_bias is not None:
            metric, name = emu_bias, "emulator bias (vs exact posterior)"
        else:
            metric, name = err_sigma, "posterior error (vs synthetic truth)"
        worst = float(np.max(metric))
        ok = worst <= check
        print(
            f"CHECK {'PASS' if ok else 'FAIL'}: max {name} = {worst:.3f} "
            f"sigma (threshold {check}); median {float(np.median(metric)):.3f}",
            flush=True,
        )
        if not ok:
            sys.exit(1)
    return result


def parse_args(argv):
    """``bench_full.py``'s command line plus ``--device DEV``: the keyword
    arguments of :func:`main`."""
    kw = {"fresh": "--resume" not in argv, "overrides": {},
          "check": CHECK_SIGMA if "--check" in argv else None}
    args = list(argv)
    while args:
        arg = args.pop(0)
        if arg == "--device":
            kw["device"] = args.pop(0)
            continue
        if arg in ("--resume", "--check") or "=" not in arg:
            continue
        k, _, v = arg.partition("=")
        if k == "out":
            kw["out"] = v
        elif k == "theory":
            kw["theory_mod"] = v
        elif k == "yaml":
            kw["config_yaml"] = v
        elif k == "check":
            kw["check"] = float(v)
        else:
            try:
                v = json.loads(v)
            except json.JSONDecodeError:
                pass
            kw["overrides"][k] = v
    return kw


if __name__ == "__main__":
    main(**parse_args(sys.argv[1:]))
