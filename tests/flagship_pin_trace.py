"""Trace the flagship acceptance pin (``tests/test_flagship_parity.py:40``)
through either package, alone or on another run's iteration 0.

    python tests/flagship_pin_trace.py jax|torch SEEDS OUTDIR
        [from=RUN_DIR keep=emulator|rows] [vary=sampler|train] [device=cuda]

Runs the JAX test's configuration (DES 3x2pt, two iterations of 2,000
points, K=2, 400 epochs, zeus then NUTS at 64 walkers; ``seed`` from SEEDS
in place of the test's 11) in OUTDIR through the JAX package (``jax``, on
the CPU) or the port (``torch``: ``tests/_torch_acceptance.py``'s function,
on ``device``, the CPU by default), and prints one JSON line a seed: the
median and largest |bias| and the median width against
``EXACT_POSTERIOR.json`` (the test's pins: 0.35, 1.2, 0.8-1.3), the signed
bias by parameter, each iteration's sampler steps, the median |bias| of the
final chain's last ``LONG_WINDOW`` steps (the emulator's own bias, with
little of the short kept window's noise) and how far iteration 1's training
rows sit from the exact mean (the median |offset| of their mean, in exact
sigmas).  SEEDS is one seed, a list (``11,14``) or a range (``11-26``);
with more than one, each seed runs in ``OUTDIR/<vary>_<n>`` and a last line
gives the distribution over the seeds.  ``vary=train`` makes SEEDS the
emulator's training seeds instead (``train_emulator``'s ``seed``, 1234 in
both packages whatever the sampler seed), with the sampler seed at the
test's 11: the sampler seed alone leaves every run with one iteration-0
emulator a package.

    python tests/flagship_pin_trace.py summary PATH...

prints that distribution over the runs PATH names: output logs of this
script (their per-seed lines) or finished run directories written as
``RUN_DIR@SEED`` (their final chain read again, kept as
``read_chain_and_cut`` keeps it).

``from=RUN_DIR`` starts from another run of either package: ``keep=emulator``
copies its iteration-0 rows, transforms and trained members (parameters
only), so this run samples that emulator with its own zeus, draws iteration
1's rows from the chain, trains and samples iteration 1; ``keep=rows`` also
copies its iteration-1 rows, so this run trains and samples iteration 1 on
them.  Crossing the packages this way tells the two stages apart: which
package drew the rows, and which trained and sampled on them.  Not a test:
a run takes minutes on the CPU.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [ROOT, HERE]
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

TEST_SEED = 11  # the test's sampler seed
LONG_WINDOW = 300  # final-chain steps of the long-window bias
PIN = 0.35  # the test's median-bias pin
ROWS = ("train_samples_x.txt", "train_samples_y.npy", "val_samples_x.txt", "val_samples_y.npy")


def seed_from(src: str, outdir: str, keep: str) -> None:
    """Copy ``src``'s iteration 0 (rows, transforms, finish marker, the
    members' best parameters) and, with ``keep="rows"``, its iteration-1
    rows into ``outdir``."""
    from linna_tpu_torch.utils import checkpoint as ck

    it0 = os.path.join(outdir, "iter_0")
    os.makedirs(os.path.join(it0, "ens_1"))
    for f in ROWS + ("transforms.npz", "finish.json"):
        shutil.copy(os.path.join(src, "iter_0", f), it0)
    for sub in ("", "ens_1"):
        params, _, meta = ck.load_checkpoint(os.path.join(src, "iter_0", sub, "best.ckpt.npz"),
                                             device="cpu")
        ck.save_checkpoint(os.path.join(it0, sub, "best.ckpt.npz"), params, meta=meta)
        shutil.copy(os.path.join(src, "iter_0", sub, "lr.npy"), os.path.join(it0, sub))
    if keep == "rows":
        os.makedirs(os.path.join(outdir, "iter_1"))
        for f in ROWS:
            shutil.copy(os.path.join(src, "iter_1", f), os.path.join(outdir, "iter_1"))


_TRAIN_EMULATOR = {}


def train_seed(pkg: str, seed: int) -> None:
    """Make ``pkg``'s ``ml_sampler_core`` train its emulators at ``seed``."""
    import functools

    if pkg == "jax":
        from linna_tpu import orchestrator as O
    else:
        from linna_tpu_torch import orchestrator as O
    original = _TRAIN_EMULATOR.setdefault(pkg, O.train_emulator)
    O.train_emulator = functools.partial(original, seed=seed)


def run_jax(outdir: str, seed: int) -> np.ndarray:
    """The JAX test's ``ml_sampler_core`` call at ``seed``; the chain."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from examples import des_theory as T
    from linna_tpu import ml_sampler_core
    from linna_tpu.driver import read_triplet_cov

    data = T.data_vector(T.fiducial() + 0.05)
    cov = read_triplet_cov(T.cov_triplet_rows(T.noise_sigma(data)))
    priors = [{"param": f"p{i}", "dist": "flat", "arg1": -1.0, "arg2": 1.0}
              for i in range(T.NDIM)]
    chain, _ = ml_sampler_core(
        ntrainArr=[2000, 2000], nvalArr=[200, 200], nkeepArr=[2, 5], ntimesArr=[5, 20],
        ntautolArr=[0.05, 0.03], meanshiftArr=[0.3, 0.3], stdshiftArr=[0.2, 0.2],
        outdir=outdir, theory=T.make_theory({}), priors=priors, data=data, cov=cov,
        init=T.fiducial(), pool=None, nwalkers=64, temperatureArr=[4.0, 1.0],
        params={"trainingoption": 1, "num_epochs": 400, "batch_size": 500, "nensemble": 2,
                "epochs_per_dispatch": 50},
        method=["zeus", "nuts"], seed=seed, verbose=True)
    return chain


def parse_seeds(text: str) -> list:
    """``11``, ``11,14`` or ``11-26`` -> the seeds."""
    if "-" in text:
        lo, hi = map(int, text.split("-"))
        return list(range(lo, hi + 1))
    return [int(t) for t in text.split(",")]


def figures(outdir: str, chain: np.ndarray) -> dict:
    """The pins' figures of ``chain`` and the long-window and row figures
    of the run in ``outdir``."""
    from linna_tpu_torch.orchestrator import _open_backend

    with open(os.path.join(ROOT, "EXACT_POSTERIOR.json")) as f:
        exact = json.load(f)
    mean, std = np.asarray(exact["exact_mean"]), np.asarray(exact["exact_std"])
    bias = (chain.mean(0) - mean) / std
    width = chain.std(0) / std
    (store,) = glob.glob(os.path.join(outdir, "iter_1", "*_256.h5*"))
    full = _open_backend(store.removesuffix(".d"), "nuts").get_value("chain_transformed")
    long = full[-LONG_WINDOW:].reshape(-1, full.shape[-1])
    rows = np.loadtxt(os.path.join(outdir, "iter_1", "train_samples_x.txt"))
    with open(os.path.join(outdir, "trace.json")) as f:
        steps = [r.get("steps_run") for r in json.load(f) if r["phase"] == "mcmc"]
    return {"median_bias": float(np.median(np.abs(bias))),
            "max_bias": float(np.max(np.abs(bias))),
            "median_width": float(np.median(width)), "steps": steps,
            "kept_steps": len(chain) // full.shape[1],
            "long_window_median_bias": float(np.median(np.abs((long.mean(0) - mean) / std))),
            "rows_median_offset": float(np.median(np.abs((rows.mean(0) - mean) / std))),
            "signed_bias": bias.round(3).tolist()}


def distribution(results: list) -> dict:
    """The median bias's and the long window's distribution over
    ``results`` (per-seed records)."""
    med = np.array([r["median_bias"] for r in results])
    lw = np.array([r["long_window_median_bias"] for r in results])
    rows = np.array([r["rows_median_offset"] for r in results])
    return {"seeds": [r["seed"] if r.get("vary", "sampler") == "sampler" else r["train_seed"]
                      for r in results],
            "median_bias": med.round(4).tolist(), "mean": float(med.mean()),
            "sd": float(med.std(ddof=1)), "missed": int((med >= PIN).sum()),
            "long_window_mean": float(lw.mean()), "long_window_sd": float(lw.std(ddof=1)),
            "rows_offset_mean": float(rows.mean()), "rows_offset_sd": float(rows.std(ddof=1)),
            "max_bias_missed": int(sum(r["max_bias"] >= 1.2 for r in results)),
            "median_width_mean": float(np.mean([r["median_width"] for r in results]))}


def summary(paths) -> int:
    """Print the distribution over the runs ``paths`` names."""
    from linna_tpu_torch.orchestrator import read_chain_and_cut

    results = []
    for path in paths:
        if "@" in path:
            path, seed = path.rsplit("@", 1)
            (store,) = glob.glob(os.path.join(path, "iter_1", "*_256.h5*"))
            chain, _, _ = read_chain_and_cut(store.removesuffix(".d"), 5, 20, method="nuts",
                                             flat=True)
            results.append({"seed": int(seed), **figures(path, chain)})
        else:
            with open(path) as f:
                results += [json.loads(ln) for ln in f
                            if ln.startswith('{"package"') and '"seeds"' not in ln]
    print(json.dumps(distribution(results)), flush=True)
    return 0


def main(argv) -> int:
    if argv[0] == "summary":
        return summary(argv[1:])
    pkg, seeds, outdir = argv[0], parse_seeds(argv[1]), argv[2]
    kw = dict(a.split("=", 1) for a in argv[3:])
    if os.path.exists(outdir):
        raise FileExistsError(outdir)
    vary = kw.get("vary", "sampler")
    results = []
    for seed in seeds:
        run = outdir if len(seeds) == 1 else os.path.join(outdir, f"{vary}_{seed}")
        if "from" in kw:
            seed_from(kw["from"], run, kw.get("keep", "emulator"))
        sampler_seed = seed
        if vary == "train":
            train_seed(pkg, seed)
            sampler_seed = TEST_SEED
        t0 = time.perf_counter()
        if pkg == "jax":
            chain = run_jax(run, sampler_seed)
        else:
            import _torch_acceptance as A

            chain = A.flagship_config_posterior_parity(run, kw.get("device", "cpu"),
                                                       seed=sampler_seed)["chain"]
        seconds = time.perf_counter() - t0
        rec = {"package": pkg, "seed": sampler_seed, "vary": vary,
               "train_seed": seed if vary == "train" else 1234, "from": kw.get("from"),
               "keep": kw.get("keep") if "from" in kw else None,
               "seconds": round(seconds, 1), **figures(run, chain)}
        results.append(rec)
        print(json.dumps(rec), flush=True)
    if len(seeds) > 1:
        print(json.dumps({"package": pkg, "vary": vary, **distribution(results)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
