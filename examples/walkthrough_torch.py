"""Open-and-execute walkthrough through the PyTorch port: sample a 2-D
Gaussian posterior with ``linna_tpu_torch``, inspect the artifacts, retrieve
the trained emulator, and take gradients through it.

The counterpart of ``examples/walkthrough.py`` (the script form of the
reference's ``docs/notebooks/multivariate_gaussian_distribution.ipynb``):
the same toy problem (means [0.1, 1], diagonal covariance, flat [-2, 2]
priors, identity theory), the same reduced 2-iteration schedule, and the
retrieval/gradient demo.

Run:
    python examples/walkthrough_torch.py [outdir] [--device DEV]

on ``cuda:0`` unless ``--device`` names another (``--device cpu`` runs on
the host).  Produces under <outdir> (default ``linna_walkthrough_torch`` in
the temporary directory, ``$TMPDIR`` else ``/tmp``):
    iter_{0,1}/...              the pipeline's file-gated artifacts
    walkthrough_posterior.png   sampled vs analytic draws (with matplotlib)
and prints the emulator's prediction and Jacobian at the posterior mean, the
log-posterior's gradient at whitened 0, and the artifact tree.  Running the
same command again resumes or skips finished stages.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

# runnable from anywhere: the repo root (this file's parent's parent) first
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEFAULT_OUT = os.path.join(tempfile.gettempdir(), "linna_walkthrough_torch")
MEANS = np.array([0.1, 1.0])
COV = np.diag([0.5, 0.2])


def theory(x, outdirs):
    # the "expensive model": here the identity map on the parameters
    return np.asarray(x[1], dtype=np.float64).copy()


def main(outdir: str = DEFAULT_OUT, device=None) -> dict:
    """Run the walkthrough on ``device`` (``cuda:0`` by default); returns the
    chain, the emulator's prediction and Jacobian at the posterior mean, and
    the log-posterior's gradient at whitened 0, as numpy arrays."""
    import torch

    from linna_tpu_torch import ml_sampler_core
    from linna_tpu_torch import priors as P
    from linna_tpu_torch.device import resolve_device
    from linna_tpu_torch.likelihood import make_grad_log_prob, make_log_prob
    from linna_tpu_torch.orchestrator import retrieve_model, retrieve_model_wrapper

    device = resolve_device(device)

    # ---- 1. the problem: a 2-D Gaussian posterior ------------------------
    ndim = 2
    priors = [
        {"param": f"test_{i}", "dist": "flat", "arg1": -2.0, "arg2": 2.0}
        for i in range(ndim)
    ]

    # ---- 2. run LINNA ----------------------------------------------------
    # A reduced 2-iteration schedule (the paper schedule is 4 x 10000; this
    # is a walkthrough, not a production run).
    chain, _ = ml_sampler_core(
        ntrainArr=[400, 400], nvalArr=[80, 80],
        nkeepArr=[2, 4], ntimesArr=[8, 15], ntautolArr=[0.2, 0.1],
        meanshiftArr=[0.5, 0.5], stdshiftArr=[0.5, 0.5],
        outdir=outdir, theory=theory, priors=priors,
        data=MEANS, cov=COV, init=np.zeros(ndim), pool=None,
        nwalkers=24, temperatureArr=[2.0, 1.0],
        params={"trainingoption": 1, "num_epochs": 300, "batch_size": 100},
        method="zeus", seed=3, device=device,
    )
    print(f"chain: {chain.shape}, posterior mean {np.mean(chain, 0).round(3)} "
          f"(truth {MEANS}), std {np.std(chain, 0).round(3)} "
          f"(truth {np.sqrt(np.diag(COV)).round(3)})")

    # ---- 3. check the result: sampled vs analytic draws ------------------
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        ref = np.random.default_rng(0).multivariate_normal(MEANS, COV, len(chain))
        fig, ax = plt.subplots(figsize=(5, 5))
        ax.scatter(chain[:, 0], chain[:, 1], s=2, label="LINNA", alpha=0.4)
        ax.scatter(ref[:, 0], ref[:, 1], s=2, label="analytic", alpha=0.4)
        ax.axvline(MEANS[0], c="r", lw=0.8)
        ax.axhline(MEANS[1], c="r", lw=0.8)
        ax.set_xlabel("test_0")
        ax.set_ylabel("test_1")
        ax.legend()
        fig.savefig(os.path.join(outdir, "walkthrough_posterior.png"), dpi=120)
        plt.close(fig)
        print(f"wrote {outdir}/walkthrough_posterior.png")
    except ImportError:
        print("matplotlib unavailable: skipping the posterior plot")

    # ---- 4. retrieve the trained emulator and differentiate through it ---
    # (the reference's retrieve_model_wrapper_in, linna/util.py:715-734)
    final_dir = os.path.join(outdir, "iter_1/")
    emulator = retrieve_model_wrapper(final_dir, device=device)
    x0 = torch.as_tensor(np.mean(chain, axis=0), dtype=torch.float32, device=device)
    pred = emulator(x0).detach().cpu().numpy()
    jac = torch.func.jacrev(emulator)(x0).detach().cpu().numpy()
    print(f"emulator({x0.cpu().numpy().round(3)}) = {pred.round(3)}")
    print(f"d(emulator)/dx =\n{jac.round(3)}")

    # gradients of the full log-posterior (what HMC and NUTS take)
    trainer = retrieve_model(final_dir, ndim, len(MEANS), device=device)
    pack = P.priors_from_list(priors, device)
    log_prob = make_log_prob(
        trainer.spec, trainer.params, trainer.transforms, pack,
        MEANS, np.linalg.inv(COV), device=device,
    )
    grad = make_grad_log_prob(log_prob)
    x_white = torch.zeros((1, ndim), dtype=torch.float32, device=device)
    g = grad(x_white).cpu().numpy()
    print(f"grad log p at whitened 0: {g[0].round(3)}")

    # ---- 5. the artifact tree (file-gated: every stage resumable) --------
    print(f"\nartifacts under {outdir}:")
    for root, _dirs, files in sorted(os.walk(outdir)):
        rel = os.path.relpath(root, outdir)
        for f in sorted(files):
            print(f"  {os.path.join(rel, f) if rel != '.' else f}")
    return {"chain": chain, "x0": x0.cpu().numpy(), "pred": pred, "jac": jac,
            "grad": g[0]}


if __name__ == "__main__":
    args = sys.argv[1:]
    dev = None
    if "--device" in args:
        i = args.index("--device")
        dev = args[i + 1]
        del args[i:i + 2]
    main(args[0] if args else DEFAULT_OUT, device=dev)
