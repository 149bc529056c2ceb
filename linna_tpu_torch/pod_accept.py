"""One-command acceptance run of the multi-process design, on the port's
collective census.

Counterpart of ``examples/pod_accept.py``:

    python -m linna_tpu_torch.pod_accept [--structural] [--max-bias S] [--max-wall T]
                                         [--device DEV] [--backend B]

started once per rank, with the cluster in the environment as for
:mod:`linna_tpu_torch.launch` (one process needs none).  Gates, JAX's
thresholds:

1. Sampler census (:func:`linna_tpu_torch.parallel.census.sampler_collective_census`):
   emcee (stretch) and zeus (slice) chunks make at most 2 collectives a
   step (the two complementary-half all-gathers), HMC and NUTS none.
2. Trainer census: the K=2 training epochs make no collective that
   crosses the ``ens`` axis.
3. The flagship gate (left out under ``--structural``): the DES-3x2pt-shaped
   synthetic analysis of ``examples/des_synthetic.yaml`` (the JAX script's
   recipe: 2 iterations of 4,000 / 400 points, K=2, zeus then NUTS) runs
   end to end; the posterior's median bias against ``EXACT_POSTERIOR.json``
   stays under ``--max-bias`` sigma (the worst under 5x that) and the wall
   under ``--max-wall`` seconds.

Rank 0 prints one JSON line, the verdict; the exit code is 0 on a pass and
1 on any miss.  On one process every census counts nothing (no process
group), as JAX's does on one device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Optional, Sequence

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLER_LIMITS = {"emcee": 2, "zeus": 2, "hmc": 0, "nuts": 0}


def structural_gates(report: dict, device) -> bool:
    """Gates 1 and 2; fills ``report["structural"]``."""
    from .parallel import census as CE
    from .parallel import multihost as MH

    sam = CE.sampler_collective_census(walkers=max(16 * MH.process_count(), 64), device=device)
    verdicts = {}
    ok = True
    for method, limit in SAMPLER_LIMITS.items():
        n = sum(sam[method]["per_step"].values())
        verdicts[method] = {"per_step_collectives": n, "limit": limit, "pass": n <= limit}
        ok &= n <= limit
    trn = CE.trainer_collective_census(k=2, device=device)
    trainer_pass = trn["cross_member_collectives"] == 0
    report["structural"] = {
        "world": sam["world"],
        "sampler": verdicts,
        "trainer": {**trn, "pass": trainer_pass},
    }
    return bool(ok and trainer_pass)


def flagship_gate(report: dict, max_bias: float, max_wall: float, device) -> bool:
    """Gate 3: the flagship synthetic analysis end to end."""
    import numpy as np

    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from examples import des_theory as T

    from . import ml_sampler_core
    from .driver import read_triplet_cov
    from .parallel import multihost as MH

    with open(os.path.join(ROOT, "EXACT_POSTERIOR.json")) as f:
        exact = json.load(f)
    e_mean, e_std = np.asarray(exact["exact_mean"]), np.asarray(exact["exact_std"])
    truth = T.fiducial() + 0.05
    data = T.data_vector(truth)
    cov = read_triplet_cov(T.cov_triplet_rows(T.noise_sigma(data)))
    priors = [{"param": f"p{i}", "dist": "flat", "arg1": -1.0, "arg2": 1.0}
              for i in range(T.NDIM)]
    outdir = os.environ.get("LINNA_ACCEPT_OUTDIR",
                            os.path.join(tempfile.gettempdir(), "pod_accept_out"))
    t0 = time.perf_counter()
    chain, _ = ml_sampler_core(
        ntrainArr=[4000, 4000], nvalArr=[400, 400], nkeepArr=[2, 5],
        ntimesArr=[5, 20], ntautolArr=[0.05, 0.03],
        meanshiftArr=[0.3, 0.2], stdshiftArr=[0.2, 0.15],
        outdir=outdir, theory=T.make_theory({}), priors=priors,
        data=data, cov=cov, init=T.fiducial(), pool=None, nwalkers=128,
        temperatureArr=[4.0, 1.0], device=device,
        params={"trainingoption": 1, "num_epochs": 1000, "batch_size": 500,
                "nensemble": 2, "epochs_per_dispatch": 50},
        method=["zeus", "nuts"], seed=11,
    )
    wall = time.perf_counter() - t0
    bias = np.abs(np.mean(chain, axis=0) - e_mean) / e_std
    med, worst = float(np.median(bias)), float(np.max(bias))
    ok = med < max_bias and worst < 5 * max_bias and wall < max_wall
    report["flagship"] = {
        "wall_s": wall, "max_wall_s": max_wall, "median_bias_sigma": med,
        "worst_bias_sigma": worst, "max_bias_sigma": max_bias,
        "n_ranks": MH.process_count(), "pass": ok,
    }
    return ok


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m linna_tpu_torch.pod_accept",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--structural", action="store_true", help="census gates only")
    ap.add_argument("--max-bias", type=float, default=0.1,
                    help="median posterior bias gate in sigma (worst 5x)")
    ap.add_argument("--max-wall", type=float, default=3600.0,
                    help="flagship wall-clock gate in seconds")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:<LOCAL_RANK>, else cuda:0)")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="torch.distributed backend (default nccl on a card, gloo on the CPU)")
    args = ap.parse_args(argv)

    from .device import resolve_device
    from .parallel import multihost as MH

    device = resolve_device(args.device or f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{device} was asked for and no CUDA device is available; "
                           "pass --device cpu to run on the CPU")
    MH.initialize(backend=args.backend, device=device)
    report: dict = {"metric": "pod_acceptance", "device": str(device)}
    ok = structural_gates(report, device)
    if not args.structural:
        ok &= flagship_gate(report, args.max_bias, args.max_wall, device)
    report["pass"] = bool(ok)
    if MH.is_primary():
        print(json.dumps(report), flush=True)
    MH.shutdown()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
