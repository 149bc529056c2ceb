"""Gradient-sampler demo on the trained flagship emulator, through the
PyTorch port.

The counterpart of ``examples/nuts_flagship_demo.py``: NUTS in the MAP
Hessian's eigenbasis against the zeus-style ensemble slice sampler on the
SAME trained emulator posterior.  Run ``python bench_full_torch.py`` first,
so that the flagship's iterations exist under ``linna_des_bench_torch`` in
the temporary directory (``$TMPDIR``, else ``/tmp``).

    python examples/nuts_flagship_demo_torch.py [--device DEV]

Reads the last iteration's emulator (``iter_3``) and chain, opened by the
method that iteration sampled with (NUTS in ``examples/des_synthetic.yaml``,
whose chain file is ``chemcee_256.h5``), and the inputs'
``data.txt`` and ``cov_triplet.txt``.  Prints the MAP search's seconds,
each sampler's tau, ESS per second and the NUTS/slice ratio, and the largest
difference of the two posterior means in slice standard deviations.  Both
samplers run their eager chunk functions, timed with
``torch.cuda.synchronize()`` on a card.
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from linna_tpu_torch import likelihood as LK
from linna_tpu_torch import orchestrator as O
from linna_tpu_torch import priors as P
from linna_tpu_torch.device import resolve_device
from linna_tpu_torch.samplers import convergence, hmc, precondition, slicemove

# bench_full_torch.py's default run and input directories for the DES class
OUT = os.path.join(tempfile.gettempdir(), "linna_des_bench_torch", "iter_3")
INDIR = os.path.join(tempfile.gettempdir(), "linna_des_inputs_torch")
NDIM, W = 27, 256


def load_posterior(outdir, indir, ndim, method, nwalkers, device):
    """The iteration's emulator likelihood (flat [-1, 1] priors, T = 1) and
    ``nwalkers`` starts drawn from the second half of its chain."""
    data = np.loadtxt(os.path.join(indir, "data.txt"))[:, 1]
    ndata = len(data)
    trainer = O.retrieve_model(outdir, ndim, ndata, device=device)
    members = O.retrieve_ensemble_params(outdir, trainer)
    rows = np.loadtxt(os.path.join(indir, "cov_triplet.txt"))
    cov = np.zeros((ndata, ndata))
    for i, j, _, v in rows:
        cov[int(i), int(j)] = cov[int(j), int(i)] = v
    priors = [{"param": f"p{i}", "dist": "flat", "arg1": -1.0, "arg2": 1.0}
              for i in range(ndim)]
    pack = P.priors_from_list(priors, device)
    lp = LK.make_log_prob(trainer.spec, members if len(members) > 1 else trainer.params,
                          trainer.transforms, pack, data, np.linalg.inv(cov), device=device)
    chain = O._open_backend(os.path.join(outdir, O._chain_filename(method)), method).get_chain()
    flat = chain[len(chain) // 2:].reshape(-1, ndim)
    x0 = flat[np.random.default_rng(0).integers(0, len(flat), nwalkers)].astype(np.float32)
    return lp, x0


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(outdir: str = OUT, indir: str = INDIR, ndim: int = NDIM, method: str = "nuts",
         nwalkers: int = W, m_adapt: int = 100, nuts_warmup: int = 100, nuts_steps: int = 200,
         tune_rounds: int = 10, tune_steps: int = 50, slice_steps: int = 500,
         device=None) -> dict:
    """NUTS against the slice sampler on ``outdir``'s emulator; ``method``
    names the sampler that wrote the iteration's chain.  NUTS adapts for
    ``m_adapt`` samples inside its ``nuts_warmup`` untimed ones, then runs
    ``nuts_steps`` timed; the slice sampler tunes mu over ``tune_rounds``
    chunks of ``tune_steps``, then runs ``slice_steps`` timed.  Returns the
    printed numbers."""
    if nuts_warmup < m_adapt:
        raise ValueError(f"nuts_warmup={nuts_warmup} < m_adapt={m_adapt}: the timed NUTS "
                         "samples must come after the adaptation")
    device = resolve_device(device)
    lp, x0 = load_posterior(outdir, indir, ndim, method, nwalkers, device)

    # NUTS with the MAP + Hessian-eigenbasis preconditioner (run_ensemble's
    # method="nuts")
    t0 = time.time()
    pre = precondition.calc_hess_mass_mat(lp, np.mean(x0, axis=0), device=device)
    lp_pre = pre.wrap_log_prob(lp, device=device)
    x0_pre = torch.as_tensor(pre.to_sampling(x0), dtype=torch.float32, device=device)
    t_pre = time.time() - t0

    g = torch.Generator(device=device).manual_seed(1)
    state = hmc.init_nuts_state(g, x0_pre, lp_pre, m_adapt=m_adapt)
    # past every dual-averaging step, so that the timed samples and tau see
    # a stationary sampler
    state, chain, _ = hmc.nuts_chunk(lp_pre, state, nuts_warmup, 5)
    _sync(device)
    if int(state.m_adapt) != 0:
        raise RuntimeError("the timed NUTS samples must start after the adaptation")
    t0 = time.time()
    state, chain, _ = hmc.nuts_chunk(lp_pre, state, nuts_steps, 5)
    _sync(device)
    t_nuts = time.time() - t0
    ch = chain.cpu().numpy()
    tau_n = convergence.integrated_time(ch)
    ess_nuts = nuts_steps * nwalkers / max(np.max(tau_n), 1.0) / t_nuts
    print(f"NUTS: precond {t_pre:.1f}s; {nuts_steps}x{nwalkers} in {t_nuts:.1f}s; "
          f"tau max={np.max(tau_n):.1f}; ESS/s={ess_nuts:.0f}")

    # the zeus-style ensemble slice sampler (the production default)
    gs = torch.Generator(device=device).manual_seed(2)
    sstate = slicemove.init_slice_state(gs, torch.as_tensor(x0, device=device), lp)
    for _ in range(tune_rounds):
        sstate, _, _ = slicemove.slice_chunk(lp, sstate, tune_steps, 100)
        sstate = slicemove.tune_mu(sstate)
    _sync(device)
    t0 = time.time()
    sstate, sch, _ = slicemove.slice_chunk(lp, sstate, slice_steps, 100)
    _sync(device)
    t_slice = time.time() - t0
    sc = sch.cpu().numpy()
    tau_s = convergence.integrated_time(sc)
    ess_slice = slice_steps * nwalkers / max(np.max(tau_s), 1.0) / t_slice
    print(f"slice: {slice_steps}x{nwalkers} in {t_slice:.1f}s; tau max={np.max(tau_s):.1f}; "
          f"ESS/s={ess_slice:.0f}")
    print(f"NUTS/slice ESS-rate ratio: {ess_nuts / ess_slice:.2f}")

    # the two samplers must agree on the posterior
    nuts_orig = pre.to_original(ch[nuts_steps // 4:].reshape(-1, ndim))
    kept = sc[slice_steps // 5:].reshape(-1, ndim)
    agree = np.max(np.abs(nuts_orig.mean(0) - kept.mean(0)) / kept.std(0))
    print(f"max |mean_nuts - mean_slice|/std = {agree:.3f}")
    return {"precond_s": t_pre, "nuts_s": t_nuts, "slice_s": t_slice,
            "tau_nuts_max": float(np.max(tau_n)), "tau_slice_max": float(np.max(tau_s)),
            "ess_per_s_nuts": ess_nuts, "ess_per_s_slice": ess_slice,
            "ratio": ess_nuts / ess_slice, "agree_sigma": float(agree)}


if __name__ == "__main__":
    args = sys.argv[1:]
    main(device=args[args.index("--device") + 1] if "--device" in args else None)
