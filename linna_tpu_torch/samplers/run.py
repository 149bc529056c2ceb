"""Convergence-gated incremental ensemble sampling (PyTorch).

Counterpart of ``linna_tpu/samplers/run.py`` in one process, for the four
samplers: ``emcee`` (the stretch move), ``zeus`` (the ensemble slice move),
and ``hmc``/``nuts`` (gradient samplers in the MAP Hessian's eigenbasis).
The device advances the ensemble in chunks of ``check_every`` steps; between
chunks the host appends to the chain file and evaluates the three-part
convergence test:

  1. chain length exceeds ``ntimes`` autocorrelation times: every
     parameter's (emcee, hmc, nuts), or the mean over the chain minus a 20%
     burn-in (zeus);
  2. the change of tau since the previous estimate, normalized to one
     ``check_every`` interval, is below ``tautol``;
  3. split-half mean/std stationarity over the trailing ``nk * tau`` steps.

Tau is estimated over a rolling window of the trailing ``tau_window`` steps,
and re-estimated only once the chain has grown ``tau_check_growth``-fold
since the last estimate.  ``tune_mu`` adapts the slice scale after each of
the first ``tune_chunks`` chunks.

Exact resume: after every chunk the sampler state (coordinates, log-probs,
the torch generator state as ``rng_state``, step sizes and dual averaging,
mu, counters) and the convergence bookkeeping go into the chain file's
``sampler_state`` group, with the method and ``_finished``/``_converged``
markers; the gradient samplers' preconditioner goes to ``precond.npz``.  The
JAX package stores its RNG under ``key`` instead, so each package's field
check resumes the other's chain statistically from its last positions, with
a warning, and never restores a foreign RNG state.
"""

from __future__ import annotations

import os
import time
import zipfile
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from . import backends, convergence, hmc, precondition, slicemove, stretch

__all__ = ["run_ensemble", "EMCEE_FILENAME", "ZEUS_FILENAME", "GRADIENT_METHODS"]

# hmc and nuts share the emcee chain file, as in the JAX package
EMCEE_FILENAME = "chemcee_256.h5"
ZEUS_FILENAME = "zeus_256.h5"
GRADIENT_METHODS = ("hmc", "nuts")
PRECOND_FILENAME = "precond.npz"

# sampler state classes by method, for the exact-resume blob
_STATE_CLS = {
    "emcee": stretch.EnsembleState,
    "hmc": hmc.HMCState,
    "nuts": hmc.NUTSState,
    "zeus": slicemove.SliceState,
}


def _blob_fields(cls) -> set:
    """A state's blob fields: the generator state is stored as rng_state
    (the JAX package's field is key)."""
    return {"rng_state" if f == "rng" else f for f in cls._fields}


def _np_transform(transform):
    if transform is None:
        return None

    def apply(chain: np.ndarray) -> np.ndarray:
        flat = chain.reshape(-1, chain.shape[-1])
        out = np.asarray(transform(flat))
        return out.reshape(chain.shape[:-1] + (out.shape[-1],))

    return apply


def _state_to_blob(state) -> dict:
    return {
        ("rng_state" if name == "rng" else name): (
            v.get_state().numpy() if name == "rng" else v.cpu().numpy()
        )
        for name, v in zip(state._fields, state)
    }


def _blob_to_state(cls, blob: dict, device: torch.device):
    kwargs = {}
    for name in cls._fields:
        if name == "rng":
            rng = torch.Generator(device=device)
            rng.set_state(torch.as_tensor(np.asarray(blob["rng_state"], dtype=np.uint8)))
            kwargs[name] = rng
        else:
            kwargs[name] = torch.as_tensor(np.asarray(blob[name])).to(device)
    return cls(**kwargs)


def _load_precond(pfile: str):
    """The saved preconditioner, or None when the file cannot be read."""
    try:
        with np.load(pfile) as z:
            return precondition.Preconditioner(z["center"], z["basis"], z["scales"])
    except (OSError, ValueError, KeyError, zipfile.BadZipFile):
        return None


def _save_precond(pfile: str, pre) -> None:
    # atomic: a torn file would pass the isfile gate and break every resume
    tmp = pfile + ".tmp.npz"  # keeps the .npz suffix, so savez does not rename
    np.savez(tmp, center=pre.center, basis=pre.basis, scales=pre.scales)
    os.replace(tmp, pfile)


def run_ensemble(
    log_prob_fn: Callable[[torch.Tensor], torch.Tensor],
    x0: np.ndarray,
    outdir: str,
    method: str = "zeus",
    transform: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    ntimes: float = 10,
    tautol: float = 0.01,
    meanshift: float = 0.1,
    stdshift: float = 0.1,
    nk: float = 2,
    check_every: int = 100,
    max_iterations: int = 100_000,
    tau_window: int = 20_000,
    tau_check_growth: float = 1.05,
    tau_walkers: int = 64,
    convergence_check: bool = True,
    seed: int = 0,
    a: float = 2.0,
    slice_max_steps: int = 100,
    tune_chunks: int = 10,
    n_leapfrog: int = 10,
    max_depth: int = 5,
    m_adapt: int = 100,
    progress: bool = False,
    trace_rec: Optional[dict] = None,
    device: DeviceLike = None,
):
    """Sample until converged (or ``max_iterations`` steps); returns the
    backend holding the chain.

    ``method``: ``"emcee"`` (the stretch move, file ``chemcee_256.h5``, after
    a 100-step burn-in restarted from the top ``50 * nwalkers`` draws),
    ``"zeus"`` (ensemble slice, ``zeus_256.h5``), or ``"hmc"``/``"nuts"``
    (in the MAP Hessian's eigenbasis, saved to ``precond.npz``, walkers
    drawn there, chains stored in the original space, in ``chemcee_256.h5``).

    ``convergence_check=False`` runs exactly ``max_iterations`` steps with
    no tau/stationarity evaluation.  ``trace_rec``: optional dict receiving
    this call's wall-time breakdown (the MAP search under ``precond``) and
    step count.
    """
    if method not in _STATE_CLS:
        raise NotImplementedError(method)
    device = resolve_device(device)
    ps = {"precond": 0.0, "init": 0.0, "setup": 0.0, "device_wait": 0.0, "host": 0.0,
          "tau_checks": 0.0}
    t_setup0 = time.perf_counter()
    if not tau_walkers or tau_walkers <= 0:
        tau_walkers = None
    os.makedirs(outdir, exist_ok=True)
    x0 = np.asarray(x0, dtype=np.float32)
    nwalkers, ndim = x0.shape
    if method == "zeus" and nwalkers < 4:
        raise ValueError(
            f"method='zeus' needs nwalkers >= 4 (got {nwalkers}): the "
            "differential slice move draws two distinct walkers from the "
            "complementary half-ensemble"
        )
    tfn = _np_transform(transform)
    if method == "zeus":
        backend = backends.ZeusBackend(os.path.join(outdir, ZEUS_FILENAME))
    else:
        backend = backends.EmceeBackend(os.path.join(outdir, EMCEE_FILENAME))
    rng = torch.Generator(device=device).manual_seed(int(seed))

    # in-memory window of the most recent ~tau_window steps (the file keeps
    # the whole chain); tau and the stationarity test read trailing windows
    rolling: list = []
    rolling_len = 0

    def _push(chunk: np.ndarray) -> None:
        nonlocal rolling_len
        rolling.append(chunk)
        rolling_len += len(chunk)
        while rolling and rolling_len - len(rolling[0]) >= tau_window:
            rolling_len -= len(rolling[0])
            rolling.pop(0)

    resume = backend.initialized
    state_blob = backend.load_state() if resume else None
    if state_blob is not None:
        # emcee, hmc and nuts share one chain file, so the blob may be
        # another method's
        saved_method = state_blob.get("_method")
        blob_fields = {k for k in state_blob if not k.startswith("_")}
        if saved_method is not None and np.asarray(saved_method).item() != method.encode():
            warnings.warn(
                f"sampler_state was written by method "
                f"{np.asarray(saved_method).item().decode()!r}; resuming "
                f"{method!r} statistically from the chain positions",
                stacklevel=2,
            )
            state_blob = None
        elif blob_fields != _blob_fields(_STATE_CLS[method]):
            # e.g. a chain written by the JAX package, whose RNG state is a
            # JAX key: never restored, the chain continues statistically
            warnings.warn(
                "sampler_state fields do not match the requested method's "
                "state; resuming statistically from the chain positions",
                stacklevel=2,
            )
            state_blob = None

    precond = None
    if method in GRADIENT_METHODS:
        # sample in the MAP Hessian's eigenbasis with unit mass; the
        # preconditioner persists so a resume continues in the same space
        pfile = os.path.join(outdir, PRECOND_FILENAME)
        if resume and os.path.isfile(pfile):
            precond = _load_precond(pfile)
            if precond is None:
                # the saved state lives in the old space: never restore it
                # against a new basis
                state_blob = None
                warnings.warn(
                    f"unreadable {PRECOND_FILENAME}; re-running the MAP search and "
                    "resuming statistically from the chain positions (the chain "
                    "continues in a fresh preconditioned space)",
                    stacklevel=2,
                )
        if precond is None:
            t0 = time.perf_counter()
            precond = precondition.calc_hess_mass_mat(log_prob_fn, np.mean(x0, axis=0),
                                                      device=device)
            ps["precond"] += time.perf_counter() - t0
            _save_precond(pfile, precond)
        log_prob_fn = precond.wrap_log_prob(log_prob_fn, device=device)

    iteration = 0
    hist_pending = 0  # persisted steps not yet read into the window
    if resume:
        x0 = np.asarray(backend.get_last_sample(), dtype=np.float32)
        iteration = int(backend.iteration)
        if (
            state_blob is not None
            and "_iteration" in state_blob
            and int(np.asarray(state_blob["_iteration"])) != iteration
        ):
            # a crash between chain append and state save leaves the blob a
            # chunk behind the file: resuming from it would re-append that
            # chunk
            warnings.warn(
                f"sampler_state is {iteration - int(np.asarray(state_blob['_iteration']))} "
                "steps behind the chain file (crash between append and state "
                "save?) — discarding it and resuming statistically",
                stacklevel=2,
            )
            state_blob = None
        hist_pending = iteration
    elif method == "emcee":
        backend.reset(nwalkers, ndim)
        # burn-in, then a restart from the high-probability set
        bstate = stretch.init_state(rng, x0, log_prob_fn)
        _, bchain, blps = stretch.stretch_chunk(log_prob_fn, bstate, 100, a)
        flat = bchain.reshape(-1, ndim).cpu().numpy()
        flat_lp = blps.reshape(-1).cpu().numpy()
        top = flat[np.argsort(flat_lp)[::-1][: int(50 * nwalkers)]]
        pick = torch.randint(0, len(top), (nwalkers,), generator=rng, device=device)
        x0 = top[pick.cpu().numpy()]

    if method in GRADIENT_METHODS:
        if resume:
            x0 = np.asarray(precond.to_sampling(x0), dtype=np.float32)
        else:
            backend.reset(nwalkers, ndim)
            x0 = precond.draw_x0(np.random.default_rng(seed), nwalkers)

    def _hydrate() -> None:
        """Prepend the persisted chain tail to the rolling window (lazy)."""
        nonlocal hist_pending, rolling_len
        need = min(hist_pending, tau_window - rolling_len)
        if need > 0:
            tail = np.asarray(backend.get_chain(discard=hist_pending - need))[:need]
            rolling.insert(0, tail)
            rolling_len += len(tail)
        hist_pending = 0

    old_tau = np.inf
    prev_accepted = np.zeros(nwalkers)
    n_chunks_done = 0
    if state_blob is not None:
        # exact resume: the generator state, step sizes, dual averaging,
        # slice mu and counters, and the convergence bookkeeping
        state = _blob_to_state(_STATE_CLS[method], state_blob, device)
        if "accepted" in state_blob:
            prev_accepted = np.asarray(state_blob["accepted"], np.float64)
        old_tau = np.asarray(state_blob["_old_tau"], np.float64)
        if method == "zeus":
            old_tau = float(old_tau[0]) if old_tau.size else np.inf
        n_chunks_done = int(state_blob["_n_chunks_done"])
    else:
        t0 = time.perf_counter()
        x0_dev = torch.as_tensor(x0, device=device)
        if method == "emcee":
            state = stretch.init_state(rng, x0_dev, log_prob_fn)
        elif method == "hmc":
            state = hmc.init_hmc_state(rng, x0_dev, log_prob_fn)
        elif method == "nuts":
            state = hmc.init_nuts_state(rng, x0_dev, log_prob_fn, m_adapt=m_adapt)
        else:
            state = slicemove.init_slice_state(rng, x0_dev, log_prob_fn)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ps["init"] += time.perf_counter() - t0
    next_tau_iter = iteration
    last_tau_iter = iteration
    if state_blob is not None and "_next_tau_iter" in state_blob:
        next_tau_iter = float(state_blob["_next_tau_iter"])
        last_tau_iter = int(state_blob["_last_tau_iter"])

    converged_flag = False
    finished_flag = False

    def _save_state() -> None:
        blob = _state_to_blob(state)
        blob["_method"] = np.bytes_(method)
        blob["_iteration"] = np.asarray(int(iteration))
        blob["_old_tau"] = np.atleast_1d(np.asarray(old_tau, np.float64))
        blob["_n_chunks_done"] = np.asarray(n_chunks_done)
        blob["_next_tau_iter"] = np.asarray(float(next_tau_iter))
        blob["_last_tau_iter"] = np.asarray(int(last_tau_iter))
        blob["_converged"] = np.asarray(bool(converged_flag))
        # terminal marker: True once the run exits through any legitimate
        # stop, so a restart tells a dead run from a finished one
        blob["_finished"] = np.asarray(bool(finished_flag))
        backend.save_state(blob)

    def _tau_check():
        """The three-part convergence test on the trailing window; advances
        the tau bookkeeping.  Returns (converged, nan_stop)."""
        nonlocal old_tau, last_tau_iter, next_tau_iter
        steps_since_tau = iteration - last_tau_iter
        last_tau_iter = iteration
        next_tau_iter = iteration * tau_check_growth
        # |tau_new - tau_old| / tau per check_every steps, whatever the
        # geometric cadence put between the two estimates
        dtau_scale = check_every / max(steps_since_tau, check_every)
        _hydrate()
        recent = np.concatenate(rolling) if len(rolling) > 1 else rolling[0]
        if method != "zeus":
            # per-parameter tau over the window, as emcee does
            tau = convergence.integrated_time(recent[-tau_window:], max_walkers=tau_walkers)
            if np.isnan(np.sum(tau)) and iteration > 10:
                return False, True
            converged = bool(np.all(tau * ntimes < iteration))
            converged &= bool(np.all(np.abs(old_tau - tau) / tau * dtau_scale < tautol))
            window = max(int(nk * np.mean(tau)), 2)
        else:
            # scalar mean tau over the chain minus a 20% burn-in; steps
            # older than the window are all burn-in once 0.8*iteration
            # exceeds it
            burn = int(0.2 * iteration)
            behind = iteration - len(recent)
            drop = max(0, burn - behind)
            tau_arr = convergence.integrated_time(
                recent[drop:][-tau_window:], max_walkers=tau_walkers
            )
            tau = float(np.mean(tau_arr))
            converged = tau * ntimes < iteration
            converged &= bool(np.abs(old_tau - tau) / tau * dtau_scale < tautol)
            window = max(int(nk * tau), 2)
        converged &= convergence.check_mean_std(recent[-window:], meanshift, stdshift)
        if progress:
            print(f"iter {iteration}: tau={np.mean(tau):.2f} converged={converged}", flush=True)
        old_tau = tau
        return bool(converged), False

    def _finish_trace() -> None:
        if trace_rec is not None:
            trace_rec["sampler"] = {k: round(v, 3) for k, v in ps.items()}
            trace_rec["steps_run"] = int(iteration)

    ps["setup"] = time.perf_counter() - t_setup0 - ps["precond"] - ps["init"]
    if (
        convergence_check
        and state_blob is not None
        and bool(np.asarray(state_blob.get("_converged", False)))
        and rolling_len + hist_pending > 0
    ):
        # a chain that stopped converged is re-tested under the current
        # criteria before anything is sampled, and returned untouched if it
        # still passes
        t_tc = time.perf_counter()
        already_done, _ = _tau_check()
        ps["tau_checks"] += time.perf_counter() - t_tc
        if already_done:
            converged_flag = True
            _finish_trace()
            return backend

    def _advance(st):
        if method == "emcee":
            return stretch.stretch_chunk(log_prob_fn, st, check_every, a)
        if method == "hmc":
            return hmc.hmc_chunk(log_prob_fn, st, check_every, n_leapfrog)
        if method == "nuts":
            return hmc.nuts_chunk(log_prob_fn, st, check_every, max_depth)
        return slicemove.slice_chunk(log_prob_fn, st, check_every, slice_max_steps)

    while iteration < max_iterations:
        t0 = time.perf_counter()
        state, chain, lps = _advance(state)
        if method == "zeus" and n_chunks_done < tune_chunks:
            state = slicemove.tune_mu(state)
        chain = chain.cpu().numpy()
        lps = lps.cpu().numpy().astype(np.float64)
        t1 = time.perf_counter()
        ps["device_wait"] += t1 - t0
        if method == "zeus":
            backend.append(chain.astype(np.float64), lps, transform=tfn)
        else:
            # cumulative acceptances (counts; the mean alpha for hmc/nuts):
            # the file takes each chunk's delta
            acc = state.accepted.cpu().numpy().astype(np.float64)
            if method in GRADIENT_METHODS:
                # stored in the original (whitened-prior) space
                chain = precond.to_original(chain.astype(np.float64).reshape(-1, ndim))
                chain = chain.reshape(-1, nwalkers, ndim)
            backend.append(chain.astype(np.float64), lps, acc - prev_accepted, transform=tfn)
            prev_accepted = acc
        _push(chain)
        iteration += check_every
        n_chunks_done += 1

        if not convergence_check or iteration < next_tau_iter:
            _save_state()
            ps["host"] += time.perf_counter() - t1
            continue
        t2 = time.perf_counter()
        ps["host"] += t2 - t1
        converged, nan_stop = _tau_check()
        t3 = time.perf_counter()
        ps["tau_checks"] += t3 - t2
        converged_flag = converged
        _save_state()
        ps["host"] += time.perf_counter() - t3
        if converged or nan_stop:
            break

    finished_flag = True
    _save_state()
    _finish_trace()
    return backend
