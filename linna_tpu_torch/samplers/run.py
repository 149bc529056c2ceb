"""Convergence-gated incremental ensemble sampling (PyTorch, zeus move).

Counterpart of ``linna_tpu/samplers/run.py`` for ``method="zeus"`` in one
process.  The device advances the ensemble in chunks of ``check_every``
steps; between chunks the host appends to the chain file and evaluates the
three-part convergence test:

  1. chain length exceeds ``ntimes`` mean autocorrelation times, taken over
     the chain minus a 20% burn-in;
  2. the change of tau since the previous estimate, normalized to one
     ``check_every`` interval, is below ``tautol``;
  3. split-half mean/std stationarity over the trailing ``nk * tau`` steps.

Tau is estimated over a rolling window of the trailing ``tau_window`` steps,
and re-estimated only once the chain has grown ``tau_check_growth``-fold
since the last estimate.  ``tune_mu`` adapts the slice scale after each of
the first ``tune_chunks`` chunks.

Exact resume: after every chunk the sampler state (coordinates, log-probs,
the torch generator state as ``rng_state``, mu, counters) and the
convergence bookkeeping go into the chain file's ``sampler_state`` group,
with ``_finished``/``_converged`` markers.  The JAX package stores its RNG
under ``key`` instead, so each package's field check resumes the other's
chain statistically from its last positions, with a warning, and never
restores a foreign RNG state.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from . import backends, convergence, slicemove

__all__ = ["run_ensemble", "EMCEE_FILENAME", "ZEUS_FILENAME", "GRADIENT_METHODS"]

EMCEE_FILENAME = "chemcee_256.h5"
ZEUS_FILENAME = "zeus_256.h5"
GRADIENT_METHODS = ("hmc", "nuts")

# the exact-resume fields of a slice state; the generator state is stored
# as rng_state (the JAX package's field is key)
_STATE_FIELDS = ("coords", "log_prob", "rng_state", "mu", "n_expand", "n_contract")


def _np_transform(transform):
    if transform is None:
        return None

    def apply(chain: np.ndarray) -> np.ndarray:
        flat = chain.reshape(-1, chain.shape[-1])
        out = np.asarray(transform(flat))
        return out.reshape(chain.shape[:-1] + (out.shape[-1],))

    return apply


def _state_to_blob(state: slicemove.SliceState) -> dict:
    return {
        "coords": state.coords.cpu().numpy(),
        "log_prob": state.log_prob.cpu().numpy(),
        "rng_state": state.rng.get_state().numpy(),
        "mu": state.mu.cpu().numpy(),
        "n_expand": state.n_expand.cpu().numpy(),
        "n_contract": state.n_contract.cpu().numpy(),
    }


def _blob_to_state(blob: dict, device: torch.device) -> slicemove.SliceState:
    rng = torch.Generator(device=device)
    rng.set_state(torch.as_tensor(np.asarray(blob["rng_state"], dtype=np.uint8)))
    t = lambda k: torch.as_tensor(np.asarray(blob[k])).to(device)
    return slicemove.SliceState(
        t("coords"), t("log_prob"), rng, t("mu"), t("n_expand"), t("n_contract")
    )


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
    slice_max_steps: int = 100,
    tune_chunks: int = 10,
    progress: bool = False,
    trace_rec: Optional[dict] = None,
    device: DeviceLike = None,
):
    """Sample until converged (or ``max_iterations`` steps); returns the
    backend holding the chain (file ``zeus_256.h5``).

    ``method``: only ``"zeus"`` (ensemble slice) is ported; ``"emcee"``,
    ``"hmc"`` and ``"nuts"`` raise ``NotImplementedError``.

    ``convergence_check=False`` runs exactly ``max_iterations`` steps with
    no tau/stationarity evaluation.  ``trace_rec``: optional dict receiving
    this call's wall-time breakdown and step count.
    """
    if method in ("emcee",) + GRADIENT_METHODS:
        raise NotImplementedError(
            f"method={method!r} is not ported to linna_tpu_torch yet (only "
            "'zeus'); see ROADMAP.md, Queue 1"
        )
    if method != "zeus":
        raise NotImplementedError(method)
    device = resolve_device(device)
    ps = {"init": 0.0, "setup": 0.0, "device_wait": 0.0, "host": 0.0, "tau_checks": 0.0}
    t_setup0 = time.perf_counter()
    if not tau_walkers or tau_walkers <= 0:
        tau_walkers = None
    os.makedirs(outdir, exist_ok=True)
    x0 = np.asarray(x0, dtype=np.float32)
    nwalkers, ndim = x0.shape
    if nwalkers < 4:
        raise ValueError(
            f"method='zeus' needs nwalkers >= 4 (got {nwalkers}): the "
            "differential slice move draws two distinct walkers from the "
            "complementary half-ensemble"
        )
    tfn = _np_transform(transform)
    backend = backends.ZeusBackend(os.path.join(outdir, ZEUS_FILENAME))

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
        elif blob_fields != set(_STATE_FIELDS):
            # e.g. a chain written by the JAX package, whose RNG state is a
            # JAX key: never restored, the chain continues statistically
            warnings.warn(
                "sampler_state fields do not match the requested method's "
                "state; resuming statistically from the chain positions",
                stacklevel=2,
            )
            state_blob = None

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
    n_chunks_done = 0
    if state_blob is not None:
        state = _blob_to_state(state_blob, device)
        old_tau_arr = np.asarray(state_blob["_old_tau"], np.float64)
        old_tau = float(old_tau_arr[0]) if old_tau_arr.size else np.inf
        n_chunks_done = int(state_blob["_n_chunks_done"])
    else:
        t0 = time.perf_counter()
        rng = torch.Generator(device=device).manual_seed(int(seed))
        state = slicemove.init_slice_state(
            rng, torch.as_tensor(x0, device=device), log_prob_fn
        )
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
        the tau bookkeeping."""
        nonlocal old_tau, last_tau_iter, next_tau_iter
        steps_since_tau = iteration - last_tau_iter
        last_tau_iter = iteration
        next_tau_iter = iteration * tau_check_growth
        # |tau_new - tau_old| / tau per check_every steps, whatever the
        # geometric cadence put between the two estimates
        dtau_scale = check_every / max(steps_since_tau, check_every)
        _hydrate()
        recent = np.concatenate(rolling) if len(rolling) > 1 else rolling[0]
        # scalar mean tau over the chain minus a 20% burn-in; steps older
        # than the window are all burn-in once 0.8*iteration exceeds it
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
            print(f"iter {iteration}: tau={tau:.2f} converged={converged}", flush=True)
        old_tau = tau
        return bool(converged)

    def _finish_trace() -> None:
        if trace_rec is not None:
            trace_rec["sampler"] = {k: round(v, 3) for k, v in ps.items()}
            trace_rec["steps_run"] = int(iteration)

    ps["setup"] = time.perf_counter() - t_setup0 - ps["init"]
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
        already_done = _tau_check()
        ps["tau_checks"] += time.perf_counter() - t_tc
        if already_done:
            converged_flag = True
            _finish_trace()
            return backend

    while iteration < max_iterations:
        t0 = time.perf_counter()
        state, chain, lps = slicemove.slice_chunk(
            log_prob_fn, state, check_every, slice_max_steps
        )
        if n_chunks_done < tune_chunks:
            state = slicemove.tune_mu(state)
        chain = chain.cpu().numpy()
        lps = lps.cpu().numpy()
        t1 = time.perf_counter()
        ps["device_wait"] += t1 - t0
        backend.append(chain.astype(np.float64), lps.astype(np.float64), transform=tfn)
        _push(chain)
        iteration += check_every
        n_chunks_done += 1

        if not convergence_check or iteration < next_tau_iter:
            _save_state()
            ps["host"] += time.perf_counter() - t1
            continue
        t2 = time.perf_counter()
        ps["host"] += t2 - t1
        converged = _tau_check()
        t3 = time.perf_counter()
        ps["tau_checks"] += t3 - t2
        converged_flag = converged
        _save_state()
        ps["host"] += time.perf_counter() - t3
        if converged:
            break

    finished_flag = True
    _save_state()
    _finish_trace()
    return backend
