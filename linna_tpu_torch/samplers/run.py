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

On a CUDA device every chunk that is not walker-sharded is replayed from
CUDA graphs (:mod:`linna_tpu_torch.samplers.graphs`), captured once per
call, as the JAX package compiles one program per chunk.  Dispatch is
double-buffered as in the JAX package: chunk k+1 is enqueued before the
host consumes chunk k, and a stop drops it; the chain file, the state blob
and a resume are those of the serial order, bit for bit.

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

Over several ranks every rank runs this same loop.  With ``shard_walkers``
and a walker count that divides into two blocks per rank, each rank
advances its block of the ensemble (the moves' ``shard`` argument); else
every rank advances the whole ensemble.  The host decisions come from
values identical on every rank: the resume flag, the state blob, the
chain's last positions and the preconditioner are read (or computed) by
rank 0 and broadcast, the tau verdict is rank 0's and broadcast, and each
chunk is gathered whole (:func:`linna_tpu_torch.parallel.multihost.fetch`)
before the host appends it and tests convergence.  Walker-sharded chunks
stay eager: gloo's collectives copy through the host and cannot be
captured in a CUDA graph.  Only rank 0 writes the
chain store, the state blob and ``precond.npz``.  The saved ``rng_state``
is the generator every rank shares, so a resumed sharded run restores the
same stream on every rank.
"""

from __future__ import annotations

import os
import time
import zipfile
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops import library
from ..parallel import mesh as ME
from ..parallel import multihost as MH
from ..utils.trace import span
from . import backends, convergence, graphs, hmc, precondition, slicemove, stretch

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


def _blob_to_state(cls, blob: dict, device: torch.device, shard=None):
    """The state from a blob; per-walker fields cut to this rank's block
    under ``shard``."""
    kwargs = {}
    for name in cls._fields:
        if name == "rng":
            rng = torch.Generator(device=device)
            rng.set_state(torch.as_tensor(np.asarray(blob["rng_state"], dtype=np.uint8)))
            kwargs[name] = rng
        else:
            v = torch.as_tensor(np.asarray(blob[name])).to(device)
            kwargs[name] = v if shard is None or v.dim() == 0 else shard.take(v)
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
    shard_walkers: bool = True,
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
    this call's wall-time breakdown (the MAP search under ``precond``, the
    graphs' capture under ``capture``, the sampling loop without the
    capture under ``loop``), step count, the kernels' launches and plain
    versions' calls this call made (``kernels``), and on a card the graphs'
    record (``graphs``: replays, likelihood calls, the card's seconds in and
    between the chunks, and zeus's loop iterations).  ``shard_walkers``: over
    several ranks, each advances its block of walkers when ``nwalkers``
    divides into two blocks per rank.
    """
    if method not in _STATE_CLS:
        raise NotImplementedError(method)
    device = resolve_device(device)
    ps = {"precond": 0.0, "init": 0.0, "setup": 0.0, "capture": 0.0, "dispatch": 0.0,
          "device_wait": 0.0, "host": 0.0, "tau_checks": 0.0, "loop": 0.0}
    t_setup0 = time.perf_counter()
    counts0 = {kind: dict(c) for kind, c in library.COUNTERS.items()}
    if not tau_walkers or tau_walkers <= 0:
        tau_walkers = None
    primary = MH.is_primary()
    if primary:
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
    world = MH.process_count()
    shard = None
    if shard_walkers and world > 1:
        if nwalkers % (2 * world) == 0:
            shard = ME.walker_shard(nwalkers)
        else:
            warnings.warn(
                f"walker sharding skipped: nwalkers={nwalkers} is not a multiple of "
                f"2*process_count={2 * world}; every rank advances the whole ensemble; "
                f"round nwalkers up to {-(-nwalkers // (2 * world)) * 2 * world} to use all "
                f"{world} ranks",
                stacklevel=2,
            )
    take = (lambda a: a) if shard is None else shard.take

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

    # rank 0's view of the store, broadcast: another rank may see the file
    # mid-reset and would take another branch
    resume = MH.primary_flag(backend.initialized if primary else False)
    state_blob = MH.broadcast_from_primary(backend.load_state) if resume else None
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
        if resume and MH.primary_flag(primary and os.path.isfile(pfile)):
            precond = MH.broadcast_from_primary(lambda: _load_precond(pfile))
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
            # rank 0 searches; every rank samples in its space, bit for bit
            with span("sampler.precond", ps):
                precond = MH.broadcast_from_primary(
                    lambda: precondition.calc_hess_mass_mat(log_prob_fn, np.mean(x0, axis=0),
                                                            device=device)
                )
            if primary:
                _save_precond(pfile, precond)
        log_prob_fn = precond.wrap_log_prob(log_prob_fn, device=device)

    graphed = None  # the CUDA-graph chunk runner, captured at the first chunk

    def _advance(st, nsteps=check_every):
        """Enqueue one chunk: replayed from CUDA graphs on a card unless the
        walkers are sharded (emcee's 100-step burn-in is a chunk too), else
        the eager chunk function."""
        nonlocal graphed
        if device.type == "cuda" and shard is None:
            if graphed is None:
                with span("sampler.capture", ps):
                    graphed = graphs.graphed_chunks(
                        method, log_prob_fn, st, max(check_every, 100 if method == "emcee" else 0),
                        a=a, n_leapfrog=n_leapfrog, max_depth=max_depth, max_steps=slice_max_steps)
            return graphed(st, nsteps)
        if method == "emcee":
            return stretch.stretch_chunk(log_prob_fn, st, nsteps, a, shard=shard)
        if method == "hmc":
            return hmc.hmc_chunk(log_prob_fn, st, nsteps, n_leapfrog, shard=shard)
        if method == "nuts":
            return hmc.nuts_chunk(log_prob_fn, st, nsteps, max_depth, shard=shard)
        return slicemove.slice_chunk(log_prob_fn, st, nsteps, slice_max_steps, shard=shard)

    iteration = 0
    hist_pending = 0  # persisted steps not yet read into the window
    if resume:
        x0, iteration = MH.broadcast_from_primary(
            lambda: (np.asarray(backend.get_last_sample(), dtype=np.float32),
                     int(backend.iteration))
        )
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
        if primary:
            backend.reset(nwalkers, ndim)
        # burn-in, then a restart from the high-probability set
        bstate = stretch.init_state(rng, take(torch.as_tensor(x0)), log_prob_fn)
        _, bchain, blps = _advance(bstate, 100)
        bchain, blps = MH.fetch((bchain, blps), shard, dim=1)
        flat = bchain.reshape(-1, ndim)
        flat_lp = blps.reshape(-1)
        top = flat[np.argsort(flat_lp)[::-1][: int(50 * nwalkers)]]
        pick = torch.randint(0, len(top), (nwalkers,), generator=rng, device=device)
        x0 = top[pick.cpu().numpy()]

    if method in GRADIENT_METHODS:
        if resume:
            x0 = np.asarray(precond.to_sampling(x0), dtype=np.float32)
        else:
            if primary:
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
        state = _blob_to_state(_STATE_CLS[method], state_blob, device, shard)
        if "accepted" in state_blob:
            prev_accepted = np.asarray(state_blob["accepted"], np.float64)
        old_tau = np.asarray(state_blob["_old_tau"], np.float64)
        if method == "zeus":
            old_tau = float(old_tau[0]) if old_tau.size else np.inf
        n_chunks_done = int(state_blob["_n_chunks_done"])
    else:
        with span("sampler.init", ps):
            x0_dev = take(torch.as_tensor(x0, device=device))
            if method == "emcee":
                state = stretch.init_state(rng, x0_dev, log_prob_fn)
            elif method == "hmc":
                state = hmc.init_hmc_state(rng, x0_dev, log_prob_fn, shard=shard)
            elif method == "nuts":
                state = hmc.init_nuts_state(rng, x0_dev, log_prob_fn, m_adapt=m_adapt,
                                            shard=shard)
            else:
                state = slicemove.init_slice_state(rng, x0_dev, log_prob_fn)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    next_tau_iter = iteration
    last_tau_iter = iteration
    if state_blob is not None and "_next_tau_iter" in state_blob:
        next_tau_iter = float(state_blob["_next_tau_iter"])
        last_tau_iter = int(state_blob["_last_tau_iter"])

    converged_flag = False
    finished_flag = False

    def _save_state(blob: dict) -> None:
        """Rank 0 writes ``blob`` (a chunk's state, :func:`_fetch`) with the
        bookkeeping."""
        if not primary:
            return
        blob = dict(blob)
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
        the tau bookkeeping.  Returns (converged, nan_stop).  Rank 0 tests
        (its window may read the store) and every rank takes its verdict
        and tau."""
        nonlocal old_tau, last_tau_iter, next_tau_iter
        steps_since_tau = iteration - last_tau_iter
        last_tau_iter = iteration
        next_tau_iter = iteration * tau_check_growth
        converged, nan_stop, tau = MH.broadcast_from_primary(
            lambda: _estimate(check_every / max(steps_since_tau, check_every))
        )
        if nan_stop:
            return False, True
        old_tau = tau
        return converged, False

    def _estimate(dtau_scale):
        """(converged, nan_stop, tau); ``dtau_scale`` normalizes
        |tau_new - tau_old| / tau to one ``check_every`` interval, whatever
        the geometric cadence put between the two estimates."""
        _hydrate()
        recent = np.concatenate(rolling) if len(rolling) > 1 else rolling[0]
        if method != "zeus":
            # per-parameter tau over the window, as emcee does
            tau = convergence.integrated_time(recent[-tau_window:], max_walkers=tau_walkers)
            if np.isnan(np.sum(tau)) and iteration > 10:
                return False, True, None
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
        return bool(converged), False, tau

    def _finish_trace() -> None:
        if trace_rec is not None:
            trace_rec["sampler"] = {k: round(v, 3) for k, v in ps.items()}
            trace_rec["steps_run"] = int(iteration)
            trace_rec["kernels"] = {
                kind: {k: now[k] - counts0[kind][k] for k in now}
                for kind, now in library.COUNTERS.items()}

    ps["setup"] = (time.perf_counter() - t_setup0 - ps["precond"] - ps["init"]
                   - ps["capture"])
    if (
        convergence_check
        and state_blob is not None
        and bool(np.asarray(state_blob.get("_converged", False)))
        and rolling_len + hist_pending > 0
    ):
        # a chain that stopped converged is re-tested under the current
        # criteria before anything is sampled, and returned untouched if it
        # still passes
        with span("sampler.tau_checks", ps):
            already_done, _ = _tau_check()
        if already_done:
            converged_flag = True
            _finish_trace()
            return backend

    fields = [n for n in _STATE_CLS[method]._fields if n != "rng"]

    def _snapshot(st, chain=None, lps=None):
        """Chunk k's chain, log-probs and state on their way to the host,
        queued before chunk k+1 is: on a card (unsharded) copies into pinned
        memory behind an event; with the generator's state after chunk k's
        draws.  Under ``shard`` the tensors are gathered when fetched."""
        tensors = [getattr(st, n) for n in fields]
        if chain is not None:
            tensors = [chain, lps] + tensors
        rng_state = st.rng.get_state().numpy()
        if shard is not None or device.type != "cuda":
            return tensors, None, rng_state
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event, rng_state

    def _fetch(snap):
        """(arrays, blob): the chunk's tensors as host numpy, the same on
        every rank, and its state blob."""
        tensors, event, rng_state = snap
        if event is not None:
            event.synchronize()
        n = len(tensors) - len(fields)
        if shard is None:
            arrays = [t.detach().cpu().numpy() for t in tensors]
        else:  # two gathers: the chunk's rows, then the state
            arrays = list(MH.fetch(tensors[:n], shard, dim=1)) if n else []
            arrays += list(MH.fetch(tensors[n:], shard))
        blob = dict(zip(fields, arrays[n:]))
        blob["rng_state"] = rng_state
        return arrays[:n], blob

    def _consume(snap) -> bool:
        """Chunk k on the host: append it, test convergence, save the state;
        True when the run stops here."""
        nonlocal prev_accepted, converged_flag, last_blob
        t0 = time.perf_counter()
        (chain, lps), blob = _fetch(snap)
        last_blob = blob
        lps = lps.astype(np.float64)
        t1 = time.perf_counter()
        ps["device_wait"] += t1 - t0
        if method == "zeus":
            if primary:
                backend.append(chain.astype(np.float64), lps, transform=tfn)
        else:
            # cumulative acceptances (counts; the mean alpha for hmc/nuts):
            # the file takes each chunk's delta
            acc = np.asarray(blob["accepted"], np.float64)
            if method in GRADIENT_METHODS:
                # stored in the original (whitened-prior) space
                chain = precond.to_original(chain.astype(np.float64).reshape(-1, ndim))
                chain = chain.reshape(-1, nwalkers, ndim)
            if primary:
                backend.append(chain.astype(np.float64), lps, acc - prev_accepted,
                               transform=tfn)
            prev_accepted = acc
        _push(chain)

        if not convergence_check or iteration < next_tau_iter:
            _save_state(blob)
            ps["host"] += time.perf_counter() - t1
            return False
        t2 = time.perf_counter()
        ps["host"] += t2 - t1
        converged, nan_stop = _tau_check()
        t3 = time.perf_counter()
        ps["tau_checks"] += t3 - t2
        converged_flag = converged
        _save_state(blob)
        ps["host"] += time.perf_counter() - t3
        return converged or nan_stop

    # Double-buffered dispatch, as in the JAX package: chunk k+1 is enqueued
    # before the host consumes chunk k (append, tau, stationarity, state
    # save), and on an early stop the pending chunk is dropped.  zeus mu is
    # tuned on chunk k's state before chunk k+1 is dispatched, and chunk k's
    # results, state and generator state are taken before (_snapshot), so the
    # chain file, the state blob and a resume are those of the serial order,
    # bit for bit.  An eager zeus chunk's host drives its loops, and a
    # graphed chunk's launches can block on the card's full queue, so
    # unsharded the consumer runs on a second thread while this one
    # dispatches; the writes
    # keep their order (one consumer at a time).  Walker-sharded chunks make
    # collectives, and consume after the dispatch on this thread, in the
    # same order on every rank.
    last_blob = None
    worker = ThreadPoolExecutor(1, thread_name_prefix="linna-consumer") if shard is None else None
    capture_before = ps["capture"]
    with span("sampler.loop", ps):
        try:
            pending = None
            while iteration < max_iterations:
                with span("sampler.dispatch", ps):
                    if pending is None:
                        pending = _advance(state)
                    state, chain, lps = pending
                    if method == "zeus" and n_chunks_done < tune_chunks:
                        state = slicemove.tune_mu(state)
                    snap = _snapshot(state, chain, lps)
                    more = iteration + check_every < max_iterations
                    iteration += check_every
                    n_chunks_done += 1
                    job = worker.submit(_consume, snap) if worker is not None else None
                    pending = _advance(state) if more else None
                stop = job.result() if job is not None else _consume(snap)
                if stop:
                    break
        finally:
            if worker is not None:
                worker.shutdown(wait=True)
    # the graphs captured at the first chunk are timed under capture alone
    captured = ps["capture"] - capture_before
    ps["loop"] -= captured
    ps["dispatch"] -= captured
    if graphed is not None:
        # also brings the kernels' counters up to the loops the card ran
        rec = graphed.record()
        if trace_rec is not None:
            trace_rec["graphs"] = rec

    finished_flag = True
    if last_blob is None:  # nothing sampled (a resume at max_iterations)
        _, last_blob = _fetch(_snapshot(state))
    _save_state(last_blob)
    _finish_trace()
    return backend
