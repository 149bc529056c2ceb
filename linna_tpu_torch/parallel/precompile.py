"""Warm-up of what stands between a fresh machine and a run's first kernel
launch, in a daemon thread while iteration 0 makes its training points.

Counterpart of ``linna_tpu/parallel/precompile.py``.  The JAX package
compiles each future iteration's XLA training and sampling programs into
its persistent compilation cache ahead of use.  The port compiles no XLA
program; what a fresh process pays before its first launch is:

- the ``nvcc`` build of every kernel library (``ops.LIBRARIES``; seconds
  each, cached by a hash of the source in :func:`compile_cache_dir`);
- the first launch of each kernel the run's path takes, at the run's shapes
  (the library's module load and the launch planner's first queries);
- cuBLAS's library and handles (the trainer's products).

:func:`warm_pipeline` does these in that order, in one thread, on a side
stream.  The builds are the ones the foreground uses: each library is held
(:meth:`~linna_tpu_torch.ops.library.KernelLibrary.warming`) while the
thread builds it and makes its first launches, and the foreground waits
for it rather than starting its own.  The thread keeps its exception
(:data:`last_error`) and does not raise: a build that failed in the thread
is tried again by the foreground's first launch, which raises the same
error, so a broken compiler still fails the run, and there is no
plain-version fallback on the card.

Gating (``ml_sampler_core``'s call, JAX's conditions): the primary process
of a single-process run, and none of ``train_subprocess``, ``ypositive``,
``nbest``, ``chisqcut`` or ``linearmodel``; the kernel half only when the
run's likelihood takes the kernel (``use_fused``, one member, no custom
likelihood, no ``compute_dtype``).  ``LINNA_PRECOMPILE=0`` turns warming
off.  JAX warms only through its persistent cache and is off without it;
here the thread's build is the process's own, so the cache directory
(``LINNA_COMPILE_CACHE``, see :func:`compile_cache_dir`) does not gate it.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import numpy as np
import torch

__all__ = [
    "warm_pipeline",
    "should_warm",
    "enabled",
    "compile_cache_enabled",
    "compile_cache_dir",
    "last_error",
    "last_report",
]

THREAD_NAME = "linna-precompile"
# the warm thread's exception, and what it did (seconds, launches)
last_error: Optional[BaseException] = None
last_report: dict = {}


def compile_cache_dir() -> Optional[str]:
    """The hashed kernel build directory, kept across processes
    (``LINNA_COMPILE_CACHE`` relocates it), or None when the variable is
    ``0`` or empty: each process then builds into a temporary directory of
    its own."""
    d = os.environ.get("LINNA_COMPILE_CACHE")
    if d in ("0", ""):
        return None
    from ..ops import library

    return str(library.build_dir())


def compile_cache_enabled() -> bool:
    return compile_cache_dir() is not None


def enabled() -> bool:
    return os.environ.get("LINNA_PRECOMPILE", "1") != "0"


def should_warm(params: dict, ypositive: bool = False, nbest=None, chisqcut=None) -> bool:
    """JAX's gate: the primary process of a single-process run with the
    default curation path (row drops, chi^2 cuts and best-point injection
    change the shapes) and no subprocess training or pre-model."""
    from . import multihost as MH

    return bool(
        enabled()
        and MH.is_primary()
        and MH.process_count() == 1
        and not params.get("train_subprocess")
        and not ypositive
        and nbest is None
        and chisqcut is None
        and not params.get("linearmodel")
    )


def _warm(model_name: str, ndim: int, ndata: int, nwalkers: int, batch_size: int,
          use_kernel: bool, device: torch.device) -> dict:
    """The warm-up itself (see the module docstring); returns what it did."""
    import time

    from ..ops import LIBRARIES, fused, library

    report = {"build_s": {}, "launches": dict.fromkeys(library.launches, 0), "cublas_s": 0.0}
    for lib in LIBRARIES:
        first_launches = lib is fused.LIBRARY
        if first_launches and not use_kernel:
            continue
        with lib.warming():
            t0 = time.perf_counter()
            lib.get()
            report["build_s"][lib.name] = time.perf_counter() - t0
            if first_launches and device.type == "cuda":
                report["launches"] = _first_launches(model_name, ndim, ndata, nwalkers, device)
    if device.type == "cuda":
        t0 = time.perf_counter()
        with torch.cuda.stream(torch.cuda.Stream(device)):
            from .. import nn as N

            spec = N.make_model_spec(model_name, ndim, ndata)
            x = torch.zeros((max(int(batch_size), 1), spec.in_size), device=device)
            w = torch.zeros((spec.in_size, spec.hidden), device=device)
            torch.addmm(w[0], x, w)
            torch.cuda.current_stream(device).synchronize()
        report["cublas_s"] = time.perf_counter() - t0
    return report


def _first_launches(model_name: str, ndim: int, ndata: int, nwalkers: int,
                    device: torch.device) -> dict:
    """``fused_log_prob`` on a random-weight emulator of the run's widths at
    the samplers' row counts (the whole ensemble at init, a half-ensemble
    a move), on a side stream; returns each kernel's launches, read from
    its counter (the foreground waits for this thread meanwhile)."""
    from .. import nn as N
    from .. import priors as P
    from .. import transforms as T
    from ..ops import fused, library

    spec = N.make_model_spec(model_name, ndim, ndata)
    tset = T.TransformSet(
        T.XTransform(torch.zeros(ndim, device=device), torch.ones(ndim, device=device),
                     torch.zeros(ndim, dtype=torch.bool, device=device)),
        T.YTransform(torch.zeros(ndata, device=device), torch.ones(ndata, device=device), False),
        T.YTransformData(torch.ones(ndata, device=device)),
    )
    pack = P.priors_from_list([{"dist": "flat", "arg1": -1.0, "arg2": 1.0}] * ndim, device)
    lp = fused.fused_log_prob(spec, N.init_model(spec, seed=0, device=device), tset, pack,
                              np.zeros(ndata), np.eye(ndata), device=device)
    before = dict(library.launches)
    with torch.cuda.stream(torch.cuda.Stream(device)), torch.no_grad():
        for rows in sorted({int(nwalkers), max(int(nwalkers) // 2, 1)}):
            lp(torch.zeros((rows, ndim), device=device))
        torch.cuda.current_stream(device).synchronize()
    return {k: library.launches[k] - before[k] for k in before}


def warm_pipeline(model_name: str, ndim: int, ndata: int, nwalkers: int, batch_size: int,
                  use_kernel: bool, device) -> Optional[threading.Thread]:
    """Start the warm-up thread for a run on ``device``.  Returns the
    thread, or None when warming is off or the device is not a card
    (nothing is built or loaded ahead there).  The thread's exception goes
    to :data:`last_error`, its report to :data:`last_report`."""
    global last_error, last_report
    device = torch.device(device)
    if not enabled() or device.type != "cuda":
        return None
    last_error, last_report = None, {}

    def run():
        global last_error, last_report
        try:
            last_report = _warm(model_name, ndim, ndata, nwalkers, batch_size, use_kernel, device)
        except Exception as e:  # the foreground's own build and launch raise it again
            last_error = e

    t = threading.Thread(target=run, name=THREAD_NAME, daemon=True)
    t.start()
    return t
