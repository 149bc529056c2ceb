#!/usr/bin/env python3
"""Drive linna_tpu_torch on one CUDA card (an H100) and check it.

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing is caught and passed over):

1. Device: name, capability (must be 9.0), ``nvidia-smi`` name and power
   limit, and which chain store the run uses (HDF5, or npz without h5py).
2. Build: compile ``linna_tpu_torch/ops/csrc/fused_mlp.cu`` with nvcc for
   sm_90a and print the seconds and the compiler's register/shared-memory
   report.
3. Kernels against their plain PyTorch versions at the DES-Y1-3x2pt width
   (27 -> 457, hidden 1000) for B in {1, 37, 128, 200, 256, 4096} (200
   leaves a ragged last cluster of ``fused_log_prob`` and a ragged row tile
   of ``fused_apply``): ``fused_apply`` against the plain trunk,
   ``fused_log_prob`` against the plain ``make_log_prob`` composition (mixed
   gauss/flat priors; log10 lanes with non-positive rows that must be -inf
   in both; ypositive), both gradients, and the device time per launch with
   each kernel's launch shape and its bounds: ``fused_apply`` at 128, 256
   and 4096 rows (one cooperative launch of 64 x 64 output tiles),
   ``fused_log_prob`` at the sampler's 128 and 256 (clusters of 8 blocks,
   and how many the card holds at once).  Both kernels also against their
   plain versions at the LSST-Y10 width (40 -> 1560): ``fused_apply`` at
   128, 256 and 4096 rows, ``fused_log_prob`` at 128 and 256, where a
   block's shared memory holds 8 walkers of its cluster, not 16.  Each
   kernel's time counts its own device events in torch.profiler and fails
   unless it saw one per launch (shown once on a deliberate mismatch).
4. The sampling stage of one ``ml_sampler_core`` iteration on a DES-width
   iteration directory written with the port's own writers:
   ``retrieve_model`` -> ``make_log_prob(use_fused=True, temperature=16)``
   -> ``run_ensemble(method="zeus", nwalkers=256)`` for 300 steps ->
   ``read_chain_and_cut`` (and once more with ``walkercut=True``, the
   numpy k-means walker cut) -> the posterior-mean prediction through
   ``retrieve_model_wrapper``.  The kernels' launch counters are zeroed just
   before and read just after: ``fused_log_prob`` must have launched and the
   plain versions must not have run.  ``fused_apply`` is not on this path
   (as in the JAX package); phase 3 alone launches it.
5. Training at the DES width: iteration 0 of a
   pipeline with 10000 training and 500 validation points on a flat Latin
   hypercube over phase 4's priors, the theory a smooth synthetic function
   from a seed, trained by ``train_emulator`` as the README's K=4
   ``EnsembleTrainer`` for ``TRAIN_EPOCHS`` epochs (the paper's 4500 cut to
   fit the time limit).  Every member's best val loss must be finite and
   below 1/10 of its initial weights', and every artifact must exist.  The
   trained ensemble is then sampled (zeus, 256 walkers, T^2 = 16), trained
   member 0's ``make_log_prob(use_fused=True)`` is held against the plain
   composition at the chain's last positions (one launch, no plain call),
   and the canonical ``ml_sampler_core`` drive (ndim 3, 2 iterations, zeus,
   ``use_fused``) runs on the card.  A 10-epoch chunk is timed and another
   traced: ms per epoch, rows per second, launches per epoch, the device's
   busy share and the host's time by op.  The kernels' counts are zeroed
   before the phase and read after it: ``fused_log_prob`` must have
   launched.
6. The gradient samplers and emcee at the DES width on phase 4's single
   emulator with ``use_fused=True`` at T = 1: the per-walker gradient
   through ``fused_log_prob`` (one launch; the backward recomputes the plain
   composition) against the plain gradient at 256 positions, log10 lanes'
   -inf rows included (zero, not NaN); then ``run_ensemble`` with the MAP
   search and 100 NUTS samples, 20 HMC samples, and 300 emcee steps at 256
   walkers: s/100 samples, launches per sample (31 per NUTS sample at depth
   5), mean acceptance, and the device busy share of a traced NUTS chunk.
7. ``python -m linna_tpu_torch.driver zeus None <yaml> examples`` as a
   subprocess on the card, the yaml being ``examples/des_synthetic.yaml``
   cut to depth (two iterations, zeus then nuts at T = 4 then 1,
   ``DRIVER_EPOCHS`` epochs, the convergence keys loosened so that each
   iteration's sampler stops at its second convergence check, 200 steps;
   each cut printed), on inputs written with
   ``examples/des_theory.py``: every artifact, the chain stores,
   ``precond.npz``, ``time.npy``, bfloat16 training, and the posterior mean's
   offsets from ``EXACT_POSTERIOR.json`` (reported, not gated).
8. The pre-model and bf16 inference at the DES width.  8a: one
   ``ml_sampler_core`` iteration on phase 5's seeded theory with
   ``linearmodel: {norder: 2}``, K=2 trained in bfloat16 for
   ``PREMODEL_EPOCHS`` epochs with ``use_fused``, zeus at T = 1 stopped at
   its second tau check (200 steps): ``linear_model.npz`` against a fit of
   the same rows (its seconds and traced host memory), each member's
   learning, ``retrieve_model_wrapper`` against the network plus the
   pre-model at 256 rows, and 0 launches of both kernels (an ensemble with
   a pre-model takes the composition, as in JAX).  8b: member 0 with its
   pre-model: per-walker gradients, the MAP search and 20 NUTS samples at
   256 walkers, and a finite, symmetric Hessian at the MAP point.  8c:
   phase 5's trained K=4 ensemble and its member 0 in bfloat16 against
   float32 at 256 and 4096 positions of phase 5's chain (float32 out, the
   same -inf rows, relative error within ``BF16_RTOL``), each call's
   device and call ms, zeus for 100 steps in each type for K=1 and K=4,
   and ``use_fused`` refusing ``compute_dtype``.
9. One ``{"kernels": [...]}`` line, the card's name and power limit, and the
   last line ``{"ok": true, "device": {...}}``.

Phase 4's and 6's weights are random (from a seed); phases 5, 7 and 8 train
their own.  Exits nonzero with no result line when no CUDA device is
present.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
RUN_DIR = os.path.join(ROOT, ".chip_smoke")

NDIM, NDATA = 27, 457  # DES-Y1-3x2pt (examples/des_synthetic.yaml)
WIDE = (40, 1560)  # LSST-Y10-6x2pt+N (examples/lsst_synthetic.yaml)
NWALKERS = 256
TEMPERATURE = 16.0  # T^2 of iteration 0 (T = 4)
STEPS = 300
BATCHES = (1, 37, 128, 200, 256, 4096)
# fused_apply at the sampler's batches and at bench.py's 4096 walkers, the
# batch it exists for; fused_log_prob where the sampler calls it
TIMED_ROWS = {"fused_apply": (128, 256, 4096), "fused_log_prob": (128, 256)}
WIDE_ROWS = {"fused_apply": (128, 256, 4096), "fused_log_prob": (128, 256)}
REPS = 30
# phase 5: ml_sampler's training set (orchestrator.py:582-583) and ensemble
# (:614), depth cut from 4500 epochs to TRAIN_EPOCHS
NTRAIN, NVAL = 10000, 500
NENSEMBLE = 4
TRAIN_EPOCHS = 300
ENS_STEPS = 100
# phase 6: the gradient samplers and emcee on one emulator
NUTS_STEPS, HMC_STEPS, EMCEE_STEPS = 100, 20, 300
# phase 7: des_synthetic.yaml through the driver, its 1000 epochs cut
DRIVER_EPOCHS = 100
DRIVER_TIMEOUT = 900
# phase 8: the pre-model pipeline (K=2, bf16 training, ml_sampler's 4500
# epochs cut), NUTS through the pre-model, and bf16 inference on phase 5's
# trained ensemble (kept in TRAINED_DIR until then)
PREMODEL_EPOCHS = 300
PREMODEL_ENSEMBLE = 2
PREMODEL_NUTS = 20
BF16_WALKERS = (256, 4096)
BF16_ZEUS_STEPS = 100
# tests/test_compute_dtype.py's tolerance: |lp_bf16 - lp_f32| / max(1, |lp_f32|)
BF16_RTOL = 0.05
TRAINED_DIR = os.path.join(ROOT, ".chip_smoke_trained")

# tests/test_ops.py's kernel tolerance; both sides accumulate in f32 and
# differ only in summation order
RTOL = ATOL = 2e-4

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_F32_FLOPS = 67e12  # CUDA cores, no tensor cores
PEAK_TF32_FLOPS = 494.7e12  # tensor cores, TF32
PEAK_BYTES = 3.35e12
SOURCE = "linna_tpu_torch/ops/csrc/fused_mlp.cu"
REPLACES = {
    "fused_apply": "linna_tpu/ops/fused.py:138",
    "fused_log_prob": "linna_tpu/ops/fused.py:250",
}
# each kernel's name in the compiler's report and the profiler's events
KERNEL_NAMES = {"fused_apply": "fused_apply_kernel", "fused_log_prob": "fused_log_prob_kernel"}


def log(*a) -> None:
    print(*a, flush=True)


# ------------------------------------------------------------------ inputs


def make_problem(device, ndim=NDIM, ndata=NDATA, seed=0, log10=(), ypositive=False):
    """Random DES-width weights, transforms, mixed priors, data and a dense
    SPD inverse covariance, from one seed."""
    from linna_tpu_torch import nn as N
    from linna_tpu_torch import priors as P
    from linna_tpu_torch import transforms as T

    rng = np.random.default_rng(seed)
    spec = N.make_model_spec("chto_v2", ndim, ndata)
    params = N.init_model(spec, seed=seed, device=device)
    mask = np.zeros(ndim, bool)
    mask[list(log10)] = True
    priors = mixed_priors(ndim)
    if ypositive:
        y_mean, y_std = np.zeros(ndata), np.full(ndata, 0.05)
    else:
        y_mean, y_std = rng.normal(size=ndata) * 0.1, 1.0 + 0.3 * rng.uniform(size=ndata)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    ts = T.TransformSet(
        T.XTransform(f32(rng.normal(size=ndim) * 0.1), f32(1.0 + 0.1 * rng.uniform(size=ndim)),
                     torch.as_tensor(mask, device=device)),
        T.YTransform(f32(y_mean), f32(y_std), ypositive),
        T.YTransformData(f32(0.5 + rng.uniform(size=ndata))),
    )
    data = rng.normal(size=ndata) * 0.3
    if ypositive:
        data = np.abs(data) + 1.0
    a = rng.normal(size=(ndata, ndata)) / np.sqrt(ndata)
    inv_cov = np.eye(ndata) + 0.1 * a @ a.T
    return spec, params, ts, P.priors_from_list(priors, device), data, inv_cov


def compare(got: torch.Tensor, want: torch.Tensor, what: str) -> dict:
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    ninf_g, ninf_w = torch.isneginf(got), torch.isneginf(want)
    if not torch.equal(ninf_g, ninf_w):
        raise AssertionError(f"{what}: -inf rows differ")
    fin = ~ninf_w
    if not torch.isfinite(got[fin]).all():
        raise AssertionError(f"{what}: non-finite values where the plain version is finite")
    diff = (got[fin] - want[fin]).abs()
    abs_err = float(diff.max()) if diff.numel() else 0.0
    rel_err = float((diff / want[fin].abs().clamp(min=1e-30)).max()) if diff.numel() else 0.0
    ok = bool(torch.all(diff <= ATOL + RTOL * want[fin].abs()))
    log(f"  {what}: max_abs_err={abs_err:.3e} max_rel_err={rel_err:.3e} "
        f"-inf rows={int(ninf_w.sum())} within rtol=atol={RTOL:g}: {ok}")
    if not ok:
        raise AssertionError(f"{what}: kernel and plain version disagree")
    return {"abs": abs_err, "rel": rel_err}


def _warm(fn) -> None:
    """Enough calls for the clocks to ramp; the weights then stay in L2
    between calls, as they do between the sampler's calls."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()


def kernel_events(prof) -> dict:
    """Device events by kernel name in a torch.profiler run, as (count,
    microseconds): the device-side events only, as the profiler's own table
    totals them (a CPU op's device time is the same kernels counted again)."""
    from torch.autograd import DeviceType

    out: dict = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            n, us = out.get(e.key, (0, 0.0))
            out[e.key] = (n + e.count, us + e.self_device_time_total)
    return out


def kernel_us(prof) -> dict:
    """Device microseconds by kernel name in a torch.profiler run."""
    return {k: us for k, (_, us) in kernel_events(prof).items() if us > 0}


def _profiled_events(fn, reps: int) -> dict:
    """{kernel name: (device events, device microseconds)} of ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return kernel_events(prof)


def device_ms(fn, kernel=None, per_call=1, reps=REPS, attempts=3) -> tuple:
    """Device time per call from torch.profiler's device events over
    ``reps`` calls; returns (ms, method).

    ``kernel``: the name of the call's own CUDA kernel, which it launches
    ``per_call`` times.  Only that kernel's events are timed, and there must
    be reps x per_call of them: a profile that missed some would read short
    without a sign.  A count that differs is logged and the reading taken
    again; after ``attempts`` readings it raises.

    ``kernel=None``: a call with no kernel of its own (a plain version, a
    chain of library kernels whose count per call the profiler does not
    reproduce: 37 to 40 at 4096 rows of the plain trunk on the H100).  Every
    device event is timed and their count reported, not checked.  Where the
    profiler records no device event at all, the time comes from CUDA events
    around ``reps`` back-to-back calls, host launch gaps included, and the
    method says so."""
    _warm(fn)
    if kernel is None:
        events = _profiled_events(fn, reps).values()
        n, us = sum(c for c, _ in events), sum(u for _, u in events)
        if n:
            return us / reps / 1e3, f"torch.profiler, {n} device events of the call's kernels"
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return (start.elapsed_time(end) / reps,
                "cuda events around back-to-back calls (the profiler saw no device event)")
    want = reps * per_call
    for attempt in range(1, attempts + 1):
        mine = [v for k, v in _profiled_events(fn, reps).items() if kernel in k]
        n, us = sum(c for c, _ in mine), sum(u for _, u in mine)
        if n == want:
            return us / reps / 1e3, f"torch.profiler, {n} device events of {kernel}"
        log(f"  device_ms: {n} device events of {kernel} where {want} were launched "
            f"(reading {attempt} of {attempts})")
    raise AssertionError(f"device_ms: the profiler saw {n} device events of {kernel}, "
                         f"not the {want} launched")


def call_ms(fn, reps=REPS) -> float:
    """Median time of one call from CUDA events around it, the host's
    launch work included: what one likelihood call of the sampler costs."""
    _warm(fn)
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound_ms(kernel: str, spec, params, rows: int) -> dict:
    """Least time for the work: the operations at the peak of the kernel's
    own arithmetic (fused_apply: 3 TF32 tensor-core products per f32
    product; fused_log_prob: f32 FMAs on the CUDA cores) or the bytes at the
    memory rate, whichever is longer; each input read once and each output
    written once.  Both operation bounds are returned for both kernels."""
    from linna_tpu_torch import nn as N

    n_params = N.count_params(params)
    flops = 2.0 * n_params * rows
    nbytes = 4.0 * (n_params + rows * spec.in_size)
    if kernel == "fused_log_prob":
        n = spec.out_size
        flops += 2.0 * n * n * rows
        # inverse covariance, 6 length-D and 4 length-N vectors, one f32 out
        nbytes += 4.0 * (n * n + 6 * spec.in_size + 4 * n + rows)
    else:
        nbytes += 4.0 * rows * spec.out_size
    f32 = flops / PEAK_F32_FLOPS * 1e3
    tf32x3 = 3.0 * flops / PEAK_TF32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = tf32x3 if kernel == "fused_apply" else f32
    return {"ms": max(t_ops, t_bytes), "by": "operations" if t_ops >= t_bytes else "bytes",
            "f32_cuda_core_ms": f32, "tf32x3_tensor_core_ms": tf32x3, "bytes_ms": t_bytes}


def kernel_resources(report: str) -> dict:
    """Registers and spilled bytes of each kernel, from nvcc's -Xptxas -v
    report."""
    out: dict = {}
    name = None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = next((k for k, v in KERNEL_NAMES.items() if v in line), None)
        elif name is not None:
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            regs = re.search(r"Used (\d+) registers", line)
            if spill:
                out.setdefault(name, {})["spill_bytes"] = int(spill[1]) + int(spill[2])
            if regs:
                out.setdefault(name, {})["registers"] = int(regs[1])
    return out


# ---------------------------------------------------------------- phases


def phase_kernels(device, batches=BATCHES, timed=TIMED_ROWS, ndim=NDIM, ndata=NDATA, wide=WIDE,
                  wide_rows=WIDE_ROWS):
    """Each kernel against its plain version; returns per-kernel records."""
    from linna_tpu_torch import likelihood as LK
    from linna_tpu_torch.ops import fused as F

    gen = torch.Generator(device="cpu").manual_seed(7)
    rec = {k: {"abs": 0.0, "rel": 0.0, "ms": {}, "plain_ms": {}, "call_ms": {},
               "plain_call_ms": {}, "bound": {}, "shape": {}} for k in REPLACES}

    def note(kernel, err):
        rec[kernel]["abs"] = max(rec[kernel]["abs"], err["abs"])
        rec[kernel]["rel"] = max(rec[kernel]["rel"], err["rel"])

    # fused_apply against the plain trunk
    spec, params, ts, pack, data, inv_cov = make_problem(device, ndim, ndata)
    for b in batches:
        x = torch.randn((b, ndim), generator=gen).to(device)
        note("fused_apply", compare(F.fused_apply(spec, params, x),
                                    F.fused_apply_plain(spec, params, x), f"fused_apply B={b}"))

    # fused_log_prob against make_log_prob's plain composition, three cases
    cases = {
        "mixed priors": dict(),
        "log10 lanes": dict(log10=(0, 3)),  # gauss priors around 0.3: some x <= 0
        "ypositive": dict(ypositive=True),
    }
    for case, kw in cases.items():
        spec, params, ts, pack, data, inv_cov = make_problem(device, ndim, ndata, **kw)
        lp_k = LK.make_log_prob(spec, params, ts, pack, data, inv_cov,
                                temperature=TEMPERATURE, use_fused=True, device=device)
        lp_p = LK.make_log_prob(spec, params, ts, pack, data, inv_cov,
                                temperature=TEMPERATURE, device=device)
        for b in batches:
            x = torch.randn((b, ndim), generator=gen).to(device)
            if case == "log10 lanes":
                x[: (b + 1) // 2, 0] = -3.0  # physical 0.3 - 3 < 0 on a log10 lane
            note("fused_log_prob", compare(lp_k(x), lp_p(x), f"fused_log_prob {case} B={b}"))

    # the widest model the repo configures: its launch shape and both kernels
    spec, params, ts, pack, data, inv_cov = make_problem(device, *wide)
    lp_k = LK.make_log_prob(spec, params, ts, pack, data, inv_cov,
                            temperature=TEMPERATURE, use_fused=True, device=device)
    lp_p = LK.make_log_prob(spec, params, ts, pack, data, inv_cov,
                            temperature=TEMPERATURE, device=device)
    wide_fns = {"fused_apply": (lambda x: F.fused_apply(spec, params, x),
                                lambda x: F.fused_apply_plain(spec, params, x)),
                "fused_log_prob": (lp_k, lp_p)}
    wide_shapes = {}
    for k, rows in wide_rows.items():
        kern, plain = wide_fns[k]
        for b in rows:
            x = torch.randn((b, wide[0]), generator=gen).to(device)
            note(k, compare(kern(x), plain(x), f"{k} {wide[0]} -> {wide[1]} B={b}"))
            shape = F.launch_shape(spec, b, k)
            log(f"  {k} {wide[0]} -> {wide[1]} B={b}: launch shape {shape}")
            if k == "fused_log_prob":
                wide_shapes[b] = shape

    # gradients: the kernels' autograd.Functions against plain autograd
    spec, params, ts, pack, data, inv_cov = make_problem(device, ndim, ndata)
    x = torch.randn((128, ndim), generator=gen).to(device)
    weights = F._flatten_params(params)
    wk = [w.detach().clone().requires_grad_(True) for w in weights]
    wp = [w.detach().clone().requires_grad_(True) for w in weights]
    xk, xp = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    probe = torch.randn((128, ndata), generator=gen).to(device)
    (F._FusedApply.apply(spec, xk, *wk) * probe).sum().backward()
    (F._trunk_plain(xp, wp) * probe).sum().backward()
    compare(xk.grad, xp.grad, "fused_apply grad x")
    for i, (a, b) in enumerate(zip(wk, wp)):
        if i in (0, 21):
            compare(a.grad, b.grad, f"fused_apply grad weight {i}")
    lp_k = LK.make_log_prob(spec, params, ts, pack, data, inv_cov,
                            temperature=TEMPERATURE, use_fused=True, device=device)
    lp_p = LK.make_log_prob(spec, params, ts, pack, data, inv_cov,
                            temperature=TEMPERATURE, device=device)
    xk, xp = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    lp_k(xk).sum().backward()
    lp_p(xp).sum().backward()
    compare(xk.grad, xp.grad, "fused_log_prob grad x")

    # device time per launch
    fns = {"fused_apply": (lambda x: F.fused_apply(spec, params, x),
                           lambda x: F.fused_apply_plain(spec, params, x)),
           "fused_log_prob": (lp_k, lp_p)}
    with torch.no_grad():
        x = torch.randn((timed["fused_apply"][0], ndim), generator=gen).to(device)
        try:
            device_ms(lambda: F.fused_apply(spec, params, x), KERNEL_NAMES["fused_apply"],
                      per_call=2, reps=3, attempts=1)
        except AssertionError as e:
            log(f"  device_ms refuses a count that does not match the launches: {e}")
        else:
            raise AssertionError("device_ms took a reading with half the launched events")
        for k, rows in timed.items():
            kern, plain = fns[k]
            r = rec[k]
            for b in rows:
                x = torch.randn((b, ndim), generator=gen).to(device)
                r["ms"][b], r["method"] = device_ms(lambda: kern(x), KERNEL_NAMES[k])
                r["plain_ms"][b], r["plain_method"] = device_ms(lambda: plain(x))
                r["call_ms"][b] = call_ms(lambda: kern(x))
                r["plain_call_ms"][b] = call_ms(lambda: plain(x))
                r["bound"][b] = bound_ms(k, spec, params, b)
                r["shape"][b] = F.launch_shape(spec, b, k)
                bd = r["bound"][b]
                log(f"  {k} B={b}: kernel {r['ms'][b]:.4f} ms ({r['method']}), plain "
                    f"{r['plain_ms'][b]:.4f} ms device ({r['plain_method']}); per call with "
                    f"host {r['call_ms'][b]:.4f} / {r['plain_call_ms'][b]:.4f} ms; bound "
                    f"{bd['ms']:.4f} ms ({bd['by']}; f32 CUDA cores "
                    f"{bd['f32_cuda_core_ms']:.4f}, 3xTF32 tensor cores "
                    f"{bd['tf32x3_tensor_core_ms']:.4f}, bytes {bd['bytes_ms']:.4f}); "
                    f"launch shape {r['shape'][b]}")
    for b, shape in [*rec["fused_log_prob"]["shape"].items(), *wide_shapes.items()]:
        if shape["cluster_size"] != 8 or shape["max_active_clusters"] < 1:
            raise AssertionError(f"fused_log_prob B={b}: launch shape {shape}")
    return rec


def traced_call(fn, device) -> dict:
    """Where the time goes in one profiled call of ``fn``: its wall time, the
    device's busy share and the device time by kernel (the profiler's own
    host cost is inside the wall time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = kernel_events(prof)
    total = sum(us for _, us in events.values()) / 1e3
    by_kernel = sorted(((k, us / 1e3) for k, (_, us) in events.items()), key=lambda kv: -kv[1])
    return {"wall_ms": wall_ms, "device_ms": total, "device_busy_share": total / wall_ms,
            "launches": sum(n for n, _ in events.values()),
            "device_ms_by_kernel": dict(by_kernel[:6])}


def traced_chunk(log_prob, coords, device, steps=20) -> dict:
    """Where the time goes: one profiled ``steps``-step slice chunk from the
    chain's last positions (run after the main path's counts were read)."""
    from linna_tpu_torch.samplers import slicemove as S

    state = S.init_slice_state(torch.Generator(device=device).manual_seed(1),
                               torch.as_tensor(coords, dtype=torch.float32, device=device), log_prob)
    return {"steps": steps, **traced_call(lambda: S.slice_chunk(log_prob, state, steps), device)}


def write_iteration_dir(outdir, device, seed=3, ndim=NDIM, ndata=NDATA, ntrain=2000):
    """An iteration directory as training leaves it, written with the port's
    own writers: random weights, transforms fitted to synthetic training
    samples, and a data vector equal to the emulator's prediction at a
    truth point plus noise, with a diagonal covariance."""
    from linna_tpu_torch import nn as N
    from linna_tpu_torch import orchestrator as O
    from linna_tpu_torch import priors as P
    from linna_tpu_torch import transforms as T
    from linna_tpu_torch.utils import checkpoint as ckpt

    rng = np.random.default_rng(seed)
    priors = mixed_priors(ndim)
    pack = P.priors_from_list(priors, device)
    os.makedirs(outdir, exist_ok=True)
    spec = N.make_model_spec("chto_v2", ndim, ndata)
    params = N.init_model(spec, seed=seed, device=device)
    train_x = P.transform_np(pack, rng.normal(size=(ntrain, ndim)))
    proj = rng.normal(size=(ndim, ndata)) / np.sqrt(ndim)
    train_y = 10.0 + train_x @ proj  # a smooth synthetic theory
    sigma = 0.05 * np.abs(train_y.mean(axis=0)) + 0.01
    ts = T.TransformSet(
        T.fit_x_transform(train_x, device=device),
        T.fit_y_transform(train_y / sigma, device=device),
        T.YTransformData(torch.as_tensor(sigma, dtype=torch.float32, device=device)),
    )
    np.savetxt(os.path.join(outdir, "train_samples_x.txt"), train_x)
    np.save(os.path.join(outdir, "train_samples_y.npy"), train_y)
    T.save_transforms(os.path.join(outdir, O.TRANSFORMS_FILE), ts)
    ckpt.save_checkpoint(os.path.join(outdir, O.BEST_CKPT), params, meta={"seed": seed})
    with open(os.path.join(outdir, O.FINISH_MARKER), "w") as f:
        json.dump({"status": "done"}, f)

    truth_white = rng.normal(size=ndim) * 0.3
    truth = P.transform_np(pack, truth_white[None])[0]
    with torch.no_grad():
        x_in = ts.x_transform(torch.as_tensor(truth[None], dtype=torch.float32, device=device))
        pred = ts.y_data.inverse(ts.y_transform(N.apply_model(spec, params, x_in)))[0]
    data = pred.double().cpu().numpy() + sigma * rng.normal(size=ndata)
    cov = np.diag(sigma**2)
    return priors, data, cov, truth


def phase_slice(device, outdir, nwalkers=NWALKERS, steps=STEPS, ndim=NDIM, ndata=NDATA):
    """The sampling stage of one ml_sampler_core iteration through the
    port's public functions; returns the launch counts and rates."""
    from linna_tpu_torch import likelihood as LK
    from linna_tpu_torch import orchestrator as O
    from linna_tpu_torch import priors as P
    from linna_tpu_torch.ops import fused as F
    from linna_tpu_torch.samplers import run as R

    priors, data, cov, truth = write_iteration_dir(outdir, device, ndim=ndim, ndata=ndata)
    inv_cov = np.linalg.inv(cov)
    pack = P.priors_from_list(priors, device)
    init_white = P.inv_transform(pack, torch.as_tensor(truth, dtype=torch.float32, device=device))
    x0 = init_white.cpu().numpy() + 0.001 * np.random.default_rng(0).standard_normal((nwalkers, ndim))
    rows = {"n": 0}

    F.reset_counts()
    t0 = time.perf_counter()
    in_saved, out_saved = O._saved_shapes(outdir)
    model = O.retrieve_model(outdir, in_saved, out_saved, device=device)
    params_lp = O.retrieve_ensemble_params(outdir, model)
    log_prob = LK.make_log_prob(
        model.spec, params_lp if len(params_lp) > 1 else model.params, model.transforms,
        pack, data, inv_cov, temperature=TEMPERATURE, use_fused=True, device=device,
    )

    def counted(x):
        rows["n"] += x.shape[0]
        return log_prob(x)

    trace = {}
    t1 = time.perf_counter()
    R.run_ensemble(
        counted, x0, outdir, method="zeus",
        transform=lambda x: P.transform_np(pack, x),
        check_every=100, max_iterations=steps, seed=0, device=device, trace_rec=trace,
    )
    t2 = time.perf_counter()
    chain_path = os.path.join(outdir, O._chain_filename("zeus"))
    chain, logp, reader = O.read_chain_and_cut(chain_path, nk=2, ntimes=10, method="zeus", flat=True)
    cut_chain, cut_lp, _ = O.read_chain_and_cut(chain_path, nk=2, ntimes=10, walkercut=True,
                                                method="zeus")
    emulator = O.retrieve_model_wrapper(outdir, device=device)
    with torch.no_grad():
        pred = emulator(chain.mean(axis=0))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t3 = time.perf_counter()
    launches, plain = dict(F.launches), dict(F.plain_calls)

    samples, lps = reader.get_chain(), reader.get_log_prob()
    if samples.shape != (steps, nwalkers, ndim) or lps.shape != (steps, nwalkers):
        raise AssertionError(f"chain shapes {samples.shape}, {lps.shape}")
    if not (np.isfinite(samples).all() and np.isfinite(lps).all() and np.isfinite(chain).all()):
        raise AssertionError("the chain or its log-probs are not finite")
    if (cut_lp.shape[1] < 1 or cut_chain.shape != (cut_lp.size, ndim)
            or not np.isfinite(cut_chain).all()):
        raise AssertionError(f"walker cut: chain {cut_chain.shape}, log-probs {cut_lp.shape}")
    pred = pred.cpu().numpy()
    if pred.shape != (ndata,) or not np.isfinite(pred).all():
        raise AssertionError(f"posterior-mean prediction {pred.shape} is not finite")
    # the stored log-probs against the plain composition at the stored points
    plain_lp = LK.make_log_prob(model.spec, model.params, model.transforms, pack, data,
                                inv_cov, temperature=TEMPERATURE, device=device)
    with torch.no_grad():
        last = torch.as_tensor(samples[-1], dtype=torch.float32, device=device)
        compare(torch.as_tensor(lps[-1]), plain_lp(last), "stored log-probs vs plain make_log_prob")
    chi2 = float(np.sum((pred - data) ** 2 / np.diag(cov)))
    busy = traced_chunk(log_prob, samples[-1], device) if device.type == "cuda" else None
    if launches["fused_log_prob"] == 0:
        raise AssertionError(f"fused_log_prob did not launch on the main path: {launches}")
    if any(plain.values()):
        raise AssertionError(f"a plain version ran on the main path: {plain}")
    res = {
        "store": reader.path,
        "setup_s": t1 - t0,
        "sample_s": t2 - t1,
        "cut_and_predict_s": t3 - t2,
        "s_per_100_steps": (t2 - t1) / (steps / 100),
        "rows_per_s": rows["n"] / (t2 - t1),
        "rows": rows["n"],
        "launches": launches,
        "launches_per_step": launches["fused_log_prob"] / steps,
        "plain_calls": plain,
        "kept_samples": int(chain.shape[0]),
        "walkercut_kept_walkers": int(cut_lp.shape[1]),
        "posterior_mean_chi2_per_point": chi2 / ndata,
        "trace": trace,
        "traced_chunk": busy,
    }
    log(f"  slice: {json.dumps(res, default=float)}")
    return res


# ---------------------------------------------------------------- training


class SmoothTheory:
    """A smooth synthetic theory made from a seed: ``y = 10 + tanh(x A) B``
    with A (ndim, width) and B (width, ndata) Gaussian.  Called as the
    pipeline calls a theory, ``theory([index, x], scratch_dir)``."""

    def __init__(self, ndim: int, ndata: int, seed: int = 5, width: int = 64):
        rng = np.random.default_rng(seed)
        self.a = rng.normal(size=(ndim, width)) / np.sqrt(ndim)
        self.b = rng.normal(size=(width, ndata)) / np.sqrt(width)

    def batch(self, x: np.ndarray) -> np.ndarray:
        return 10.0 + np.tanh(np.asarray(x, np.float64) @ self.a) @ self.b

    def __call__(self, task, outdir) -> np.ndarray:
        return self.batch(np.asarray(task[1])[None])[0]


def mixed_priors(ndim: int) -> list:
    """Phase 4's priors: Gaussian on every third parameter, flat elsewhere."""
    return [
        {"dist": "gauss", "arg1": 0.3, "arg2": 1.0} if i % 3 == 0
        else {"dist": "flat", "arg1": -2.0, "arg2": 2.0}
        for i in range(ndim)
    ]


def seeded_problem(device, ndim: int, ndata: int):
    """Phase 5's problem, from seeds: the smooth theory, the mixed priors, a
    truth point, a data vector (the theory at the truth plus noise, sigma
    0.1), its covariance, and the generator, which phase 5 draws on."""
    from types import SimpleNamespace

    from linna_tpu_torch import priors as P

    theory = SmoothTheory(ndim, ndata)
    priors = mixed_priors(ndim)
    pack = P.priors_from_list(priors, device)
    rng = np.random.default_rng(11)
    truth = P.transform_np(pack, rng.normal(size=(1, ndim)) * 0.3)[0]
    sigma = np.full(ndata, 0.1)
    data = theory.batch(truth[None])[0] + sigma * rng.normal(size=ndata)
    cov = np.diag(sigma**2)
    return SimpleNamespace(theory=theory, priors=priors, pack=pack, rng=rng, truth=truth,
                           sigma=sigma, data=data, cov=cov, inv_cov=np.linalg.inv(cov))


def iteration_missing(outdir: str, nensemble: int, chain: bool = False) -> list:
    """The artifacts of a trained (and, with ``chain``, sampled) iteration
    directory that are not there: the sample files, transforms, marker, and
    each member's checkpoints and learning rate."""
    from linna_tpu_torch import orchestrator as O

    need = ["train_samples_x.txt", "train_samples_y.npy", "val_samples_x.txt",
            "val_samples_y.npy", O.TRANSFORMS_FILE, O.FINISH_MARKER]
    for k in range(nensemble):
        sub = "" if k == 0 else f"ens_{k}"
        need += [os.path.join(sub, f) for f in (O.BEST_CKPT, "last.ckpt.npz", "lr.npy")]
    missing = [f for f in need if not os.path.isfile(os.path.join(outdir, f))]
    if chain and not O._open_backend(os.path.join(outdir, O._chain_filename("zeus")), "zeus").exists():
        missing.append(O._chain_filename("zeus"))
    return missing


def member_dirs(outdir: str, nensemble: int) -> list:
    return [outdir] + [os.path.join(outdir, f"ens_{k}") for k in range(1, nensemble)]


def initial_val_losses(outdir, spec, data, cov, seeds, device, linearmodel=None) -> list:
    """Each member's validation loss (the median chi^2 ratio) at its initial
    weights, which its seed fixes, under the iteration's transforms, with
    the iteration's pre-model added where it has one."""
    from linna_tpu_torch import data as D
    from linna_tpu_torch import losses as L
    from linna_tpu_torch import nn as N
    from linna_tpu_torch import orchestrator as O
    from linna_tpu_torch import transforms as T

    ts = T.load_transforms(os.path.join(outdir, O.TRANSFORMS_FILE), device=device)
    ls = L.build_loss_state(data, cov, ts)
    stack = D.load_curated_stack([outdir])
    vx = torch.as_tensor(stack.val_x, dtype=torch.float32, device=device)
    vy = torch.as_tensor(stack.val_y, dtype=torch.float32, device=device)
    out = []
    with torch.no_grad():
        for s in seeds:
            pred = N.apply_model(spec, N.init_model(spec, seed=s, device=device), ts.x_transform(vx),
                                 linearmodel=linearmodel)
            out.append(float(L.val_metric_fn(ls, ts, pred, vy)[0]))
    return out


def best_val_losses(outdir: str, nensemble: int) -> list:
    from linna_tpu_torch import orchestrator as O
    from linna_tpu_torch.utils import checkpoint as ckpt

    return [float(ckpt.read_checkpoint_raw(os.path.join(d, O.BEST_CKPT))[1]["best_val_loss"])
            for d in member_dirs(outdir, nensemble)]


def not_learned(best: list, initial: list, factor: float = 10.0) -> list:
    """Members whose best val loss is not finite or not below 1/factor of
    their initial weights' val loss: [(member, best, initial)]."""
    return [(m, b, i) for m, (b, i) in enumerate(zip(best, initial))
            if not (np.isfinite(b) and b < i / factor)]


def trained_ensemble_trainer(outdir, data, cov, nensemble, batch_size, device,
                             compute_dtype=None, linearmodel=None):
    """An EnsembleTrainer holding the trained members' best weights, over
    the iteration's rows, for a timed and a traced chunk."""
    from linna_tpu_torch import data as D
    from linna_tpu_torch import losses as L
    from linna_tpu_torch import nn as N
    from linna_tpu_torch import orchestrator as O
    from linna_tpu_torch import transforms as T
    from linna_tpu_torch.parallel import EnsembleTrainer
    from linna_tpu_torch.utils import checkpoint as ckpt

    stack = D.load_curated_stack([outdir])
    ts = T.load_transforms(os.path.join(outdir, O.TRANSFORMS_FILE), device=device)
    spec = N.make_model_spec("chto_v2", stack.train_x.shape[1], stack.train_y.shape[1])
    params = [ckpt.load_checkpoint(os.path.join(d, O.BEST_CKPT), device="cpu")[0]
              for d in member_dirs(outdir, nensemble)]
    tr = EnsembleTrainer(spec, ts, L.build_loss_state(data, cov, ts), [None] * nensemble,
                         list(range(nensemble)), params=params, compute_dtype=compute_dtype,
                         linearmodel=linearmodel, device=device)
    tr._batch_size = batch_size
    rows = tr._prepare(stack.train_x, stack.train_y, stack.val_x, stack.val_y)
    return tr, rows, len(stack.train_x)


def epoch_ms(tr, rows, n, device, epochs=10) -> float:
    """ms an epoch of a chunk of ``epochs`` epochs after a warm epoch, timed
    with a synchronize on each side."""
    tr._epochs_tracked(tr._draw_perms(1, n), rows)
    perms = tr._draw_perms(epochs, n)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    tr._epochs_tracked(perms, rows)
    torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) / epochs * 1e3


def timed_train_chunk(tr, rows, n, device, epochs=10) -> dict:
    """Where a training epoch's time goes: a chunk of ``epochs`` epochs timed
    with a synchronize on each side, then one traced by torch.profiler
    (its wall includes the profiler's own cost): device busy share, kernel
    launches per epoch, and device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    wall = epoch_ms(tr, rows, n, device, epochs) * epochs / 1e3
    perms = tr._draw_perms(epochs, n)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr._epochs_tracked(perms, rows)
        torch.cuda.synchronize(device)
        traced_wall = time.perf_counter() - t0
    events = kernel_events(prof)
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count) for e in prof.key_averages()
                   if e.self_cpu_time_total > 0), key=lambda r: -r[1])
    n_kernels = sum(c for c, _ in events.values())
    dev_ms = sum(us for _, us in events.values()) / 1e3
    by_kernel = sorted(((k, us / 1e3) for k, (_, us) in events.items()), key=lambda kv: -kv[1])
    rows_per_epoch = (n // tr._batch_size) * tr._batch_size * tr.n_members
    return {
        "epochs": epochs,
        "ms_per_epoch": wall / epochs * 1e3,
        "rows_per_s": rows_per_epoch * epochs / wall,
        "traced_wall_ms": traced_wall * 1e3,
        "device_ms": dev_ms,
        "device_busy_share": dev_ms / (traced_wall * 1e3),
        "launches_per_epoch": n_kernels / epochs,
        "device_ms_by_kernel": dict(by_kernel[:8]),
        "host_ms_and_calls_by_op": {k: [ms, n] for k, ms, n in host[:10]},
    }


def drive_pipeline(outdir, device, use_fused=False) -> dict:
    """The canonical ml_sampler_core drive (ndim 3, 2 iterations, zeus) of
    the verify recipe; ``use_fused`` routes its single emulator through
    ``fused_log_prob``."""
    import linna_tpu_torch as LT

    ndim = 3
    cov, means = np.diag([0.3, 0.5, 0.2]), np.array([0.3, -0.2, 0.5])
    priors = [{"param": f"p{i}", "dist": "flat", "arg1": -2.0, "arg2": 2.0} for i in range(ndim)]
    t0 = time.perf_counter()
    chain, logp = LT.ml_sampler_core(
        ntrainArr=[400, 400], nvalArr=[80, 80], nkeepArr=[2, 4], ntimesArr=[8, 15],
        ntautolArr=[0.2, 0.1], meanshiftArr=[0.5, 0.5], stdshiftArr=[0.5, 0.5],
        outdir=outdir, theory=_identity_theory, priors=priors, data=means, cov=cov,
        init=np.zeros(ndim), pool=None, nwalkers=24, temperatureArr=[2.0, 1.0],
        params={"trainingoption": 1, "num_epochs": 300, "batch_size": 100,
                "use_fused": use_fused},
        method="zeus", seed=3, device=device,
    )
    seconds = time.perf_counter() - t0
    missing = [f"iter_{i}/{f}" for i in range(2)
               for f in iteration_missing(os.path.join(outdir, f"iter_{i}"), 1, chain=True)]
    if missing:
        raise AssertionError(f"ml_sampler_core left artifacts out: {missing}")
    if chain.ndim != 2 or chain.shape[1] != ndim or not np.isfinite(chain).all() \
            or not np.isfinite(logp).all():
        raise AssertionError(f"ml_sampler_core chain {chain.shape} is not finite")
    sd = np.sqrt(np.diag(cov))
    return {"seconds": seconds, "samples": int(chain.shape[0]),
            "mean_offset_sigma": ((chain.mean(axis=0) - means) / sd).tolist(),
            "std_ratio": (chain.std(axis=0) / sd).tolist()}


def _identity_theory(task, outdir):
    return np.asarray(task[1], dtype=np.float64).copy()


def phase_train(device, outdir, ndim=NDIM, ndata=NDATA, ntrain=NTRAIN, nval=NVAL,
                epochs=TRAIN_EPOCHS, nensemble=NENSEMBLE, nwalkers=NWALKERS, steps=ENS_STEPS,
                chunk_epochs=10):
    """Training at the DES width: iteration 0 of a pipeline (flat LHS points,
    a smooth synthetic theory) trained as the README's K=4 ensemble through
    ``train_emulator``, then sampled, then the fused likelihood held against
    the plain composition on trained member 0, then the canonical drive of
    ``ml_sampler_core``.  Returns the records the result line reports."""
    from linna_tpu_torch import likelihood as LK
    from linna_tpu_torch import nn as N
    from linna_tpu_torch import orchestrator as O
    from linna_tpu_torch import priors as P
    from linna_tpu_torch import sample_gen as SG
    from linna_tpu_torch.ops import fused as F
    from linna_tpu_torch.samplers import run as R
    from linna_tpu_torch.train import _walk

    on_card = device.type == "cuda"
    it0 = os.path.join(outdir, "train", "iter_0")
    pb = seeded_problem(device, ndim, ndata)
    theory, priors, pack, rng, truth = pb.theory, pb.priors, pb.pack, pb.rng, pb.truth
    sigma, data, cov, inv_cov = pb.sigma, pb.data, pb.cov, pb.inv_cov

    t0 = time.perf_counter()
    SG.generate_training_point(theory, SG.NNSampler(it0, P.prior_range(pack)), None, it0,
                               ntrain, nval, data, inv_cov)
    t1 = time.perf_counter()
    params = {"trainingoption": 1, "nensemble": nensemble, "batch_size": 500, "num_epochs": epochs}
    rec: dict = {}
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    O.train_emulator(it0, [it0], data, cov, sigma, None, False, "chto_v2", params,
                     trace_rec=rec, device=device)
    if on_card:
        torch.cuda.synchronize(device)
    t2 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    missing = iteration_missing(it0, nensemble)
    if missing:
        raise AssertionError(f"train_emulator left artifacts out: {missing}")
    plots = {f: [os.path.isfile(os.path.join(d, f)) for d in member_dirs(it0, nensemble)]
             for f in ("lr_tunning.png", "training_progress.png", "trainniing.png")}

    spec = N.make_model_spec("chto_v2", ndim, ndata)
    seeds = [1234 + 1000 * k for k in range(nensemble)]  # train_emulator's member seeds
    initial = initial_val_losses(it0, spec, data, cov, seeds, device)
    best = best_val_losses(it0, nensemble)
    log(f"  val loss per member: initial {initial}, best {best}")
    bad = not_learned(best, initial)
    if bad:
        raise AssertionError(f"members that did not learn (member, best, initial): {bad}")

    # sample the trained ensemble, then hold the fused likelihood of trained
    # member 0 against the plain composition at the chain's last positions
    model = O.retrieve_model(it0, ndim, ndata, device=device)
    members = O.retrieve_ensemble_params(it0, model)
    off = ["/".join(k) for m in members for k, v in _walk(m) if v.device != device]
    if len(members) != nensemble or off:
        raise AssertionError(f"{len(members)} members retrieved, tensors off {device}: {off}")
    log_prob = LK.make_log_prob(model.spec, members, model.transforms, pack, data, inv_cov,
                                temperature=TEMPERATURE, device=device)
    init_white = P.inv_transform(pack, torch.as_tensor(truth, dtype=torch.float32, device=device))
    x0 = init_white.cpu().numpy() + 0.001 * rng.standard_normal((nwalkers, ndim))
    t3 = time.perf_counter()
    R.run_ensemble(log_prob, x0, it0, method="zeus", transform=lambda x: P.transform_np(pack, x),
                   check_every=min(100, steps), max_iterations=steps, convergence_check=False,
                   seed=0, device=device)
    t4 = time.perf_counter()
    chain_path = os.path.join(it0, O._chain_filename("zeus"))
    chain, lp, reader = O.read_chain_and_cut(chain_path, nk=2, ntimes=10, method="zeus", flat=True)
    last = reader.get_chain()[-1]
    if not (np.isfinite(chain).all() and np.isfinite(lp).all()) or last.shape != (nwalkers, ndim):
        raise AssertionError(f"trained-ensemble chain {chain.shape} is not finite")
    fused = LK.make_log_prob(model.spec, model.params, model.transforms, pack, data, inv_cov,
                             temperature=TEMPERATURE, use_fused=True, device=device)
    plain = LK.make_log_prob(model.spec, model.params, model.transforms, pack, data, inv_cov,
                             temperature=TEMPERATURE, device=device)
    x_last = torch.as_tensor(last, dtype=torch.float32, device=device)
    before = dict(F.launches), dict(F.plain_calls)
    with torch.no_grad():
        got = fused(x_last)
        moved = F.launches["fused_log_prob"] - before[0]["fused_log_prob"]
        plain_in_fused = F.plain_calls["fused_log_prob"] - before[1]["fused_log_prob"]
        err = compare(got, plain(x_last), "fused_log_prob on trained member 0")
    if on_card and (moved != 1 or plain_in_fused):
        raise AssertionError(f"the fused call launched {moved} kernels and ran the plain "
                             f"version {plain_in_fused} times")

    t5 = time.perf_counter()
    drive = drive_pipeline(os.path.join(outdir, "drive"), device, use_fused=True)
    log(f"  ml_sampler_core drive: {json.dumps(drive)}")

    res = {
        "epochs": epochs,
        "epochs_run": rec.get("epochs_run"),
        "train_emulator_s": t2 - t1,
        "points_s": t1 - t0,
        "ms_per_epoch_in_train_emulator": (rec["trainer"]["dispatch"] + rec["trainer"]["wait_fetch"])
        / max(rec["epochs_run"], 1) * 1e3,
        "trainer_phase_s": rec["trainer"],
        "stack_fit_s": rec.get("stack_fit_s"),
        "trainer_init_s": rec.get("trainer_init_s"),
        "peak_device_bytes": peak,
        "initial_val_loss": initial,
        "best_val_loss": best,
        "plots_written": plots,
        "ensemble_sample_s": t4 - t3,
        "ensemble_steps": steps,
        "fused_check": err,
        "drive": drive,
        "drive_s": time.perf_counter() - t5,
    }
    if on_card:
        tr, rows, n = trained_ensemble_trainer(it0, data, cov, nensemble, 500, device)
        if any(t.device != device for t in (tr.flat, *tr.opt, *rows[:4])):
            raise AssertionError("the trainer's tensors are not all on the card")
        res["chunk"] = timed_train_chunk(tr, rows, n, device, chunk_epochs)
    log(f"  training: {json.dumps(res, default=float)}")
    return res


# ---------------------------------------------------------------- gradient


def check_gradient(device, rows=NWALKERS, ndim=NDIM, ndata=NDATA) -> dict:
    """The per-walker gradient through ``fused_log_prob`` (its autograd
    Function: a kernel launch, then the plain composition's backward)
    against the plain composition's, at ``rows`` positions; with log10
    lanes where some rows are -inf, whose gradient must be zero, not NaN."""
    from linna_tpu_torch import likelihood as LK
    from linna_tpu_torch.ops import fused as F
    from linna_tpu_torch.samplers import hmc

    gen = torch.Generator(device="cpu").manual_seed(11)
    out = {}
    for case, kw in {"mixed priors": {}, "log10 lanes": {"log10": (0, 3)}}.items():
        spec, params, ts, pack, data, inv_cov = make_problem(device, ndim, ndata, **kw)
        lp_k = LK.make_log_prob(spec, params, ts, pack, data, inv_cov, use_fused=True,
                                device=device)
        lp_p = LK.make_log_prob(spec, params, ts, pack, data, inv_cov, device=device)
        x = torch.randn((rows, ndim), generator=gen).to(device)
        if kw:
            x[: rows // 2, 0] = -3.0  # physical 0.3 - 3 < 0 on a log10 lane
        before = F.launches["fused_log_prob"]
        v_k, g_k = hmc.value_and_grad(lp_k, x)
        if device.type == "cuda" and F.launches["fused_log_prob"] - before != 1:
            raise AssertionError("the gradient call did not launch fused_log_prob once")
        v_p, g_p = hmc.value_and_grad(lp_p, x)
        compare(v_k, v_p, f"value through the gradient path, {case}")
        if not torch.isfinite(g_k).all():
            raise AssertionError(f"{case}: a gradient through the kernel is not finite")
        dead = ~torch.isfinite(v_k)
        if dead.any() and g_k[dead].abs().max() != 0:
            raise AssertionError(f"{case}: a -inf walker has a nonzero gradient")
        out[case] = compare(g_k, g_p, f"per-walker gradient through the kernel, {case}")
        out[case]["-inf rows"] = int(dead.sum())
    return out


def phase_gradient(device, outdir, nwalkers=NWALKERS, nuts_steps=NUTS_STEPS,
                   hmc_steps=HMC_STEPS, emcee_steps=EMCEE_STEPS, ndim=NDIM, ndata=NDATA):
    """The gradient samplers and emcee at the DES width on one emulator with
    ``use_fused=True`` (phase 4's iteration directory, T = 1): the kernel's
    gradient against the plain one, then ``run_ensemble`` with the MAP
    search and ``nuts_steps`` NUTS samples, ``hmc_steps`` HMC samples, and
    ``emcee_steps`` stretch steps after emcee's 100-step burn-in.  Returns
    the records and each kernel's launches on the gradient path (the NUTS
    and HMC runs) and on the emcee run."""
    from linna_tpu_torch import likelihood as LK
    from linna_tpu_torch import orchestrator as O
    from linna_tpu_torch import priors as P
    from linna_tpu_torch.ops import fused as F
    from linna_tpu_torch.samplers import hmc
    from linna_tpu_torch.samplers import run as R

    grad = check_gradient(device, ndim=ndim, ndata=ndata)
    it0 = os.path.join(outdir, "iter_0")
    priors, data, cov, truth = write_iteration_dir(it0, device, ndim=ndim, ndata=ndata)
    inv_cov = np.linalg.inv(cov)
    pack = P.priors_from_list(priors, device)
    model = O.retrieve_model(it0, ndim, ndata, device=device)
    log_prob = LK.make_log_prob(model.spec, model.params, model.transforms, pack, data,
                                inv_cov, temperature=1.0, use_fused=True, device=device)
    init_white = P.inv_transform(pack, torch.as_tensor(truth, dtype=torch.float32, device=device))
    x0 = init_white.cpu().numpy() + 0.001 * np.random.default_rng(0).standard_normal((nwalkers, ndim))
    tfn = lambda x: P.transform_np(pack, x)

    def run(method, steps):
        d = os.path.join(outdir, method)
        trace: dict = {}
        F.reset_counts()
        t0 = time.perf_counter()
        backend = R.run_ensemble(log_prob, x0, d, method=method, transform=tfn,
                                 check_every=steps, max_iterations=steps,
                                 convergence_check=False, seed=0, device=device,
                                 trace_rec=trace)
        wall = time.perf_counter() - t0
        launches, plain = dict(F.launches), dict(F.plain_calls)
        chain, lps = backend.get_chain(), backend.get_log_prob()
        if chain.shape != (steps, nwalkers, ndim) or not (np.isfinite(chain).all()
                                                          and np.isfinite(lps).all()):
            raise AssertionError(f"{method}: chain {chain.shape} is not finite")
        if device.type == "cuda" and any(plain.values()):
            raise AssertionError(f"{method}: a plain version ran on the gradient path")
        s = trace["sampler"]
        loop = s["device_wait"] + s["host"]
        with backend._open("r") as f:
            accepted = np.asarray(f["mcmc"]["accepted"][:])
        half = tfn(chain[steps // 2:].reshape(-1, ndim))
        rec = {"wall_s": wall, "sampler_s": s, "steps": steps,
               "s_per_100_steps": loop / steps * 100, "launches": launches,
               "fused_log_prob_launches": launches["fused_log_prob"],
               "launches_per_step": launches["fused_log_prob"] / steps,
               "mean_acceptance": float(accepted.mean() / steps),
               "max_truth_offset_in_chain_std": float(np.max(
                   np.abs(half.mean(axis=0) - truth) / half.std(axis=0)))}
        log(f"  {method}: {json.dumps(rec, default=float)}")
        return rec, backend

    res = {"gradient_check": grad}
    res["nuts"], nuts_backend = run("nuts", nuts_steps)
    res["hmc"], _ = run("hmc", hmc_steps)
    res["emcee"], _ = run("emcee", emcee_steps)
    launches = {
        "gradient": {k: res["nuts"]["launches"][k] + res["hmc"]["launches"][k]
                     for k in F.launches},
        "emcee": res["emcee"]["launches"],
    }

    # launches per NUTS sample, and where a sample's time goes, from a
    # traced chunk of 5 samples at the chain's end in the saved space
    pre = R._load_precond(os.path.join(outdir, "nuts", R.PRECOND_FILENAME))
    wrapped = pre.wrap_log_prob(log_prob)
    y = torch.as_tensor(pre.to_sampling(nuts_backend.get_chain()[-1]), dtype=torch.float32,
                        device=device)
    state = hmc.init_nuts_state(torch.Generator(device=device).manual_seed(1), y, wrapped,
                                m_adapt=0)
    before = F.launches["fused_log_prob"]
    chunk = lambda: hmc.nuts_chunk(wrapped, state, 5)
    if device.type == "cuda":
        res["nuts_traced_chunk"] = traced_call(chunk, device)
    else:
        chunk()
    per_sample = (F.launches["fused_log_prob"] - before) / 5
    res["nuts_fused_log_prob_launches_per_sample"] = per_sample
    if device.type == "cuda" and per_sample != 2**5 - 1:
        raise AssertionError(f"{per_sample} fused_log_prob launches per NUTS sample, not 31")
    log(f"  gradient: {json.dumps(res, default=float)}")
    return res, launches


# ------------------------------------------------------------------ driver


def phase_driver(device, outdir, epochs=DRIVER_EPOCHS, timeout=DRIVER_TIMEOUT,
                 theory_mod="examples.des_theory", overrides=None,
                 exact=os.path.join(ROOT, "EXACT_POSTERIOR.json")) -> dict:
    """``python -m linna_tpu_torch.driver`` on ``examples/des_synthetic.yaml``
    with its depth cut: the first two iterations (methods zeus then nuts at
    T = 4 then 1), ``epochs`` epochs, convergence keys that pass at the
    sampler's second check (200 steps: the first compares with no earlier
    tau), outdir under the run directory.  The
    inputs are written with ``examples/des_theory.py``'s functions, as
    ``examples/make_des_inputs.py`` writes them.  Checks every iteration's
    artifacts, the chain stores, ``precond.npz``, ``time.npy`` and that
    training ran in bfloat16, and reports the posterior mean's offsets from
    the exact posterior (``EXACT_POSTERIOR.json``), not gated at this
    depth.  ``theory_mod``, ``overrides`` (applied after the cuts) and
    ``exact`` let a CPU rehearsal run the same phase at a small size."""
    import importlib

    import yaml

    import des_report
    from linna_tpu_torch import orchestrator as O
    from linna_tpu_torch.config import yaml_load
    from linna_tpu_torch.samplers import run as R

    T = importlib.import_module(theory_mod)
    inputs = os.path.join(outdir, "des_inputs")
    os.makedirs(inputs, exist_ok=True)
    truth = T.data_vector(T.fiducial() + 0.05)
    np.savetxt(os.path.join(inputs, "data.txt"), np.stack([np.arange(T.NDATA), truth], 1))
    np.savetxt(os.path.join(inputs, "cov_triplet.txt"), T.cov_triplet_rows(T.noise_sigma(truth)))

    params = yaml_load(os.path.join(ROOT, "examples", "des_synthetic.yaml"),
                       parent_dir=os.path.join(ROOT, "examples"))
    n_iter = 2
    cuts = {
        "iterations": f"{len(params['ntrainArr'])} -> {n_iter} (the first two of every "
                      "per-iteration list)",
        "methodArr": f"{params['methodArr']} -> ['zeus', 'nuts']",
        "temperatureArr": f"{params['temperatureArr']} -> [4.0, 1.0]",
        "num_epochs": f"{params['num_epochs']} -> {epochs}",
        # the first tau check has no earlier tau to compare with, so each
        # sampler stops at its second, after 200 steps
        "ntimesArr": f"{params['ntimesArr']} -> [0, 0]",
        "ntautolArr": f"{params['ntautolArr']} -> [inf, inf]",
        "meanshiftArr": f"{params['meanshiftArr']} -> [inf, inf]",
        "stdshiftArr": f"{params['stdshiftArr']} -> [inf, inf]",
        "outdir": f"{params['outdir']} -> {outdir}/run",
        "base_dir": f"{params['base_dir']} -> {inputs}",
    }
    for k in ("ntrainArr", "nvalArr", "nkeepArr"):
        params[k] = params[k][:n_iter]
    inf = float("inf")
    params.update(methodArr=["zeus", "nuts"], temperatureArr=[4.0, 1.0], num_epochs=epochs,
                  ntimesArr=[0, 0], ntautolArr=[inf, inf], meanshiftArr=[inf, inf],
                  stdshiftArr=[inf, inf], outdir=os.path.join(outdir, "run"), base_dir=inputs)
    params.update(overrides or {})
    log(f"  des_synthetic.yaml cut to depth: {json.dumps(cuts)}")
    cfg = os.path.join(outdir, "des_synthetic_cut.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump(params, f)

    cmd = [sys.executable, "-m", "linna_tpu_torch.driver", "zeus", "None", cfg, "examples"]
    if device.type != "cuda":
        cmd += ["--device", str(device)]
    log(f"  running: {' '.join(cmd)}")
    t0 = time.perf_counter()
    # the driver imports the theory plugin from where this process does
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT] + [p for p in sys.path if p]))
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout, env=env)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        log(proc.stdout[-3000:])
        log(proc.stderr[-6000:])
        raise AssertionError(f"the driver exited with {proc.returncode}")
    run_dir = params["outdir"]
    missing = [f"iter_{i}/{f}" for i in range(n_iter)
               for f in iteration_missing(os.path.join(run_dir, f"iter_{i}"), params["nensemble"])]
    for i, m in enumerate(params["methodArr"]):
        path = os.path.join(run_dir, f"iter_{i}", O._chain_filename(m))
        if not O._open_backend(path, m).exists():
            missing.append(f"iter_{i}/{O._chain_filename(m)}")
    missing += [f for f in (os.path.join(f"iter_{n_iter - 1}", R.PRECOND_FILENAME), "time.npy",
                            "trace.json") if not os.path.isfile(os.path.join(run_dir, f))]
    if missing:
        raise AssertionError(f"the driver left artifacts out: {missing}")
    rep = des_report.report(run_dir, exact)
    dtypes = {r.get("compute_dtype") for r in rep["iterations"]}
    if dtypes != {"torch.bfloat16"}:
        raise AssertionError(f"training ran in {dtypes}, not bfloat16")
    bias = rep["bias"]
    if not np.isfinite(bias["bias_sigma"]).all():
        raise AssertionError("the posterior mean is not finite")
    res = {"seconds": seconds, "cuts": cuts, "report": rep,
           "store": O._open_backend(des_report.final_chain_path(run_dir, n_iter, "nuts"),
                                    "nuts").path}
    log(f"  posterior-mean offsets from the exact posterior (sigma, reported, not gated at "
        f"this depth): max {bias['max_emulator_bias_sigma']:.3f}, median "
        f"{bias['median_emulator_bias_sigma']:.3f}")
    log(f"  driver: {json.dumps(res, default=float)}")
    return res


# ------------------------------------------- pre-model and bf16 inference


def _launch_counts():
    from linna_tpu_torch.ops import fused as F

    return {"launches": dict(F.launches), "plain_calls": dict(F.plain_calls)}


def _no_kernel(counts: dict, what: str) -> None:
    """The path must reach neither kernel nor its plain version: the
    routing rule sends it to the composition, as in the JAX package."""
    if any(counts["launches"].values()) or any(counts["plain_calls"].values()):
        raise AssertionError(f"{what} reached a kernel: {counts}")


def _sampler_rate(trace: dict, steps: int) -> dict:
    s = trace["sampler"]
    return {"s_per_100_steps": (s["device_wait"] + s["host"]) / steps * 100,
            "precond_s": s["precond"], "steps": steps}


def phase_premodel(device, outdir, ndim=NDIM, ndata=NDATA, ntrain=NTRAIN, nval=NVAL,
                   epochs=PREMODEL_EPOCHS, nensemble=PREMODEL_ENSEMBLE, nwalkers=NWALKERS,
                   nuts_steps=PREMODEL_NUTS, wrapper_rows=256) -> dict:
    """8a: one ``ml_sampler_core`` iteration on phase 5's seeded theory with
    ``linearmodel: {norder: 2}``, K members trained in bfloat16 and
    ``use_fused`` (which an ensemble with a pre-model does not reach), zeus
    at T = 1 stopped at its second tau check through the convergence keys;
    then ``linear_model.npz`` against a fit of the same rows, each member's
    learning, and ``retrieve_model_wrapper`` against the network plus the
    pre-model.  8b: member 0 with its pre-model: per-walker gradients, the
    MAP search and ``nuts_steps`` NUTS samples, and the Hessian at the MAP
    point through ``torch.func``.  Neither reaches a kernel."""
    import resource
    import tracemalloc

    import des_report
    import linna_tpu_torch as LT
    from linna_tpu_torch import data as D
    from linna_tpu_torch import likelihood as LK
    from linna_tpu_torch import linear_model as LM
    from linna_tpu_torch import nn as N
    from linna_tpu_torch import orchestrator as O
    from linna_tpu_torch import priors as P
    from linna_tpu_torch import transforms as T
    from linna_tpu_torch.ops import fused as F
    from linna_tpu_torch.samplers import hmc
    from linna_tpu_torch.samplers import run as R

    pb = seeded_problem(device, ndim, ndata)
    inf = float("inf")
    lm_cfg = {"norder": 2}
    params = {"trainingoption": 1, "nensemble": nensemble, "batch_size": 500,
              "num_epochs": epochs, "train_compute_dtype": "bfloat16", "linearmodel": lm_cfg,
              "use_fused": True}
    cuts = {"iterations": "4 -> 1 (iteration 0 at T = 1)", "nensemble": f"4 -> {nensemble}",
            "num_epochs": f"4500 -> {epochs}",
            "ntimesArr, ntautolArr, meanshiftArr, stdshiftArr":
                "-> [0], [inf], [inf], [inf]: zeus stops at its second tau check, 200 steps"}
    log(f"  8a: ml_sampler's schedule cut: {json.dumps(cuts)}")
    run_dir = os.path.join(outdir, "run")
    F.reset_counts()
    t0 = time.perf_counter()
    chain, logp = LT.ml_sampler_core(
        ntrainArr=[ntrain], nvalArr=[nval], nkeepArr=[2], ntimesArr=[0], ntautolArr=[inf],
        meanshiftArr=[inf], stdshiftArr=[inf], outdir=run_dir, theory=pb.theory,
        priors=pb.priors, data=pb.data, cov=pb.cov, init=pb.truth, pool=None,
        nwalkers=nwalkers, temperatureArr=[1.0], params=params, method="zeus", seed=3,
        device=device)
    pipeline_s = time.perf_counter() - t0
    counts = _launch_counts()
    _no_kernel(counts, "the pre-model pipeline")
    it0 = os.path.join(run_dir, "iter_0")
    lm_path = os.path.join(it0, O.LINEAR_MODEL_FILE)
    missing = iteration_missing(it0, nensemble, chain=True)
    if not os.path.isfile(lm_path):
        missing.append(O.LINEAR_MODEL_FILE)
    if missing:
        raise AssertionError(f"ml_sampler_core left artifacts out: {missing}")
    if chain.ndim != 2 or chain.shape[1] != ndim or not (np.isfinite(chain).all()
                                                         and np.isfinite(logp).all()):
        raise AssertionError(f"the pre-model chain {chain.shape} is not finite")

    # the saved pre-model: retrieval reloads it as saved, and a fit of the
    # same rows (timed, its numpy allocations traced) gives the same fields
    model = O.retrieve_model(it0, ndim, ndata, device=device)
    saved = LM.load_linear_model(lm_path, device=device).arrays()
    if any(not np.array_equal(v, saved[k]) for k, v in model.linearmodel.arrays().items()):
        raise AssertionError("retrieve_model's pre-model differs from linear_model.npz")
    stack = D.load_curated_stack([it0])
    ts = T.load_transforms(os.path.join(it0, O.TRANSFORMS_FILE), device=device)
    refit_dir = os.path.join(outdir, "refit")
    os.makedirs(refit_dir, exist_ok=True)
    tracemalloc.start()
    t0 = time.perf_counter()
    refit = O._fit_or_load_linear_model(refit_dir, stack, ts, lm_cfg, device).arrays()
    fit_s = time.perf_counter() - t0
    fit_peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    off = [k for k, v in refit.items() if not np.allclose(v, saved[k], rtol=1e-6, atol=0)]
    if off:
        raise AssertionError(f"linear_model.npz differs from a fit of the same rows: {off}")
    exact = all(np.array_equal(v, saved[k]) for k, v in refit.items())

    spec = N.make_model_spec("chto_v2", ndim, ndata)
    seeds = [1234 + 1000 * k for k in range(nensemble)]  # train_emulator's member seeds
    # learned: phase 5's rule against the untrained network, and below the
    # loss training starts from, the untrained network plus the pre-model
    initial = initial_val_losses(it0, spec, pb.data, pb.cov, seeds, device)
    start = initial_val_losses(it0, spec, pb.data, pb.cov, seeds, device,
                               linearmodel=model.linearmodel)
    best = best_val_losses(it0, nensemble)
    log(f"  8a: val loss per member: untrained network {initial}, with the pre-model "
        f"{start}, best {best}")
    bad = not_learned(best, initial) + [(m, b, s0) for m, (b, s0) in enumerate(zip(best, start))
                                        if not b < s0]
    if bad:
        raise AssertionError(f"members that did not learn (member, best, initial): {bad}")

    x = torch.as_tensor(P.transform_np(pb.pack, pb.rng.normal(size=(wrapper_rows, ndim)) * 0.5),
                        dtype=torch.float32, device=device)
    with torch.no_grad():
        got = O.retrieve_model_wrapper(it0, device=device)(x)
        mt = model.transforms
        x_in = mt.x_transform(x)
        net = N.apply_model(spec, model.params, x_in)
        manual = mt.y_data.inverse(mt.y_transform(net + model.linearmodel(x_in)))
        bare = mt.y_data.inverse(mt.y_transform(net))
    wrapper = compare(got, manual, f"retrieve_model_wrapper against network + pre-model, "
                                   f"{wrapper_rows} rows")
    if torch.allclose(got, bare):
        raise AssertionError("the wrapper's output does not change with the pre-model")

    with open(os.path.join(run_dir, "trace.json")) as f:
        trace = json.load(f)
    row = des_report.iterations(trace)[0]
    lm_s = next(r["linear_model_s"] for r in trace if r["phase"] == "train_emulator")
    rec = {
        "cuts": cuts, "pipeline_s": pipeline_s, "train_emulator_s": row["train_emulator_s"],
        "linear_model_s_in_train_emulator": lm_s, "fit_s": fit_s,
        "fit_traced_peak_bytes": fit_peak, "refit_bit_identical": exact,
        "host_peak_rss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
        "ms_per_epoch": row.get("ms_per_epoch"), "epochs_run": row.get("epochs_run"),
        "compute_dtype": row.get("compute_dtype"), "zeus_steps": row["steps"],
        "zeus_s_per_100_steps": row["s_per_100_steps"], "npc": int(saved["vec"].shape[0]),
        "monomials": int(saved["powers"].shape[0]), "initial_val_loss": initial,
        "start_val_loss_with_pre_model": start, "best_val_loss": best, "wrapper_check": wrapper, "counts": counts,
    }
    if device.type == "cuda":
        # what the pre-model costs a training epoch: chunks of the trained
        # members in bf16 with and without it, in turns, in this process
        rec["chunk_ms_per_epoch"] = {"with": [], "without": []}
        for tag in ("with", "without", "without", "with"):
            tr, rows, n = trained_ensemble_trainer(
                it0, pb.data, pb.cov, nensemble, 500, device, compute_dtype="bfloat16",
                linearmodel=model.linearmodel if tag == "with" else None)
            rec["chunk_ms_per_epoch"][tag].append(epoch_ms(tr, rows, n, device))
    log(f"  8a: {json.dumps(rec, default=float)}")

    # 8b: member 0 with its pre-model through the gradient path
    lp = LK.make_log_prob(model.spec, model.params, model.transforms, pb.pack, pb.data,
                          pb.inv_cov, temperature=1.0, linearmodel=model.linearmodel,
                          use_fused=True, device=device)
    last = O._open_backend(os.path.join(it0, O._chain_filename("zeus")), "zeus").get_chain()[-1]
    F.reset_counts()
    v, g = hmc.value_and_grad(lp, torch.as_tensor(last, dtype=torch.float32, device=device))
    if not (torch.isfinite(v).all() and torch.isfinite(g).all()):
        raise AssertionError("a per-walker gradient through the pre-model is not finite")
    trace_rec: dict = {}
    d = os.path.join(outdir, "nuts")
    backend = R.run_ensemble(lp, last, d, method="nuts", check_every=nuts_steps,
                             max_iterations=nuts_steps, convergence_check=False, seed=0,
                             device=device, trace_rec=trace_rec)
    chain = backend.get_chain()
    if chain.shape != (nuts_steps, nwalkers, ndim) or not np.isfinite(chain).all():
        raise AssertionError(f"NUTS through the pre-model: chain {chain.shape} is not finite")
    pre = R._load_precond(os.path.join(d, R.PRECOND_FILENAME))
    center = torch.as_tensor(pre.center, dtype=torch.float32, device=device)
    hess = torch.func.hessian(lambda z: lp._pure(z[None, :], lp._env)[0])(center)
    hess = hess.double().cpu().numpy()
    asym = float(np.abs(hess - hess.T).max() / np.abs(hess).max())
    if not np.isfinite(hess).all() or asym > 1e-3:
        raise AssertionError(f"the Hessian through the pre-model: finite "
                             f"{np.isfinite(hess).all()}, asymmetry {asym:.2e}")
    grad_counts = _launch_counts()
    _no_kernel(grad_counts, "NUTS through the pre-model")
    rec["gradient"] = {**_sampler_rate(trace_rec, nuts_steps), "hessian_asymmetry": asym,
                       "hessian_eig_min_max": [float(np.linalg.eigvalsh(-hess).min()),
                                               float(np.linalg.eigvalsh(-hess).max())],
                       "max_abs_grad": float(g.abs().max()), "counts": grad_counts}
    log(f"  8b: {json.dumps(rec['gradient'], default=float)}")
    return rec


def phase_bf16(device, trained_dir, nensemble=NENSEMBLE, ndim=NDIM, ndata=NDATA,
               walker_counts=BF16_WALKERS, zeus_steps=BF16_ZEUS_STEPS, nwalkers=NWALKERS) -> dict:
    """8c: bfloat16 inference on phase 5's trained ensemble and on its
    member 0: log-probs at T = 1 in bf16 against f32 at ``walker_counts``
    positions from phase 5's chain (float32 out, the same -inf rows,
    ``|dlp| / max(1, |lp_f32|) <= BF16_RTOL``), each call's device and call
    ms on the card, zeus for ``zeus_steps`` steps at T^2 = 16 in each type
    for K = 1 and K, and ``use_fused`` refusing ``compute_dtype``."""
    from linna_tpu_torch import likelihood as LK
    from linna_tpu_torch import orchestrator as O
    from linna_tpu_torch.ops import fused as F
    from linna_tpu_torch.samplers import run as R

    on_card = device.type == "cuda"
    pb = seeded_problem(device, ndim, ndata)
    model = O.retrieve_model(trained_dir, ndim, ndata, device=device)
    members = O.retrieve_ensemble_params(trained_dir, model)
    if len(members) != nensemble:
        raise AssertionError(f"{len(members)} trained members, not {nensemble}")
    chain = O._open_backend(os.path.join(trained_dir, O._chain_filename("zeus")),
                            "zeus").get_chain()
    pos = chain.reshape(-1, ndim)[-max(walker_counts):]
    if len(pos) < max(walker_counts):
        raise AssertionError(f"phase 5's chain holds {len(pos)} positions")
    configs = {f"K={nensemble}": members, "member 0": model.params}

    def make(params, cd, temperature=1.0, **kw):
        return LK.make_log_prob(model.spec, params, model.transforms, pb.pack, pb.data,
                                pb.inv_cov, temperature=temperature, compute_dtype=cd,
                                device=device, **kw)

    try:
        make(model.params, "bfloat16", use_fused=True)
    except ValueError as e:
        log(f"  8c: use_fused with compute_dtype raises ValueError: {e}")
    else:
        raise AssertionError("use_fused with compute_dtype did not raise")

    def errors(a, b, what):
        if b.dtype != torch.float32:
            raise AssertionError(f"{what}: bf16 output is {b.dtype}")
        a, b = a.double().cpu(), b.double().cpu()
        if not torch.equal(torch.isneginf(a), torch.isneginf(b)):
            raise AssertionError(f"{what}: the -inf rows differ")
        fin = torch.isfinite(a)
        if not torch.isfinite(b[fin]).all():
            raise AssertionError(f"{what}: bf16 is not finite where f32 is")
        rel = ((b - a).abs() / a.abs().clamp(min=1.0))[fin]
        out = {"max": float(rel.max()), "median": float(rel.median()),
               "-inf rows": int((~fin).sum())}
        log(f"  8c {what}: |dlp| / max(1, |lp_f32|) max {out['max']:.3e}, median "
            f"{out['median']:.3e} (bound {BF16_RTOL})")
        if out["max"] > BF16_RTOL:
            raise AssertionError(f"{what}: bf16 log-probs off by {out['max']:.3e}")
        return out

    F.reset_counts()
    rec: dict = {"log_prob": {}, "zeus": {}}
    with torch.no_grad():
        for name, params in configs.items():
            lp32, lp16 = make(params, None), make(params, "bfloat16")
            for n in walker_counts:
                x = torch.as_tensor(pos[-n:], dtype=torch.float32, device=device)
                r = {"rel_err": errors(lp32(x), lp16(x), f"{name} at {n} walkers")}
                if on_card:
                    for tag, fn in (("f32", lp32), ("bf16", lp16)):
                        r[f"{tag}_device_ms"], r[f"{tag}_device_timing"] = device_ms(lambda: fn(x))
                        r[f"{tag}_call_ms"] = call_ms(lambda: fn(x))
                    log(f"  8c {name} at {n} walkers: device ms f32 {r['f32_device_ms']:.4f} / "
                        f"bf16 {r['bf16_device_ms']:.4f}; call ms f32 {r['f32_call_ms']:.4f} / "
                        f"bf16 {r['bf16_call_ms']:.4f}")
                rec["log_prob"][f"{name} @{n}"] = r
        if on_card:
            # what the cuBLAS bf16 reductions (PyTorch's default) cost
            flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
            try:
                x = torch.as_tensor(pos, dtype=torch.float32, device=device)
                rec["rel_err_f32_reductions"] = errors(
                    make(members, None)(x), make(members, "bfloat16")(x),
                    f"K={nensemble} at {len(pos)} walkers, bf16 products reduced in f32")
            finally:
                torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
            a = torch.randn((64, 32), device=device, dtype=torch.bfloat16)
            try:
                out = torch.mm(a, a.T, out_dtype=torch.float32)
                rec["mm_out_dtype_float32"] = str(out.dtype)
            except (RuntimeError, TypeError, NotImplementedError) as e:
                rec["mm_out_dtype_float32"] = f"{type(e).__name__}: {str(e)[:120]}"
            log(f"  8c: torch.mm(bf16, bf16, out_dtype=torch.float32) on the card: "
                f"{rec['mm_out_dtype_float32']}")

    x0 = chain[-1]
    order = [("member 0", None), ("member 0", "bfloat16"), (f"K={nensemble}", "bfloat16"),
             (f"K={nensemble}", None)]
    for name, cd in order:
        trace: dict = {}
        calls = {"n": 0}
        lp = make(configs[name], cd, temperature=TEMPERATURE)

        def counted(x, lp=lp):
            calls["n"] += 1
            return lp(x)

        d = os.path.join(trained_dir, "bf16_zeus", f"{name}_{cd}".replace(" ", "_"))
        R.run_ensemble(counted, x0, d, method="zeus", check_every=zeus_steps,
                       max_iterations=zeus_steps, convergence_check=False, seed=0,
                       device=device, trace_rec=trace)
        rate = _sampler_rate(trace, zeus_steps)["s_per_100_steps"]
        per_step = calls["n"] / zeus_steps
        rec["zeus"][f"{name} {cd or 'float32'}"] = {
            "s_per_100_steps": rate, "calls_per_step": per_step,
            "ms_per_call": rate * 10 / per_step}
        log(f"  8c zeus {name} in {cd or 'float32'}: {rate:.3f} s / 100 steps at "
            f"{len(x0)} walkers, {per_step:.1f} likelihood calls a step")
    rec["counts"] = _launch_counts()
    _no_kernel(rec["counts"], "bf16 inference")
    log(f"  8c: {json.dumps(rec, default=float)}")
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from linna_tpu_torch.ops import fused as F
    from linna_tpu_torch.samplers import backends

    device = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    log("== 1. device")
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    log(f"  {name}, capability {cap}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"  nvidia-smi: {smi}")
    log(f"  chain store: {backends.store_kind()} (h5py importable: {backends.store_kind() == 'hdf5'})")
    log("  bf16 products may reduce in bf16 (PyTorch's default, left as it is): "
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
    if cap != (9, 0):
        raise AssertionError(f"compute capability {cap}, the kernels are built for sm_90a")

    log("== 2. build")
    t0 = time.perf_counter()
    report = F.build()
    log(f"  built in {time.perf_counter() - t0:.1f} s")
    for line in report.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            log("  " + line.strip())
    resources = kernel_resources(report)
    log(f"  registers and spills: {resources}")

    seconds = {}
    log("== 3. kernels against their plain versions")
    t0 = time.perf_counter()
    rec = phase_kernels(device)
    seconds[3] = time.perf_counter() - t0

    log("== 4. sampling slice")
    t0 = time.perf_counter()
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    try:
        res = phase_slice(device, os.path.join(RUN_DIR, "iter_0"))
    finally:
        shutil.rmtree(RUN_DIR, ignore_errors=True)
    seconds[4] = time.perf_counter() - t0

    log("== 5. training at the DES width")
    t0 = time.perf_counter()
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    shutil.rmtree(TRAINED_DIR, ignore_errors=True)
    F.reset_counts()
    try:
        phase_train(device, RUN_DIR)
        # phase 8 runs bf16 inference on the trained ensemble
        shutil.move(os.path.join(RUN_DIR, "train", "iter_0"), TRAINED_DIR)
    finally:
        shutil.rmtree(RUN_DIR, ignore_errors=True)
    train_launches, train_plain = dict(F.launches), dict(F.plain_calls)
    log(f"  training path launches {train_launches}, plain calls {train_plain}")
    if train_launches["fused_log_prob"] == 0:
        raise AssertionError("fused_log_prob did not launch on the training path")
    seconds[5] = time.perf_counter() - t0

    log("== 6. gradient samplers and emcee through the likelihood kernel")
    t0 = time.perf_counter()
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    try:
        _, path_launches = phase_gradient(device, RUN_DIR)
    finally:
        shutil.rmtree(RUN_DIR, ignore_errors=True)
    log(f"  launches by path: {path_launches}")
    if any(path_launches[p]["fused_log_prob"] == 0 for p in ("gradient", "emcee")):
        raise AssertionError("fused_log_prob did not launch on the gradient or emcee path")
    seconds[6] = time.perf_counter() - t0
    log(f"  phase 6: {seconds[6]:.1f} s")

    log("== 7. the driver on des_synthetic.yaml, depth cut")
    t0 = time.perf_counter()
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    try:
        phase_driver(device, RUN_DIR)
    finally:
        shutil.rmtree(RUN_DIR, ignore_errors=True)
    seconds[7] = time.perf_counter() - t0
    log(f"  phase 7: {seconds[7]:.1f} s")

    log("== 8. the pre-model and bf16 inference at the DES width")
    t0 = time.perf_counter()
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    try:
        premodel = phase_premodel(device, RUN_DIR)
        bf16 = phase_bf16(device, TRAINED_DIR)
    finally:
        shutil.rmtree(RUN_DIR, ignore_errors=True)
        shutil.rmtree(TRAINED_DIR, ignore_errors=True)
    seconds[8] = time.perf_counter() - t0
    log(f"  phase 8: {seconds[8]:.1f} s")

    log(f"== 9. result (phase seconds {json.dumps(seconds)})")
    kernels = []
    for k in REPLACES:
        r = rec[k]
        b = NWALKERS
        kernels.append({
            "name": k,
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES[k],
            "launches": res["launches"][k],
            "launches_by_path": {
                "sampling": res["launches"][k],
                "training": train_launches[k],
                "gradient": path_launches["gradient"][k],
                "emcee": path_launches["emcee"][k],
                "premodel": premodel["counts"]["launches"][k]
                + premodel["gradient"]["counts"]["launches"][k],
                "bf16": bf16["counts"]["launches"][k],
            },
            "max_abs_err": r["abs"],
            "max_rel_err": r["rel"],
            "tolerance": {"rtol": RTOL, "atol": ATOL},
            "ms": r["ms"][b],
            "plain_ms": r["plain_ms"][b],
            "bound_ms": r["bound"][b]["ms"],
            "bound_by": r["bound"][b]["by"],
            "library_ms": None,
            "rows": b,
            "timing": r["method"],
            "plain_timing": r["plain_method"],
            "ms_by_rows": r["ms"],
            "bound_by_rows": r["bound"],
            "plain_ms_by_rows": r["plain_ms"],
            "call_ms_by_rows": r["call_ms"],
            "plain_call_ms_by_rows": r["plain_call_ms"],
            "launch_shape_by_rows": r["shape"],
            **resources.get(k, {}),
            "check": "pass",
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
