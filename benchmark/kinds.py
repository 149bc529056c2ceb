"""The two kinds of cell, each driving the program through its own entry
point: ``train`` (``EnsembleTrainer.train``) and ``sample``
(``run_ensemble``).  A traffic file names its kind and holds every number
the kind reads; nothing here is particular to one cell.

Each kind's :func:`run` makes the inputs from the seed, builds the
program's objects, takes the readings of ``correct`` that must come from
set-up, warms every shape, runs the measured window, optionally a traced
call after it, reads the device's peak memory, frees the program's state and
returns everything :mod:`benchmark.harness` needs: the end-to-end values,
what the per-layer readers read, and the program's readings beside the
reference's.  The reference runs only after the program's state is freed.
"""

from __future__ import annotations

import contextlib
import math
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from . import problem as P
from . import reference as R
from . import theory as TH
from . import trace as TR


@contextlib.contextmanager
def span(name: str):
    """A benchmark span: a ``record_function`` range a traced run names its
    idle gaps by."""
    with torch.profiler.record_function(name):
        yield


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def memory_peak(device) -> Optional[int]:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else None


def quantized(seconds: float, per_unit_s: float, quantum: int) -> int:
    """The count of units, a multiple of ``quantum`` and at least one, that
    fills ``seconds`` at ``per_unit_s`` seconds a unit: the cell's measured
    rate, not this run's, so every run of a cell does the same work."""
    return max(quantum, int(round(seconds / max(per_unit_s, 1e-9) / quantum)) * quantum)


def norm_gaps(prog: dict, ref: dict, keep=None) -> tuple:
    """The worst leaf's gap between two sets of norms by leaf, and the leaf:
    |a - b| over the larger of the reference's norm of that leaf and its
    median leaf's; ``keep`` names the leaves compared (all by default)."""
    med = float(np.median(list(ref.values())))
    gaps = {p: abs(prog[p] - ref[p]) / max(ref[p], med, 1e-30)
            for p in ref if keep is None or p in keep}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def fused_counts(fused, since=None) -> dict:
    """The program's kernel counters (launches and plain versions' calls),
    less ``since``."""
    now = {"launches": dict(fused.launches), "plain_calls": dict(fused.plain_calls)}
    if since is None:
        return now
    return {kind: {k: v - since[kind][k] for k, v in now[kind].items()} for kind in now}


def read_trace(prof, grids_for=(), workdir: Optional[str] = None) -> Optional[dict]:
    """:func:`benchmark.trace.read`, its cost said on standard error."""
    t0 = time.perf_counter()
    traced = TR.read(prof, grids_for, workdir)
    if traced is not None:
        print(f"trace: {traced['device_events']} device events, busy {traced['busy_s']:.3f} s "
              f"of {traced['window_s']:.3f} s, read in {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    return traced


def leaf_norms(tree_items) -> dict:
    return {path: float(torch.linalg.vector_norm(t.double())) for path, t in tree_items}


# ------------------------------------------------------------------- train


def run_train(cfg: dict, traffic: dict, unit_seconds: float, seed: int, seconds: float,
              trace: bool, device, workdir: str, controls: bool = False) -> dict:
    """One training cell: K members of the configuration's emulator trained
    by one ``EnsembleTrainer`` on an iteration-3 stack of rows drawn from
    the seed (:func:`benchmark.theory.iteration_rows`), with the transforms
    and loss state ``orchestrator.train_emulator`` builds for them.

    Set-up builds the trainer from weights the benchmark made and makes one
    training call of ``check_epochs`` epochs on every row, the same call
    the window makes: its loss at every minibatch step and its validation
    loss at every epoch's end, the optimizer's second moment and the
    parameters after the last step are the program's readings.  A
    ``warm_epochs`` call then warms the epoch's shapes again, and the window
    is one training call of as many epochs as fill ``seconds`` at
    ``unit_seconds`` an epoch, with its capture, supervisor and checkpoint
    saves inside.  The same trainer object runs all three."""
    from linna_tpu_torch import losses as L
    from linna_tpu_torch import nn as N
    from linna_tpu_torch import transforms as T
    from linna_tpu_torch.ops import fused
    from linna_tpu_torch.parallel.ensemble import EnsembleTrainer

    ndim, ndata, k = cfg["ndim"], cfg["ndata"], traffic["nensemble"]
    bs, n_check = traffic["batch_size"], traffic["check_epochs"]
    seeds = [int(seed) + 1000 * m for m in range(k)]
    with span("setup.inputs"):
        rows = TH.iteration_rows(cfg, traffic["stack"], traffic["n_train"], traffic["n_val"],
                                 [int(seed), P.STREAMS["rows"]])
        tx, ty, vx, vy = rows["tx"], rows["ty"], rows["vx"], rows["vy"]
        data, cov = rows["data"], rows["cov"]
        members = R.make_weights(ndim, ndata, k, seed, device)
        p0 = [{path: t.clone() for path, t in R.leaves(m)} for m in members]
    with span("setup.program"):
        sigma = np.sqrt(np.diag(cov))
        spec = N.make_model_spec(cfg["nnmodel"], ndim, ndata)
        tset = T.TransformSet(T.fit_x_transform(tx, None, device=device),
                              T.fit_y_transform(ty / sigma, ypositive=False, device=device),
                              T.YTransformData(torch.as_tensor(sigma.astype(np.float32),
                                                               device=device)))
        loss_state = L.build_loss_state(data, cov, tset)
        trainer = EnsembleTrainer(spec, tset, loss_state, [None] * k, seeds, params=members,
                                  compute_dtype=traffic["train_compute_dtype"], device=device)
        trainer.lrs = np.full(k, traffic["lr"])
        trainer.wds = np.full(k, traffic["wd"])
        del members
    kw = dict(batch_size=bs, auto_lr=False, initfrombest=False,
              epochs_per_dispatch=traffic["epochs_per_dispatch"])

    # the program's readings: one training call on every row
    with span("setup.check_call"):
        losses, vms = trainer.train(tx, ty, vx, vy, num_epochs=n_check, **kw)
        leaf_of = lambda t: dict(R.leaves(trainer.layout.tree(t)))
        prog = [{"losses": [float(v) for v in losses[m]],
                 "val": [float(vm[0]) for vm in vms[m]],
                 "params": {p: t.clone() for p, t in leaf_of(trainer.flat[m].detach()).items()},
                 "nu": {p: t.clone() for p, t in leaf_of(trainer.opt.nu[m]).items()},
                 "steps": int(trainer.opt.count[m])} for m in range(k)]

    with span("setup.warm"):
        trainer.train(tx, ty, vx, vy, num_epochs=traffic["warm_epochs"], **kw)
        sync(device)
    epochs = quantized(seconds, unit_seconds, traffic["epoch_quantum"])

    trainer.outdirs = [os.path.join(workdir, f"member{m}") for m in range(k)]
    counts0 = fused_counts(fused)
    t_window = time.perf_counter()
    with span("trainer.train"):
        trainer.train(tx, ty, vx, vy, num_epochs=epochs, **kw)
        sync(device)
    wall = time.perf_counter() - t_window
    counters = {"window": fused_counts(fused, counts0)}
    window = {"phase_seconds": dict(trainer.phase_seconds), "epochs_run": trainer.epochs_run,
              "graphs": dict(trainer.graphs.get("epochs", {})), "speculation":
              dict(trainer.speculation)}
    traced = None
    if trace:
        with TR.traced() as prof, span("trainer.train"):
            trainer.train(tx, ty, vx, vy, num_epochs=traffic["trace_epochs"], **kw)
        traced = read_trace(prof)
        del prof
    peak = memory_peak(device)
    n_weights = N.count_params(trainer.member_params(0))
    del trainer, tset, loss_state
    free(device)

    t_ref = time.perf_counter()
    with span("reference"), R.full_f32():
        fit = R.fit_training(tx, ty, data, cov, device)
        dev = lambda a: torch.as_tensor(a, device=device)
        call = dict(rows=(dev(tx), dev(ty), dev(vx), dev(vy)), fit=fit, lr=traffic["lr"],
                    wd=traffic["wd"], batch_size=bs)
        orders = [R.epoch_orders(s, n_check, len(tx), bs) for s in seeds]
        dtype = traffic["train_compute_dtype"]
        refs = [R.training_call(R.nest(p0[m].items()), orders=orders[m],
                                **_precision(dtype, dtype), **call) for m in range(k)]
        readings = train_readings(p0, prog, refs)
        control = None
        if controls:
            # the reference one precision lower in the program's place, and
            # the reference playing each fault of the program
            low = [R.training_call(R.nest(p0[m].items()), orders=orders[m],
                                   **_precision(traffic["control_precision"], dtype), **call)
                   for m in range(k)]
            control = train_readings(p0, low, refs)
            control["faults"] = {f: train_readings(p0, [R.training_call(
                R.nest(p0[m].items()), orders=orders[m], fault=f, **_precision(dtype, dtype),
                **call) for m in range(k)], refs) for f in R.FAULTS}
    return {
        "e2e": {"epoch_ms": wall / max(window["epochs_run"], 1) * 1e3},
        "window_start": t_window, "window_s": wall, "attempted": epochs,
        "failed": epochs - window["epochs_run"], "memory_peak": peak, "counters": counters,
        "readings": readings, "control": control, "reference_s": time.perf_counter() - t_ref,
        "layer": {"kind": "train", "trainer": window, "trace": traced, "members": k,
                  "n_weights": n_weights, "rows": (len(tx) // bs) * bs,
                  "val_rows": len(vx), "window_s": wall,
                  "compute_dtype": traffic["train_compute_dtype"]},
    }


def _precision(precision: str, compute_dtype: Optional[str]) -> dict:
    """The reference's products at ``precision`` (the configuration's
    ``train_compute_dtype`` names it as ``bf16``), and its first moment
    stored in the compute type, as the program stores it."""
    names = {"bfloat16": "bf16", None: "f32", "float32": "f32"}
    mu = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
    return {"precision": names.get(precision, precision), "mu_dtype": mu}


def train_readings(p0: list, prog: list, refs: list) -> dict:
    """The numbers a training cell reads, each the worst over members:
    ``loss_gap``, the largest relative gap of a minibatch step's loss;
    ``val_gap``, of an epoch's validation loss; ``grad_gap``, the gap of
    the norm by leaf of the second moment's root after the last step (the
    gradients as the optimizer got them); ``change_gap``, of the norm by
    leaf of the parameters' change over the call; ``steps``, the largest
    gap between the optimizer's step counts.  A gap by leaf is taken over
    the larger of the reference's norm of that leaf and its median leaf's,
    and the worst leaf counts (:func:`norm_gaps`).  Leaves whose reference
    gradient is under a thousandth of the median leaf's move by rounding
    alone and are left out of the change.  The cell's limits name the
    numbers compared."""
    out = {"loss_gap": 0.0, "val_gap": 0.0, "grad_gap": 0.0, "change_gap": 0.0, "steps": 0}
    worst = {}
    for start, got, ref in zip(p0, prog, refs):
        for name in ("losses", "val"):
            gap = max((abs(a - b) / abs(b) for a, b in zip(got[name], ref[name])),
                      default=math.inf)
            if len(got[name]) != len(ref[name]) or not math.isfinite(gap):
                gap = math.inf
            key = "loss_gap" if name == "losses" else "val_gap"
            out[key] = max(out[key], gap)
        out["steps"] = max(out["steps"], abs(got["steps"] - ref["steps"]))
        g_ref = leaf_norms((p, torch.sqrt(v)) for p, v in ref["nu"].items())
        g_prog = leaf_norms((p, torch.sqrt(v)) for p, v in got["nu"].items())
        med = float(np.median(list(g_ref.values())))
        moving = {p for p, v in g_ref.items() if v >= 1e-3 * med}
        c_ref = leaf_norms((p, ref["params"][p] - start[p]) for p in start)
        c_prog = leaf_norms((p, got["params"][p] - start[p]) for p in start)
        for name, (gap, leaf) in (("grad_gap", norm_gaps(g_prog, g_ref)),
                                  ("change_gap", norm_gaps(c_prog, c_ref, keep=moving))):
            if gap >= out[name]:
                out[name], worst[name] = gap, "/".join(leaf)
    return {**out, "worst_leaves": worst}


# ------------------------------------------------------------------ sample


def run_sample(cfg: dict, traffic: dict, unit_seconds: float, seed: int, seconds: float,
               trace: bool, device, workdir: str, controls: bool = False) -> dict:
    """One sampling cell: ``run_ensemble`` with the traffic's method at its
    temperature, ``nwalkers`` walkers started in a ball around the truth,
    through K members (the K-member composition) or, with ``use_fused``
    and K = 1, the ``fused_log_prob`` route.  Set-up's warm call (the MAP
    search and the preconditioner for the gradient methods, the graphs'
    capture, ``warm_steps`` steps) warms every shape; the window is one call
    that resumes its chain directory for as many steps as fill ``seconds``
    at ``unit_seconds`` a step, convergence checks off.  After it, the reference computes the
    log-posterior again at ``n_compare`` of the window's stored positions
    drawn from the seed (every walker of its last step among them)."""
    from linna_tpu_torch import likelihood as LK
    from linna_tpu_torch import nn as N
    from linna_tpu_torch import priors as PR
    from linna_tpu_torch import transforms as T
    from linna_tpu_torch.ops import fused
    from linna_tpu_torch.samplers.run import run_ensemble

    ndim, ndata, k = cfg["ndim"], cfg["ndata"], traffic["nensemble"]
    nwalkers, temperature = traffic["nwalkers"], traffic["temperature"]
    with span("setup.inputs"):
        members = R.make_weights(ndim, ndata, k, seed, device)
        prob = P.sampling_problem(cfg, members, temperature, seed, device)
        x0 = prob["truth"] + traffic["ball"] * P.rng(seed, "start").standard_normal(
            (nwalkers, ndim))
    with span("setup.program"):
        spec = N.make_model_spec(cfg["nnmodel"], ndim, ndata)
        tset = T.TransformSet(
            T.XTransform(prob["x_mean"], prob["x_std"],
                         torch.zeros(ndim, dtype=torch.bool, device=device)),
            T.YTransform(prob["y_mean"], prob["y_std"], False),
            T.YTransformData(prob["sigma"]))
        lo, hi = P.flat_bounds(cfg)
        pack = PR.priors_from_list([{"param": f"p{i}", "dist": "flat", "arg1": float(lo[i]),
                                     "arg2": float(hi[i])} for i in range(ndim)], device)
        # the program gets copies: the reference keeps the benchmark's own
        copies = [R.nest((path, t.clone()) for path, t in R.leaves(m)) for m in members]
        log_prob = LK.make_log_prob(
            spec, copies if k > 1 else copies[0], tset, pack,
            prob["data64"], prob["inv_cov64"], temperature=temperature,
            ensemble_k_std=prob["k_std"], use_fused=traffic["use_fused"], device=device)
    ce, warm = traffic["check_every"], traffic["warm_steps"]
    opts = dict(method=traffic["method"], convergence_check=False, check_every=ce,
                seed=int(seed), max_depth=traffic.get("max_depth", 5), device=device)
    outdir = os.path.join(workdir, "chain")
    with span("setup.warm"):
        run_ensemble(log_prob, x0, outdir, max_iterations=warm, **opts)
        sync(device)
    steps = quantized(seconds, unit_seconds, ce)

    t_window = time.perf_counter()
    window_rec: dict = {}
    with span("sampler.run_ensemble"):
        backend = run_ensemble(log_prob, x0, outdir, max_iterations=warm + steps,
                               trace_rec=window_rec, **opts)
        sync(device)
    wall = time.perf_counter() - t_window
    traced, trace_rec, shapes, blocks = None, None, None, None
    if trace:
        fused.reset_counts()
        trace_rec = {}
        with TR.traced() as prof, span("sampler.run_ensemble"):
            run_ensemble(log_prob, x0, outdir, max_iterations=warm + steps
                         + traffic["trace_steps"], trace_rec=trace_rec, **opts)
        traced = read_trace(prof, ("fused_log_prob",) if traffic["use_fused"] else (), workdir)
        shapes = {name: sorted(s) for name, s in fused.launch_shapes.items()}
        # each row count's blocks, to tell the traced launches apart (none
        # where two row counts launch alike)
        blocks = {fused.launch_shape(spec, r, "fused_log_prob")["blocks"]: [r, i, o]
                  for r, i, o in shapes["fused_log_prob"]} if device.type == "cuda" else {}
        if len(blocks) < len(shapes["fused_log_prob"]):
            blocks = {}
        del prof
        if traced is not None:
            seen = sum(n for name, (n, _) in traced["kernels"].items() if "fused_log_prob" in name)
            print(f"trace: fused_log_prob {seen} device events, {trace_rec['kernels']} counted, "
                  f"shapes {shapes}, blocks {blocks}, grids {traced['grids']}", file=sys.stderr,
                  flush=True)
    peak = memory_peak(device)
    chain = np.asarray(backend.get_chain(discard=warm), np.float64)[:steps]
    lps = np.asarray(backend.get_log_prob(discard=warm), np.float64)[:steps]
    del log_prob, backend, tset, pack, copies
    free(device)

    t_ref = time.perf_counter()
    with span("reference"), R.full_f32():
        flat_x, flat_lp = chain.reshape(-1, ndim), lps.reshape(-1)
        pick = P.rng(seed, "compare").choice(
            len(flat_x) - nwalkers, size=min(traffic["n_compare"], len(flat_x)) - nwalkers,
            replace=False)
        pick = np.concatenate([pick, np.arange(len(flat_x) - nwalkers, len(flat_x))])
        x = torch.as_tensor(flat_x[pick], dtype=torch.float32, device=device)
        ref = R.log_prob(members, x, prob).double().cpu().numpy()
        readings = {"lp_gap": _lp_gap(flat_lp[pick], ref),
                    "unmoved_share": float(np.all(chain == chain[:1], axis=(0, 2)).mean())}
        control = None
        if controls:
            low = R.log_prob(members, x, prob, traffic["control_precision"]).double()
            control = {"lp_gap": _lp_gap(low.cpu().numpy(), ref)}
    return {
        "e2e": {"walker_steps_per_s": nwalkers * steps / wall},
        "window_start": t_window, "window_s": wall, "attempted": nwalkers * steps,
        "failed": int((~np.isfinite(lps)).sum()), "memory_peak": peak,
        "counters": {"window": window_rec.get("kernels"),
                     "traced": None if trace_rec is None else trace_rec.get("kernels")},
        "readings": readings, "control": control, "reference_s": time.perf_counter() - t_ref,
        "layer": {"kind": "sample", "method": traffic["method"], "nwalkers": nwalkers,
                  "window": window_rec, "traced_call": trace_rec, "steps": steps, "trace": traced,
                  "launch_shapes": shapes, "launch_blocks": blocks, "members": k, "ndim": ndim, "ndata": ndata,
                  "n_weights": R.n_weights(ndim, ndata), "window_s": wall,
                  "gradient": traffic["method"] in ("hmc", "nuts")},
    }


def _lp_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    """The widest gap between two log-posteriors, in nats; a row finite on
    one side only is an infinite gap."""
    both = np.isfinite(prog) & np.isfinite(ref)
    if (np.isfinite(prog) != np.isfinite(ref)).any():
        return math.inf
    return float(np.abs(prog[both] - ref[both]).max()) if both.any() else 0.0


KINDS = {"train": run_train, "sample": run_sample}
