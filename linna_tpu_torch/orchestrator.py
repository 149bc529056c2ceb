"""The LINNA outer loop (PyTorch): sample -> evaluate theory -> train
emulator -> MCMC.

Counterpart of ``linna_tpu/orchestrator.py``:

- ``ml_sampler`` carries the paper's hyperparameters (linna/main.py:47-75);
- ``ml_sampler_core`` runs the iterations: read and cut the previous chain,
  draw training points focused on it, fan the theory out over the host
  pool, train the emulator (:func:`train_emulator`, in process or in a child
  process with ``params["train_subprocess"]``) and sample it with the
  iteration's method (emcee, zeus, hmc or nuts) at the iteration's
  temperature (squared before use, linna/main.py:153);
- the retrieval helpers rebuild a trained emulator from an iteration
  directory (``transforms.npz``, ``best.ckpt.npz``, the training sample
  files, ``finish.json``), and ``read_chain_and_cut`` reads the chain.

Every stage is file-gated, so a rerun of the same command resumes after a
crash.  Artifacts have the JAX package's names and layouts: an iteration
directory written by either package is read by the other.  Training and
sampling run on ``device`` (``cuda:0`` unless the caller passes another);
the theory and the files stay on the host.

Over several ranks (:mod:`linna_tpu_torch.parallel.multihost`) every rank
runs this loop.  Rank 0 alone writes: the training points, transforms, the
pre-model, ``finish.json``, the chains and the final results; every file
gate is rank 0's view, broadcast (``primary_flag``); a barrier follows each
phase that writes what the next one reads.  Training over the ranks is the
ensemble trainer on the (ens, data) grid, sampling the walker-sharded
``run_ensemble``.
"""

from __future__ import annotations

import json
import os
import time
import warnings
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from . import data as D
from . import likelihood as LK
from . import linear_model as LM
from . import losses as L
from . import nn as N
from . import priors as P
from . import sample_gen as SG
from . import transforms as T
from .device import DeviceLike, resolve_device
from .parallel import multihost as MH
from .parallel import precompile
from .samplers import backends, convergence
from .samplers import run as sampler_run
from .train import Trainer
from .utils import checkpoint as ckpt
from .utils.runtime import check_map_count
from .utils.trace import PhaseTimer, device_profile

__all__ = [
    "ml_sampler",
    "ml_sampler_core",
    "train_emulator",
    "FINISH_MARKER",
    "TRANSFORMS_FILE",
    "BEST_CKPT",
    "RetrievedModel",
    "retrieve_model",
    "retrieve_model_exist",
    "retrieve_model_wrapper",
    "retrieve_ensemble_params",
    "iteration_log_prob",
    "read_chain_and_cut",
    "get_good_walker_list",
]

FINISH_MARKER = "finish.json"
TRANSFORMS_FILE = "transforms.npz"
LINEAR_MODEL_FILE = "linear_model.npz"
BEST_CKPT = "best.ckpt.npz"


# --------------------------------------------------------------------- chains


def _chain_filename(method: str) -> str:
    if method in ("emcee",) + sampler_run.GRADIENT_METHODS:
        return sampler_run.EMCEE_FILENAME
    if method == "zeus":
        return sampler_run.ZEUS_FILENAME
    raise NotImplementedError(method)


def _open_backend(chainname: str, method: str):
    if method in ("emcee",) + sampler_run.GRADIENT_METHODS:
        return backends.EmceeBackend(chainname)
    return backends.ZeusBackend(chainname)


def _chain_incomplete(chain_path: str, method: str) -> bool:
    """True when the chain's exact-resume state says its sampler died
    mid-run: neither the ``_finished`` marker nor ``_converged``.  Chains
    without the state or the flags count as complete."""
    try:
        blob = _open_backend(chain_path, method).load_state()
    except OSError:
        return False
    if blob is None or ("_converged" not in blob and "_finished" not in blob):
        return False
    done = bool(np.asarray(blob.get("_converged", False))) or bool(
        np.asarray(blob.get("_finished", False))
    )
    return not done


def _kmeans_1d(x: np.ndarray, k: int, n_init: int = 10, max_iter: int = 300, seed: int = 0):
    """Lloyd's k-means on 1-D points from ``n_init`` k-means++ starts; the
    lowest-inertia result as (labels, centers)."""
    rng = np.random.default_rng(seed)
    best = None
    for _ in range(n_init):
        centers = [x[rng.integers(len(x))]]
        for _ in range(1, k):
            # k <= the number of distinct points, so some point is off every center
            d2 = np.min((x[:, None] - np.asarray(centers)[None, :]) ** 2, axis=1)
            centers.append(x[rng.choice(len(x), p=d2 / d2.sum())])
        c = np.asarray(centers, dtype=np.float64)
        for _ in range(max_iter):
            labels = np.argmin(np.abs(x[:, None] - c[None, :]), axis=1)
            new = np.array([x[labels == j].mean() if np.any(labels == j) else c[j]
                            for j in range(k)])
            if np.array_equal(new, c):
                break
            c = new
        labels = np.argmin(np.abs(x[:, None] - c[None, :]), axis=1)
        inertia = float(np.sum((x - c[labels]) ** 2))
        if best is None or inertia < best[0]:
            best = (inertia, labels, c)
    return best[1], best[2]


def get_good_walker_list(log_prob_samples: np.ndarray) -> np.ndarray:
    """Cluster walkers by (int-cast) mean log-prob and keep the cluster with
    the highest center: k-means with at most 8 clusters and 10 restarts, as
    the JAX package does with scikit-learn's ``KMeans``."""
    x = np.mean(log_prob_samples[-10000:, :], axis=0).astype(int).astype(np.float64)
    labels, centers = _kmeans_1d(x, max(min(8, len(np.unique(x))), 1))
    return np.where(labels == int(np.argmax(centers)))[0]


def read_chain_and_cut(
    chainname: str,
    nk: float,
    ntimes: float = 20,
    walkercut: bool = False,
    method: str = "emcee",
    flat: bool = False,
):
    """Keep the last ``nk * median(tau)`` steps of the physical-space chain.
    ``ntimes`` is diagnostic only.  Returns (chain, log_prob, backend)."""
    reader = _open_backend(chainname, method)
    raw = reader.get_chain()
    med_tau = np.nanmedian(convergence.integrated_time(raw))
    if not np.isfinite(med_tau):
        warnings.warn(
            f"all tau estimates are NaN for {chainname}; keeping the full "
            "chain (burn-in included)",
            stacklevel=2,
        )
        nkeep = len(raw)
    else:
        # floor at 1: int(tau*nk) = 0 would keep the whole chain via [-0:]
        nkeep = max(int(med_tau * nk), 1)
    if nk > ntimes:
        warnings.warn(
            f"nk={nk} exceeds ntimes={ntimes}: the kept window reaches "
            "beyond the converged span and will include burn-in steps",
            stacklevel=2,
        )
    chain = reader.get_value("chain_transformed")
    log_prob_samples = reader.get_log_prob()
    if walkercut:
        good = get_good_walker_list(log_prob_samples)
    else:
        good = np.arange(log_prob_samples.shape[1])
    chain = chain[-nkeep:, good, :].reshape(-1, chain.shape[-1])
    log_prob_samples = log_prob_samples[-nkeep:, good]
    if flat:
        log_prob_samples = log_prob_samples.reshape(-1, 1)
    return chain, log_prob_samples, reader


# ------------------------------------------------------------------ retrieval


class RetrievedModel(NamedTuple):
    """A trained emulator rebuilt from an iteration directory: the
    attributes the JAX package's ``Trainer`` exposes to the sampling stage."""

    spec: N.ModelSpec
    params: Dict[str, Any]
    transforms: T.TransformSet
    linearmodel: Optional[Callable]
    outdir: str


def retrieve_model(
    outdir: str,
    in_size: int,
    out_size: int,
    model_name: str = "chto_v2",
    device: DeviceLike = None,
) -> RetrievedModel:
    """Rebuild a trained emulator from ``transforms.npz``,
    ``best.ckpt.npz`` and, where it exists, the pre-model's
    ``linear_model.npz`` on ``device``."""
    device = resolve_device(device)
    spec = N.make_model_spec(model_name, in_size, out_size)
    transforms = T.load_transforms(os.path.join(outdir, TRANSFORMS_FILE), device=device)
    template = N.init_model(spec, seed=0, device="cpu")
    params, _, _ = ckpt.load_checkpoint(os.path.join(outdir, BEST_CKPT), template, device=device)
    lm_path = os.path.join(outdir, LINEAR_MODEL_FILE)
    linearmodel = None
    # a linear_bypass spec never trains with a pre-model (the trainers
    # refuse it), so a stale file from another model is not attached
    if os.path.isfile(lm_path) and not spec.linear_bypass:
        linearmodel = LM.load_linear_model(lm_path, device=device)
    return RetrievedModel(spec, params, transforms, linearmodel, outdir)


def retrieve_ensemble_params(outdir: str, model: RetrievedModel) -> list:
    """All ensemble members' best params: member 0 is ``model``'s own,
    further members live in ``ens_k/`` subdirectories."""
    device = model.params["layer1"]["w"].device
    params_list = [model.params]
    k = 1
    while True:
        path = os.path.join(outdir, f"ens_{k}/", BEST_CKPT)
        if not os.path.isfile(path):
            break
        member, _, _ = ckpt.load_checkpoint(path, model.params, device=device)
        params_list.append(member)
        k += 1
    return params_list


def _saved_shapes(outdir: str):
    # ndmin=2: a one-parameter run's single-column file reads as (N, 1)
    x = np.loadtxt(os.path.join(outdir, "train_samples_x.txt"), ndmin=2)
    y = np.load(os.path.join(outdir, "train_samples_y.npy"))
    return int(x.shape[1]), int(np.atleast_2d(y).shape[1])


def retrieve_model_exist(
    outdir: str,
    in_size: int,
    out_size: int,
    model_name: str = "chto_v2",
    device: DeviceLike = None,
):
    """Retrieval with shapes inferred from the saved training data, for
    models trained with padded dimensions.  Returns (model, incut, outcut);
    pass ``outcut`` to ``make_log_prob(out_cut=...)``.  Raises
    ``ValueError`` when the checkpoint's output is narrower than
    ``out_size``."""
    in_saved, out_saved = _saved_shapes(outdir)
    if out_saved < out_size:
        raise ValueError(
            f"checkpoint under {outdir} was trained with a {out_saved}-point "
            f"output but a {out_size}-point data vector was requested; a "
            "narrower model cannot be cut up to the data size"
        )
    model = retrieve_model(outdir, in_saved, out_saved, model_name, device=device)
    return model, max(in_saved, in_size), out_size


def retrieve_model_wrapper(
    outdir: str,
    model_name: str = "chto_v2",
    device: DeviceLike = None,
):
    """A function mapping physical parameters to the emulated data vector
    in raw data space (X transform -> model -> y transform -> sigma)."""
    in_size, out_size = _saved_shapes(outdir)
    model = retrieve_model(outdir, in_size, out_size, model_name, device=device)
    spec, params, transforms = model.spec, model.params, model.transforms
    dev = params["layer1"]["w"].device

    def emulator(x):
        x = torch.as_tensor(x, dtype=torch.float32).to(dev)
        one = x.ndim == 1
        if one:
            x = x[None, :]
        pred = N.apply_model(spec, params, transforms.x_transform(x), linearmodel=model.linearmodel)
        out = transforms.y_data.inverse(transforms.y_transform(pred))
        return out[0] if one else out

    return emulator


def iteration_log_prob(
    outdir_in: str,
    priors: Sequence[dict],
    data: np.ndarray,
    inv_cov: np.ndarray,
    temperature: float,
    nnmodel_in: str = "chto_v2",
    params: Optional[dict] = None,
    loglike_fn: Optional[Callable] = None,
    external_loglike: Optional[Callable] = None,
    device: DeviceLike = None,
):
    """The likelihood :func:`ml_sampler_core` samples an iteration with: the
    emulator members trained under ``outdir_in``, ``priors``, the squared
    ``temperature`` and ``params``' ``use_fused`` and ``compute_dtype``.
    A checkpoint trained with more parameters or outputs than ``priors``
    and ``data`` gets flat [-1, 1] priors for its extra inputs and its
    predictions cut to the data width.  Returns (log_prob, the priors pack
    the walkers take, their dimension)."""
    params = params or {}
    ndim = len(priors)
    in_saved, out_saved = _saved_shapes(outdir_in)
    out_cut = len(data) if out_saved != len(data) else None
    if in_saved == ndim and out_cut is None:
        model = retrieve_model(outdir_in, ndim, len(data), nnmodel_in, device=device)
        ndim_run = ndim
    else:
        model, ndim_run, _ = retrieve_model_exist(outdir_in, ndim, len(data), nnmodel_in,
                                                  device=device)
    priors_run = list(priors) + [
        {"dist": "flat", "arg1": -1, "arg2": 1} for _ in range(ndim_run - ndim)
    ]
    pack_run = P.priors_from_list(priors_run, device)
    members = retrieve_ensemble_params(outdir_in, model)
    log_prob = LK.make_log_prob(
        model.spec,
        members if len(members) > 1 else model.params,
        model.transforms,
        pack_run,
        data,
        inv_cov,
        temperature=temperature,
        loglike_fn=loglike_fn,
        external_loglike=external_loglike,
        use_fused=bool(params.get("use_fused")),
        compute_dtype=params.get("compute_dtype"),
        out_cut=out_cut,
        linearmodel=model.linearmodel,
        device=device,
    )
    return log_prob, pack_run, ndim_run


# ------------------------------------------------------------------- training


def _write_finish(path: str) -> None:
    with open(path, "w") as f:
        json.dump({"status": "done"}, f)


def train_emulator(
    outdir_in: str,
    outdir_list: Sequence[str],
    data_vec: np.ndarray,
    cov: np.ndarray,
    sigma: np.ndarray,
    dolog10index: Optional[Sequence[int]],
    ypositive: bool,
    model_name: str,
    params: dict,
    retrain: bool = False,
    usebest: bool = False,
    seed: int = 1234,
    verbose: bool = False,
    trace_rec: Optional[dict] = None,
    device: DeviceLike = None,
) -> None:
    """Train one iteration's emulator on ``device``: stack every iteration's
    samples so far, curate, fit and save the transforms, train, and write
    ``finish.json``.

    ``params["nensemble"] = K > 1`` trains K members seeded ``seed + 1000 k``
    as one :class:`EnsembleTrainer` (member 0 into ``outdir_in``, member k
    into ``ens_k/``), or one after another with ``params["serial_members"]``.
    ``params["train_compute_dtype"]`` (e.g. ``"bfloat16"``) runs the training
    forward and backward in that type (see :mod:`linna_tpu_torch.train`).
    ``params["linearmodel"]``, when truthy, fits the PCA + polynomial
    pre-model (a dict passes ``norder``/``npc``) on the x-transformed
    inputs against the standardized targets, rows with a sentinel left
    out, saves it as ``linear_model.npz`` (reloaded when it exists) and
    adds it under every member.
    Skipped when ``finish.json`` exists, or when every member's
    ``best.ckpt.npz`` does (then the marker is written), unless ``retrain``.
    ``trace_rec`` receives the wall-time breakdown.

    Over several ranks every rank calls this: the members train on the
    (ens, data) grid (one member over its data ranks when K = 1), unless
    ``params["serial_members"]``, when rank 0 trains them one after
    another; rank 0 writes, and every rank leaves through a barrier."""
    device = resolve_device(device)
    finish_path = os.path.join(outdir_in, FINISH_MARKER)
    if MH.primary_flag(os.path.isfile(finish_path)) and not retrain:
        return
    n_ensemble = int(params.get("nensemble", 1))
    member_dirs = [outdir_in] + [
        os.path.join(outdir_in, f"ens_{k}/") for k in range(1, n_ensemble)
    ]
    if MH.primary_flag(all(os.path.isfile(os.path.join(d, BEST_CKPT)) for d in member_dirs)
                       ) and not retrain:
        if MH.is_primary():
            _write_finish(finish_path)
        return

    t0 = time.perf_counter()
    stack = D.load_curated_stack(outdir_list, ypositive, usebest=usebest)
    transforms = T.TransformSet(
        T.fit_x_transform(stack.train_x, dolog10index, device=device),
        T.fit_y_transform(stack.train_y_for_stats / np.asarray(sigma), ypositive=ypositive,
                          device=device),
        T.YTransformData(torch.as_tensor(np.asarray(sigma, np.float32), device=device)),
    )
    if MH.is_primary():
        T.save_transforms(os.path.join(outdir_in, TRANSFORMS_FILE), transforms)
    if trace_rec is not None:
        trace_rec["stack_fit_s"] = round(time.perf_counter() - t0, 3)

    spec = N.make_model_spec(model_name, stack.train_x.shape[-1], stack.train_y.shape[-1])
    lm_cfg = params.get("linearmodel")
    if lm_cfg and spec.linear_bypass:
        # apply_model ignores the pre-model for a linear_bypass spec, so
        # training NN + pre-model would sample NN alone
        raise ValueError(
            f"params['linearmodel'] cannot be combined with the "
            f"'{model_name}' model: its built-in 1e-3 linear bypass replaces "
            f"the external pre-model slot (reference linna/nn.py:220-232). "
            f"Use 'chto_v2' or 'chto_simple' with linearmodel, or drop it."
        )
    linearmodel = None
    if lm_cfg:
        t0 = time.perf_counter()
        linearmodel = _fit_or_load_linear_model(outdir_in, stack, transforms, lm_cfg, device)
        if trace_rec is not None:
            trace_rec["linear_model_s"] = round(time.perf_counter() - t0, 3)
    loss_state = L.build_loss_state(data_vec, cov, transforms)
    seeds = [seed + 1000 * k for k in range(n_ensemble)]
    cdtype = params.get("train_compute_dtype")
    train_kwargs = dict(
        num_epochs=int(params.get("num_epochs", 4500)),
        batch_size=int(params.get("batch_size", 500)),
        initfrombest=True,
        epochs_per_dispatch=params.get("epochs_per_dispatch"),
        verbose=verbose,
    )
    rows = (stack.train_x, stack.train_y, stack.val_x, stack.val_y)
    trainer = None
    use_mesh = (n_ensemble > 1 or MH.process_count() > 1) and not params.get("serial_members")
    if use_mesh:
        from .parallel.ensemble import EnsembleTrainer

        t0 = time.perf_counter()
        trainer = EnsembleTrainer(spec, transforms, loss_state, member_dirs, seeds,
                                  compute_dtype=cdtype, linearmodel=linearmodel,
                                  device=device)
        if trace_rec is not None:
            trace_rec["trainer_init_s"] = round(time.perf_counter() - t0, 3)
        trainer.train(*rows, **train_kwargs)
        if trace_rec is not None:
            trace_rec["trainer"] = {k: round(v, 3) for k, v in trainer.phase_seconds.items()}
            trace_rec["epochs_run"] = trainer.epochs_run
            trace_rec["graphs"] = trainer.graphs["epochs"]
    elif MH.is_primary():
        # the one-rank trainer makes no collective: rank 0 alone runs it
        for mi, (member_dir, member_seed) in enumerate(zip(member_dirs, seeds)):
            os.makedirs(member_dir, exist_ok=True)
            t0 = time.perf_counter()
            trainer = Trainer(spec, transforms, loss_state, outdir=member_dir,
                              seed=member_seed, compute_dtype=cdtype,
                              linearmodel=linearmodel, device=device)
            if trace_rec is not None:
                trace_rec[f"trainer_init_s_m{mi}"] = round(time.perf_counter() - t0, 3)
            trainer.train(*rows, **train_kwargs)
            if trace_rec is not None:
                trace_rec[f"trainer_m{mi}"] = {
                    k: round(v, 3) for k, v in trainer.phase_seconds.items()
                }
                trace_rec[f"epochs_run_m{mi}"] = trainer.epochs_run
                trace_rec[f"graphs_m{mi}"] = trainer.graphs["epochs"]
    if trace_rec is not None and trainer is not None:
        trace_rec["compute_dtype"] = str(trainer.compute_dtype or torch.float32)
    if MH.is_primary():
        _write_finish(finish_path)
    # the other ranks read the checkpoints and transforms next
    MH.barrier("train-emulator")


def _fit_or_load_linear_model(outdir_in, stack, transforms, lm_cfg, device):
    """The iteration's pre-model: ``linear_model.npz`` when it exists, else
    fitted on the network's own input and output spaces (x-transformed
    inputs -> standardized targets), rows carrying a sentinel left out, and
    saved (by rank 0; every rank fits the same model from the same
    rows)."""
    lm_path = os.path.join(outdir_in, LINEAR_MODEL_FILE)
    if MH.primary_flag(os.path.isfile(lm_path)):
        return LM.load_linear_model(lm_path, device=device)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    y_raw = np.asarray(stack.train_y, np.float64)
    good = ~np.any((y_raw == L.SENTINEL_LOW) | (y_raw == L.SENTINEL_HIGH), axis=1)
    with torch.no_grad():
        x_in = transforms.x_transform(f32(stack.train_x)).cpu().numpy()
        y_std = transforms.y_transform.inverse(transforms.y_data(f32(y_raw[good]))).cpu().numpy()
    kwargs = dict(lm_cfg) if isinstance(lm_cfg, dict) else {}
    model = LM.fit_linear_model(x_in[good], y_std, device=device, **kwargs)
    if MH.is_primary():
        LM.save_linear_model(lm_path, model)
    return model


def _train_in_subprocess(
    outdir_in, outdir_list, data, cov, sigma, dolog10index, ypositive, model_name, params,
    usebest, verbose, device,
) -> None:
    """Write the request and run ``python -m linna_tpu_torch.train_entry``;
    the request names ``device``, so the child trains where the parent
    asked."""
    import subprocess
    import sys

    from . import train_entry as TE

    if os.path.isfile(os.path.join(outdir_in, FINISH_MARKER)):
        return
    TE.write_request(outdir_in, outdir_list, data, cov, sigma, dolog10index, ypositive,
                     model_name, params, usebest, device=device)
    cmd = [sys.executable, "-m", "linna_tpu_torch.train_entry", outdir_in]
    if verbose:
        cmd.append("--verbose")
    # the child imports this package from where the parent found it
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p)
    proc = subprocess.run(cmd, capture_output=not verbose, env=dict(os.environ, PYTHONPATH=path))
    if proc.returncode != 0:
        tail = (proc.stderr or b"").decode(errors="replace")[-2000:]
        raise RuntimeError(f"training subprocess failed:\n{tail}")
    if not os.path.isfile(os.path.join(outdir_in, FINISH_MARKER)):
        raise RuntimeError("training subprocess exited without finish marker")


# ------------------------------------------------------------------ main loop


def ml_sampler(
    outdir: str,
    theory: Callable,
    priors: Sequence[dict],
    data: np.ndarray,
    cov: np.ndarray,
    init: np.ndarray,
    pool=None,
    nwalkers: int = 128,
    gpunode: Optional[str] = None,
    omegab2cut: Optional[Sequence] = None,
    nepoch: int = 4500,
    method: str = "zeus",
    nbest=None,
    chisqcut: Optional[float] = None,
    loglikelihoodfunc: Optional[Callable] = None,
    device: DeviceLike = None,
):
    """LINNA with the To et al. 2022 hyperparameters (reference
    linna/main.py:22-75): 4 iterations of 10000 training and 500 validation
    points, temperatures 4, 2, 1, 1, and a 4-member emulator ensemble.
    ``method`` is one sampler name or a 4-entry list, one per iteration
    (e.g. ``["zeus", "zeus", "zeus", "nuts"]``); hmc and nuts use zeus's
    convergence table."""
    ntrainArr = [10000] * 4
    nvalArr = [500] * 4
    per_method = {
        "emcee": ([2, 2, 5, 4], [5, 5, 10, 15], [0.03, 0.03, 0.02, 0.01]),
        "zeus": ([2, 2, 5, 5], [5, 5, 10, 50], [0.03, 0.03, 0.02, 0.01]),
    }
    per_method["hmc"] = per_method["nuts"] = per_method["zeus"]
    methods = [method] * 4 if isinstance(method, str) else [str(m) for m in method]
    if len(methods) != 4:
        raise ValueError(
            f"ml_sampler's paper schedule has 4 iterations; method list has "
            f"{len(methods)} entries (use ml_sampler_core for other schedules)"
        )
    for m in methods:
        _chain_filename(m)  # unknown names raise NotImplementedError(method)
    nkeepArr = [per_method[m][0][i] for i, m in enumerate(methods)]
    ntimesArr = [per_method[m][1][i] for i, m in enumerate(methods)]
    ntautolArr = [per_method[m][2][i] for i, m in enumerate(methods)]
    params = {"trainingoption": 1, "num_epochs": nepoch, "batch_size": 500, "nensemble": 4}
    return ml_sampler_core(
        ntrainArr, nvalArr, nkeepArr, ntimesArr, ntautolArr, [0.2] * 4, [0.15] * 4,
        outdir, theory, priors, data, cov, init, pool, nwalkers,
        device=device,
        temperatureArr=[4.0, 2.0, 1.0, 1.0],
        omegab2cut=omegab2cut,
        gpunode=gpunode,
        nnmodel_in="chto_v2",
        params=params,
        method=methods,
        nbest=nbest,
        chisqcut=chisqcut,
        loglikelihoodfunc=loglikelihoodfunc,
    )


def ml_sampler_core(
    ntrainArr,
    nvalArr,
    nkeepArr,
    ntimesArr,
    ntautolArr,
    meanshiftArr,
    stdshiftArr,
    outdir: str,
    theory: Callable,
    priors: Sequence[dict],
    data: np.ndarray,
    cov: np.ndarray,
    init: np.ndarray,
    pool=None,
    nwalkers: int = 128,
    device: DeviceLike = None,
    dolog10index: Optional[Sequence[int]] = None,
    ypositive: bool = False,
    temperatureArr: Sequence[float] = (4.0, 2.0, 1.0, 1.0),
    omegab2cut: Optional[Sequence] = None,
    docuda: bool = False,
    tsize: int = 1,
    gpunode: Optional[str] = None,
    nnmodel_in: str = "chto_v2",
    params: Optional[dict] = None,
    method: str = "emcee",
    nbest=None,
    chisqcut: Optional[float] = None,
    loglikelihoodfunc: Optional[Callable] = None,
    nsigma: float = 3,
    externalloglike: Optional[Callable] = None,
    seed: int = 0,
    verbose: bool = False,
):
    """The iterative loop (reference linna/main.py:77-335) on ``device``.
    Returns (chain, log_prob) of the final iteration, the chain in physical
    space.  ``method`` is one of emcee (the default, as in the JAX package),
    zeus, hmc and nuts, or a list with one per iteration.  ``docuda``,
    ``tsize`` and ``gpunode`` are accepted for the reference's signature and
    unused.

    ``params["linearmodel"]`` adds the PCA + polynomial pre-model under the
    emulator in training and sampling (see :func:`train_emulator`), and
    ``params["compute_dtype"]`` (e.g. ``"bfloat16"``) runs the sampling
    likelihood's emulator in that type (see
    :func:`linna_tpu_torch.likelihood.make_log_prob`)."""
    D.clear_cache()  # never reuse a previous run's curated stacks
    check_map_count()
    params = dict(params or {})
    if not isinstance(nnmodel_in, str):
        nnmodel_in = getattr(nnmodel_in, "__name__", "chto_v2")
        nnmodel_in = {
            "ChtoModelv2": "chto_v2",
            "ChtoModelsimple": "chto_simple",
            "ChtoModelv2_linear": "chto_v2_linear",
        }.get(nnmodel_in, "chto_v2")
    device = resolve_device(device)
    data = np.asarray(data, dtype=np.float64)
    cov = np.asarray(cov, dtype=np.float64)
    init = np.asarray(init, dtype=np.float64)
    ndim = len(init)
    sigma = np.sqrt(np.diag(cov))
    inv_cov = np.linalg.inv(cov)
    pack = P.priors_from_list(priors, device)
    prior_range = P.prior_range(pack)
    init_white = P.inv_transform(pack, torch.as_tensor(init, dtype=torch.float32, device=device))
    init_white = np.atleast_1d(init_white.cpu().numpy().astype(np.float64))
    if isinstance(method, str):
        methods = [method] * len(ntrainArr)
    else:
        methods = [str(m) for m in method]
        if len(methods) != len(ntrainArr):
            raise ValueError(
                f"method list has {len(methods)} entries for {len(ntrainArr)} iterations"
            )
    for m in methods:
        _chain_filename(m)  # unknown names raise NotImplementedError(method)
    is_master = pool is None or pool.is_master()
    options = int(params.get("trainingoption", 0))
    timer = PhaseTimer(outdir if is_master and MH.is_primary() else None)
    rng = np.random.default_rng(seed)

    # the kernel build, its first launches at this run's shapes and cuBLAS's
    # first use, in a daemon thread while iteration 0 makes its training
    # points (parallel/precompile.py has the gating story)
    if is_master and precompile.should_warm(params, ypositive, nbest, chisqcut):
        use_kernel = (
            bool(params.get("use_fused"))
            and int(params.get("nensemble", 1)) == 1
            and loglikelihoodfunc is None
            and externalloglike is None
            and params.get("compute_dtype") is None
            and nnmodel_in != "chto_v2_linear"
        )
        precompile.warm_pipeline(nnmodel_in, ndim, len(data), nwalkers,
                                 int(params.get("batch_size", 500)), use_kernel, device)

    chain = None
    for i, (nt, nv, nk, ntimes, tautol, temperature, meanshift, stdshift) in enumerate(
        zip(ntrainArr, nvalArr, nkeepArr, ntimesArr, ntautolArr, temperatureArr,
            meanshiftArr, stdshiftArr)
    ):
        nbest_in = nbest[i] if isinstance(nbest, list) else nbest
        if isinstance(nbest, list) and nbest_in is not None and nbest_in <= 0:
            nbest_in = None
        negloglike = None
        if nbest_in is not None:
            import tempfile

            tempdir = tempfile.mkdtemp()

            def negloglike(x, _tmp=tempdir):
                d = data - theory([-1, x], _tmp)
                return float(d @ inv_cov @ d)

        temperature = float(temperature) ** 2  # linna/main.py:153
        outdir_in = os.path.join(outdir, f"iter_{i}/")
        # the previous chain feeds only the training points, which rank 0
        # draws and writes; the others wait at the barrier, then read them
        if i > 0 and MH.is_primary():
            prev = os.path.join(outdir, f"iter_{i-1}/", _chain_filename(methods[i - 1]))
            with timer.phase("read_chain_and_cut", iteration=i - 1):
                chain, _, _ = read_chain_and_cut(prev, nk, ntimes, method=methods[i - 1])

        nnsampler = SG.NNSampler(outdir_in, prior_range)
        with timer.phase("generate_training_point", iteration=i, n=nt + nv):
            if MH.is_primary():
                SG.generate_training_point(
                    theory, nnsampler, pool, outdir_in, nt, nv, data, inv_cov, chain,
                    nsigma=nsigma, omegab2cut=omegab2cut, options=options,
                    negloglike=negloglike, nbest_in=nbest_in, chisqcut=chisqcut,
                )
            MH.barrier(f"training-points-{i}")
        chain = None

        if not is_master:
            continue
        outdir_list = [os.path.join(outdir, f"iter_{m}/") for m in range(i + 1)]
        with timer.phase("train_emulator", iteration=i) as trec, \
                device_profile(f"train_iter{i}"):
            if params.get("train_subprocess"):
                # training in a child process (crash isolation, CLI parity);
                # rank 0 alone starts it, the child runs on one rank
                if MH.is_primary():
                    _train_in_subprocess(
                        outdir_in, outdir_list, data, cov, sigma, dolog10index, ypositive,
                        nnmodel_in, params, nbest_in is not None, verbose, device,
                    )
                MH.barrier(f"train-subprocess-{i}")
            else:
                train_emulator(
                    outdir_in, outdir_list, data, cov, sigma, dolog10index, ypositive,
                    nnmodel_in, params, usebest=nbest_in is not None, verbose=verbose,
                    trace_rec=trec, device=device,
                )

        # sample unless this iteration's chain exists and is complete; a
        # chain whose sampler died mid-run resumes from its saved state
        chain_path = os.path.join(outdir_in, _chain_filename(methods[i]))
        if MH.primary_flag(MH.is_primary() and _open_backend(chain_path, methods[i]).exists()
                           and not _chain_incomplete(chain_path, methods[i])):
            continue
        log_prob, pack_run, ndim_run = iteration_log_prob(
            outdir_in, priors, data, inv_cov, temperature, nnmodel_in, params,
            loglike_fn=loglikelihoodfunc, external_loglike=externalloglike, device=device,
        )
        init_run = np.concatenate([init_white, np.zeros(ndim_run - ndim)])
        jitter = 0.1 if methods[i] == "emcee" else 0.001
        x0 = init_run + jitter * rng.standard_normal((nwalkers, ndim_run))
        with timer.phase("mcmc", iteration=i, method=methods[i]) as mrec, \
                device_profile(f"mcmc_iter{i}"):
            sampler_run.run_ensemble(
                log_prob,
                x0,
                outdir_in,
                method=methods[i],
                transform=lambda x, _p=pack_run: P.transform_np(_p, x),
                ntimes=ntimes,
                tautol=tautol,
                meanshift=meanshift,
                stdshift=stdshift,
                nk=nk,
                seed=seed + i,
                progress=verbose,
                trace_rec=mrec,
                device=device,
            )
        # the next iteration and the final read take this chain on every rank
        MH.barrier(f"mcmc-{i}")

    last = os.path.join(outdir, f"iter_{len(ntrainArr)-1}/", _chain_filename(methods[-1]))
    # the returned log-probs are the same cut rows as the chain
    with timer.phase("read_chain_and_cut", iteration=len(ntrainArr) - 1):
        chain, log_prob_samples, _ = read_chain_and_cut(
            last, nkeepArr[-1], ntimesArr[-1], method=methods[-1], flat=True
        )
    if "nimp" in params and is_master:
        imp_args = (outdir, last, params, nkeepArr[-1], ntimesArr[-1], methods[-1], theory,
                    pool, pack, data, inv_cov, prior_range, rng)
        if MH.is_primary():
            with timer.phase("importance_sampling", n=int(params["nimp"])):
                chain, log_prob_samples = _importance_sampling(*imp_args)
        # the other ranks then take the file-gated reads of the same function
        MH.barrier("importance")
        if not MH.is_primary():
            chain, log_prob_samples = _importance_sampling(*imp_args)
    return chain, log_prob_samples


def _importance_sampling(
    outdir, chain_name, params, nk, ntimes, method, theory, pool, pack, data, inv_cov,
    prior_range, rng,
):
    """Exact-theory importance reweighting of the final chain (reference
    linna/main.py:297-334): subsample, evaluate the true theory, weight by
    exp(logp_true - logp_emulator) in log space, and zero out log-weights
    beyond 2 sigma of the finite ones."""
    samples_path = os.path.join(outdir, "samples_im.npy")
    logp_path = os.path.join(outdir, "log_prob_samples_x.npy")
    if not os.path.isfile(samples_path):
        chain, log_prob_samples, _ = read_chain_and_cut(
            chain_name, nk, ntimes, method=method, flat=True
        )
        log_prob_samples = np.asarray(log_prob_samples).flatten()
        select = rng.integers(0, len(chain), int(params["nimp"]))
        chain = chain[select]
        log_prob_samples = log_prob_samples[select]
        np.save(samples_path, chain)
        np.save(logp_path, log_prob_samples)
    else:
        chain = np.load(samples_path)
        log_prob_samples = np.load(logp_path)

    outimp = os.path.join(outdir, "imp/")
    os.makedirs(outimp, exist_ok=True)
    theory_path = os.path.join(outdir, "theory.npy")
    nnsampler = SG.NNSampler(outimp, prior_range)
    if not os.path.isfile(theory_path):
        theory_vals = nnsampler.generate_training_data(
            zip(range(len(chain)), chain), theory, pool=pool, args=[outimp]
        )
        np.save(theory_path, theory_vals)
    else:
        theory_vals = np.load(theory_path)

    resid = np.asarray(theory_vals, np.float64)[:, : len(data)] - data
    x = torch.as_tensor(np.asarray(chain, np.float32), device=pack.arg1.device)
    logp = (
        -0.5 * np.einsum("ij,jk,ik->i", resid, inv_cov, resid)
        + P.log_prior_physical(pack, x).double().cpu().numpy()
    )
    logw = logp - log_prob_samples
    finite = np.isfinite(logw)
    if not finite.any():
        raise RuntimeError(
            "importance sampling: every subsampled point produced a "
            f"non-finite log-weight; inspect {theory_path}"
        )
    ref = logw[finite]
    keep = finite & (np.abs(logw - np.mean(ref)) <= 2 * np.std(ref))
    w = np.zeros_like(logw)
    w[keep] = np.exp(logw[keep] - np.max(logw[keep]))
    w = w / np.sum(w)
    if MH.is_primary():
        np.save(os.path.join(outdir, "weight_im.npy"), [log_prob_samples, logp, w])
    return chain, log_prob_samples
