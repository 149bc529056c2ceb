"""The sampling stage of one LINNA iteration (PyTorch).

Counterpart of the parts of ``linna_tpu/orchestrator.py`` that the sampling
stage of ``ml_sampler_core`` calls: rebuild the trained emulator of an
iteration directory (``transforms.npz``, ``best.ckpt.npz``, the training
sample files, ``finish.json``), and read and cut the chain that
``samplers.run.run_ensemble`` wrote.  Artifacts have the JAX package's
names and layouts, so an iteration directory written by either package is
sampled by the other.
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from . import nn as N
from . import transforms as T
from .device import DeviceLike, resolve_device
from .samplers import backends, convergence
from .samplers import run as sampler_run
from .utils import checkpoint as ckpt

__all__ = [
    "FINISH_MARKER",
    "TRANSFORMS_FILE",
    "BEST_CKPT",
    "RetrievedModel",
    "retrieve_model",
    "retrieve_model_exist",
    "retrieve_model_wrapper",
    "retrieve_ensemble_params",
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
    """Rebuild a trained emulator from ``transforms.npz`` and
    ``best.ckpt.npz`` on ``device``."""
    device = resolve_device(device)
    spec = N.make_model_spec(model_name, in_size, out_size)
    if os.path.isfile(os.path.join(outdir, LINEAR_MODEL_FILE)) and not spec.linear_bypass:
        raise NotImplementedError(
            f"{LINEAR_MODEL_FILE} found in {outdir}: the PCA + polynomial "
            "pre-model is not ported to linna_tpu_torch yet (see ROADMAP.md)"
        )
    transforms = T.load_transforms(os.path.join(outdir, TRANSFORMS_FILE), device=device)
    template = N.init_model(spec, seed=0, device="cpu")
    params, _, _ = ckpt.load_checkpoint(os.path.join(outdir, BEST_CKPT), template, device=device)
    return RetrievedModel(spec, params, transforms, None, outdir)


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
