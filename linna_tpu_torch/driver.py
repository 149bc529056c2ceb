"""Application driver: YAML-configured LINNA runs from the command line.

Counterpart of ``linna_tpu/driver.py``:

    python -m linna_tpu_torch.driver <method> <gpunode> <yaml> [yamldir] [--device DEV]

- the four positional arguments of the reference's CLI; ``gpunode`` is
  accepted and unused, and the run trains and samples on ``cuda:0`` unless
  ``--device`` names another (``--device cpu`` runs the plain PyTorch
  versions on the host);
- YAML config with ``include:`` merging (:mod:`linna_tpu_torch.config`);
- the theory is a plugin: ``theory: "pkg.module:factory"`` names a factory
  that receives the config dict and returns ``theory([index, x], outdir)``
  (``examples/des_theory.py`` imports numpy only), or ``"identity"``;
- triplet-file covariance read and symmetrized, |C| > 1e10 zeroed; mask
  loading and alignment; an optional linear compression of data, covariance
  and theory outputs (``transform_matrix_file``);
- priors and the initial point from the config's ``sampled_params``;
- external likelihood terms summed into the posterior;
- ``methodArr`` overrides the CLI method per iteration;
- MPI and multiprocess pools (``pool: mpi | multiprocess``): non-master
  ranks wait on the pool, then exit;
- the wall-clock seconds saved to ``time.npy``.

Over several ranks (``python -m linna_tpu_torch.launch``) every rank runs
the driver and rank 0 alone writes the run directory.
"""

from __future__ import annotations

import importlib
import os
import sys
import time
from copy import deepcopy
from typing import Callable, Optional, Sequence

import numpy as np

from .config import yaml_load
from .device import DeviceLike
from .orchestrator import ml_sampler_core
from .parallel import multihost as MH

__all__ = [
    "ExternalLogLike",
    "ModelFunc",
    "CompressedModel",
    "read_triplet_cov",
    "align_mask",
    "priors_and_init_from_config",
    "resolve_theory",
    "external_loglike_from_config",
    "run_from_config",
    "main",
]


class ExternalLogLike:
    """Sum of extra likelihood terms evaluated in physical space."""

    def __init__(self, like_arr: Sequence[Callable]):
        self.like_arr = list(like_arr)

    def __call__(self, x):
        total = 0.0
        for like in self.like_arr:
            total = total + like(x)
        return total


class ModelFunc:
    """Theory wrapper with file-gated caching and masking: each evaluation
    writes ``data_<i>`` into the scratch dir, skips if it exists, masks the
    result, and returns zeros on failure (the loss masks such rows)."""

    def __init__(self, datavector_writer: Callable, mask: np.ndarray):
        self.datavector_writer = datavector_writer
        self.mask = np.asarray(mask, dtype=bool)

    def __call__(self, x, outdirs):
        index, params = x[0], x[1]
        data_file = os.path.join(outdirs, f"data_{index}")
        if os.path.isfile(data_file):
            return np.loadtxt(data_file)[self.mask, 1]
        try:
            self.datavector_writer(params, data_file)
            data = np.loadtxt(data_file)
            mask = self.mask
            if len(mask) > len(data):
                mask = mask[: len(data)]
            data = data[mask, 1]
        except Exception:
            # a failed theory point is a zero vector, as in the reference
            data = np.zeros(int(np.sum(self.mask)))
        if len(data) == 0:
            data = np.zeros(int(np.sum(self.mask)))
        return data


class CompressedModel:
    """Apply the driver's linear data compression to theory outputs, so the
    emulator trains on, and the likelihood compares, vectors in the
    compressed space.  A class, not a closure: theory callables must pickle
    for the multiprocess and MPI pools."""

    def __init__(self, fn: Callable, t: np.ndarray):
        self.fn = fn
        self.t = np.asarray(t, dtype=np.float64)

    def __call__(self, x, outdirs):
        return self.t @ np.asarray(self.fn(x, outdirs), dtype=np.float64)


def read_triplet_cov(covin: np.ndarray) -> np.ndarray:
    """(i, j, ..., gauss, non-gauss) triplet rows -> dense symmetric
    covariance; |C| > 1e10 entries zeroed."""
    covin = np.atleast_2d(np.asarray(covin, dtype=np.float64))
    n = int(np.max(covin[:, 0])) + 1
    cov = np.zeros((n, n))
    ii = covin[:, 0].astype(int)
    jj = covin[:, 1].astype(int)
    vv = covin[:, -2] + covin[:, -1]
    cov[ii, jj] = vv
    cov[jj, ii] = vv
    cov[np.abs(cov) > 1e10] = 0
    return cov


def align_mask(mask: np.ndarray, n: int) -> np.ndarray:
    """Pad or truncate a boolean mask to length ``n``."""
    mask = np.asarray(mask, dtype=bool)
    if len(mask) > n:
        return mask[:n]
    if len(mask) < n:
        out = np.zeros(n, dtype=bool)
        out[: len(mask)] = mask
        return out
    return mask


def priors_and_init_from_config(params: dict):
    """(priors, init) from the config's ``sampled_params`` list: each entry
    is ``{param, dist: flat|gauss, arg1, arg2, fid?}``; a gauss prior's init
    is its mean (arg1), a flat prior's ``fid`` or the interval's center."""
    entries = params.get("sampled_params")
    if not entries:
        raise KeyError("config needs a 'sampled_params' list")
    priors, init = [], []
    for e in entries:
        dist = e.get("dist", "flat")
        priors.append({
            "param": e.get("param", f"p{len(priors)}"),
            "dist": dist,
            "arg1": float(e["arg1"]),
            "arg2": float(e["arg2"]),
        })
        if "fid" in e:
            init.append(float(e["fid"]))
        elif dist == "gauss":
            init.append(float(e["arg1"]))
        else:
            init.append(0.5 * (float(e["arg1"]) + float(e["arg2"])))
    return priors, np.asarray(init)


def resolve_theory(params: dict) -> Callable:
    """The theory plugin: ``"pkg.module:factory"`` is imported and called
    with the config dict; ``"identity"`` returns the parameters themselves."""
    spec = params.get("theory")
    if spec is None:
        raise KeyError("config needs a 'theory' entry point")
    if spec == "identity":
        return lambda x, outdirs: deepcopy(np.asarray(x[1], dtype=np.float64))
    mod_name, _, attr = spec.partition(":")
    if not attr:
        raise ValueError(f"theory {spec!r} must be 'module:factory'")
    factory = getattr(importlib.import_module(mod_name), attr)
    return factory(params)


def _load_data_cov(params: dict):
    """(data, cov, mask, transform matrix or None) from the config's files."""
    base = params.get("base_dir", "")
    cov_raw = np.loadtxt(os.path.join(base, params["cov_file"]))
    if cov_raw.ndim == 2 and cov_raw.shape[0] == cov_raw.shape[1] and (
        params.get("cov_format", "triplet") == "dense"
    ):
        cov = np.asarray(cov_raw, dtype=np.float64)
    else:
        cov = read_triplet_cov(cov_raw)
    data = np.loadtxt(os.path.join(base, params["data_file"]))
    if data.ndim == 2:  # (index, value) rows as in cosmolike outputs
        data = data[:, 1]
    if "mask_file" in params:
        mask = np.loadtxt(os.path.join(base, params["mask_file"]))
        if mask.ndim == 2:
            mask = mask[:, 1]
        mask = mask > 0
    else:
        mask = np.ones(len(cov), dtype=bool)
    mask = align_mask(mask, len(cov))
    cov = cov[mask][:, mask]
    if len(data) == len(mask):
        data = data[mask]  # full-length vector: masked here
    elif len(data) != len(cov):
        # neither the full nor the masked length: never truncate silently
        raise ValueError(
            f"data vector has {len(data)} points; expected the full "
            f"{len(mask)} (masked here) or the pre-masked {len(cov)}"
        )
    if "transform_matrix_file" in params:
        # linear compression: data <- T data, cov <- T cov T^T (rows of T are
        # the compressed dimension, columns the masked data dimension)
        t = np.loadtxt(os.path.join(base, params["transform_matrix_file"]))
        t = np.atleast_2d(np.asarray(t, dtype=np.float64))
        if t.shape[1] != len(cov):
            raise ValueError(
                f"transform matrix has {t.shape[1]} columns for a "
                f"{len(cov)}-point masked data vector"
            )
        return t @ data, t @ cov @ t.T, mask, t
    return data, cov, mask, None


def external_loglike_from_config(params: dict) -> Optional[ExternalLogLike]:
    """The sum of the config's ``external_likelihoods`` (``module:factory``
    entries, each called with ``params``), or None without any."""
    ext_spec = params.get("external_likelihoods")
    if not ext_spec:
        return None
    likes = []
    for item in ext_spec:
        mod_name, _, attr = item.partition(":")
        likes.append(getattr(importlib.import_module(mod_name), attr)(params))
    return ExternalLogLike(likes)


def run_from_config(
    params: dict,
    method: str = "zeus",
    pool=None,
    gpunode: Optional[str] = None,
    verbose: bool = False,
    device: DeviceLike = None,
):
    """Run the full pipeline from a loaded config dict on ``device``
    (``cuda:0`` by default); returns (chain, log_prob)."""
    outdir = params["outdir"]
    if MH.is_primary():
        os.makedirs(outdir, exist_ok=True)

    start = time.time()
    data, cov, mask, tmat = _load_data_cov(params)
    priors, init = priors_and_init_from_config(params)
    theory = resolve_theory(params)
    if params.get("mask_theory", False):
        theory = ModelFunc(theory, mask)
    if tmat is not None:
        theory = CompressedModel(theory, tmat)

    external = external_loglike_from_config(params)

    if pool is not None and not pool.is_master():
        pool.wait()
        sys.exit(0)

    chain, log_prob = ml_sampler_core(
        ntrainArr=params["ntrainArr"],
        nvalArr=params["nvalArr"],
        nkeepArr=params["nkeepArr"],
        ntimesArr=params["ntimesArr"],
        ntautolArr=params["ntautolArr"],
        meanshiftArr=params["meanshiftArr"],
        stdshiftArr=params["stdshiftArr"],
        outdir=outdir,
        theory=theory,
        priors=priors,
        data=data,
        cov=cov,
        init=init,
        pool=pool,
        nwalkers=int(params.get("nwalkers", 128)),
        device=device,
        dolog10index=params.get("dolog10index"),
        ypositive=bool(params.get("ypositive", False)),
        temperatureArr=params["temperatureArr"],
        omegab2cut=params.get("omegab2cut"),
        gpunode=gpunode,
        nnmodel_in=params.get("nnmodel", "chto_v2"),
        params=params,
        # methodArr overrides the CLI method with one sampler per iteration
        method=params.get("methodArr", method),
        externalloglike=external,
        seed=int(params.get("seed", 0)),
        verbose=verbose,
    )
    if MH.is_primary():
        np.save(os.path.join(outdir, "time.npy"), time.time() - start)
    return chain, log_prob


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="python -m linna_tpu_torch.driver")
    parser.add_argument("method")
    parser.add_argument("gpunode", help="accepted for the reference's CLI; unused")
    parser.add_argument("yaml")
    parser.add_argument("yamldir", nargs="?", default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda:0; 'cpu' runs on the host)")
    args = parser.parse_args(argv)
    params = yaml_load(args.yaml, parent_dir=args.yamldir)

    pool = None
    if params.get("pool") == "mpi":
        from .pool import MPIPool

        pool = MPIPool()
    elif params.get("pool") == "multiprocess":
        from .pool import MultiprocessPool

        pool = MultiprocessPool(params.get("processes"))

    try:
        run_from_config(params, method=args.method, pool=pool, gpunode=args.gpunode,
                        device=args.device)
    finally:
        if pool is not None:
            pool.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
