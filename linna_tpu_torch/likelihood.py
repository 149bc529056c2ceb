"""Batched emulator likelihood, the sampling hot path (PyTorch).

Counterpart of ``linna_tpu/likelihood.py``: whitened parameters -> physical
transform -> emulator -> data-space prediction -> Gaussian (or custom)
log-likelihood tempered by 1/T, plus the whitened-space unit-normal
log-prior and optional external terms; NaN -> -inf.  ``make_log_prob``
builds one batch-native function (W, D) -> (W,) as a pure ``_pure(x, env)``
over an ``env`` dict of tensors (weights, transforms, priors, data, inverse
covariance, temperature, ensemble k_std).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from . import nn as N
from . import priors as P
from .device import DeviceLike, resolve_device
from .transforms import TransformSet

__all__ = ["gaussian_loglike", "make_log_prob"]


def _chi2(d: torch.Tensor, inv_cov: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...i,ij,...j->...", d, inv_cov, d)


def gaussian_loglike(m: torch.Tensor, data: torch.Tensor, inv_cov: torch.Tensor) -> torch.Tensor:
    """-0.5 (m-d)^T C^-1 (m-d), batched over leading axes."""
    return -0.5 * _chi2(m - data, inv_cov)


def _f32(a, device) -> torch.Tensor:
    if torch.is_tensor(a):
        return a.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(a), dtype=torch.float32).to(device)


def _to(tree, device, dtype=None):
    if isinstance(tree, dict):
        return {k: _to(v, device, dtype) for k, v in tree.items()}
    return tree.to(device=device, dtype=dtype)


def make_log_prob(
    spec: N.ModelSpec,
    params,
    transforms: TransformSet,
    prior_pack: P.PriorPack,
    data,
    inv_cov,
    temperature: float = 1.0,
    loglike_fn: Optional[Callable] = None,
    external_loglike: Optional[Callable] = None,
    linearmodel: Optional[Callable] = None,
    ensemble_k_std: float = 1.0,
    use_fused: bool = False,
    out_cut: Optional[int] = None,
    compute_dtype: Optional[str] = None,
    device: DeviceLike = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build the batched whitened-space log-posterior on ``device``.

    ``loglike_fn(m, data, inv_cov)`` may replace the Gaussian likelihood;
    ``external_loglike(x_physical)`` adds terms evaluated in physical space.

    ``use_fused=True`` routes the plain single-emulator Gaussian
    configuration (no ensemble, no custom or external likelihood, no
    linearmodel, no ``out_cut``, no linear bypass) to
    :func:`linna_tpu_torch.ops.fused.fused_log_prob`: on a CUDA device that
    always launches the CUDA kernel (a build or launch error propagates), on
    the CPU it runs the kernel's plain version.  Every other configuration
    uses the composition below.

    ``out_cut``: compare only the first ``out_cut`` components of a wider
    checkpoint's prediction with ``data``.

    ``compute_dtype`` (for example ``"bfloat16"``): the emulator's weights
    are cast to it once, here, and its inputs on every call; each product
    accumulates in float32 and rounds once to that type
    (:func:`linna_tpu_torch.nn.apply_model`).  The prediction returns to
    float32 before the y transforms and chi^2, so the output is float32.
    ``use_fused=True`` with a ``compute_dtype`` raises ``ValueError``: the
    kernel computes in float32 only.  The pre-model sees the reduced-type
    inputs, as in the JAX package.

    Ensemble likelihood: ``params`` may be a list of K parameter dicts; the
    effective chi^2 is ``mean_k chi2_k + ensemble_k_std * std_k chi2_k``
    with the population std (ddof=0).  Only for the Gaussian likelihood.
    """
    cdtype = N.compute_dtype(compute_dtype)
    if cdtype is not None and use_fused:
        raise ValueError("use_fused supports float32 only; drop compute_dtype")
    device = resolve_device(device)
    data_t = _f32(data, device)
    inv_cov_t = _f32(inv_cov, device)
    like = loglike_fn if loglike_fn is not None else gaussian_loglike
    temperature = float(temperature)

    is_ensemble = isinstance(params, (list, tuple)) and len(params) > 1
    if isinstance(params, (list, tuple)) and len(params) == 1:
        params = params[0]
    if is_ensemble:
        if loglike_fn is not None:
            raise ValueError("ensemble likelihood requires the default Gaussian loglike")
        members = [_to(p, device) for p in params]
        params = {k: _stack([m[k] for m in members]) for k in members[0]}
    else:
        params = _to(params, device)
    if cdtype is not None:
        params = _to(params, device, cdtype)

    if out_cut is not None:
        out_cut = int(out_cut)
        if out_cut > spec.out_size:
            raise ValueError(
                f"out_cut={out_cut} exceeds the model's output size "
                f"{spec.out_size}: the checkpoint cannot produce the "
                "requested data vector"
            )
        if out_cut == spec.out_size:
            out_cut = None

    if (
        use_fused
        and not is_ensemble
        and loglike_fn is None
        and external_loglike is None
        and linearmodel is None
        and out_cut is None
        and not spec.linear_bypass
    ):
        from .ops import fused

        return fused.fused_log_prob(
            spec, params, transforms, prior_pack, data, inv_cov,
            temperature=temperature, device=device,
        )

    env = {
        "params": params,
        "transforms": transforms.to(device),
        "priors": prior_pack.to(device),
        "data": data_t,
        "inv_cov": inv_cov_t,
        "temperature": torch.tensor(temperature, dtype=torch.float32, device=device),
        "k_std": torch.tensor(ensemble_k_std, dtype=torch.float32, device=device),
    }
    n_members = len(members) if is_ensemble else 0

    def _pure(x: torch.Tensor, env) -> torch.Tensor:
        tset = env["transforms"]
        x = torch.as_tensor(x, dtype=torch.float32, device=env["data"].device)
        x_phys = P.transform(env["priors"], x)
        x_in = tset.x_transform(x_phys)
        if cdtype is not None:
            x_in = x_in.to(cdtype)
        if is_ensemble:
            # the pre-model depends on x_in alone: one evaluation for all
            # members (apply_model ignores it for a linear_bypass spec)
            base = None
            if linearmodel is not None and not spec.linear_bypass:
                base = linearmodel(x_in)
            chi2 = []
            for k in range(n_members):
                pred = N.apply_model(spec, _index(env["params"], k), x_in).float()
                if base is not None:
                    pred = pred + base
                m = tset.y_data.inverse(tset.y_transform(pred))
                if out_cut is not None:
                    m = m[..., :out_cut]
                chi2.append(_chi2(m - env["data"], env["inv_cov"]))
            chi2 = torch.stack(chi2)  # (K, ...)
            eff = chi2.mean(dim=0) + env["k_std"] * chi2.std(dim=0, correction=0)
            lp = -0.5 * eff / env["temperature"] + P.lnprior(x)
        else:
            pred = N.apply_model(spec, env["params"], x_in, linearmodel=linearmodel).float()
            m = tset.y_data.inverse(tset.y_transform(pred))
            if out_cut is not None:
                m = m[..., :out_cut]
            lp = like(m, env["data"], env["inv_cov"]) / env["temperature"]
            lp = lp + P.lnprior(x)
        if external_loglike is not None:
            lp = lp + external_loglike(x_phys)
        return torch.where(torch.isnan(lp), torch.full_like(lp, -torch.inf), lp)

    def log_prob(x: torch.Tensor) -> torch.Tensor:
        return _pure(x, env)

    log_prob._pure = _pure
    log_prob._env = env
    return log_prob


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _index(tree, k: int):
    if isinstance(tree, dict):
        return {key: _index(v, k) for key, v in tree.items()}
    return tree[k]
