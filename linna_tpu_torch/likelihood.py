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

__all__ = ["gaussian_loglike", "make_log_prob", "make_grad_log_prob", "make_hessian_log_prob"]


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

    The plain Gaussian configuration in float32 (K members or one, no
    custom or external likelihood, no linearmodel, no ``out_cut``, no
    ``compute_dtype``, no linear bypass) takes its value and its gradient
    from one CUDA kernel (:mod:`linna_tpu_torch.ops.composition`) when a
    call asks autograd for a gradient on a card: the input on CUDA and
    requiring a gradient in grad mode, no env tensor requiring one, no
    ``torch.func`` transform tracing the call, the log-prob's own env.
    Every other call (value-only calls, the Hessian's ``torch.func``
    trace) runs the composition as written here.

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
        # biases stacked (K, 1, out), so they broadcast over the rows
        params = _stack([_to(p, device) for p in params])
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

    # The Gaussian composition's value and input gradient from one kernel
    # (ops/composition.py), for the calls that ask autograd for a gradient
    # on a card; every other call, and every other configuration, runs the
    # composition below.
    route = None
    if (
        loglike_fn is None
        and external_loglike is None
        and linearmodel is None
        and out_cut is None
        and cdtype is None
        and not spec.linear_bypass
    ):
        from .ops import composition as CG, fused as F

        members = len(params["layer1"]["w"]) if is_ensemble else 1
        if CG.supports(F.kernel_dims(spec), members):
            route = CG.GradRoute(spec, env, members, transforms.y_transform.ypositive,
                                 lambda x_in: _chi2(_prediction(x_in, env) - env["data"],
                                                    env["inv_cov"]))

    def _prediction(x_in: torch.Tensor, env) -> torch.Tensor:
        """The data-space prediction at ``x_in``: (K, ..., out) for an
        ensemble."""
        tset = env["transforms"]
        if is_ensemble:
            # every member in one pass over the stacked (K, in, out) weights;
            # the pre-model depends on x_in alone: one evaluation added under
            # every member (apply_model ignores it for a linear_bypass spec)
            lead = x_in.shape[:-1]
            pred = N.apply_model(spec, env["params"], x_in.reshape(-1, x_in.shape[-1])).float()
            pred = pred.reshape(pred.shape[0], *lead, pred.shape[-1])  # (K, ..., out)
            if linearmodel is not None and not spec.linear_bypass:
                pred = pred + linearmodel(x_in)
        else:
            pred = N.apply_model(spec, env["params"], x_in, linearmodel=linearmodel).float()
        m = tset.y_data.inverse(tset.y_transform(pred))
        return m if out_cut is None else m[..., :out_cut]

    def _pure(x: torch.Tensor, env) -> torch.Tensor:
        tset = env["transforms"]
        x = torch.as_tensor(x, dtype=torch.float32, device=env["data"].device)
        x_phys = P.transform(env["priors"], x)
        x_in = tset.x_transform(x_phys)
        if route is not None and env is route.env and route.engages(x_in):
            lp = route(x_in) + P.lnprior(x)
            return torch.where(torch.isnan(lp), torch.full_like(lp, -torch.inf), lp)
        if cdtype is not None:
            x_in = x_in.to(cdtype)
        m = _prediction(x_in, env)
        if is_ensemble:
            chi2 = _chi2(m - env["data"], env["inv_cov"])  # (K, ...)
            eff = chi2.mean(dim=0) + env["k_std"] * chi2.std(dim=0, correction=0)
            lp = -0.5 * eff / env["temperature"] + P.lnprior(x)
        else:
            lp = like(m, env["data"], env["inv_cov"]) / env["temperature"]
            lp = lp + P.lnprior(x)
        if external_loglike is not None:
            lp = lp + external_loglike(x_phys)
        return torch.where(torch.isnan(lp), torch.full_like(lp, -torch.inf), lp)

    def log_prob(x: torch.Tensor) -> torch.Tensor:
        return _pure(x, env)

    log_prob._pure = _pure
    log_prob._env = env
    # the kernel's side (ops/composition.py), or None where the
    # configuration keeps the composition for every call
    log_prob._route = route
    return log_prob


def make_grad_log_prob(log_prob: Callable) -> Callable:
    """Batched gradient (W, D) -> (W, D), each walker's own: autograd of the
    summed log-probs (the rows are independent).  A likelihood on the fused
    route runs the kernel forward and its plain backward
    (:class:`linna_tpu_torch.ops.fused._FusedLogProb`).  A row whose
    log-prob is -inf gets a zero gradient, as JAX's gives it there: the
    gradient samplers' :func:`linna_tpu_torch.samplers.hmc.value_and_grad`."""
    from .samplers.hmc import value_and_grad

    def grad(x: torch.Tensor) -> torch.Tensor:
        return value_and_grad(log_prob, torch.as_tensor(x, dtype=torch.float32))[1]

    return grad


def make_hessian_log_prob(log_prob: Callable) -> Callable:
    """Batched Hessian (W, D) -> (W, D, D): ``torch.func.hessian`` of one
    row, vmapped over the walkers; zero on a row whose log-prob is -inf, as
    JAX's is there.

    The fused likelihood (``use_fused=True``, or
    :func:`linna_tpu_torch.ops.fused.fused_log_prob`) is refused with a
    TypeError, as the JAX package refuses it: JAX's kernel is a
    ``custom_vjp``, which forward-mode differentiation rejects, and the
    port's kernel is an ``autograd.Function`` with no forward-mode rule.
    Nothing here swaps the plain composition in for the kernel; take the
    Hessian of ``make_log_prob(..., use_fused=False)``."""
    if getattr(log_prob, "_plain_pure", None) is not None:
        raise TypeError(
            "make_hessian_log_prob: this log-prob runs the fused_log_prob kernel, whose "
            "autograd.Function has no forward-mode rule (the JAX package's custom_vjp "
            "kernel refuses jvp the same way); build the likelihood with use_fused=False "
            "for a Hessian"
        )

    def single(x: torch.Tensor) -> torch.Tensor:
        return log_prob(x[None, :])[0]

    hess = torch.func.vmap(torch.func.hessian(single))

    def hessian(x: torch.Tensor) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32)
        h = hess(x)
        with torch.no_grad():
            finite = torch.isfinite(log_prob(x))[:, None, None]
        return torch.where(finite, h, torch.zeros_like(h))

    return hessian


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    stacked = torch.stack(trees)
    return stacked[:, None] if stacked.dim() == 2 else stacked
