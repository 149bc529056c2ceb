"""Prior specification and whitened-parameter transforms (PyTorch).

Counterpart of ``linna_tpu/priors.py``: MCMC runs in a whitened space in
which every prior is an independent unit normal.  ``transform`` maps
whitened walker positions to physical parameters (Gaussian prior:
``x * sigma + mu``; flat prior: ``Phi(x) * (hi - lo) + lo``), batched over
leading axes, on whatever device the tensors live on.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .device import DeviceLike, resolve_device

__all__ = [
    "PriorPack",
    "priors_from_list",
    "pack_from_numpy",
    "gauss2unif",
    "invgauss2unif",
    "transform",
    "transform_np",
    "inv_transform",
    "lnprior",
    "log_prior_physical",
    "prior_range",
]

_SQRT2 = math.sqrt(2.0)


class PriorPack(NamedTuple):
    """Struct-of-arrays priors: ``is_gauss[i]`` selects a Gaussian prior
    (``arg1`` mean, ``arg2`` sigma) or a flat one (``arg1`` lower, ``arg2``
    upper) for parameter ``i``."""

    is_gauss: torch.Tensor  # bool[D]
    arg1: torch.Tensor  # f32[D]
    arg2: torch.Tensor  # f32[D]

    @property
    def ndim(self) -> int:
        return self.arg1.shape[0]

    def to(self, device) -> "PriorPack":
        return PriorPack(*(t.to(device) for t in self))


def _pack(is_gauss, arg1, arg2, device) -> PriorPack:
    return PriorPack(
        torch.as_tensor(np.asarray(is_gauss, dtype=bool), device=device),
        torch.as_tensor(np.asarray(arg1, dtype=np.float32), device=device),
        torch.as_tensor(np.asarray(arg2, dtype=np.float32), device=device),
    )


def priors_from_list(priors: Sequence[dict], device: DeviceLike = None) -> PriorPack:
    """Build a :class:`PriorPack` from the list-of-dicts form
    ``{'dist': 'flat'|'gauss', 'arg1': float, 'arg2': float}``."""
    for p in priors:
        if p["dist"] not in ("gauss", "flat"):
            raise NotImplementedError(f"prior dist {p['dist']!r} not supported")
    return _pack(
        [p["dist"] == "gauss" for p in priors],
        [p["arg1"] for p in priors],
        [p["arg2"] for p in priors],
        resolve_device(device),
    )


def pack_from_numpy(pack, device: DeviceLike = None) -> PriorPack:
    """Carry a prior pack across from its array form: any object with
    ``is_gauss``/``arg1``/``arg2`` array attributes (for example the JAX
    package's ``PriorPack`` after ``jax.device_get``)."""
    return _pack(pack.is_gauss, pack.arg1, pack.arg2, resolve_device(device))


def gauss2unif(x: torch.Tensor) -> torch.Tensor:
    """N(0,1)-distributed -> U(0,1)-distributed."""
    return 0.5 * (1.0 + torch.special.erf(x / _SQRT2))


def invgauss2unif(u: torch.Tensor) -> torch.Tensor:
    """U(0,1)-distributed -> N(0,1)-distributed."""
    return _SQRT2 * torch.special.erfinv(2.0 * u - 1.0)


def transform(pack: PriorPack, x: torch.Tensor) -> torch.Tensor:
    """Whitened -> physical parameters, batched over leading axes."""
    gauss = x * pack.arg2 + pack.arg1
    flat = gauss2unif(x) * (pack.arg2 - pack.arg1) + pack.arg1
    return torch.where(pack.is_gauss, gauss, flat)


def transform_np(pack: PriorPack, x: np.ndarray) -> np.ndarray:
    """Host-side float64 twin of :func:`transform`, applied to every
    persisted chain chunk (the chunk is already on the host)."""
    from scipy.special import ndtr

    x = np.asarray(x, dtype=np.float64)
    is_gauss = pack.is_gauss.cpu().numpy()
    arg1 = pack.arg1.cpu().numpy().astype(np.float64)
    arg2 = pack.arg2.cpu().numpy().astype(np.float64)
    gauss = x * arg2 + arg1
    flat = ndtr(x) * (arg2 - arg1) + arg1
    return np.where(is_gauss, gauss, flat)


def inv_transform(pack: PriorPack, x: torch.Tensor) -> torch.Tensor:
    """Physical -> whitened parameters."""
    gauss = (x - pack.arg1) / pack.arg2
    flat = invgauss2unif((x - pack.arg1) / (pack.arg2 - pack.arg1))
    return torch.where(pack.is_gauss, gauss, flat)


def lnprior(x: torch.Tensor) -> torch.Tensor:
    """Whitened-space log-prior, exactly unit normal: ``-0.5 * sum(x^2)``
    over the last axis."""
    return -0.5 * torch.sum(torch.square(x), dim=-1)


def log_prior_physical(pack: PriorPack, x: torch.Tensor) -> torch.Tensor:
    """Physical-space log-prior, the importance weights' prior: a flat box
    adds -inf outside its bounds, a Gaussian ``-0.5 ((x-mu)/sigma)^2``;
    summed over the last axis."""
    gauss_term = -0.5 * torch.square((x - pack.arg1) / pack.arg2)
    inside = (x >= pack.arg1) & (x <= pack.arg2)
    flat_term = torch.where(inside, torch.zeros_like(x), torch.full_like(x, -torch.inf))
    return torch.sum(torch.where(pack.is_gauss, gauss_term, flat_term), dim=-1)


def prior_range(pack: PriorPack) -> np.ndarray:
    """[D, 2] sampling box: flat priors use their bounds, Gaussian priors
    mu +/- 5 sigma."""
    is_gauss = pack.is_gauss.cpu().numpy()
    arg1 = pack.arg1.cpu().numpy().astype(np.float64)
    arg2 = pack.arg2.cpu().numpy().astype(np.float64)
    lo = np.where(is_gauss, arg1 - 5.0 * arg2, arg1)
    hi = np.where(is_gauss, arg1 + 5.0 * arg2, arg2)
    return np.stack([lo, hi], axis=1)
