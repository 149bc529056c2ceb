"""MAP + Hessian-eigenbasis preconditioning for the gradient samplers
(PyTorch).

Counterpart of ``linna_tpu/samplers/precondition.py``: find the MAP
(scipy's Nelder-Mead, then BFGS with the autograd gradient, in the JAX
package's order and options), take the Hessian there, and reparameterize the
sampling space by the curvature eigenbasis, so that HMC and NUTS run in an
approximately unit-mass space.  Walker starts are drawn ~ N(0, 1) in that
space.

The Hessian is ``torch.func.hessian`` of one row at the MAP in float32; it
is symmetrized and decomposed with ``eigh`` in float64.  For a K-member
ensemble likelihood it is the Hessian of the members' mean chi^2
(``ensemble_k_std`` set to 0), where the JAX package takes the ensemble's
mean + std: the MAP search often ends on the kink between two members'
chi^2, and the std's second derivatives there are f32 rounding noise that
can hand NUTS a direction of negative curvature (unit scale) and a tiny
step.  The MAP search and the sampled posterior stay the reference's.  It always goes
through the likelihood's plain composition: the CUDA kernels'
``autograd.Function``s have no forward-mode or vmap rule, so ``torch.func``
cannot trace them (the composition's kernel route steps aside under a
``torch.func`` transform).  The MAP search itself calls the likelihood as
the sampler does (its BFGS gradient through a kernel where the likelihood
has one).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

__all__ = ["Preconditioner", "calc_hess_mass_mat"]


def _env_device(log_prob_fn, device: DeviceLike) -> torch.device:
    """The device of the likelihood's env tensors, else ``device``."""
    env = getattr(log_prob_fn, "_env", None)
    data = env.get("data") if isinstance(env, dict) else None
    if torch.is_tensor(data):
        return data.device
    return resolve_device(device)


class Preconditioner(NamedTuple):
    """Affine reparameterization y = sqrt(s) * U^T (x - center)."""

    center: np.ndarray  # f64[D] MAP point (whitened space)
    basis: np.ndarray  # f64[D, D] eigenbasis U (columns)
    scales: np.ndarray  # f64[D] sqrt of clipped Hessian eigenvalues

    def to_sampling(self, x: np.ndarray) -> np.ndarray:
        return (np.asarray(x) - self.center) @ self.basis * self.scales

    def to_original(self, y: np.ndarray) -> np.ndarray:
        return self.center + (np.asarray(y) / self.scales) @ self.basis.T

    def wrap_log_prob(self, log_prob_fn: Callable, device: DeviceLike = None) -> Callable:
        """The batched log-prob in the preconditioned space, on the device of
        the likelihood's env (else ``device``)."""
        dev = _env_device(log_prob_fn, device)
        f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)
        center, basis, inv_scales = f32(self.center), f32(self.basis), f32(1.0 / self.scales)

        def wrapped(y):
            return log_prob_fn(center + (y * inv_scales) @ basis.T)

        return wrapped

    def draw_x0(self, rng: np.random.Generator, nwalkers: int) -> np.ndarray:
        """Walker starts in sampling space ~ N(0, 1) per coordinate."""
        return rng.standard_normal((nwalkers, len(self.center))).astype(np.float32)


def calc_hess_mass_mat(
    log_prob_fn: Callable,
    x0: np.ndarray,
    maxiter: int = 10_000,
    gtol: float = 1.0,
    eig_floor: float = 1e-6,
    device: DeviceLike = None,
) -> Preconditioner:
    """MAP search from ``x0`` and the Hessian's eigendecomposition there.
    The likelihood's tensors set the device (``device`` when it has none).
    ``log_prob_fn._plain_pure``, where the likelihood has one (the kernel's
    plain composition), gives the Hessian, with the ensemble's std term
    left out (see the module docstring)."""
    from scipy import optimize

    dev = _env_device(log_prob_fn, device)
    x0 = np.asarray(x0, dtype=np.float64).reshape(-1)
    ndim = x0.size

    def row(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev).reshape(1, ndim)

    def f(x) -> float:
        with torch.no_grad():
            return -float(log_prob_fn(row(x))[0])

    def g(x) -> np.ndarray:
        xx = row(x).requires_grad_(True)
        (grad,) = torch.autograd.grad(-log_prob_fn(xx)[0], xx)
        return grad[0].double().cpu().numpy()

    # Nelder-Mead warm start, then a gradient polish (the reference's order)
    res = optimize.minimize(f, x0, method="Nelder-Mead",
                            options={"maxiter": min(maxiter, 200 * ndim)})
    res = optimize.minimize(f, res.x, jac=g, method="BFGS",
                            options={"maxiter": maxiter, "gtol": gtol})
    center = np.asarray(res.x, dtype=np.float64)

    plain = getattr(log_prob_fn, "_plain_pure", None) or getattr(log_prob_fn, "_pure", None)
    if plain is not None:
        env = log_prob_fn._env
        if "k_std" in env:
            # an ensemble's chi^2_eff = mean + k_std * std is the larger
            # member's at K=2, and the MAP often sits on the kink c_1 = c_2,
            # where the std's f32 second derivatives are rounding noise of
            # size |grad(c_1 - c_2)|^2 / |c_1 - c_2|: the members' mean
            # chi^2 gives the curvature
            env = {**env, "k_std": torch.zeros_like(env["k_std"])}
        single = lambda x: -plain(x[None, :], env)[0]
    else:
        single = lambda x: -log_prob_fn(x[None, :])[0]
    hess = torch.func.hessian(single)(row(center)[0])
    hess = hess.detach().double().cpu().numpy()
    hess = 0.5 * (hess + hess.T)
    eigval, eigvec = np.linalg.eigh(hess)
    # directions with non-positive curvature get unit scale
    floor = max(eig_floor, eig_floor * np.max(np.abs(eigval)))
    eigval = np.where(eigval <= floor, 1.0, eigval)
    return Preconditioner(center, eigvec, np.sqrt(eigval))
