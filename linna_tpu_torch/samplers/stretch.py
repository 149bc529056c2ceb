"""Affine-invariant ensemble "stretch" move (emcee), PyTorch.

Counterpart of ``linna_tpu/samplers/stretch.py``.  One chunk advances the
whole ensemble ``nsteps`` steps; each step updates the two Goodman-Weare
half-ensembles in turn, with the complementary half as the pool of stretch
partners and the batched likelihood evaluated for every walker of the half
at once.

Proposal: z ~ g(z) ∝ 1/sqrt(z) on [1/a, a] via z = ((a-1)u + 1)^2 / a;
accept with ln q = (D-1) ln z + logp(y) - logp(x) (Goodman & Weare 2010, as
in emcee's StretchMove).

As in the JAX package, a chunk draws all of its randoms first, in three
batched draws (partner indices, z-uniforms, log accept-uniforms), and the
ensemble is carried as ``(2, W/2, D)``.  :func:`stretch_steps` takes those
draws as arguments, so the same draws can be fed to both packages.  The
draws come from one ``torch.Generator`` on the sampling device; they are not
JAX's bits.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

__all__ = ["EnsembleState", "init_state", "stretch_chunk", "stretch_steps"]


class EnsembleState(NamedTuple):
    coords: torch.Tensor  # f32[W, D]
    log_prob: torch.Tensor  # f32[W]
    rng: torch.Generator
    accepted: torch.Tensor  # i32[W] cumulative acceptance counts


@torch.no_grad()
def init_state(
    rng: torch.Generator, x0, log_prob_fn: Callable[[torch.Tensor], torch.Tensor]
) -> EnsembleState:
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=rng.device)
    if x0.shape[0] % 2:
        # emcee's RedBlueMove contract; the (2, W/2, D) layout relies on it
        raise ValueError(f"nwalkers must be even for the stretch move (got {x0.shape[0]})")
    return EnsembleState(
        x0, log_prob_fn(x0), rng, torch.zeros(x0.shape[0], dtype=torch.int32, device=x0.device)
    )


def _half_update(
    log_prob_fn, a: float, ndim: int, active_x, active_lp, comp_x, prt, u, u_acc
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Update one half-ensemble given the complementary half and this step's
    pre-drawn randoms (partner indices, z-uniforms, log accept-uniforms)."""
    z = ((a - 1.0) * u + 1.0) ** 2 / a
    partner_x = comp_x[prt]
    proposal = partner_x + z[:, None] * (active_x - partner_x)
    prop_lp = log_prob_fn(proposal)
    ln_accept = (ndim - 1.0) * torch.log(z) + prop_lp - active_lp
    accept = u_acc < ln_accept
    new_x = torch.where(accept[:, None], proposal, active_x)
    new_lp = torch.where(accept, prop_lp, active_lp)
    return new_x, new_lp, accept


@torch.no_grad()
def stretch_steps(log_prob_fn, a: float, carry, xs):
    """The chunk's steps on the ``(2, W/2, ...)`` carry ``(coords, log_prob,
    accepted)`` with the draws ``xs = (partners, us, ln_u_acc)``, each
    ``(nsteps, 2, W/2)``.  Returns ``(carry, (chain, log_probs))`` with the
    chain ``(nsteps, 2, W/2, D)``: the JAX package's ``_stretch_scan`` on
    one device."""
    c2, lp2, acc2 = carry
    partners, us, ln_u_acc = xs
    nsteps, ndim = partners.shape[0], c2.shape[-1]
    chain = torch.empty((nsteps,) + tuple(c2.shape), dtype=c2.dtype, device=c2.device)
    lps = torch.empty((nsteps,) + tuple(lp2.shape), dtype=lp2.dtype, device=lp2.device)
    for s in range(nsteps):
        prt, u, ua = partners[s], us[s], ln_u_acc[s]
        nx0, nlp0, a0 = _half_update(log_prob_fn, a, ndim, c2[0], lp2[0], c2[1], prt[0], u[0], ua[0])
        nx1, nlp1, a1 = _half_update(log_prob_fn, a, ndim, c2[1], lp2[1], nx0, prt[1], u[1], ua[1])
        c2 = torch.stack([nx0, nx1])
        lp2 = torch.stack([nlp0, nlp1])
        acc2 = acc2 + torch.stack([a0, a1]).to(torch.int32)
        chain[s] = c2
        lps[s] = lp2
    return (c2, lp2, acc2), (chain, lps)


@torch.no_grad()
def stretch_chunk(
    log_prob_fn: Callable[[torch.Tensor], torch.Tensor],
    state: EnsembleState,
    nsteps: int,
    a: float = 2.0,
):
    """Advance ``nsteps`` stretch-move steps; returns (state, chain
    f32[nsteps, W, D], log_probs f32[nsteps, W])."""
    coords, lp, g, accepted = state
    w, ndim = coords.shape
    half = w // 2
    dev = coords.device
    shape = (nsteps, 2, half)
    # one batched draw per random stream for the whole chunk
    partners = torch.randint(0, half, shape, generator=g, device=dev)
    us = torch.rand(shape, generator=g, device=dev)
    ln_u_acc = torch.log(torch.rand(shape, generator=g, device=dev))
    carry = (coords.reshape(2, half, ndim), lp.reshape(2, half), accepted.reshape(2, half))
    (c2, lp2, acc2), (chain2, lps2) = stretch_steps(log_prob_fn, a, carry, (partners, us, ln_u_acc))
    new_state = EnsembleState(c2.reshape(w, ndim), lp2.reshape(w), g, acc2.reshape(w))
    return new_state, chain2.reshape(nsteps, w, ndim), lps2.reshape(nsteps, w)
