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

Walker-sharded over ranks (``shard``, a
:class:`linna_tpu_torch.parallel.mesh.WalkerShard`), a chunk advances this
rank's block of each half-ensemble; the complementary half is gathered
whole once per half-update (two all-gathers a step, the chunk's only
collectives, as ``shard_over_walkers`` gives the JAX package).  The draws
are taken for the whole ensemble from the same generator on every rank and
cut to the block, so the chain is one rank's chain, bit for bit wherever
the likelihood's value for a row does not depend on the rows beside it:
through ``fused_log_prob`` it does not (the kernel's sums follow the
model's width, not the launch's rows); the plain composition's cuBLAS
products may sum in another order at another row count.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

__all__ = ["EnsembleState", "init_state", "stretch_chunk", "stretch_steps"]


class EnsembleState(NamedTuple):
    coords: torch.Tensor  # f32[W, D] (this rank's walkers when sharded)
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
def stretch_steps(log_prob_fn, a: float, carry, xs, gather: Optional[Callable] = None):
    """The chunk's steps on the ``(2, W/2, ...)`` carry ``(coords, log_prob,
    accepted)`` with the draws ``xs = (partners, us, ln_u_acc)``, each
    ``(nsteps, 2, W/2)``.  Returns ``(carry, (chain, log_probs))`` with the
    chain ``(nsteps, 2, W/2, D)``: the JAX package's ``_stretch_scan``.
    With ``gather`` (walker-sharded: W/2 is this rank's block, the partner
    indices index the whole half) the complementary half is gathered whole
    before each half-update."""
    c2, lp2, acc2 = carry
    partners, us, ln_u_acc = xs
    nsteps = partners.shape[0]
    chain = torch.empty((nsteps,) + tuple(c2.shape), dtype=c2.dtype, device=c2.device)
    lps = torch.empty((nsteps,) + tuple(lp2.shape), dtype=lp2.dtype, device=lp2.device)
    for s in range(nsteps):
        c2, lp2, acc2 = stretch_step(log_prob_fn, a, c2, lp2, acc2, partners[s], us[s],
                                     ln_u_acc[s], gather)
        chain[s] = c2
        lps[s] = lp2
    return (c2, lp2, acc2), (chain, lps)


def stretch_step(log_prob_fn, a: float, c2, lp2, acc2, prt, u, ua, gather=None):
    """One step, both half-updates, on the ``(2, W/2, ...)`` carry with
    this step's draws (each ``(2, W/2)``); returns the new carry."""
    gather = (lambda x: x) if gather is None else gather
    ndim = c2.shape[-1]
    nx0, nlp0, a0 = _half_update(log_prob_fn, a, ndim, c2[0], lp2[0], gather(c2[1]), prt[0],
                                 u[0], ua[0])
    nx1, nlp1, a1 = _half_update(log_prob_fn, a, ndim, c2[1], lp2[1], gather(nx0), prt[1],
                                 u[1], ua[1])
    return (torch.stack([nx0, nx1]), torch.stack([nlp0, nlp1]),
            acc2 + torch.stack([a0, a1]).to(torch.int32))


def chunk_draws(g: torch.Generator, nsteps: int, half: int, device):
    """A chunk's draws, each ``(nsteps, 2, half)``: partner indices,
    z-uniforms and log accept-uniforms, one batched draw per stream."""
    shape = (nsteps, 2, half)
    partners = torch.randint(0, half, shape, generator=g, device=device)
    us = torch.rand(shape, generator=g, device=device)
    return partners, us, torch.log(torch.rand(shape, generator=g, device=device))


@torch.no_grad()
def stretch_chunk(
    log_prob_fn: Callable[[torch.Tensor], torch.Tensor],
    state: EnsembleState,
    nsteps: int,
    a: float = 2.0,
    shard=None,
):
    """Advance ``nsteps`` stretch-move steps; returns (state, chain
    f32[nsteps, W, D], log_probs f32[nsteps, W]), W this rank's walkers
    when ``shard`` is given."""
    coords, lp, g, accepted = state
    w, ndim = coords.shape
    half = w // 2 if shard is None else shard.half
    if shard is not None and w != shard.local:
        raise ValueError(f"{w} walkers on this rank; the walker shard holds {shard.local}")
    dev = coords.device
    # one batched draw per random stream for the whole chunk (the whole
    # ensemble's, cut to this rank's block when sharded)
    xs = chunk_draws(g, nsteps, half, dev)
    gather = None
    if shard is not None:
        xs = tuple(t[..., shard.block] for t in xs)
        gather = shard.gather_half
    hl = w // 2
    carry = (coords.reshape(2, hl, ndim), lp.reshape(2, hl), accepted.reshape(2, hl))
    (c2, lp2, acc2), (chain2, lps2) = stretch_steps(log_prob_fn, a, carry, xs, gather)
    new_state = EnsembleState(c2.reshape(w, ndim), lp2.reshape(w), g, acc2.reshape(w))
    return new_state, chain2.reshape(nsteps, w, ndim), lps2.reshape(nsteps, w)
