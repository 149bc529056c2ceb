"""Ensemble slice sampler (zeus-style differential slice move), PyTorch.

Counterpart of ``linna_tpu/samplers/slicemove.py``.  The Karamanis &
Beutler (2020) ensemble slice move runs over a whole half-ensemble at once:
directions come from the differential move ``mu * (x_l - x_m)`` with two
distinct walkers of the complementary half; the stepping-out and shrink
loops evaluate the batched likelihood for every walker of the half and
freeze finished walkers by masks.

As in the JAX package:
- the ensemble is carried as ``(2, W/2, D)``;
- the step-fixed draws (partner indices ``l`` and ``m = (l + off) % half``,
  slice-height exponentials, initial-interval uniforms) are drawn for the
  whole chunk before the step loop; only the shrink loop's uniforms, whose
  count depends on the data, are drawn inside it;
- stepping out evaluates both interval ends in one stacked ``(2*half, D)``
  batch per iteration;
- walkers that exhaust ``max_steps`` keep their position.

The JAX ``while_loop``s are Python loops here, with one host
synchronisation per iteration for the loop condition.  The draws come from
one ``torch.Generator`` on the sampling device; they are not JAX's bits.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Union

import torch

__all__ = ["SliceState", "init_slice_state", "slice_chunk", "tune_mu"]


class SliceState(NamedTuple):
    coords: torch.Tensor  # f32[W, D]
    log_prob: torch.Tensor  # f32[W]
    rng: torch.Generator
    mu: torch.Tensor  # f32[] tunable scale
    n_expand: torch.Tensor  # i32[] cumulative expansion count
    n_contract: torch.Tensor  # i32[] cumulative contraction count


@torch.no_grad()
def init_slice_state(
    rng: torch.Generator,
    x0: torch.Tensor,
    log_prob_fn: Callable[[torch.Tensor], torch.Tensor],
    mu: float = 1.0,
) -> SliceState:
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=rng.device)
    if x0.shape[0] % 2:
        raise ValueError(f"nwalkers must be even for the slice move (got {x0.shape[0]})")
    zero = torch.zeros((), dtype=torch.int32, device=x0.device)
    return SliceState(
        x0,
        log_prob_fn(x0),
        rng,
        torch.tensor(mu, dtype=torch.float32, device=x0.device),
        zero,
        zero.clone(),
    )


ShrinkDraws = Union[torch.Tensor, Callable[[int], torch.Tensor]]


def _slice_half(
    log_prob_fn, max_steps: int, active_x, active_lp, comp_x, mu,
    l, m, expo, u0, shrink_u: ShrinkDraws,
):
    """One slice update of the active half-ensemble given this step's draws:
    partner indices ``l``/``m``, slice-height exponentials ``expo``,
    initial-interval uniforms ``u0``, and the shrink loop's uniforms
    ``shrink_u`` — a ``(max_steps, n_active)`` tensor or a callable giving
    the ``(n_active,)`` draw of loop iteration ``it``.

    Returns (new_x, new_lp, n_expand, n_contract)."""
    n_active = active_x.shape[0]
    direction = mu * (comp_x[l] - comp_x[m])  # [n_active, D]
    y = active_lp - expo  # log slice height
    left = -u0
    right = left + 1.0

    # stepping-out: both ends ride one stacked batch per iteration
    x2 = torch.cat([active_x, active_x])
    d2 = torch.cat([direction, direction])
    need_l = torch.ones(n_active, dtype=torch.bool, device=active_x.device)
    need_r = need_l
    n_expand = torch.zeros((), dtype=torch.int32, device=active_x.device)
    it = 0
    while it < max_steps and bool(torch.any(need_l | need_r)):
        t_both = torch.cat([left, right])
        lp_both = log_prob_fn(x2 + t_both[:, None] * d2)
        need_l = need_l & (lp_both[:n_active] > y)
        need_r = need_r & (lp_both[n_active:] > y)
        left = torch.where(need_l, left - 1.0, left)
        right = torch.where(need_r, right + 1.0, right)
        n_expand = n_expand + need_l.sum(dtype=torch.int32) + need_r.sum(dtype=torch.int32)
        it += 1

    # shrinking: t ~ U(L, R) until inside the slice
    t_acc = torch.zeros_like(active_lp)
    lp_acc = active_lp
    done = torch.zeros(n_active, dtype=torch.bool, device=active_x.device)
    n_contract = torch.zeros((), dtype=torch.int32, device=active_x.device)
    it = 0
    while it < max_steps and not bool(torch.all(done)):
        u = shrink_u(it) if callable(shrink_u) else shrink_u[it]
        t = left + (right - left) * u
        lp_t = log_prob_fn(active_x + t[:, None] * direction)
        inside = lp_t > y
        accept_now = inside & ~done
        t_acc = torch.where(accept_now, t, t_acc)
        lp_acc = torch.where(accept_now, lp_t, lp_acc)
        reject = ~inside & ~done
        left = torch.where(reject & (t < 0), t, left)
        right = torch.where(reject & (t >= 0), t, right)
        n_contract = n_contract + reject.sum(dtype=torch.int32)
        done = done | accept_now
        it += 1
    new_x = active_x + torch.where(done, t_acc, torch.zeros_like(t_acc))[:, None] * direction
    new_lp = torch.where(done, lp_acc, active_lp)
    return new_x, new_lp, n_expand, n_contract


@torch.no_grad()
def slice_chunk(
    log_prob_fn: Callable[[torch.Tensor], torch.Tensor],
    state: SliceState,
    nsteps: int,
    max_steps: int = 100,
):
    """Advance ``nsteps`` ensemble-slice steps; returns
    (state, chain f32[nsteps, W, D], log_probs f32[nsteps, W])."""
    coords, lp, g, mu, n_expand, n_contract = state
    w, ndim = coords.shape
    half = w // 2
    dev = coords.device
    c2 = coords.reshape(2, half, ndim)
    lp2 = lp.reshape(2, half)

    shape = (nsteps, 2, half)
    ls = torch.randint(0, half, shape, generator=g, device=dev)
    offs = torch.randint(1, half, shape, generator=g, device=dev)
    ms = (ls + offs) % half
    expos = torch.empty(shape, device=dev).exponential_(generator=g)
    u0s = torch.rand(shape, generator=g, device=dev)

    def shrink_u(it: int) -> torch.Tensor:
        return torch.rand(half, generator=g, device=dev)

    chain = torch.empty((nsteps, w, ndim), dtype=torch.float32, device=dev)
    lps = torch.empty((nsteps, w), dtype=torch.float32, device=dev)
    for s in range(nsteps):
        nx0, nlp0, ne0, nc0 = _slice_half(
            log_prob_fn, max_steps, c2[0], lp2[0], c2[1], mu,
            ls[s, 0], ms[s, 0], expos[s, 0], u0s[s, 0], shrink_u,
        )
        nx1, nlp1, ne1, nc1 = _slice_half(
            log_prob_fn, max_steps, c2[1], lp2[1], nx0, mu,
            ls[s, 1], ms[s, 1], expos[s, 1], u0s[s, 1], shrink_u,
        )
        c2 = torch.stack([nx0, nx1])
        lp2 = torch.stack([nlp0, nlp1])
        chain[s] = c2.reshape(w, ndim)
        lps[s] = lp2.reshape(w)
        n_expand = n_expand + ne0 + ne1
        n_contract = n_contract + nc0 + nc1
    new_state = SliceState(c2.reshape(w, ndim), lp2.reshape(w), g, mu, n_expand, n_contract)
    return new_state, chain, lps


def tune_mu(state: SliceState) -> SliceState:
    """zeus step-size adaptation between chunks: mu *= 2 Ne/(Ne+Nc),
    clipped to [1e-4, 1e4]."""
    ne = state.n_expand.to(torch.float32)
    nc = state.n_contract.to(torch.float32)
    factor = 2.0 * ne / torch.clamp(ne + nc, min=1.0)
    new_mu = torch.clamp(state.mu * torch.clamp(factor, min=1e-3), 1e-4, 1e4)
    zero = torch.zeros_like(state.n_expand)
    return state._replace(mu=new_mu, n_expand=zero, n_contract=zero.clone())
