"""Gradient samplers: HMC and NUTS, walker-batched (PyTorch).

Counterpart of ``linna_tpu/samplers/hmc.py``.  Every walker advances at
once: a leapfrog is one batched likelihood call over the whole ensemble
followed by one backward pass, and the per-walker gradients come from
``torch.autograd.grad(lp.sum(), x)``.  Rows are independent, so that is
each walker's own gradient: what the JAX package gets from
``vmap(value_and_grad)``.  It also runs through the likelihood kernels'
``autograd.Function``s: on a card the K-member composition's value and
gradient come from one kernel (``ops.composition``), and the
``fused_log_prob`` kernel's backward recomputes the plain composition
(``ops.fused``).

The NUTS tree is Hoffman & Gelman's Algorithm 3 with the recursion unrolled
over the static ``max_depth``, as in the JAX package: every lane takes all
2^d - 1 leapfrogs of a depth-d subtree, and lanes that stopped are masked.
The masks are (W,) tensors instead of a vmapped single-walker function.
Step sizes are per walker, with dual averaging (gamma 0.05, t0 10, kappa
0.75, target 0.6) for the first ``m_adapt`` samples.

The carried ``grad`` saves one forward and backward per sample.  The draws
come from one ``torch.Generator`` on the sampling device; they are not JAX's
bits.  Functions that the tests feed JAX's draws take them as arguments
(``find_reasonable_epsilon(r0=...)``).

Walker-sharded over ranks (``shard``), each rank advances its block of
walkers with no collective: every move is walker-local.  Every draw has a
fixed size, one value per walker of the ensemble: HMC's momenta and accept
uniforms, and NUTS's too, since its doubling loop runs all ``max_depth``
levels with stopped lanes masked rather than ending when every lane has
stopped.  So each draw is taken for the whole ensemble from the same
generator on every rank and cut to the block, and the sharded HMC and NUTS
chains are the one-rank chains, bit for bit wherever the likelihood's value
and gradient for a row do not depend on the rows beside it.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

__all__ = [
    "HMCState",
    "NUTSState",
    "init_hmc_state",
    "init_nuts_state",
    "hmc_chunk",
    "nuts_chunk",
    "find_reasonable_epsilon",
    "value_and_grad",
]

# dual-averaging constants (the JAX package's hmc.py:45-49)
DA_GAMMA = 0.05
DA_T0 = 10.0
DA_KAPPA = 0.75
DA_DELTA = 0.6
DIVERGENCE = 1000.0  # joint-energy drop treated as divergent (H&G eq. 8)


class HMCState(NamedTuple):
    coords: torch.Tensor  # f32[W, D]
    log_prob: torch.Tensor  # f32[W]
    grad: torch.Tensor  # f32[W, D] d(log_prob)/dx at coords (carried)
    rng: torch.Generator
    epsilon: torch.Tensor  # f32[W] per-walker step size
    accepted: torch.Tensor  # i32[W]


class NUTSState(NamedTuple):
    coords: torch.Tensor  # f32[W, D]
    log_prob: torch.Tensor  # f32[W]
    grad: torch.Tensor  # f32[W, D] (carried)
    rng: torch.Generator
    epsilon: torch.Tensor  # f32[W]
    # dual averaging per walker
    mu: torch.Tensor  # f32[W] log(10 * eps0)
    h_bar: torch.Tensor  # f32[W]
    log_eps_bar: torch.Tensor  # f32[W]
    m: torch.Tensor  # f32[W] adaptation step counter
    m_adapt: torch.Tensor  # i32[] adaptation samples remaining
    accepted: torch.Tensor  # f32[W] cumulative mean alpha (expected acceptances)


def value_and_grad(log_prob_fn: Callable, x: torch.Tensor):
    """(W, D) -> (lp (W,), d lp / dx (W, D)), both detached.

    A walker whose log-prob is not finite gets a zero gradient: its lp is
    -inf, so no move keeps it, and the NaN that a masked branch of the
    likelihood can give (``0 * NaN`` in a backward) stays out of the
    trajectory arithmetic."""
    with torch.enable_grad():
        xx = x.detach().requires_grad_(True)
        lp = log_prob_fn(xx)
        (g,) = torch.autograd.grad(lp.sum(), xx)
    lp = lp.detach()
    return lp, torch.where(torch.isfinite(lp)[:, None], g, torch.zeros_like(g))


class _Draws:
    """Per-walker draws from the ensemble's generator ``g``: taken for the
    whole ensemble and cut to this rank's walkers under ``shard``."""

    def __init__(self, g: torch.Generator, w: int, shard=None):
        self.g, self.shard = g, shard
        self.w = w if shard is None else shard.nwalkers

    def _cut(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.shard is None else self.shard.take(t)

    def normal(self, d: int) -> torch.Tensor:
        return self._cut(torch.randn((self.w, d), generator=self.g, device=self.g.device))

    def uniform(self) -> torch.Tensor:
        return self._cut(torch.rand(self.w, generator=self.g, device=self.g.device))


def _mass(mass, d: int, device):
    m = torch.as_tensor(mass, dtype=torch.float32, device=device).expand(d)
    return 1.0 / m, torch.sqrt(m)


def _leapfrog(log_prob_fn, x, r, grad, eps, inv_mass):
    """One batched leapfrog step with per-walker ``eps`` (W,).
    r ~ N(0, M); K = 0.5 r^T M^-1 r."""
    r_half = r + 0.5 * eps[:, None] * grad
    x_new = x + eps[:, None] * (inv_mass * r_half)
    lp_new, grad_new = value_and_grad(log_prob_fn, x_new)
    r_new = r_half + 0.5 * eps[:, None] * grad_new
    return x_new, r_new, lp_new, grad_new


def _kinetic(r, inv_mass):
    return 0.5 * torch.sum(r * r * inv_mass, dim=-1)


# --------------------------------------------------------------------- HMC


@torch.no_grad()
def find_reasonable_epsilon(
    rng: torch.Generator,
    x0: torch.Tensor,
    log_prob_fn: Callable,
    mass=1.0,
    r0: Optional[torch.Tensor] = None,
    shard=None,
) -> torch.Tensor:
    """Per-walker initial step size (H&G Alg. 4): double or halve eps until
    the one-step acceptance crosses 0.5, at most 100 times.  ``r0``: the
    momenta (W, D) to use instead of drawing them."""
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=rng.device)
    w, d = x0.shape
    inv_mass, sqrt_mass = _mass(mass, d, x0.device)
    lp0, grad0 = value_and_grad(log_prob_fn, x0)
    if r0 is None:
        r0 = _Draws(rng, w, shard).normal(d) * sqrt_mass
    r0 = torch.as_tensor(r0, dtype=torch.float32, device=x0.device)
    joint0 = lp0 - _kinetic(r0, inv_mass)

    def log_ratio(eps):
        r_half = r0 + 0.5 * eps[:, None] * grad0
        x_new = x0 + eps[:, None] * inv_mass * r_half
        lp_new, grad_new = value_and_grad(log_prob_fn, x_new)
        r_new = r_half + 0.5 * eps[:, None] * grad_new
        lp_new = torch.where(torch.isnan(lp_new), -torch.inf, lp_new)
        ratio = lp_new - _kinetic(r_new, inv_mass) - joint0
        return torch.where(torch.isnan(ratio), -torch.inf, ratio)

    eps = torch.ones(w, dtype=torch.float32, device=x0.device)
    ratio = log_ratio(eps)  # eps = 1 sets the direction and is the first test
    a = torch.where(ratio > math.log(0.5), 1.0, -1.0)
    it = torch.zeros(w, dtype=torch.int32, device=x0.device)
    running = torch.ones(w, dtype=torch.bool, device=x0.device)
    while True:
        # a lane that stops keeps its eps, as a vmapped while_loop's does
        running = running & (it < 100) & (a * ratio > -a * math.log(2.0))
        if not bool(running.any()):
            return eps
        eps = torch.where(running, eps * 2.0**a, eps)
        it = it + running.to(torch.int32)
        ratio = log_ratio(eps)


def init_hmc_state(
    rng: torch.Generator,
    x0,
    log_prob_fn: Callable,
    epsilon: Optional[float] = None,
    mass=1.0,
    shard=None,
) -> HMCState:
    """``epsilon=None`` (the default) runs the per-walker reasonable-epsilon
    search with the ``mass`` that the chunks will integrate with."""
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=rng.device)
    lp, grad = value_and_grad(log_prob_fn, x0)
    w = x0.shape[0]
    if epsilon is None:
        eps = find_reasonable_epsilon(rng, x0, log_prob_fn, mass, shard=shard)
    else:
        eps = torch.full((w,), float(epsilon), dtype=torch.float32, device=x0.device)
    return HMCState(x0, lp, grad, rng, eps, torch.zeros(w, dtype=torch.int32, device=x0.device))


@torch.no_grad()
def hmc_chunk(
    log_prob_fn: Callable,
    state: HMCState,
    nsteps: int,
    n_leapfrog: int = 10,
    mass=1.0,
    shard=None,
):
    """Advance ``nsteps`` HMC samples, each ``n_leapfrog`` leapfrog steps and
    a Metropolis test with the kinetic energy; returns (state, chain
    f32[nsteps, W, D], log_probs f32[nsteps, W]), W this rank's walkers
    under ``shard``."""
    coords, lp0, grad0, g, eps, accepted = state
    w, d = coords.shape
    draws = _Draws(g, w, shard)
    inv_mass, sqrt_mass = _mass(mass, d, coords.device)
    chain = torch.empty((nsteps, w, d), dtype=torch.float32, device=coords.device)
    lps = torch.empty((nsteps, w), dtype=torch.float32, device=coords.device)
    for s in range(nsteps):
        coords, lp0, grad0, accepted = hmc_sample(log_prob_fn, n_leapfrog, draws, coords, lp0,
                                                  grad0, eps, accepted, inv_mass, sqrt_mass)
        chain[s] = coords
        lps[s] = lp0
    return HMCState(coords, lp0, grad0, g, eps, accepted), chain, lps


def hmc_sample(log_prob_fn, n_leapfrog: int, draws, coords, lp0, grad0, eps, accepted,
               inv_mass, sqrt_mass):
    """One HMC sample of every walker: ``n_leapfrog`` leapfrogs and the
    Metropolis test; returns (coords, log_prob, grad, accepted)."""
    d = coords.shape[1]
    r0 = draws.normal(d) * sqrt_mass
    x, r, lp, grad = coords, r0, lp0, grad0
    for _ in range(n_leapfrog):
        x, r, lp, grad = _leapfrog(log_prob_fn, x, r, grad, eps, inv_mass)
    log_accept = (lp - _kinetic(r, inv_mass)) - (lp0 - _kinetic(r0, inv_mass))
    accept = torch.log(draws.uniform()) < log_accept
    return (torch.where(accept[:, None], x, coords), torch.where(accept, lp, lp0),
            torch.where(accept[:, None], grad, grad0), accepted + accept.to(torch.int32))


# -------------------------------------------------------------------- NUTS


class _Tree(NamedTuple):
    zm: torch.Tensor
    rm: torch.Tensor
    gm: torch.Tensor
    zp: torch.Tensor
    rp: torch.Tensor
    gp: torch.Tensor
    zprop: torch.Tensor
    lpprop: torch.Tensor
    gprop: torch.Tensor
    n: torch.Tensor  # valid points
    s: torch.Tensor  # bool: keep going
    a: torch.Tensor  # summed alpha
    na: torch.Tensor  # alpha count


def _where(mask, a, b):
    return torch.where(mask[:, None] if a.dim() > 1 else mask, a, b)


def _no_uturn(zm, zp, rm, rp, inv_mass):
    dz = zp - zm
    return (torch.sum(dz * (inv_mass * rm), dim=-1) >= 0.0) & (
        torch.sum(dz * (inv_mass * rp), dim=-1) >= 0.0
    )


def _build_tree(log_prob_fn, z, r, grad, v, depth, eps, joint0, log_slice, draws, inv_mass
                ) -> _Tree:
    """H&G Alg. 3 ``BuildTree`` for every walker at once, the recursion
    unrolled over the Python int ``depth``; ``v`` (W,) is each walker's
    direction, +1 or -1."""
    if depth == 0:
        ve = (v * eps)[:, None]
        r_half = r + 0.5 * ve * grad
        z_new = z + ve * inv_mass * r_half
        lp_new, grad_new = value_and_grad(log_prob_fn, z_new)
        r_new = r_half + 0.5 * ve * grad_new
        lp_new = torch.where(torch.isnan(lp_new), -torch.inf, lp_new)
        joint = lp_new - _kinetic(r_new, inv_mass)
        alpha = torch.clamp(torch.exp(joint - joint0), max=1.0)
        return _Tree(
            z_new, r_new, grad_new, z_new, r_new, grad_new, z_new, lp_new, grad_new,
            (log_slice <= joint).to(torch.float32),
            log_slice < joint + DIVERGENCE,
            torch.where(torch.isnan(alpha), 0.0, alpha),
            torch.ones_like(lp_new),
        )

    t1 = _build_tree(log_prob_fn, z, r, grad, v, depth - 1, eps, joint0, log_slice, draws,
                     inv_mass)
    # the second half starts from the edge in direction v; it is computed for
    # every lane and masked by s1 (stopped lanes keep the first half)
    fwd = v > 0
    t2 = _build_tree(
        log_prob_fn, _where(fwd, t1.zp, t1.zm), _where(fwd, t1.rp, t1.rm),
        _where(fwd, t1.gp, t1.gm), v, depth - 1, eps, joint0, log_slice, draws, inv_mass,
    )
    back, ahead = t1.s & (v < 0), t1.s & fwd
    zm, rm, gm = (_where(back, a, b) for a, b in ((t2.zm, t1.zm), (t2.rm, t1.rm), (t2.gm, t1.gm)))
    zp, rp, gp = (_where(ahead, a, b) for a, b in ((t2.zp, t1.zp), (t2.rp, t1.rp), (t2.gp, t1.gp)))
    n2 = torch.where(t1.s, t2.n, 0.0)
    u = draws.uniform()
    take2 = t1.s & (u < n2 / torch.clamp(t1.n + n2, min=1e-30))
    zprop = _where(take2, t2.zprop, t1.zprop)
    lpprop = torch.where(take2, t2.lpprop, t1.lpprop)
    gprop = _where(take2, t2.gprop, t1.gprop)
    s_out = t1.s & t2.s & _no_uturn(zm, zp, rm, rp, inv_mass)
    return _Tree(
        zm, rm, gm, zp, rp, gp, zprop, lpprop, gprop, t1.n + n2, s_out,
        t1.a + torch.where(t1.s, t2.a, 0.0), t1.na + torch.where(t1.s, t2.na, 0.0),
    )


def _nuts_sample(log_prob_fn, max_depth: int, draws, x, lp, grad, eps, inv_mass, sqrt_mass):
    """One NUTS sample of every walker (H&G Alg. 3's doubling loop, all
    ``max_depth`` levels).  ``grad`` is the carried gradient at ``x``;
    ``draws`` a :class:`_Draws`.  Returns (x', lp', grad', alpha,
    n_alpha)."""
    w, d = x.shape
    dev = x.device
    r0 = draws.normal(d) * sqrt_mass
    joint0 = lp - _kinetic(r0, inv_mass)
    # log of the slice variable u ~ U(0, exp(joint0))
    log_slice = joint0 + torch.log(draws.uniform())
    zm = zp = zprop = x
    rm = rp = r0
    gm = gp = gprop = grad
    lpprop = lp
    n_total = torch.ones(w, device=dev)
    s = torch.ones(w, dtype=torch.bool, device=dev)
    alpha_sum = torch.zeros(w, device=dev)
    n_alpha = torch.zeros(w, device=dev)
    for depth in range(max_depth):
        v = torch.where(draws.uniform() < 0.5, 1.0, -1.0)
        fwd = v > 0
        t = _build_tree(
            log_prob_fn, _where(fwd, zp, zm), _where(fwd, rp, rm), _where(fwd, gp, gm),
            v, depth, eps, joint0, log_slice, draws, inv_mass,
        )
        upd = s  # only lanes still running may extend the trajectory
        back, ahead = upd & (v < 0), upd & fwd
        zm, rm, gm = _where(back, t.zm, zm), _where(back, t.rm, rm), _where(back, t.gm, gm)
        zp, rp, gp = _where(ahead, t.zp, zp), _where(ahead, t.rp, rp), _where(ahead, t.gp, gp)
        accept_prob = torch.clamp(t.n / torch.clamp(n_total, min=1e-30), max=1.0)
        take = upd & t.s & (draws.uniform() < accept_prob)
        zprop, gprop = _where(take, t.zprop, zprop), _where(take, t.gprop, gprop)
        lpprop = torch.where(take, t.lpprop, lpprop)
        alpha_sum = alpha_sum + torch.where(upd, t.a, 0.0)
        n_alpha = n_alpha + torch.where(upd, t.na, 0.0)
        n_total = n_total + torch.where(upd, t.n, 0.0)
        s = upd & t.s & _no_uturn(zm, zp, rm, rp, inv_mass)
    n_alpha = torch.clamp(n_alpha, min=1.0)
    return zprop, lpprop, gprop, alpha_sum / n_alpha, n_alpha


def init_nuts_state(
    rng: torch.Generator,
    x0,
    log_prob_fn: Callable,
    m_adapt: int = 100,
    mass=1.0,
    shard=None,
) -> NUTSState:
    """Initialize, including the per-walker reasonable-epsilon search."""
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=rng.device)
    lp, grad = value_and_grad(log_prob_fn, x0)
    eps = find_reasonable_epsilon(rng, x0, log_prob_fn, mass, shard=shard)
    w = x0.shape[0]
    zeros = torch.zeros(w, dtype=torch.float32, device=x0.device)
    return NUTSState(
        x0, lp, grad, rng, eps, torch.log(10.0 * eps), zeros, zeros.clone(),
        torch.ones_like(zeros), torch.tensor(m_adapt, dtype=torch.int32, device=x0.device),
        zeros.clone(),
    )


@torch.no_grad()
def nuts_chunk(
    log_prob_fn: Callable,
    state: NUTSState,
    nsteps: int,
    max_depth: int = 5,
    mass=1.0,
    shard=None,
):
    """Advance ``nsteps`` NUTS samples of the whole ensemble (this rank's
    walkers under ``shard``); dual averaging adapts the step sizes during
    the first ``state.m_adapt`` samples.  Returns (state, chain f32[nsteps,
    W, D], log_probs f32[nsteps, W])."""
    coords = state.coords
    w, d = coords.shape
    draws = _Draws(state.rng, w, shard)
    inv_mass, sqrt_mass = _mass(mass, d, coords.device)
    chain = torch.empty((nsteps, w, d), dtype=torch.float32, device=coords.device)
    lps = torch.empty((nsteps, w), dtype=torch.float32, device=coords.device)
    for s in range(nsteps):
        state = nuts_step(log_prob_fn, max_depth, draws, state, inv_mass, sqrt_mass)
        chain[s] = state.coords
        lps[s] = state.log_prob
    return state, chain, lps


def nuts_step(log_prob_fn, max_depth: int, draws, state: NUTSState, inv_mass, sqrt_mass
              ) -> NUTSState:
    """One NUTS sample of every walker and its dual-averaging update."""
    x_new, lp_new, grad_new, alpha, _ = _nuts_sample(
        log_prob_fn, max_depth, draws, state.coords, state.log_prob, state.grad,
        state.epsilon, inv_mass, sqrt_mass,
    )
    # dual averaging (H&G Alg. 6)
    adapting = state.m_adapt > 0
    eta = 1.0 / (state.m + DA_T0)
    h_bar = torch.where(adapting, (1.0 - eta) * state.h_bar + eta * (DA_DELTA - alpha),
                        state.h_bar)
    log_eps = state.mu - torch.sqrt(state.m) / DA_GAMMA * h_bar
    eta2 = state.m ** (-DA_KAPPA)
    log_eps_bar = torch.where(adapting, eta2 * log_eps + (1.0 - eta2) * state.log_eps_bar,
                              state.log_eps_bar)
    return NUTSState(
        x_new, lp_new, grad_new, state.rng,
        torch.where(adapting, torch.exp(log_eps), torch.exp(state.log_eps_bar)),
        state.mu, h_bar, log_eps_bar,
        state.m + adapting.to(torch.float32),
        torch.clamp(state.m_adapt - 1, min=0),
        # expected acceptances: the sample's mean Metropolis alpha, the
        # statistic the chain file's 'accepted' records for NUTS
        state.accepted + alpha,
    )
