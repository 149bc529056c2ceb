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
  whole chunk before the step loop; the shrink loop's uniforms are drawn
  for all ``max_steps`` iterations at each half-update's start (JAX draws
  them inside its loop), so the draws never depend on when a loop ends;
- stepping out evaluates both interval ends in one stacked ``(2*half, D)``
  batch per iteration;
- walkers that exhaust ``max_steps`` keep their position.

In :func:`slice_chunk` the JAX ``while_loop``s are host loops
(:func:`late_loop`) whose condition is copied to the host behind an event
and read :data:`CONDITION_LAG` iterations late.  On a card
:func:`linna_tpu_torch.samplers.run.run_ensemble` replays the pieces of a
half-update (:func:`slice_begin`, one :func:`step_out`, one
:func:`shrink`, :func:`slice_end`) from CUDA graphs
(:mod:`linna_tpu_torch.samplers.graphs`), the two loops as CUDA while
nodes that the card ends after the same iterations, so the host reads no
condition there; :func:`slice_chunk` runs the pieces eagerly (the CPU, and
walker-sharded chunks).  The draws come from one ``torch.Generator`` on the sampling
device; they are not JAX's bits.

Walker-sharded over ranks (``shard``), a chunk advances this rank's block
of each half-ensemble and gathers the complementary half whole once per
half-update (two all-gathers a step); the step-fixed draws are the whole
ensemble's, cut to the block.  The stepping-out and shrink loops run on the
block alone, so they end per rank, and the shrink loop's draws come from a
stream of this rank's own (seeded from the shared generator, which every
rank advances alike), as JAX folds the device index into them: sharded and
one-rank zeus chains agree in distribution, not draw for draw.  The
expansion and contraction counters count the chunk from zero on each rank
and are summed over the ranks once per chunk (one all-reduce).
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import torch

from ..parallel import multihost as MH
from ..utils.trace import span

__all__ = ["SliceState", "init_slice_state", "slice_chunk", "tune_mu"]


class SliceState(NamedTuple):
    coords: torch.Tensor  # f32[W, D] (this rank's walkers when sharded)
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


# The eager chunk's loops (slice_chunk: the CPU, walker-sharded chunks) can
# read their condition late: the condition after iteration i is waited for
# only once iterations i+1 .. i+CONDITION_LAG are enqueued, so the device
# need not idle while the host reads it.  An iteration after a loop's end is
# a masked no-op (need_l, need_r and done mask every update, and the shrink
# loop's uniforms are drawn up front), so the lag changes the work done,
# never the result; each extra iteration costs one likelihood call.  An
# eager chunk's host enqueues an iteration more slowly than the device runs
# it, so there an extra iteration only adds work: 0.  The graphed chunks on
# a card read no condition (samplers/graphs.py); when they still did, lag 0
# was fastest there too (chip_smoke.py phase 11 on an NVIDIA H100 80GB HBM3
# at 700 W, PERF.md).
CONDITION_LAG = 0


class LateFlags:
    """A ring of ``lag + 1`` loop conditions copied to the host: on a card
    into pinned memory behind an event each, read after the event; on the
    CPU the copy has finished when it returns.

    ``reads`` counts the reads and ``seconds["cond_wait"]`` sums the time
    they blocked (each a ``sampler.cond_wait`` span).  ``turnaround_s``
    sums the host's time from each read having the flag to the next
    :meth:`launched`, which the caller calls as a replay returns: at lag 0
    the card has nothing queued in it."""

    def __init__(self, device, lag: int):
        device = torch.device(device)
        self.lag = int(lag)
        cuda = device.type == "cuda"
        self.host = torch.zeros(self.lag + 1, dtype=torch.bool, pin_memory=cuda)
        self.events = [torch.cuda.Event() for _ in range(self.lag + 1)] if cuda else None
        self.reads = 0
        self.seconds = {"cond_wait": 0.0}
        self.turnaround_s = 0.0
        self._read_at: Optional[float] = None

    def post(self, it: int, flag: torch.Tensor) -> None:
        slot = it % len(self.host)
        self.host[slot].copy_(flag, non_blocking=True)
        if self.events is not None:
            self.events[slot].record()

    def read(self, it: int) -> bool:
        slot = it % len(self.host)
        with span("sampler.cond_wait", self.seconds):
            if self.events is not None:
                self.events[slot].synchronize()
            flag = bool(self.host[slot])
            self._read_at = time.perf_counter()
        self.reads += 1
        return flag

    def launched(self) -> None:
        if self._read_at is not None:
            self.turnaround_s += time.perf_counter() - self._read_at
            self._read_at = None


def late_loop(body: Callable[[int], torch.Tensor], max_steps: int, flags: LateFlags) -> int:
    """``while it < max_steps and cond: cond = body(it)``, with ``cond``
    read ``flags.lag`` iterations late: ``body(it)`` enqueues iteration
    ``it`` and returns the condition after it (a bool tensor).  The first
    condition holds.  Returns the iterations run."""
    it = 0
    while it < max_steps:
        if it > flags.lag and not flags.read(it - 1 - flags.lag):
            break
        flags.post(it, body(it))
        it += 1
    return it


class SliceWork(NamedTuple):
    """One half-update's loop state."""

    x2: torch.Tensor  # f32[2n, D] the active walkers twice (both interval ends)
    d2: torch.Tensor  # f32[2n, D] their directions twice
    direction: torch.Tensor  # f32[n, D]
    y: torch.Tensor  # f32[n] log slice height
    left: torch.Tensor  # f32[n]
    right: torch.Tensor  # f32[n]
    need_l: torch.Tensor  # bool[n] still stepping out
    need_r: torch.Tensor
    n_expand: torch.Tensor  # i32[]
    t_acc: torch.Tensor  # f32[n] accepted offset
    lp_acc: torch.Tensor  # f32[n]
    done: torch.Tensor  # bool[n] shrink finished
    n_contract: torch.Tensor  # i32[]


def slice_begin(active_x, active_lp, comp_x, mu, l, m, expo, u0) -> SliceWork:
    """The direction, slice height, initial interval and both loops' start."""
    n = active_x.shape[0]
    direction = mu * (comp_x[l] - comp_x[m])  # [n, D]
    left = -u0
    need = torch.ones(n, dtype=torch.bool, device=active_x.device)
    zero = torch.zeros((), dtype=torch.int32, device=active_x.device)
    return SliceWork(
        torch.cat([active_x, active_x]), torch.cat([direction, direction]), direction,
        active_lp - expo, left, left + 1.0, need, need, zero,
        torch.zeros_like(active_lp), active_lp, torch.zeros_like(need), zero,
    )


def step_out(log_prob_fn, w: SliceWork):
    """One stepping-out iteration, both ends in one stacked batch; returns
    (work, whether any end still needs to step out)."""
    n = w.y.shape[0]
    lp_both = log_prob_fn(w.x2 + torch.cat([w.left, w.right])[:, None] * w.d2)
    need_l = w.need_l & (lp_both[:n] > w.y)
    need_r = w.need_r & (lp_both[n:] > w.y)
    w = w._replace(
        left=torch.where(need_l, w.left - 1.0, w.left),
        right=torch.where(need_r, w.right + 1.0, w.right),
        need_l=need_l, need_r=need_r,
        n_expand=w.n_expand + need_l.sum(dtype=torch.int32) + need_r.sum(dtype=torch.int32),
    )
    return w, torch.any(need_l | need_r)


def shrink(log_prob_fn, active_x, w: SliceWork, u: torch.Tensor):
    """One shrink iteration, t ~ U(L, R) from the uniforms ``u``; returns
    (work, whether a walker is not done)."""
    t = w.left + (w.right - w.left) * u
    lp_t = log_prob_fn(active_x + t[:, None] * w.direction)
    inside = lp_t > w.y
    accept_now = inside & ~w.done
    reject = ~inside & ~w.done
    done = w.done | accept_now
    w = w._replace(
        t_acc=torch.where(accept_now, t, w.t_acc),
        lp_acc=torch.where(accept_now, lp_t, w.lp_acc),
        left=torch.where(reject & (t < 0), t, w.left),
        right=torch.where(reject & (t >= 0), t, w.right),
        n_contract=w.n_contract + reject.sum(dtype=torch.int32),
        done=done,
    )
    return w, ~torch.all(done)


def slice_end(active_x, active_lp, w: SliceWork):
    """(new_x, new_lp): walkers that exhausted ``max_steps`` keep their
    position."""
    new_x = active_x + torch.where(w.done, w.t_acc, torch.zeros_like(w.t_acc))[:, None] * w.direction
    return new_x, torch.where(w.done, w.lp_acc, active_lp)


def _slice_half(
    log_prob_fn, max_steps: int, active_x, active_lp, comp_x, mu,
    l, m, expo, u0, shrink_u: torch.Tensor, flags: Optional[LateFlags] = None,
):
    """One slice update of the active half-ensemble given this step's draws:
    partner indices ``l``/``m``, slice-height exponentials ``expo``,
    initial-interval uniforms ``u0``, and the shrink loop's uniforms
    ``shrink_u``, ``(max_steps, n_active)``, row ``it`` for loop iteration
    ``it``.  ``flags``: the loops' condition reads (default: at
    :data:`CONDITION_LAG`).

    Returns (new_x, new_lp, n_expand, n_contract)."""
    if flags is None:
        flags = LateFlags(active_x.device, CONDITION_LAG)
    w = slice_begin(active_x, active_lp, comp_x, mu, l, m, expo, u0)

    def out(it: int) -> torch.Tensor:
        nonlocal w
        w, more = step_out(log_prob_fn, w)
        return more

    def inward(it: int) -> torch.Tensor:
        nonlocal w
        w, more = shrink(log_prob_fn, active_x, w, shrink_u[it])
        return more

    late_loop(out, max_steps, flags)
    late_loop(inward, max_steps, flags)
    new_x, new_lp = slice_end(active_x, active_lp, w)
    return new_x, new_lp, w.n_expand, w.n_contract


def chunk_draws(g: torch.Generator, nsteps: int, half: int, device):
    """A chunk's step-fixed draws, each ``(nsteps, 2, half)``: partner
    indices ``l`` and ``m``, slice-height exponentials, initial-interval
    uniforms."""
    shape = (nsteps, 2, half)
    ls = torch.randint(0, half, shape, generator=g, device=device)
    offs = torch.randint(1, half, shape, generator=g, device=device)
    expos = torch.empty(shape, device=device).exponential_(generator=g)
    u0s = torch.rand(shape, generator=g, device=device)
    return ls, (ls + offs) % half, expos, u0s


@torch.no_grad()
def slice_chunk(
    log_prob_fn: Callable[[torch.Tensor], torch.Tensor],
    state: SliceState,
    nsteps: int,
    max_steps: int = 100,
    shard=None,
):
    """Advance ``nsteps`` ensemble-slice steps; returns
    (state, chain f32[nsteps, W, D], log_probs f32[nsteps, W]), W this
    rank's walkers when ``shard`` is given."""
    coords, lp, g, mu, n_expand, n_contract = state
    w, ndim = coords.shape
    hl = w // 2
    half = hl if shard is None else shard.half
    if shard is not None and w != shard.local:
        raise ValueError(f"{w} walkers on this rank; the walker shard holds {shard.local}")
    dev = coords.device
    c2 = coords.reshape(2, hl, ndim)
    lp2 = lp.reshape(2, hl)

    ls, ms, expos, u0s = chunk_draws(g, nsteps, half, dev)
    sg = g
    gather = lambda x: x  # noqa: E731
    if shard is not None:
        ls, ms, expos, u0s = (t[..., shard.block] for t in (ls, ms, expos, u0s))
        gather = shard.gather_half
        seed = int(torch.randint(0, 2**62, (1,), generator=g, device=dev))
        sg = torch.Generator(device=dev).manual_seed(seed + shard.rank)
        # this chunk's counts from zero: their sum over the ranks is added
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        totals, n_expand, n_contract = (n_expand, n_contract), zero, zero.clone()

    def shrink_u() -> torch.Tensor:
        return torch.rand(max_steps, hl, generator=sg, device=dev)

    flags = LateFlags(dev, CONDITION_LAG)
    chain = torch.empty((nsteps, w, ndim), dtype=torch.float32, device=dev)
    lps = torch.empty((nsteps, w), dtype=torch.float32, device=dev)
    for s in range(nsteps):
        nx0, nlp0, ne0, nc0 = _slice_half(
            log_prob_fn, max_steps, c2[0], lp2[0], gather(c2[1]), mu,
            ls[s, 0], ms[s, 0], expos[s, 0], u0s[s, 0], shrink_u(), flags,
        )
        nx1, nlp1, ne1, nc1 = _slice_half(
            log_prob_fn, max_steps, c2[1], lp2[1], gather(nx0), mu,
            ls[s, 1], ms[s, 1], expos[s, 1], u0s[s, 1], shrink_u(), flags,
        )
        c2 = torch.stack([nx0, nx1])
        lp2 = torch.stack([nlp0, nlp1])
        chain[s] = c2.reshape(w, ndim)
        lps[s] = lp2.reshape(w)
        n_expand = n_expand + ne0 + ne1
        n_contract = n_contract + nc0 + nc1
    if shard is not None:
        counts = MH.all_reduce(torch.stack([n_expand, n_contract]))
        n_expand, n_contract = totals[0] + counts[0], totals[1] + counts[1]
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
