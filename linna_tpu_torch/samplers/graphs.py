"""Sampler steps replayed from CUDA graphs.

The JAX package runs each sampler chunk as one compiled device program
(``lax.scan`` over the steps, ``lax.while_loop`` for the slice move's
loops).  On a CUDA device :func:`linna_tpu_torch.samplers.run.run_ensemble`
gets the same effect from :func:`graphed_chunks`: each sampler's step is
captured once per run as a CUDA graph over static buffers and replayed once
a step, so a step costs one launch on the host instead of hundreds:

- emcee: one stretch step (both half-updates);
- HMC: one sample (``n_leapfrog`` leapfrogs with their gradients);
- NUTS: one sample (the unrolled depth-``max_depth`` tree, 2^depth - 1
  leapfrogs, and the dual-averaging update);
- zeus: each half-update's start and end, and one graph of its two loops
  (:class:`~linna_tpu_torch.ops.graph_loops.WhileLoops`): CUDA while
  nodes whose bodies are the stepping-out and the shrink iteration, ended
  on the card, as JAX's ``lax.while_loop``s are, so a step is six launches
  and the host reads no loop condition.

A chunk takes its step-fixed draws eagerly, exactly as the eager chunk
functions take them, and copies them and the state into the static
buffers; the draws inside a step (HMC's and NUTS's momenta and uniforms,
the shrink loop's uniforms at a half-update's start) come from the state's
generator, registered with every graph that draws.  So a graphed chunk computes what the eager
chunk computes, kernel for kernel, and leaves the generator where the eager
chunk leaves it.  Each step writes its row of the chunk's chain and
log-probs at a device step counter; the chunk returns copies of them and
of the state, so the next chunk's replays overwrite nothing it returned.

The eager chunk functions (``stretch_chunk``, ``hmc_chunk``, ``nuts_chunk``,
``slice_chunk``) stay: the CPU runs them, walker-sharded chunks run them
(gloo's collectives copy through the host and cannot be captured), and
``chip_smoke.py`` holds the graphs against them.  A capture or replay error
propagates; nothing falls back to the eager step.

Each graph is a :class:`~linna_tpu_torch.ops.graphs.StepGraph`, whose
ledger adds the kernels' counts on every replay.  zeus's loop bodies
replay on the card as often as the card decides: it counts their
iterations, and :meth:`_Chunks.settle` (called by ``record()``, which
``run_ensemble`` calls as a run ends) reads that count once and adds the
iterations since its last read to the bodies' replays and ledgers.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from ..ops import graph_loops
from ..ops.graphs import WARMUP, StepGraph
from ..utils.trace import ChunkTimes
from . import hmc, slicemove, stretch

__all__ = ["graphed_chunks"]


def _store(bufs: Sequence[torch.Tensor], values: Sequence[torch.Tensor]) -> None:
    for b, v in zip(bufs, values):
        b.copy_(v)


class _Chunks:
    """Static buffers and graphs shared by the samplers' runners."""

    def __init__(self, state, capacity: int):
        coords = state.coords
        self.w, self.d = coords.shape
        self.dev = coords.device
        self.capacity = int(capacity)
        # the per-step buffers' rows: each warm-up run of a step before its
        # capture advances the step counter, so they hold WARMUP rows at least
        self.rows = max(self.capacity, WARMUP)
        self.g = state.rng
        self.pool = None  # the graphs' memory pool, made at the first capture
        self.graphs: List[StepGraph] = []
        self.step = torch.zeros((), dtype=torch.int64, device=self.dev)
        self.steps = 0
        self.calls_by_graph = []  # (graph, likelihood calls a replay, rows a call)
        self.times = ChunkTimes()

    def zeros(self, *shape, dtype=torch.float32) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.dev)

    def capture(self, fn, buffers, draws: bool = False, calls: int = 0, rows: int = 0,
                body: bool = False) -> StepGraph:
        """``fn`` as a graph; ``draws``: it draws from the generator;
        ``calls``: the likelihood calls it makes, at ``rows`` rows each;
        ``body``: it runs as a loop's body, not by replays."""
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = StepGraph(fn, buffers, [self.g] if draws else (), self.pool, keep_graph=body)
        self.graphs.append(graph)
        if calls:
            self.calls_by_graph.append((graph, calls, rows))
        return graph

    def check(self, state, nsteps: int) -> None:
        if state.rng is not self.g or tuple(state.coords.shape) != (self.w, self.d):
            raise ValueError("a graphed chunk runs the state it was captured for")
        if not 0 < nsteps <= self.capacity:
            raise ValueError(f"{nsteps} steps; the graphs hold {self.capacity}")

    def row(self, t: torch.Tensor) -> torch.Tensor:
        """This step's row of a ``(rows, ...)`` buffer."""
        return t.index_select(0, self.step)[0]

    def write_row(self, buf: torch.Tensor, value: torch.Tensor) -> None:
        buf.index_copy_(0, self.step, value[None])

    @property
    def replays(self) -> int:
        return sum(g.replays for g in self.graphs)

    def settle(self) -> None:
        """Bring the graphs' replays and the kernels' counters up to what
        the card has run.  Here every replay is the host's, counted as it
        is launched; a runner whose loops the card ends reads their count."""

    def record(self) -> dict:
        """Replays, steps, the likelihood calls and rows replayed (a Python
        wrapper of the likelihood runs only while a graph is captured, so
        it cannot count them), and the card's seconds in and between the
        chunks (:class:`ChunkTimes`), once :meth:`settle` has counted."""
        self.settle()
        return {"replays": self.replays, "steps": self.steps,
                "calls": sum(g.replays * c for g, c, _ in self.calls_by_graph),
                "rows": sum(g.replays * c * r for g, c, r in self.calls_by_graph),
                **self.times.record()}


class _StretchChunks(_Chunks):
    def __init__(self, log_prob_fn, state, capacity: int, a: float):
        super().__init__(state, capacity)
        hl, n = self.w // 2, self.rows
        self.c2, self.lp2 = self.zeros(2, hl, self.d), self.zeros(2, hl)
        self.acc2 = self.zeros(2, hl, dtype=torch.int32)
        self.draws = (self.zeros(n, 2, hl, dtype=torch.int64), self.zeros(n, 2, hl),
                      self.zeros(n, 2, hl))
        self.chain, self.lps = self.zeros(n, 2, hl, self.d), self.zeros(n, 2, hl)
        carry = (self.c2, self.lp2, self.acc2)

        def step():
            new = stretch.stretch_step(log_prob_fn, a, *carry,
                                       *(self.row(t) for t in self.draws))
            _store(carry, new)
            self.write_row(self.chain, new[0])
            self.write_row(self.lps, new[1])
            self.step.add_(1)

        self.graph = self.capture(step, [*carry, self.chain, self.lps, self.step],
                                  calls=2, rows=hl)

    def __call__(self, state, nsteps: int):
        self.check(state, nsteps)
        coords, lp, g, accepted = state
        w, d, hl = self.w, self.d, self.w // 2
        self.times.start()
        _store([t[:nsteps] for t in self.draws], stretch.chunk_draws(g, nsteps, hl, self.dev))
        _store((self.c2, self.lp2, self.acc2),
               (coords.reshape(2, hl, d), lp.reshape(2, hl), accepted.reshape(2, hl)))
        self.step.zero_()
        for _ in range(nsteps):
            self.graph.replay()
        self.times.stop()
        self.steps += nsteps
        new = stretch.EnsembleState(self.c2.reshape(w, d).clone(), self.lp2.reshape(w).clone(),
                                    g, self.acc2.reshape(w).clone())
        return (new, self.chain[:nsteps].reshape(nsteps, w, d).clone(),
                self.lps[:nsteps].reshape(nsteps, w).clone())


class _StateChunks(_Chunks):
    """HMC and NUTS: every state field but the generator is a buffer, and
    a step is one sample."""

    def __init__(self, state, capacity: int, sample: Callable, calls: int):
        super().__init__(state, capacity)
        self.cls = type(state)
        self.fields = [n for n in state._fields if n != "rng"]
        self.bufs = {n: torch.zeros_like(getattr(state, n)) for n in self.fields}
        self.chain = self.zeros(self.rows, self.w, self.d)
        self.lps = self.zeros(self.rows, self.w)
        draws = hmc._Draws(self.g, self.w)
        inv_mass, sqrt_mass = hmc._mass(1.0, self.d, self.dev)

        def step():
            new = sample(draws, self._state(), inv_mass, sqrt_mass)
            _store([self.bufs[n] for n in self.fields], [getattr(new, n) for n in self.fields])
            self.write_row(self.chain, new.coords)
            self.write_row(self.lps, new.log_prob)
            self.step.add_(1)

        self.graph = self.capture(step, [*self.bufs.values(), self.chain, self.lps, self.step],
                                  draws=True, calls=calls, rows=self.w)

    def _state(self, clone: bool = False):
        f = (lambda t: t.clone()) if clone else (lambda t: t)
        return self.cls(**{n: f(b) for n, b in self.bufs.items()}, rng=self.g)

    def __call__(self, state, nsteps: int):
        self.check(state, nsteps)
        self.times.start()
        _store([self.bufs[n] for n in self.fields], [getattr(state, n) for n in self.fields])
        self.step.zero_()
        for _ in range(nsteps):
            self.graph.replay()
        self.times.stop()
        self.steps += nsteps
        return (self._state(clone=True), self.chain[:nsteps].clone(),
                self.lps[:nsteps].clone())


def _hmc_sample(log_prob_fn, n_leapfrog: int):
    def sample(draws, st, inv_mass, sqrt_mass):
        coords, lp, grad, accepted = hmc.hmc_sample(
            log_prob_fn, n_leapfrog, draws, st.coords, st.log_prob, st.grad, st.epsilon,
            st.accepted, inv_mass, sqrt_mass)
        return st._replace(coords=coords, log_prob=lp, grad=grad, accepted=accepted)

    return sample


def _nuts_sample(log_prob_fn, max_depth: int):
    def sample(draws, st, inv_mass, sqrt_mass):
        return hmc.nuts_step(log_prob_fn, max_depth, draws, st, inv_mass, sqrt_mass)

    return sample


class _SliceChunks(_Chunks):
    """zeus: per half ``h`` a start and an end graph; one stepping-out and
    one shrink iteration graph serve both halves (the work holds the active
    walkers twice, in ``x2``), as the bodies of one graph of two while
    loops that the card ends (:class:`~linna_tpu_torch.ops.graph_loops.WhileLoops`),
    each after at most ``max_steps`` iterations, as
    :func:`~linna_tpu_torch.samplers.slicemove.late_loop` ends them.  The
    start draws the shrink loop's uniforms for all ``max_steps``
    iterations; the shrink iteration takes its row at a device counter.
    The start and end graphs stay torch replays: the start draws, and torch
    advances the generator's offset only on its own replay."""

    def __init__(self, log_prob_fn, state, capacity: int, max_steps: int):
        super().__init__(state, capacity)
        hl, n, d = self.w // 2, self.rows, self.d
        self.max_steps = int(max_steps)
        self.c2, self.lp2 = self.zeros(2, hl, d), self.zeros(2, hl)
        self.nx, self.nlp = self.zeros(2, hl, d), self.zeros(2, hl)
        self.mu = self.zeros()
        self.counts = self.zeros(2, dtype=torch.int32)  # n_expand, n_contract
        self.half_counts = self.zeros(2, 2, dtype=torch.int32)
        self.draws = (self.zeros(n, 2, hl, dtype=torch.int64),
                      self.zeros(n, 2, hl, dtype=torch.int64), self.zeros(n, 2, hl),
                      self.zeros(n, 2, hl))
        self.chain, self.lps = self.zeros(n, 2, hl, d), self.zeros(n, 2, hl)
        # the work's buffers, shaped and typed by one start from zeros
        start = slicemove.slice_begin(self.c2[0], self.lp2[0], self.c2[1], self.mu,
                                      *(t[0, 0] for t in self.draws))
        self.work = slicemove.SliceWork(*(t.clone() for t in start))
        self.more = self.zeros(dtype=torch.bool)
        # the shrink iteration's warm-up runs before its capture read rows
        # 0 .. WARMUP - 1; a half-update draws max_steps of them
        self.shrink_u = self.zeros(max(self.max_steps, WARMUP), hl)
        self.it = self.zeros(dtype=torch.int64)  # the shrink iteration
        work = list(self.work)

        def begin(h):
            def fn():
                l, m, expo, u0 = (self.row(t)[h] for t in self.draws)
                comp = self.c2[1] if h == 0 else self.nx[0]
                _store(work, slicemove.slice_begin(self.c2[h], self.lp2[h], comp, self.mu,
                                                   l, m, expo, u0))
                u = torch.rand(self.max_steps, hl, generator=self.g, device=self.dev)
                self.shrink_u[:self.max_steps].copy_(u)
                self.it.zero_()
            return fn

        def out():
            new, more = slicemove.step_out(log_prob_fn, self.work)
            _store(work + [self.more], list(new) + [more])

        def inward():
            u = self.shrink_u.index_select(0, self.it)[0]
            new, more = slicemove.shrink(log_prob_fn, self.work.x2[:hl], self.work, u)
            _store(work + [self.more], list(new) + [more])
            self.it.add_(1)

        def end(h):
            def fn():
                x, lp = slicemove.slice_end(self.c2[h], self.lp2[h], self.work)
                _store((self.nx[h], self.nlp[h], self.half_counts[h]),
                       (x, lp, torch.stack([self.work.n_expand, self.work.n_contract])))
                if h == 1:
                    _store((self.c2, self.lp2), (self.nx, self.nlp))
                    self.counts.copy_(self.counts + self.half_counts[0] + self.half_counts[1])
                    self.write_row(self.chain, self.nx)
                    self.write_row(self.lps, self.nlp)
                    self.step.add_(1)
            return fn

        loop_bufs = work + [self.more]
        self.begin = [self.capture(begin(h), work + [self.shrink_u, self.it], draws=True)
                      for h in (0, 1)]
        self.out = self.capture(out, loop_bufs, calls=1, rows=self.w, body=True)
        self.inward = self.capture(inward, loop_bufs + [self.it], calls=1, rows=hl, body=True)
        self.end = [self.capture(end(h), [self.nx, self.nlp, self.half_counts, self.c2, self.lp2,
                                          self.counts, self.chain, self.lps, self.step])
                    for h in (0, 1)]
        self.loops = graph_loops.WhileLoops([self.out.graph, self.inward.graph], self.more,
                                            self.max_steps)
        # each body's iterations on the card, as far as its replays count them
        self.loop_iters = [0, 0]

    def __call__(self, state, nsteps: int):
        self.check(state, nsteps)
        coords, lp, g, mu, n_expand, n_contract = state
        w, d, hl = self.w, self.d, self.w // 2
        self.times.start()
        _store([t[:nsteps] for t in self.draws], slicemove.chunk_draws(g, nsteps, hl, self.dev))
        _store((self.c2, self.lp2, self.mu, self.counts),
               (coords.reshape(2, hl, d), lp.reshape(2, hl), mu,
                torch.stack([n_expand, n_contract])))
        self.step.zero_()
        for _ in range(nsteps):
            for h in (0, 1):
                self.begin[h].replay()
                self.loops.launch()
                self.end[h].replay()
        self.times.stop()
        self.steps += nsteps
        counts = self.counts.clone()
        new = slicemove.SliceState(self.c2.reshape(w, d).clone(), self.lp2.reshape(w).clone(),
                                   g, mu, counts[0], counts[1])
        return (new, self.chain[:nsteps].reshape(nsteps, w, d).clone(),
                self.lps[:nsteps].reshape(nsteps, w).clone())

    def settle(self) -> None:
        """The loops' iterations since the last call, read from the card
        (one wait), added to the bodies' replays and launch ledgers."""
        totals = self.loops.totals()
        for body, now, seen in zip((self.out, self.inward), totals, self.loop_iters):
            body.replayed(now - seen)
        self.loop_iters = totals

    def record(self) -> dict:
        """:meth:`_Chunks.record` with the iterations the card ran in each
        loop (``loop_iters``, ``out`` and ``in``), and the host-driven
        loops' condition reads, the host's turnaround after them and the
        time the reads blocked, all 0: the host reads no condition."""
        rec = super().record()
        out_iters, in_iters = self.loop_iters
        return {**rec, "loop_iters": {"out": out_iters, "in": in_iters}, "cond_reads": 0,
                "turnaround_s": 0.0, "cond_wait_s": 0.0}


def graphed_chunks(method: str, log_prob_fn: Callable, state, capacity: int, *, a: float,
                   n_leapfrog: int, max_depth: int, max_steps: int):
    """The graphed chunk runner of ``method`` for ``state``'s walkers and
    generator, for chunks of up to ``capacity`` steps, with the eager chunk
    functions' ``a`` (emcee), ``n_leapfrog`` (HMC), ``max_depth`` (NUTS)
    and ``max_steps`` (zeus): called as
    ``runner(state, nsteps)``, it returns ``(state, chain, log_probs)`` as
    the eager chunk function does; ``runner.record()`` counts the replays,
    steps and likelihood calls."""
    if state.coords.device.type != "cuda":
        raise ValueError("CUDA graphs need a CUDA device; the CPU runs the eager chunks")
    with torch.no_grad():
        if method == "emcee":
            return _StretchChunks(log_prob_fn, state, capacity, a)
        if method == "hmc":
            return _StateChunks(state, capacity, _hmc_sample(log_prob_fn, n_leapfrog), n_leapfrog)
        if method == "nuts":
            return _StateChunks(state, capacity, _nuts_sample(log_prob_fn, max_depth),
                                2**max_depth - 1)
        if method == "zeus":
            return _SliceChunks(log_prob_fn, state, capacity, max_steps)
    raise NotImplementedError(method)
