"""A step captured once as a CUDA graph and replayed, with its kernel counts.

:class:`StepGraph` captures ``fn()`` over static buffers after a few eager
runs on a side stream, with Python's cyclic collector paused.  The kernel
counters of :mod:`linna_tpu_torch.ops.library` tick in Python, so a replay
would not move them: the graph's :class:`LaunchLedger` takes back what the
capture counted and adds it on every replay.
"""

from __future__ import annotations

import contextlib
import gc
from typing import Callable, Dict, Iterable, List, Sequence

import torch

from . import library

__all__ = ["LaunchLedger", "StepGraph", "collector_paused", "WARMUP"]

# eager runs of a step on a side stream before its capture: they create
# cuBLAS's workspace and the autograd engine's state on the stream, and
# their results are put back
WARMUP = 3


class LaunchLedger:
    """The counts one graph holds: each counter's change while it was
    captured.  Capturing runs nothing, so the change is taken back, and
    every replay adds it.  ``counters``: dicts of counts, each kept."""

    def __init__(self, *counters: Dict[str, int]):
        self.counters = counters
        self.per_replay: List[Dict[str, int]] = [{k: 0 for k in c} for c in counters]

    @contextlib.contextmanager
    def capturing(self):
        before = [dict(c) for c in self.counters]
        try:
            yield self
        finally:
            self.per_replay = [{k: c[k] - b[k] for k in b} for c, b in zip(self.counters, before)]
            for c, b in zip(self.counters, before):
                c.update(b)

    def replayed(self, n: int = 1) -> None:
        for c, per in zip(self.counters, self.per_replay):
            for k, v in per.items():
                c[k] += n * v


@contextlib.contextmanager
def collector_paused():
    """Python's cyclic garbage collector off inside, as it was outside.

    An object nobody holds any more lives on in a cycle (its graphs' step
    functions hold it) until the collector frees it, and freeing it
    destroys its CUDA graphs.  That destruction is a CUDA call a capture
    forbids: run by a collection that happens to start inside a capture,
    it invalidates the capture (``cudaErrorStreamCaptureInvalidated`` at
    its end)."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


class StepGraph:
    """``fn()`` captured over static buffers.  ``buffers``: every tensor
    ``fn`` writes (put back after the warm-up); ``generators``: the
    generators ``fn`` draws from, registered with the graph; ``keep_graph``:
    the graph is kept uninstantiated, to be run as another graph's body
    (its runs are counted by :meth:`replayed`).

    The graph holds ``fn``: a replay reads the tensors ``fn``'s closure
    holds at the addresses they had at capture, and a tensor freed after
    the capture would have its memory handed to the next allocation."""

    def __init__(self, fn: Callable[[], None], buffers: Sequence[torch.Tensor],
                 generators: Iterable[torch.Generator] = (), pool=None,
                 keep_graph: bool = False):
        self.fn = fn
        generators = list(generators)
        saved = [b.clone() for b in buffers]
        states = [g.get_state() for g in generators]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        for b, s in zip(buffers, saved):
            b.copy_(s)
        for g, s in zip(generators, states):
            g.set_state(s)
        self.graph = torch.cuda.CUDAGraph(keep_graph=keep_graph)
        for g in generators:
            self.graph.register_generator_state(g)
        self.ledger = LaunchLedger(*library.COUNTERS.values())
        # thread_local: another thread (a kernel warm-up) may be launching
        with self.ledger.capturing(), collector_paused(), \
                torch.cuda.graph(self.graph, pool=pool, capture_error_mode="thread_local"):
            fn()
        self.replays = 0

    def replay(self) -> None:
        self.graph.replay()
        self.replayed()

    def replayed(self, n: int = 1) -> None:
        """Count ``n`` runs of the graph: its replays and its ledger's."""
        self.ledger.replayed(n)
        self.replays += n
