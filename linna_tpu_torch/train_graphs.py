"""Training chunks and the learning-rate range test replayed from CUDA graphs.

The JAX package runs each dispatch chunk of epochs as one compiled device
program: ``Trainer._epochs_tracked`` (``linna_tpu/train.py``) and
``EnsembleTrainer._epochs_members`` (``linna_tpu/parallel/ensemble.py``) are
each one jitted ``lax.scan`` over the chunk's epochs and minibatches, and
``EnsembleTrainer._lr_sweep_members`` is the range test's scan.  Here a
chunk is two bodies over static buffers:

- the minibatch step reads its rows' indices from the chunk's permutation
  buffer at a device step counter, runs the trainer's ``_step`` (the
  batched forward and backward and the AdamW update in place), writes the
  members' losses at the counter and advances it;
- the epoch end runs the validation pass, writes the metric and
  correlation rows at a device epoch counter, keeps the best value and
  params, and advances it.

:class:`EpochProgram` runs a chunk as ``nb`` steps and one end an epoch.  On
a CUDA device with no data group each body is captured once per training
call as a CUDA graph
(:class:`linna_tpu_torch.samplers.graphs.StepGraph`) and replayed nb + 1
times an epoch; neither graph depends on the number of minibatches or on
the chunk's length.  Elsewhere (the CPU; a data group, whose gloo
all-reduce copies through the host) the same bodies run eagerly, so the
eager and the graphed chunk run the same operations.  :func:`lr_sweep`
does the same for the range test's step.

A graph reads the storage it was captured with.  The trainer writes the
parameters, the AdamW state, lr and wd in place (``_set_hypers``, the
optimizer reset, reinit, reload, the speculative restore), and a program
refuses to run once one of them has been replaced.  A chunk returns copies
of its outputs, taken before the next chunk's replays, so speculative
dispatch (chunk k+1 enqueued before chunk k's results are read) overwrites
nothing it returned.  Training reaches neither CUDA kernel of
``ops/fused``; each graph's :class:`~linna_tpu_torch.samplers.graphs.LaunchLedger`
still adds its capture's counts per replay.  A capture or replay error
propagates; nothing falls back to the eager bodies on a card.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from .samplers.graphs import StepGraph
from .utils.trace import ChunkTimes

__all__ = ["EpochProgram", "lr_sweep"]


def _copy(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy that shares no storage with a static buffer."""
    return t.clone(memory_format=torch.contiguous_format)


class _Program:
    """The bodies of one program, run eagerly or captured."""

    def __init__(self, stack, graphed: bool):
        if graphed and stack.flat.device.type != "cuda":
            raise ValueError("CUDA graphs need a CUDA device; the CPU runs the eager bodies")
        self.stack = stack
        self.graphed = graphed
        self.dev = stack.flat.device
        self.graphs: List[StepGraph] = []
        self.capture_s = 0.0
        self.pool = torch.cuda.graph_pool_handle() if graphed else None

    def zeros(self, *shape, dtype=torch.float32) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.dev)

    def body(self, fn: Callable[[], None], writes: Sequence[torch.Tensor]) -> Callable[[], None]:
        """``fn`` itself, or its graph's replay; ``writes``: every tensor
        ``fn`` writes (put back after the capture's warm-up)."""
        if not self.graphed:
            return fn
        t0 = time.perf_counter()
        graph = StepGraph(fn, writes, pool=self.pool)
        torch.cuda.synchronize(self.dev)
        self.capture_s += time.perf_counter() - t0
        self.graphs.append(graph)
        return graph.replay

    @property
    def replays(self) -> int:
        return sum(g.replays for g in self.graphs)


class EpochProgram(_Program):
    """The chunk program of one training call's rows ``data``: ``nb``
    minibatches an epoch, chunks of up to ``capacity`` epochs.  Called as
    ``program(perms)`` with perms (epochs, K, nb*bs), it returns what
    ``_MemberStack._epochs_tracked`` returns."""

    def __init__(self, stack, data, nb: int, capacity: int, graphed: bool):
        super().__init__(stack, graphed)
        self._held = self._reads()
        self.data, self.nb, self.capacity = data, int(nb), int(capacity)
        self.k, self.bs = stack.flat.shape[0], stack._batch_size
        k, out = self.k, stack.spec.out_size
        # zeros: valid rows for the warm-up steps before the first chunk
        self.perm_rows = self.zeros(self.capacity * self.nb, k, self.bs, dtype=torch.int64)
        self.losses = self.zeros(self.capacity * self.nb, k)
        self.vms = self.zeros(self.capacity, k, 3)
        self.corrs = self.zeros(self.capacity, k, out, out) if out <= 16 else None
        self.best_val = self.zeros(k)
        self.best_flat = stack.flat.clone()
        self.step_i = self.zeros(dtype=torch.int64)
        self.epoch_i = self.zeros(dtype=torch.int64)
        self.chunks = self.epochs = 0
        self.times = ChunkTimes() if graphed else None

        def step():
            idx = self.perm_rows.index_select(0, self.step_i)[0]
            with torch.enable_grad():
                loss = stack._step(data, idx, stack.opt, stack._lr_t, stack._wd_t)
            self.losses.index_copy_(0, self.step_i, loss[None])
            self.step_i.add_(1)

        def end():
            with torch.no_grad():
                vm, corr = stack._validate(data)
                self.vms.index_copy_(0, self.epoch_i, vm[None])
                if corr is not None:
                    self.corrs.index_copy_(0, self.epoch_i, corr[None])
                improved = vm[:, 0] < self.best_val
                self.best_val.copy_(torch.where(improved, vm[:, 0], self.best_val))
                self.best_flat.copy_(torch.where(improved[:, None], stack.flat, self.best_flat))
                self.epoch_i.add_(1)

        self.step = self.body(step, [stack.flat, *stack.opt, self.losses, self.step_i])
        outs = [self.vms, self.best_val, self.best_flat, self.epoch_i]
        self.end = self.body(end, outs + ([self.corrs] if self.corrs is not None else []))

    def _reads(self) -> List[torch.Tensor]:
        """The trainer tensors the bodies read, which must keep their
        storage while the program lives."""
        s = self.stack
        return [s.flat, *s.opt, s._lr_t, s._wd_t]

    def __call__(self, perms: torch.Tensor):
        if any(a is not b for a, b in zip(self._reads(), self._held)):
            raise RuntimeError("a trainer tensor the chunk program reads was replaced; "
                               "the trainer writes its state in place")
        n_ep, k, nb, bs = perms.shape[0], self.k, self.nb, self.bs
        if not 0 < n_ep <= self.capacity or tuple(perms.shape[1:]) != (k, nb * bs):
            raise ValueError(f"perms {tuple(perms.shape)}; the program holds {self.capacity} "
                             f"epochs of ({k}, {nb * bs})")
        times = self.times
        if times is not None:
            times.start()
        with torch.no_grad():
            self.perm_rows[:n_ep * nb].view(n_ep, nb, k, bs).copy_(
                perms.reshape(n_ep, k, nb, bs).transpose(1, 2))
            self.step_i.zero_()
            self.epoch_i.zero_()
            self.best_val.fill_(torch.inf)
            self.best_flat.copy_(self.stack.flat)
        for e in range(n_ep):
            for _ in range(nb):
                self.step()
            if times is not None and e == n_ep - 1:
                times.mark()
            self.end()
        if times is not None:
            times.stop()
        self.chunks += 1
        self.epochs += n_ep
        losses = self.losses[:n_ep * nb].view(n_ep, nb, k).transpose(1, 2)
        corrs = None if self.corrs is None else _copy(self.corrs[:n_ep])
        return _copy(losses), _copy(self.vms[:n_ep]), corrs, _copy(self.best_val), \
            _copy(self.best_flat)

    def record(self) -> dict:
        """Replays, chunks and epochs run; graphed, the card's seconds in
        the chunks and between them (``chunk_s``, ``between_chunks_s``) and
        each chunk's last epoch end (``epoch_end_s``), from
        :class:`~linna_tpu_torch.utils.trace.ChunkTimes`."""
        rec = {"graphed": self.graphed, "replays": self.replays, "chunks": self.chunks,
               "epochs": self.epochs, "minibatches_per_epoch": self.nb}
        if self.times is not None:
            rec.update(self.times.record(), epoch_end_s=list(self.times.split_s))
        return rec


def lr_sweep(stack, data, order: np.ndarray, lrs: np.ndarray, opt, graphed: bool,
             record: Optional[dict] = None) -> torch.Tensor:
    """The range test's raw loss traces (K, len(lrs)) on the device: from the
    trainer's current params with the fresh AdamW state ``opt``, batch
    ``it % nb`` of ``order`` and lr ``lrs[it]`` at step ``it``, weight decay
    1e-4; the params are put back afterwards.  ``graphed``: one step graph
    replayed ``len(lrs)`` times; ``record`` (a dict) gets the capture
    seconds and replays."""
    k, bs = stack.flat.shape[0], stack._batch_size
    nb = max(len(order) // bs, 1)
    backup = stack.flat.clone()
    prog = _Program(stack, graphed)
    batches = torch.as_tensor(np.asarray(order)[:nb * bs], device=prog.dev).view(nb, -1)
    lrs_t = torch.as_tensor(np.asarray(lrs, np.float32), device=prog.dev)
    wd = torch.full((k, 1), 1e-4, device=prog.dev)
    raw = prog.zeros(k, len(lrs))
    it = prog.zeros(dtype=torch.int64)

    def step():
        idx = batches.index_select(0, torch.remainder(it, nb))[0].expand(k, -1)
        lr = lrs_t.index_select(0, it).view(1, 1).expand(k, 1)
        with torch.enable_grad():
            loss = stack._step(data, idx, opt, lr, wd)
        raw.index_copy_(1, it, loss[:, None])
        it.add_(1)

    run = prog.body(step, [stack.flat, *opt, raw, it])
    for _ in range(len(lrs)):
        run()
    with torch.no_grad():
        stack.flat.copy_(backup)
    if record is not None:
        record.update(graphed=graphed, capture_s=prog.capture_s, replays=prog.replays,
                      steps=len(lrs))
    return raw
