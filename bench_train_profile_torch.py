"""Where does a training step's time go?  Stripped variants of the epoch
through the PyTorch port.

    python bench_train_profile_torch.py [--device DEV] [f32] [ndim=D] [ndata=N]
        [epochs=N] [out=FILE.json]

The counterpart of ``bench_train_profile.py``: K=2 members, batch 500, the
40,000 / 2,000 seeded rows of ``bench_train.py`` at 27 -> 457 (``ndim=40
ndata=1560`` for the LSST-Y10 shape), bfloat16 compute unless ``f32``.  Each
variant is built from the port's own step (``train.py``'s ``_loss``,
``_grad``, ``_step`` with ``adamw_step_``, and ``_validate``) and, on a card,
replayed from a CUDA graph of one minibatch step and one of the epoch's
end, as ``train_graphs.py`` runs the trainer's chunks; the CPU runs the
same bodies eagerly.  Every variant starts from the same parameters and
AdamW state and reads the same epoch permutations, drawn before the timed
epochs from ``torch.Generator`` seed 0:

  full           : the minibatch AdamW steps, then the validation metric
  no_val         : the same minus the validation pass
  no_opt         : forward and backward only (the gradients summed into the
                   loss with weight 0; no optimizer update)
  fwd_only       : forward and loss only
  carry_only     : one trivial elementwise op on the parameters a step: the
                   cost of a step's replay and its carry
  megabatch      : the whole epoch's rows as one forward and backward (a
                   1e-12 gradient step): the large-batch ceiling
  full_unroll2/4 : ``full`` with 2 / 4 minibatch steps in one graph, so an
                   epoch takes a half / a quarter of the step replays (the
                   counterpart of the JAX scan's ``unroll``)
  full_besttrack : ``full`` plus the production best-params tracking, a
                   select over the whole parameter tensor each epoch
  full_bestidx   : ``full`` plus tracking the best value and epoch only

Each variant runs one warm epoch, then ``epochs`` (30) timed epochs with one
synchronize at the end.  Beside each: ms an epoch, graph replays an epoch
and the capture's seconds.  Prints the card's name and power limit, a line
a variant and the result as one JSON line; the result goes to
``TRAIN_PROFILE_torch.json`` in ``$TMPDIR/linna_bench_train_profile_torch/``
(see ``bench_torch_common``).
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import bench_torch_common as BC  # noqa: E402

NDIM, NDATA = BC.NDIM, BC.NDATA
N_TRAIN, N_VAL = BC.N_TRAIN, BC.N_VAL
BATCH = 500
EPOCHS = 30
K = 2
# variant -> (minibatch step, epoch end, minibatch steps a step graph holds)
VARIANTS = {
    "full": ("adamw", "val", 1),
    "no_val": ("adamw", None, 1),
    "no_opt": ("grad", None, 1),
    "fwd_only": ("forward", None, 1),
    "full_unroll2": ("adamw", "val", 2),
    "full_unroll4": ("adamw", "val", 4),
    "full_besttrack": ("adamw", "besttrack", 1),
    "full_bestidx": ("adamw", "bestidx", 1),
    "carry_only": ("carry", None, 1),
    "megabatch": ("megabatch", None, 1),
}
RESULT_FILE = "TRAIN_PROFILE_torch.json"


def make_stack(problem, device, compute_dtype, params=None, k: int = K):
    """The K-member trainer whose step the variants take, with no output
    directories; ``params`` (one dict a member) defaults to ``init_model``
    with seeds 0..K-1."""
    from linna_tpu_torch.parallel.ensemble import EnsembleTrainer

    spec, tset, loss_state = problem
    stack = EnsembleTrainer(spec, tset, loss_state, [None] * k, list(range(k)), params=params,
                            compute_dtype=compute_dtype, device=device)
    stack._batch_size = BATCH
    return stack


def step_body(stack, data, kind: str):
    """The minibatch step of a variant: ``fn(idx)`` on rows idx (K, bs)
    returns each member's loss (K,)."""
    if kind == "adamw":
        return lambda idx: stack._step(data, idx, stack.opt, stack._lr_t, stack._wd_t)
    if kind == "grad":
        def grad_only(idx):
            loss, leaves = stack._loss(data, idx)
            # consume the gradients without an update
            return loss.detach() + 0.0 * stack._grad(loss, leaves).sum(dim=1)
        return grad_only
    if kind == "forward":
        def forward(idx):
            with torch.no_grad():
                return stack._loss(data, idx)[0]
        return forward
    if kind == "carry":
        def carry(idx):
            with torch.no_grad():
                stack.flat.add_(idx[0, 0].to(stack.flat.dtype) * 0.0)
            return torch.zeros(stack.flat.shape[0], device=stack.flat.device)
        return carry
    if kind == "megabatch":
        def megabatch(idx):
            loss, leaves = stack._loss(data, idx)
            grad = stack._grad(loss, leaves)
            with torch.no_grad():
                stack.flat.sub_(1e-12 * grad)
            return loss.detach()
        return megabatch
    raise ValueError(kind)


class Variant:
    """One variant's epochs over static buffers: a step body (``unroll``
    minibatch steps) and an epoch end, each a CUDA graph on a card."""

    def __init__(self, stack, data, perms: torch.Tensor, name: str, graphed: bool):
        from linna_tpu_torch.ops.graphs import WARMUP, StepGraph

        kind, end, self.unroll = VARIANTS[name]
        self.graphed = graphed
        dev = stack.flat.device
        k = stack.flat.shape[0]
        if kind == "megabatch":
            # one "minibatch" an epoch: all of the epoch's rows
            perms = perms.transpose(1, 2).reshape(perms.shape[0], 1, k, -1)
        self.nb = perms.shape[1]
        if self.nb % self.unroll:
            raise ValueError(f"{self.nb} minibatches an epoch do not split into steps of "
                             f"{self.unroll}")
        rows = perms.reshape(-1, *perms.shape[2:])
        # the capture's warm-up runs advance the counter: rows for them too
        pad = max(WARMUP * self.unroll - rows.shape[0], 0)
        self.perm_rows = torch.cat([rows, rows[:pad]]) if pad else rows.clone()
        self.losses = torch.zeros(self.perm_rows.shape[0], k, device=dev)
        self.vms = torch.zeros(perms.shape[0] + WARMUP, k, 3, device=dev)
        self.best_val = torch.full((k,), torch.inf, device=dev)
        self.best_epoch = torch.zeros(k, dtype=torch.int64, device=dev)
        self.best_flat = stack.flat.clone()
        self.step_i = torch.zeros((), dtype=torch.int64, device=dev)
        self.epoch_i = torch.zeros((), dtype=torch.int64, device=dev)
        body = step_body(stack, data, kind)

        def step():
            for _ in range(self.unroll):
                idx = self.perm_rows.index_select(0, self.step_i)[0]
                with torch.enable_grad():
                    loss = body(idx)
                self.losses.index_copy_(0, self.step_i, loss[None])
                self.step_i.add_(1)

        def epoch_end():
            with torch.no_grad():
                vm, _ = stack._validate(data)
                self.vms.index_copy_(0, self.epoch_i, vm[None])
                if end != "val":
                    improved = vm[:, 0] < self.best_val
                    self.best_val.copy_(torch.where(improved, vm[:, 0], self.best_val))
                if end == "besttrack":
                    self.best_flat.copy_(torch.where(improved[:, None], stack.flat,
                                                     self.best_flat))
                elif end == "bestidx":
                    self.best_epoch.copy_(torch.where(improved, self.epoch_i, self.best_epoch))
                self.epoch_i.add_(1)

        pool = torch.cuda.graph_pool_handle() if graphed else None

        def graph(fn, writes):
            # fn itself, or its graph's replay; writes: every tensor fn writes
            return StepGraph(fn, writes, pool=pool).replay if graphed else fn

        t0 = time.perf_counter()
        self.step = graph(step, [stack.flat, *stack.opt, self.losses, self.step_i])
        self.end = graph(epoch_end, [self.vms, self.best_val, self.best_epoch, self.best_flat,
                                     self.epoch_i]) if end else None
        BC.synchronize(dev)
        self.capture_s = time.perf_counter() - t0

    def run(self, epochs: int) -> None:
        """``epochs`` epochs from the first permutation."""
        with torch.no_grad():
            self.step_i.zero_()
            self.epoch_i.zero_()
        for _ in range(epochs):
            for _ in range(self.nb // self.unroll):
                self.step()
            if self.end is not None:
                self.end()

    @property
    def replays_per_epoch(self) -> int:
        if not self.graphed:
            return 0
        return self.nb // self.unroll + (self.end is not None)


def draw_perms(epochs: int, k: int, n: int, device) -> torch.Tensor:
    """Each epoch's row order per member, cut to whole minibatches:
    (epochs, nb, K, BATCH) on the device, from ``torch.Generator`` seed 0."""
    g = torch.Generator().manual_seed(0)
    nb = n // BATCH
    perms = torch.stack([torch.stack([torch.randperm(n, generator=g)[:nb * BATCH]
                                      for _ in range(k)]) for _ in range(epochs)])
    return perms.view(epochs, k, nb, BATCH).transpose(1, 2).contiguous().to(device)


def main(compute_dtype="bfloat16", ndim: int = NDIM, ndata: int = NDATA, out: str | None = None,
         device=None, epochs: int = EPOCHS, n_train: int = N_TRAIN, n_val: int = N_VAL) -> dict:
    from linna_tpu_torch.device import resolve_device

    device = resolve_device(device)
    out_path = BC.result_path(BC.run_dir("bench_train_profile"), out, RESULT_FILE)
    card = BC.card_line(device)
    print(f"device: {card}", flush=True)
    tx, ty, vx, vy = BC.training_set(ndim, ndata, n_train, n_val)
    stack = make_stack(BC.training_problem(tx, ty, device), device, compute_dtype)
    data = stack._prepare(tx, ty, vx, vy)
    start = (stack.flat.clone(), [t.clone() for t in stack.opt])
    perms = draw_perms(epochs, K, n_train, device)
    graphed = device.type == "cuda"
    ms, replays, capture = {}, {}, {}
    for name in VARIANTS:
        with torch.no_grad():
            stack.flat.copy_(start[0])
            for dst, src in zip(stack.opt, start[1]):
                dst.copy_(src)
        v = Variant(stack, data, perms, name, graphed)
        v.run(1)  # warm
        BC.synchronize(device)
        t0 = time.perf_counter()
        v.run(epochs)
        BC.synchronize(device)
        ms[name] = round((time.perf_counter() - t0) / epochs * 1e3, 2)
        replays[name], capture[name] = v.replays_per_epoch, round(v.capture_s, 3)
        print(f"{name}: {ms[name]:.2f} ms/epoch, {replays[name]} replays/epoch", flush=True)
        # the graphs hold their bodies, which hold the variant: a cycle
        del v
        gc.collect()
    result = {
        "metric": "train_step_profile",
        "unit": "ms/epoch",
        "compute_dtype": str(compute_dtype),
        "shape": {"ndim": ndim, "ndata": ndata, "n_train": n_train, "batch": BATCH, "k": K,
                  "epochs_timed": epochs},
        "device": card,
        **ms,
        "replays_per_epoch": replays,
        "capture_s": capture,
        "path": ("CUDA graphs: one of a minibatch step (full_unroll2/4: of 2 / 4 steps, the "
                 "scan's unroll) and one of the epoch's end, replayed" if graphed
                 else "the same bodies, eager (the CPU)"),
    }
    BC.write_result(out_path, result)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    dev, kv, words = BC.parse_argv(sys.argv[1:])
    # the JAX script's command line: [f32] [ndim=D] [ndata=N] [out=FILE.json]
    main(None if "f32" in words else "bfloat16", ndim=int(kv.get("ndim", NDIM)),
         ndata=int(kv.get("ndata", NDATA)), out=kv.get("out"), device=dev,
         epochs=int(kv.get("epochs", EPOCHS)))
