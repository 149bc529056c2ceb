"""Emulator trainer (PyTorch): an epoch loop on the card plus a host-side
training supervisor.

Counterpart of ``linna_tpu/train.py``.  The K members of an ensemble (K = 1
for :class:`Trainer`, K > 1 for
:class:`linna_tpu_torch.parallel.ensemble.EnsembleTrainer`) live in ONE
float32 tensor of shape (K, P): row m holds member m's P parameters, and
every weight and bias the network reads is a view into that row (a weight
(K, in, out), a bias (K, 1, out)).  One training step is therefore one
batched forward and backward of all members (``x @ w`` is a batched matrix
product over K) and one AdamW update of the whole (K, P) tensor, whatever
the number of layers.  The loss summed over members gives each member
exactly its own gradient.

Around the epochs run the reference's recovery rules, shared with the JAX
package and copied here unchanged: the learning-rate range test
(:func:`lr_range_test`, :func:`smooth_and_pick_lr`), :class:`EarlyStopping`,
and :class:`Supervisor`'s flat-start reinit, NaN/spike reload with lr
halving, and the collapse and late-stall escapes.  A dispatch chunk of
``DispatchSchedule.k_at`` epochs runs without a host sync; its metrics come
back in one fetch and the supervisor then decides epoch by epoch.

Speculative dispatch (``speculative_dispatch``, on by default as in the JAX
package): after a quiet chunk, chunk k+1 is enqueued from the post-chunk
state before the host waits for chunk k's metrics, so the fetch and the
supervisor, save and plot work overlap the card's work.  The parameters and
the optimizer state advance in place, so a device copy of both, taken on
the stream between the two chunks, is the restore point: the first
intervention of chunk k (reinit, reload, hyper), or every member stopping,
drops chunk k+1 and copies the restore point back before anything else
writes.  Chunk k's metrics go to pinned host memory with ``non_blocking``
copies enqueued before chunk k+1, and the host waits on an event, not on
the stream.  Without an intervention a speculative run equals the serial
run bit for bit; a dropped chunk has drawn its epoch permutations from each
member's stream, so after a drop the draws differ from the serial run's
(JAX's run burns one key split there).  Over ranks the metrics are gathered
before chunk k+1 is enqueued and every decision comes from them, so every
rank takes the same branch.

AdamW matches ``optax.inject_hyperparams(optax.adamw)``: b1 0.9, b2 0.999,
eps 1e-8 outside the square root, bias correction by each member's step
count, decoupled decay ``lr * wd * p`` on every parameter, biases included,
with lr and wd per member as runtime tensors.  A reinit or reload resets the
member's moments and count.

``compute_dtype`` (``train_compute_dtype``, e.g. ``"bfloat16"``) runs the
training forward and backward in that type, as the JAX trainers do: the
parameters and the standardized inputs are cast inside the loss and the
prediction returns to float32 before it.  The master weights, the second
moment, the validation pass and all loss and metric arithmetic stay float32;
the first moment is stored in the compute type and updated in float32.  The
trainer sets no process-wide precision flag.

Over several ranks (``mesh``, an
:class:`linna_tpu_torch.parallel.mesh.EnsembleMesh`) each rank holds the rows
of its block of members, each minibatch is split over the ranks that share
a member, and those ranks sum their gradients (and losses) in one
``all_reduce`` a step in their own group; nothing else crosses ranks inside
the epochs.  The supervisors, the range test and best tracking decide from
every member's metrics, gathered after each chunk, so every rank decides
the same; files are read by rank 0 and broadcast, and written by rank 0.

``linearmodel`` (a fitted :class:`linna_tpu_torch.linear_model.LinearModel`,
or any callable on the standardized inputs) is a frozen pre-model shared by
every member: its float32 output on the float32 inputs is subtracted from
the training targets once per training call and added to the prediction in
validation, so the network trains on the residual.  A ``linear_bypass``
spec refuses it, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import losses as L
from . import nn as N
from . import train_graphs as TG
from .device import DeviceLike, resolve_device
from .ops import adamw as AW
from .parallel import multihost as MH
from .transforms import TransformSet
from .utils import checkpoint as ckpt
from .utils import plots
from .utils.trace import span

__all__ = [
    "EarlyStopping",
    "Supervisor",
    "DispatchSchedule",
    "device_spike_recover",
    "AdamWState",
    "adamw_init",
    "adamw_step_",
    "adamw_reset_",
    "Trainer",
    "lr_range_test",
    "smooth_and_pick_lr",
]

LAST_CKPT = "last.ckpt.npz"
BEST_CKPT = "best.ckpt.npz"
MIN_LR = 2e-6


class EarlyStopping:
    """Patience/cooling early-stopping state machine
    (reference linna/predictor_gpu.py:19-151).

    ``step`` returns an action code: 0 = continue, 1 = halve lr (+wd),
    2 = stop, 3 = double weight decay (overfit detected).
    """

    def __init__(self, patience: int = 500, nqueue: int = 200, min_delta: float = 0.0):
        self.patience = patience
        self.nqueue = nqueue
        self.min_delta = min_delta
        self.best: Optional[float] = None
        self.best_t: Optional[float] = None
        self.num_bad_epochs = 0
        self.cooling = 0
        self.cooling_weight_decay = 0
        self.queue_t: List[float] = []
        self.queue_v: List[float] = []

    def step(self, val_metric: float, train_metric: float) -> int:
        self.queue_t.append(float(train_metric))
        self.queue_v.append(float(val_metric))
        if len(self.queue_t) > self.nqueue:
            self.queue_t.pop(0)
        if len(self.queue_v) > self.nqueue:
            self.queue_v.pop(0)
        if self.best is None:
            self.best = val_metric
            self.best_t = train_metric
            self.num_bad_epochs = 0
            return 0
        if np.isnan(val_metric):
            self.num_bad_epochs += 1
            return 0
        if val_metric < self.best - self.min_delta:
            self.num_bad_epochs = 0
            self.cooling = 0
            self.cooling_weight_decay = 0
            self.best = val_metric
            self.best_t = train_metric
            return self._check_stop()
        self.num_bad_epochs += 1
        if self.patience * 0.9 <= self.num_bad_epochs < self.patience:
            # nearly out of patience: try one lr halving, then "cool" for up
            # to 500 epochs before giving up (linna/predictor_gpu.py:101-113)
            if self.cooling != 0:
                if self.cooling > 500:
                    self.cooling = 0
                    self.num_bad_epochs += 5
                    return self._check_stop()
                self.num_bad_epochs -= 1
                self.cooling += 1
                return 0
            self.cooling += 1
            return 1
        if len(self.queue_t) > max(2, 0.5 * self.nqueue):
            # overfit: train loss falling while val loss rising over the two
            # halves of the queues (linna/predictor_gpu.py:114-131)
            half_t = len(self.queue_t) // 2
            half_v = len(self.queue_v) // 2
            t_trend = np.median(self.queue_t[half_t:]) - np.median(self.queue_t[:half_t])
            v_trend = np.median(self.queue_v[half_v:]) - np.median(self.queue_v[:half_v])
            if t_trend < 0 and v_trend > 0:
                if self.cooling_weight_decay != 0:
                    if self.cooling_weight_decay > 1000:
                        self.cooling_weight_decay = 0
                        return self._check_stop()
                    self.queue_t = []
                    self.queue_v = []
                    self.cooling_weight_decay += 1
                    if self.cooling_weight_decay % 50 == 0:
                        return 3
                    return self._check_stop()
                self.cooling_weight_decay += 1
                return 3
        return self._check_stop()

    def _check_stop(self) -> int:
        return 2 if self.num_bad_epochs >= self.patience else 0


class Supervisor:
    """Host-side per-member training supervisor: per-epoch metrics in, the
    reference's recovery decision out.  Actions of :meth:`step`:

    - ``"none"``   — keep training;
    - ``"hyper"``  — ``self.lr``/``self.wd`` changed (EarlyStopping codes 1/3);
    - ``"reinit"`` — new weights and a fresh optimizer (flat start, collapse);
    - ``"reload"`` — best params (else new weights) and a fresh optimizer
      (NaN/spike, late stall);
    - ``"stop"``   — early stop.

    The spike rule clamps ``vm[0]`` in place (linna/predictor_gpu.py:369-371).
    """

    def __init__(
        self,
        lr: float,
        wd: float = 1e-4,
        patience: int = 500,
        verbose: bool = False,
        tag: str = "",
    ):
        self.es = EarlyStopping(patience=patience)
        self.lr = float(lr)
        self.wd = float(wd)
        self.old = 0.0
        self.told = 0.0
        self.best_val_loss = float("inf")
        self.stopped = False
        self.verbose = verbose
        self.tag = tag
        self.val_hist: List[float] = []

    def _say(self, msg: str) -> None:
        if self.verbose:
            prefix = f"[{self.tag}] " if self.tag else ""
            print(prefix + msg, flush=True)

    def observe_chunk_best(self, chunk_best_val: float) -> bool:
        """Record a dispatch chunk's best validation metric; True when it
        improves on the running best of a member still training."""
        if self.stopped or not chunk_best_val < self.best_val_loss:
            return False
        self.best_val_loss = float(chunk_best_val)
        return True

    def step(
        self,
        ep: int,
        vm: np.ndarray,
        loss: float,
        min_eig: float,
        suppressed: bool = False,
    ) -> str:
        """Decide on epoch ``ep`` from its val-metric row ``vm``, last-batch
        train ``loss`` and collapse diagnostic ``min_eig``.  ``suppressed``
        marks epochs after a params-replacing intervention within the same
        chunk: only their metric history is kept."""
        val0 = float(vm[0])
        self.val_hist.append(val0)
        if suppressed or self.stopped:
            self.old, self.told = val0, loss
            return "none"

        recent = self.val_hist[-10:]
        flat_start = (
            ep >= 10
            and ep < 120
            and ep % 10 == 0
            and np.std(recent) < 0.01 * np.mean(recent)
        )
        collapsed = (
            min_eig < 1e-6
            and ep % 10 == 0
            and ep >= 10
            and val0 > 2.0 * self.best_val_loss
        )
        late_stall = (
            ep >= 120
            and ep % 50 == 0
            and self.best_val_loss < np.inf
            and val0 > 3.0 * self.best_val_loss
            and np.std(recent) < 0.01 * np.mean(recent)
        )
        if flat_start or collapsed:
            self._say(
                f"bad training restart at epoch {ep} "
                f"({'collapse' if collapsed else 'flat start'})"
            )
            if ep > 10 and self.lr > 2e-4:
                self.lr = max(self.lr / 2.0, MIN_LR)
            return "reinit"
        if late_stall:
            self._say(f"late stall at epoch {ep}: reload best")
            return "reload"
        if (
            np.isnan(val0)
            or val0 > 1e10
            or (ep != 0 and val0 - self.old > 5 * self.old)
            or (ep != 0 and loss - self.told > 5 * self.told)
        ):
            if (
                np.isnan(val0) or val0 > 1e10 or val0 - self.old > 10 * self.old
            ) and ep > 10:
                if self.lr > MIN_LR:
                    self.lr = self.lr / 2.0
            if not np.isnan(val0) and val0 - self.old > 5 * self.old:
                vm[0] = self.old
                self.val_hist[-1] = self.old
            return "reload"

        action = self.es.step(val0, loss)
        out = "none"
        if action == 1:
            if self.lr > MIN_LR:
                self.lr /= 2.0
                self.wd /= 2.0
                out = "hyper"
            else:
                self.es.cooling = 0
        elif action == 2:
            self._say(f"early stop at epoch {ep} (lr={self.lr:g})")
            self.stopped = True
            out = "stop"
        elif action == 3:
            if self.wd < 1.0:
                self.wd *= 2.0
                out = "hyper"
        if out != "stop":
            self.old, self.told = val0, loss
        return out


class DispatchSchedule:
    """Epochs per dispatch chunk: ``guard`` (10) inside the supervisor's
    flat-start window (the first 120 epochs) and for one chunk after an
    intervention, else the configured maximum ``epochs_per_dispatch``.  The
    same lengths as the JAX package's schedule, so a run with no
    intervention chunks its epochs identically."""

    FLAT_WINDOW = 120
    GUARD = 10

    def __init__(self, max_epd: int, guard: int = GUARD):
        self.max_epd = max(int(max_epd), 1)
        self.guard = min(guard, self.max_epd)
        self.quiet = 0  # consecutive chunks without a params intervention

    def k_at(self, i: int, num_epochs: int, quiet: Optional[int] = None) -> int:
        """Chunk length starting at epoch ``i`` (0 when done).  ``quiet``
        overrides the observed count of quiet chunks: speculative dispatch
        asks for the next chunk as if the current one lands quiet."""
        if i >= num_epochs:
            return 0
        q = self.quiet if quiet is None else quiet
        k = self.guard if i < self.FLAT_WINDOW or q == 0 else self.max_epd
        return min(k, num_epochs - i)

    def observe(self, intervened: bool) -> None:
        self.quiet = 0 if intervened else self.quiet + 1

    def quiet_path_lengths(self, num_epochs: int) -> List[int]:
        """The chunk lengths of a run with no intervention."""
        out, i, q = [], 0, 0
        while i < num_epochs:
            k = self.k_at(i, num_epochs, quiet=q)
            out.append(k)
            i += k
            q += 1
        return out


# ------------------------------------------------------------------- AdamW


class AdamWState(NamedTuple):
    """AdamW moments of K stacked members, each (K, P), and each member's
    step count (K,)."""

    count: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor


def adamw_init(flat: torch.Tensor, mu_dtype: Optional[torch.dtype] = None) -> AdamWState:
    """Zero moments for the (K, P) parameters; ``mu_dtype`` is the storage
    type of the first moment (optax's ``mu_dtype``), float32 by default."""
    return AdamWState(
        torch.zeros(flat.shape[0], dtype=torch.int32, device=flat.device),
        torch.zeros_like(flat, dtype=mu_dtype),
        torch.zeros_like(flat),
    )


def adamw_step_(flat: torch.Tensor, grad, state: AdamWState, lr: torch.Tensor,
                wd: torch.Tensor) -> None:
    """One AdamW update of the (K, P) parameters in place; ``lr`` and ``wd``
    are (K, 1) tensors.  ``grad`` is the (K, P) gradient, or the leaves'
    gradients in :class:`Layout` order as autograd left them (each (K, ...),
    in the compute type).  The arithmetic follows ``optax.adamw`` op for op.
    A first moment stored in a narrower type is updated in float32, the
    update uses that float32 moment, and only the stored copy is rounded
    (optax's order under ``mu_dtype``).  On a card this is one launch of
    :mod:`linna_tpu_torch.ops.adamw`'s kernel, which reads the leaves in
    place; on the CPU its plain version concatenates them and runs the
    PyTorch ops, to the same bits."""
    AW.adamw_(flat, grad, state, lr, wd)


@torch.no_grad()
def adamw_reset_(state: AdamWState, m: int) -> None:
    """Fresh optimizer state for member ``m`` (moments and count)."""
    state.count[m] = 0
    state.mu[m] = 0.0
    state.nu[m] = 0.0


@torch.no_grad()
def device_spike_recover(
    flat: torch.Tensor,
    opt: AdamWState,
    best_flat: torch.Tensor,
    lr: torch.Tensor,
    val0: torch.Tensor,
    loss: torch.Tensor,
    prev_val: torch.Tensor,
    prev_loss: torch.Tensor,
    ep,
):
    """The NaN/spike recovery of one epoch on the card, for K stacked
    members (JAX ``train.device_spike_recover``; the JAX package never
    calls it, and neither does the trainer here).

    ``flat``/``best_flat`` (K, P), ``opt`` the members' AdamW state, and the
    (K,) float32 ``lr``, validation metric ``val0``, last-batch ``loss`` and
    the previous quiet epoch's ``prev_val``/``prev_loss``.  A member
    triggers on a NaN or > 1e10 metric, or (after epoch 0) a metric or loss
    rising by more than 5x its previous value.  A triggered member gets its
    best params, a fresh optimizer state, its lr halved when the spike is
    big (NaN, > 1e10 or a 10x metric rise, after epoch 10, lr above
    ``MIN_LR``), and its recorded metric clamped to the previous value;
    the previous values advance only on quiet members.  Returns new
    tensors: (flat, opt, lr, recorded val0, prev_val, prev_loss, trigger)."""
    ep = torch.as_tensor(ep, device=val0.device)
    bad = torch.isnan(val0) | (val0 > 1e10)
    spike_v = (ep != 0) & (val0 - prev_val > 5.0 * prev_val)
    spike_t = (ep != 0) & (loss - prev_loss > 5.0 * prev_loss)
    trigger = bad | spike_v | spike_t
    big = (bad | (val0 - prev_val > 10.0 * prev_val)) & (ep > 10)
    rows = trigger[:, None]
    flat = torch.where(rows, best_flat, flat)
    opt = AdamWState(
        torch.where(trigger, torch.zeros_like(opt.count), opt.count),
        torch.where(rows, torch.zeros_like(opt.mu), opt.mu),
        torch.where(rows, torch.zeros_like(opt.nu), opt.nu),
    )
    lr = torch.where(trigger & big & (lr > MIN_LR), lr * 0.5, lr)
    vm0_rec = torch.where(trigger, prev_val, val0)
    prev_val = torch.where(trigger, prev_val, val0)
    prev_loss = torch.where(trigger, prev_loss, loss)
    return flat, opt, lr, vm0_rec, prev_val, prev_loss, trigger


def _to_device(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``host`` on ``device``, the copy enqueued on the stream: from pinned
    memory with ``non_blocking`` on a card, so the host does not wait for
    the work already enqueued (a speculated chunk's)."""
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


# ------------------------------------------------------------------ layout


def _walk(tree: Dict[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _nest(items) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, v in items:
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    return tree


class Layout:
    """Where each parameter of one member lives in a flat row of P floats,
    in the port's own parameter order."""

    def __init__(self, spec: N.ModelSpec):
        template = N.init_model(spec, seed=0, device="cpu")
        self.entries = []
        off = 0
        for path, t in _walk(template):
            self.entries.append((path, tuple(t.shape), off, t.numel()))
            off += t.numel()
        self.size = off

    def flatten(self, tree: Dict[str, Any]) -> torch.Tensor:
        """One member's parameter dict (any key order) -> f32[P] on the CPU."""
        out = []
        for path, shape, _, _ in self.entries:
            node = tree
            for p in path:
                node = node[p]
            t = torch.as_tensor(np.asarray(node) if not torch.is_tensor(node) else node)
            if tuple(t.shape) != shape:
                raise ValueError(f"parameter {'/'.join(path)}: shape {tuple(t.shape)} != {shape}")
            out.append(t.detach().to("cpu", torch.float32).reshape(-1))
        return torch.cat(out)

    def tree(self, row: torch.Tensor) -> Dict[str, Any]:
        """Views of one member's row f32[P] in the parameter dict layout."""
        return _nest((path, row[off:off + n].view(shape)) for path, shape, off, n in self.entries)

    def stacked_views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """Views of the (K, P) rows in entry order: weights (K, in, out),
        biases (K, 1, out) so they broadcast over a batch of rows."""
        k = flat.shape[0]
        return [
            flat[:, off:off + n].view((k,) + (shape if len(shape) > 1 else (1,) + shape))
            for _, shape, off, n in self.entries
        ]


# ----------------------------------------------------------------- trainer


class _Data(NamedTuple):
    """One training call's rows on the device: inputs already x-transformed
    and each target's loss terms (standardized target, sentinel mask,
    floored chi^2(target, data)) computed once.  With a pre-model the
    training target is the residual, the standardized target less the
    pre-model's float32 output on the row (the loss compares it with the
    network's output: target - (network + pre-model)), and ``val_lm`` holds
    the pre-model's output on the validation rows (else None)."""

    x: torch.Tensor
    t_std: torch.Tensor
    t_mask: torch.Tensor
    t_denom: torch.Tensor
    val_x: Optional[torch.Tensor]
    val_std: Optional[torch.Tensor]
    val_mask: Optional[torch.Tensor]
    val_denom: Optional[torch.Tensor]
    val_lm: Optional[torch.Tensor]


class _MemberStack:
    """K stacked members trained together (see the module docstring).
    ``outdirs[m]``/``seeds[m]`` give member m the artifacts and random
    stream of a one-member run with that directory and seed."""

    # disk checkpoints: a dirty best.ckpt every ``save_every`` epochs, and
    # last.ckpt with the optimizer state at the final forced save only
    save_every = 200
    # the most epochs one dispatch chunk runs without a host sync
    epochs_per_dispatch = 10
    # enqueue chunk k+1 before fetching chunk k (see the module docstring);
    # False gives the serial loop
    speculative_dispatch = True
    # write training_progress.png after the first chunk as well (ensembles)
    _plot_first_chunk = False

    def __init__(
        self,
        spec: N.ModelSpec,
        transforms: TransformSet,
        loss_state: L.LossState,
        outdirs: Sequence[Optional[str]],
        seeds: Sequence[int],
        params: Optional[Sequence[Dict[str, Any]]] = None,
        compute_dtype: Optional[str] = None,
        linearmodel=None,
        device: DeviceLike = None,
        mesh=None,
    ):
        self.compute_dtype = N.compute_dtype(compute_dtype, "train_compute_dtype")
        if linearmodel is not None and spec.linear_bypass:
            # apply_model ignores the pre-model for a linear_bypass spec:
            # training NN + pre-model would sample NN alone
            raise ValueError(
                "linearmodel cannot be combined with a linear_bypass model "
                "spec (the built-in 1e-3 bypass replaces the pre-model slot)"
            )
        # a frozen additive pre-model (the reference's ``linearmodel``
        # slot): the network trains on the residual
        self.linearmodel = linearmodel
        if len(outdirs) != len(seeds):
            raise ValueError("one output directory per seed")
        self.device = resolve_device(device)
        self.spec = spec
        self.transforms = transforms.to(self.device)
        self.loss_state = loss_state.to(self.device)
        self.outdirs = [None if d is None else str(d) for d in outdirs]
        self.n_members = len(seeds)
        seeds = [int(s) for s in seeds]
        # which members this rank holds, and the ranks it shares them with
        self.mesh = mesh if mesh is not None and mesh.world > 1 else None
        if self.mesh is not None:
            if self.mesh.n_members != self.n_members or self.mesh.world != MH.process_count():
                raise ValueError(
                    f"a mesh of {mesh.n_members} members over {mesh.world} ranks for "
                    f"{self.n_members} members over {MH.process_count()} ranks"
                )
            self._rank = MH.process_index()
            self.local = self.mesh.members(self._rank)
            self._group = self.mesh.data_group(self._rank)
        else:
            self.local = range(self.n_members)
            self._group = None
        # rank 0 alone writes; a trainer without a mesh runs on one rank
        self._writes = self.mesh is None or MH.is_primary()
        # each member's host stream: its epoch permutations and reinit seeds
        self.gens = [torch.Generator().manual_seed(s) for s in seeds]
        self.layout = Layout(spec)
        if params is None:
            params = {m: N.init_model(spec, seed=seeds[m], device="cpu") for m in self.local}
        self.flat = torch.stack([self.layout.flatten(params[m]) for m in self.local]
                                ).to(self.device)
        self._leaves = [
            v.detach().requires_grad_(True) for v in self.layout.stacked_views(self.flat)
        ]
        self._model = _nest(
            (path, leaf) for (path, *_), leaf in zip(self.layout.entries, self._leaves)
        )
        self.opt = adamw_init(self.flat, self.compute_dtype)
        self.lrs = np.full(self.n_members, 1e-4)
        self.wds = np.full(self.n_members, 1e-4)
        self.best_val_losses = np.full(self.n_members, np.inf)
        self._best_flat: Optional[torch.Tensor] = None
        self._best_dirty = np.zeros(self.n_members, bool)
        self._last_disk_save = -(10**9)
        self._batch_size: Optional[int] = None
        # the chunk program of the current training call's rows
        # (train_graphs.EpochProgram), and the graph records of the last
        # training call
        self._program: Optional[TG.EpochProgram] = None
        self.graphs: Dict[str, dict] = {}
        self._set_hypers()

    # ----------------------------------------------------------- device work

    def _row(self, m: int) -> Optional[int]:
        """Member ``m``'s row in this rank's tensors, None when another
        rank holds it."""
        return m - self.local.start if m in self.local else None

    def member_params(self, m: int) -> Dict[str, Any]:
        """Member ``m``'s parameters as a dict of views into its row (a
        member this rank holds)."""
        if self._row(m) is None:
            raise ValueError(f"member {m} is held by another rank")
        return self.layout.tree(self.flat[self._row(m)])

    def _gather(self, tensors, axes) -> List[np.ndarray]:
        """Host numpy of every member from this rank's rows of each tensor
        (members on ``axes[i]``): one all-gather over the ranks, or a copy
        to the host (one copy) without a mesh."""
        if self.mesh is None:
            return MH.to_host(tensors)
        return self.mesh.gather_members(tensors, axes)

    def _fetch_start(self, tensors, axes):
        """Start the host copy of every member's ``tensors`` (members on
        ``axes[i]``); returns the function that waits for it and gives the
        numpy arrays.  With a mesh the gather, a collective, runs here, so
        every rank makes it before enqueuing anything else; on a card the
        bytes go to pinned host memory behind an event."""
        if self.mesh is not None:
            host = self._gather(tensors, axes)
            return lambda: host
        return MH.to_host_async(tensors)

    def _set_hypers(self) -> None:
        """This rank's rows of ``lrs``/``wds`` into the (K, 1) tensors the
        steps read, in place after the first call: a captured step reads
        the storage it was captured with."""
        rows = slice(self.local.start, self.local.stop)
        for name, vals in (("_lr_t", self.lrs), ("_wd_t", self.wds)):
            new = _to_device(torch.as_tensor(np.asarray(vals, np.float32)[rows, None]),
                             self.device)
            dst = getattr(self, name, None)
            if dst is None:
                setattr(self, name, new)
            else:
                dst.copy_(new)

    def _prepare(self, train_x, train_y, val_x=None, val_y=None) -> _Data:
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=self.device)
        ts, ls = self.transforms, self.loss_state
        lm = self.linearmodel
        with torch.no_grad():
            x = ts.x_transform(f32(train_x))
            t_std, t_mask, t_denom = L.target_terms(ls, ts, f32(train_y))
            if lm is not None:
                t_std = t_std - lm(x)
            if val_x is None:
                return _Data(x, t_std, t_mask, t_denom, None, None, None, None, None)
            vx = ts.x_transform(f32(val_x))
            return _Data(x, t_std, t_mask, t_denom, vx, *L.target_terms(ls, ts, f32(val_y)),
                         None if lm is None else lm(vx))

    def _loss(self, data: _Data, idx: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """Every member's minibatch loss (K,) on rows ``idx`` (K, bs), this
        rank's share of them with a data group, and the autograd leaves it
        was computed from (see :meth:`_step`)."""
        bs = idx.shape[1]
        if self._group is not None:
            idx = idx[:, self.mesh.batch_slice(self._rank, bs)]
        if self.compute_dtype is None:
            pred = N.apply_model(self.spec, self._model, data.x[idx])
            leaves = self._leaves
        else:
            low = self.flat.to(self.compute_dtype)
            leaves = [v.detach().requires_grad_(True) for v in self.layout.stacked_views(low)]
            model = _nest((path, v) for (path, *_), v in zip(self.layout.entries, leaves))
            pred = N.apply_model(self.spec, model, data.x[idx].to(self.compute_dtype))
            pred = pred.to(torch.float32)
        per_row = L.chi2_ratio(self.loss_state, pred, data.t_std[idx], data.t_mask[idx],
                               data.t_denom[idx])
        if self._group is None:
            return torch.mean(per_row, dim=-1), leaves
        return per_row.sum(dim=-1) / bs, leaves

    def _leaf_grads(self, loss: torch.Tensor, leaves: List[torch.Tensor]
                    ) -> Tuple[torch.Tensor, ...]:
        """The gradients of the members' summed ``loss`` by leaf, as
        autograd leaves them: (K, ...) in the leaves' type, in
        :class:`Layout` order."""
        return torch.autograd.grad(loss.sum(), leaves)

    def _grad(self, loss: torch.Tensor, leaves: List[torch.Tensor]) -> torch.Tensor:
        """The float32 gradient (K, P) of the members' summed ``loss``."""
        grads = self._leaf_grads(loss, leaves)
        return torch.cat([g.reshape(self.flat.shape[0], -1) for g in grads], dim=1).to(
            torch.float32)

    def _step(self, data: _Data, idx: torch.Tensor, opt: AdamWState, lr, wd) -> torch.Tensor:
        """One minibatch AdamW step of every member on rows ``idx`` (K, bs);
        returns each member's loss (K,).

        With a ``compute_dtype`` the forward and backward run in it: the
        (K, P) parameters are cast in one op and the cast's views are the
        network's weights, the inputs are cast, and the prediction returns
        to float32 before the loss (the JAX trainers' ``_loss``).  A
        pre-model's float32 output on the float32 inputs is already in the
        residual target, in either type.  The views
        are the autograd leaves, so their gradients arrive without being
        scattered into full-size tensors; widened to float32 they are the
        gradient of the float32 parameters, as the cast's backward gives
        it.  :func:`adamw_step_` takes them as autograd left them (the
        kernel reads each leaf in place).

        With a data group this rank takes its share of each minibatch; the
        ranks' sums of their rows' losses over the whole minibatch size add
        up, in one ``all_reduce`` of the float32 gradient (K, P) with the
        loss beside it, to the minibatch's mean loss and its gradient."""
        loss, leaves = self._loss(data, idx)
        if self._group is None:
            grad, loss = self._leaf_grads(loss, leaves), loss.detach()
        else:
            both = MH.all_reduce(torch.cat([self._grad(loss, leaves), loss.detach()[:, None]],
                                           dim=1), group=self._group)
            grad, loss = both[:, :-1], both[:, -1]
        adamw_step_(self.flat, grad, opt, lr, wd)
        return loss

    def _validate(self, data: _Data):
        """Every member's validation metric row (K, 3) on the full
        validation set, and the output-correlation matrix (K, out, out) for
        the collapse check (None when the output has more than 16
        components)."""
        ls = self.loss_state
        with torch.no_grad():
            pred = N.apply_model(self.spec, self._model, data.val_x)  # (K, nval, out)
            if data.val_lm is not None:
                pred = pred + data.val_lm
            loss_v = L.chi2_ratio(ls, pred, data.val_std, data.val_mask, data.val_denom)
            chisq_nn_d = L._masked_chi2(pred - ls.data_std, data.val_mask, ls.inv_transformed_cov)
            vm = L.val_metric_from_terms(loss_v, data.val_denom, chisq_nn_d)
            if self.spec.out_size > 16:
                return vm, None
            centered = pred - pred.mean(dim=1, keepdim=True)
            c = centered / (torch.sqrt(torch.mean(centered**2, dim=1, keepdim=True)) + 1e-20)
            return vm, c.transpose(1, 2) @ c / pred.shape[1]

    def _graphed(self) -> bool:
        """Whether chunks and the range test replay CUDA graphs: on a card
        with no data group (gloo's all-reduce copies through the host and
        cannot be captured)."""
        return self.device.type == "cuda" and self._group is None

    def _epoch_program(self, data: _Data, nb: int, n_epochs: int) -> "TG.EpochProgram":
        """The chunk program of ``data`` with ``nb`` minibatches an epoch,
        holding at least ``n_epochs`` epochs: the one built before, else a
        new one (on a card its two graphs are captured now)."""
        prog = self._program
        if (prog is None or prog.data is not data or prog.nb != nb
                or prog.capacity < n_epochs):
            self._program = None  # the old buffers and graphs go first
            prog = self._program = TG.EpochProgram(
                self, data, nb, max(n_epochs, self.epochs_per_dispatch), self._graphed())
        return prog

    def _epochs_tracked(self, perms: torch.Tensor, data: _Data):
        """``perms.shape[0]`` epochs of every member with no host sync.

        ``perms`` (epochs, K, nb*bs): each epoch's row order per member (the
        remainder rows of a permutation are already dropped).  Each epoch:
        the minibatch steps, the metric of the full validation set, the
        output-correlation matrix for the collapse check (only when the
        output has at most 16 components), and the best params so far.
        Returns (losses (e, K, nb), val metrics (e, K, 3), correlations
        (e, K, out, out) or None, best val (K,), best params (K, P)), all on
        the device and owned by the caller; the parameters and optimizer
        state advance in place.  K counts this rank's members.  The chunk
        runs as :class:`linna_tpu_torch.train_graphs.EpochProgram`: CUDA
        graphs on a card with no data group, the same bodies eagerly
        elsewhere."""
        nb = perms.shape[-1] // self._batch_size
        return self._epoch_program(data, nb, perms.shape[0])(perms)

    def _draw_perms(self, n_epochs: int, n: int) -> torch.Tensor:
        """Each of this rank's members' epoch permutations from its own
        stream, cut to ``nb * bs`` rows (the remainder rows drop that
        epoch).  On a card they are drawn into pinned host memory and
        copied with ``non_blocking``; the caching host allocator hands that
        memory out again only after the copy has run."""
        bs = self._batch_size
        keep = max(n // bs, 1) * bs
        with span("trainer.draw_perms"):
            host = torch.empty((n_epochs, len(self.local), min(keep, n)), dtype=torch.int64,
                               pin_memory=self.device.type == "cuda")
            for e in range(n_epochs):
                for j, m in enumerate(self.local):
                    host[e, j] = torch.randperm(n, generator=self.gens[m])[:keep]
            return host.to(self.device, non_blocking=True)

    def _lr_sweep(self, data: _Data, order: np.ndarray, lrs: np.ndarray) -> np.ndarray:
        """The range test's raw loss traces f32[K, num_iter] (as float64):
        every member from its current params with a fresh optimizer, batch
        ``it % nb`` of ``order`` at step ``it``, weight decay 1e-4.  The
        params are restored afterwards.  Every member's traces, on every
        rank.  The steps run as :func:`linna_tpu_torch.train_graphs.lr_sweep`:
        one step graph replayed on a card with no data group."""
        self.graphs["lr_sweep"] = rec = {}
        raw = TG.lr_sweep(self, data, order, lrs, adamw_init(self.flat, self.compute_dtype),
                          self._graphed(), rec)
        return self._gather([raw], [0])[0].astype(np.float64)

    # ------------------------------------------------------------------ host

    def _auto_lr(
        self,
        data: _Data,
        start_lr: float = 1e-4,
        end_lr: float = 5e-3,
        num_iter: int = 100,
        smooth_f: float = 0.05,
        diverge_th: float = 5.0,
        outdirs: Optional[Sequence[Optional[str]]] = None,
    ) -> np.ndarray:
        """Per-member learning rates from each ``lr.npy``, or from one range
        test of all members that lack it (persisted to ``lr.npy`` with the
        ``lr_tunning.png`` plot).  Rank 0 reads the files and every rank
        gets its values, so all of them take the same branch."""
        outdirs = self.outdirs if outdirs is None else list(outdirs)

        def load():
            vals = np.full(self.n_members, np.nan)
            for m, d in enumerate(outdirs):
                if d is not None and os.path.isfile(os.path.join(d, "lr.npy")):
                    vals[m] = float(np.load(os.path.join(d, "lr.npy")))
            return vals

        vals = self._from_primary(load)
        missing = [m for m in range(self.n_members) if not np.isfinite(vals[m])]
        if not missing:
            return vals
        lrs = np.geomspace(start_lr, end_lr, num_iter)
        order = np.random.default_rng(1234).permutation(int(data.x.shape[0]))
        raw = self._lr_sweep(data, order, lrs)
        for m in missing:
            lr, losses, lrs_used = smooth_and_pick_lr(lrs, raw[m], smooth_f, diverge_th)
            vals[m] = lr
            d = outdirs[m]
            if d is not None and self._writes:
                os.makedirs(d, exist_ok=True)
                np.save(os.path.join(d, "lr.npy"), lr)
                plots.plot_lr_range(lrs_used, losses, os.path.join(d, "lr_tunning.png"))
        return vals

    def _from_primary(self, load_fn):
        """``load_fn()`` on rank 0, its result on every rank of the mesh."""
        return load_fn() if self.mesh is None else MH.broadcast_from_primary(load_fn)

    def _write_row(self, m: int, row: torch.Tensor) -> None:
        """Member ``m``'s parameters, where this rank holds it."""
        if self._row(m) is not None:
            with torch.no_grad():
                self.flat[self._row(m)].copy_(torch.as_tensor(row))

    def _reset_optimizer(self, m: int) -> None:
        if self._row(m) is not None:
            adamw_reset_(self.opt, self._row(m))

    def _reinit_member(self, m: int) -> None:
        """New weights for member ``m`` from its stream, on its ranks."""
        if self._row(m) is None:
            return
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=self.gens[m]))
        self._write_row(m, self.layout.flatten(N.init_model(self.spec, seed=seed, device="cpu")))
        self._reset_optimizer(m)

    def _load_best_member(self, m: int) -> bool:
        """Member ``m``'s best params: the in-memory best of this run first,
        then its ``best.ckpt.npz`` (read by rank 0, its row shipped to every
        rank); False when there is neither.  Every rank calls this for every
        member at the same point."""
        if self._best_flat is not None and np.isfinite(self.best_val_losses[m]):
            if self._row(m) is not None:
                self._write_row(m, self._best_flat[self._row(m)])
            return True
        d = self.outdirs[m]
        path = None if d is None else os.path.join(d, BEST_CKPT)

        def read():
            if path is None or not os.path.isfile(path):
                return None
            params, _, meta = ckpt.load_checkpoint(path, device="cpu")
            return self.layout.flatten(params).numpy(), meta

        payload = self._from_primary(read)
        if payload is None:
            return False
        row, meta = payload
        self._write_row(m, row)
        self.best_val_losses[m] = float(meta.get("best_val_loss", self.best_val_losses[m]))
        return True

    def _save(self, epoch: int, force: bool = False) -> None:
        """Periodic saves write only dirty best checkpoints; the forced final
        save adds ``last.ckpt.npz`` with the optimizer state.  Every rank
        takes the same branches (the gates are the same everywhere) and joins
        the gather of the members' rows; rank 0 writes."""
        if all(d is None for d in self.outdirs):
            return
        if not force and epoch - self._last_disk_save < self.save_every:
            return
        if not force and not self._best_dirty.any():
            return
        self._last_disk_save = epoch
        dirty = self._best_dirty.copy()
        self._best_dirty[:] = False
        # a bfloat16 first moment is saved as float32 (exact), as the JAX
        # package's checkpoints hold it
        rows = ([self.flat, self.opt.count, self.opt.mu.float(), self.opt.nu] if force else [])
        rows += [self._best_flat] if self._best_flat is not None else []
        host = [torch.as_tensor(a) for a in self._gather(rows, [0] * len(rows))]
        if force:
            params_h, count_h, mu_h, nu_h = host[:4]
        best_h = host[-1] if self._best_flat is not None else None
        if not self._writes:
            return
        for m, d in enumerate(self.outdirs):
            if d is None:
                continue
            meta = {
                "epoch": epoch,
                "best_val_loss": float(self.best_val_losses[m]),
                "lr": float(self.lrs[m]),
            }
            opt_m = None
            if force:
                opt_m = {
                    "count": count_h[m],
                    "mu": self.layout.tree(mu_h[m]),
                    "nu": self.layout.tree(nu_h[m]),
                    "hyperparams": {
                        "learning_rate": np.float32(self.lrs[m]),
                        "weight_decay": np.float32(self.wds[m]),
                    },
                }
                ckpt.save_checkpoint(
                    os.path.join(d, LAST_CKPT), self.layout.tree(params_h[m]), opt_m, meta
                )
            if best_h is not None and dirty[m]:
                ckpt.save_checkpoint(
                    os.path.join(d, BEST_CKPT), self.layout.tree(best_h[m]), opt_m, meta
                )

    def _plot(self, name: str, train_losses, val_metrics, nb: int) -> None:
        if not self._writes:
            return
        for m, d in enumerate(self.outdirs):
            if d is not None:
                plots.plot_training_progress(
                    train_losses[m], val_metrics[m], os.path.join(d, name),
                    batches_per_epoch=max(nb, 1),
                )

    def _train(
        self,
        train_x: np.ndarray,
        train_y: np.ndarray,
        val_x: np.ndarray,
        val_y: np.ndarray,
        num_epochs: int,
        batch_size: int,
        initfrombest: bool = True,
        auto_lr: bool = True,
        lr_scale: float = 1.0,
        epochs_per_dispatch: Optional[int] = None,
        verbose: bool = False,
    ) -> Tuple[List[List[float]], List[List[np.ndarray]]]:
        """The supervised loop of every member; per-member (train_losses,
        val_metrics) lists: per-batch losses and per-epoch metric rows."""
        n = int(np.shape(train_x)[0])
        self._batch_size = min(int(batch_size), n)
        nb = max(n // self._batch_size, 1)
        if epochs_per_dispatch is not None:
            self.epochs_per_dispatch = max(int(epochs_per_dispatch), 1)
        for d in self.outdirs:
            if d is not None and self._writes:
                os.makedirs(d, exist_ok=True)
        data = self._prepare(train_x, train_y, val_x, val_y)
        k_members = self.n_members

        ps = self.phase_seconds = {
            "auto_lr": 0.0, "capture": 0.0, "dispatch": 0.0, "wait_fetch": 0.0,
            "supervisor": 0.0, "save": 0.0, "plot": 0.0,
        }
        self.graphs = {}
        if auto_lr:
            with span("trainer.auto_lr", ps):
                self.lrs = self._auto_lr(data)
        self.lrs = self.lrs * lr_scale
        if initfrombest:
            for m in range(k_members):
                self._load_best_member(m)
        with torch.no_grad():
            for t in self.opt:
                t.zero_()
        self._set_hypers()
        # this call's chunk program, its graphs captured now on a card
        with span("trainer.capture", ps):
            self._epoch_program(data, nb, self.epochs_per_dispatch)

        sups = [
            Supervisor(self.lrs[m], self.wds[m], verbose=verbose,
                       tag=f"member{m}" if k_members > 1 else "")
            for m in range(k_members)
        ]
        for m in range(k_members):
            sups[m].best_val_loss = float(self.best_val_losses[m])
        train_losses: List[List[float]] = [[] for _ in range(k_members)]
        val_metrics: List[List[np.ndarray]] = [[] for _ in range(k_members)]
        i = 0
        last_plot = 0
        sched = DispatchSchedule(self.epochs_per_dispatch)
        self.speculation = {"speculated": 0, "dropped": 0}
        pending = None  # the speculative chunk: (k, outputs)
        while i < num_epochs and not all(s.stopped for s in sups):
            if pending is None:
                k = sched.k_at(i, num_epochs)
                with span("trainer.dispatch", ps):
                    outs = self._epochs_tracked(self._draw_perms(k, n), data)
            else:
                (k, outs), pending = pending, None
            losses_k, vms_k, corrs_k, best_val, best_flat = outs
            # one fetch of every member's chunk metrics (the only host sync
            # of a chunk; a gather over the ranks with a mesh), started
            # before chunk k+1 is enqueued
            with span("trainer.wait_fetch", ps):
                parts = [losses_k, vms_k, best_val] + ([corrs_k] if corrs_k is not None else [])
                fetch = self._fetch_start(parts, [1, 1, 0, 1][:len(parts)])

            # speculate only after a quiet chunk, with chunk k assumed quiet
            k2 = sched.k_at(i + k, num_epochs, quiet=sched.quiet + 1)
            restore = None
            if k2 > 0 and self.speculative_dispatch and sched.quiet >= 1:
                with span("trainer.dispatch", ps):
                    restore = (self.flat.clone(), AdamWState(*(t.clone() for t in self.opt)))
                    outs2 = self._epochs_tracked(self._draw_perms(k2, n), data)
                    self.speculation["speculated"] += 1

            with span("trainer.wait_fetch", ps):
                pieces = fetch()
            losses_k = pieces[0]
            vms_k = pieces[1].astype(np.float64)
            cbv = pieces[2].astype(np.float64)
            if corrs_k is not None:
                eigs_k = np.linalg.eigvalsh(pieces[3])[..., 0]
            else:
                eigs_k = np.ones((k, k_members))

            improved = np.array([sups[m].observe_chunk_best(float(cbv[m])) for m in range(k_members)])
            if improved.any():
                self.best_val_losses = np.array([s.best_val_loss for s in sups])
                # enqueued behind the speculated chunk, not waiting for it
                mask = _to_device(torch.as_tensor(improved[self.local.start:self.local.stop]),
                                  self.device)[:, None]
                self._best_flat = (
                    best_flat if self._best_flat is None
                    else torch.where(mask, best_flat, self._best_flat)
                )
                self._best_dirty |= improved

            def drop_speculation():
                # chunk k+1 ran from superseded params or hypers: the
                # restore point goes back before anything else writes
                nonlocal restore
                if restore is not None:
                    with torch.no_grad():
                        self.flat.copy_(restore[0])
                        for dst, src in zip(self.opt, restore[1]):
                            dst.copy_(src)
                    restore = None
                    self.speculation["dropped"] += 1

            with span("trainer.supervisor", ps):
                intervened = [False] * k_members
                hyper_changed = False
                for j in range(k):
                    for m in range(k_members):
                        batch_losses = losses_k[j, m]
                        train_losses[m].extend(batch_losses.tolist())
                        vm = vms_k[j, m]
                        val_metrics[m].append(vm)
                        action = sups[m].step(i + j, vm, float(batch_losses[-1]),
                                              float(eigs_k[j, m]), suppressed=intervened[m])
                        if action in ("reinit", "reload", "hyper"):
                            drop_speculation()
                        if action == "reinit":
                            self.lrs[m] = sups[m].lr
                            self._reinit_member(m)
                            hyper_changed = intervened[m] = True
                        elif action == "reload":
                            self.lrs[m] = sups[m].lr
                            if not self._load_best_member(m):
                                self._reinit_member(m)
                            self._reset_optimizer(m)
                            hyper_changed = intervened[m] = True
                        elif action == "hyper":
                            self.lrs[m], self.wds[m] = sups[m].lr, sups[m].wd
                            hyper_changed = True
                if hyper_changed:
                    self._set_hypers()
                if all(s.stopped for s in sups):
                    drop_speculation()
                if restore is not None:
                    pending = (k2, outs2)
            sched.observe(any(intervened))

            i += k
            with span("trainer.save", ps):
                self._save(i - 1)
            if (self._plot_first_chunk and last_plot == 0) or i - last_plot >= 500:
                last_plot = i
                with span("trainer.plot", ps):
                    self._plot("training_progress.png", train_losses, val_metrics, nb)

        self.epochs_run = i
        self.graphs["epochs"] = self._program.record()
        self._program = None
        with span("trainer.save", ps):
            self._save(num_epochs - 1, force=True)
        with span("trainer.plot", ps):
            self._plot("trainniing.png", train_losses, val_metrics, nb)
        return train_losses, val_metrics


class Trainer(_MemberStack):
    """One emulator: its spec, params, optimizer and transforms, and the
    supervised training loop (reference ``Predictor``,
    linna/predictor_gpu.py:153-199)."""

    def __init__(
        self,
        spec: N.ModelSpec,
        transforms: TransformSet,
        loss_state: L.LossState,
        outdir: Optional[str] = None,
        seed: int = 1234,
        params: Optional[Dict[str, Any]] = None,
        compute_dtype: Optional[str] = None,
        linearmodel=None,
        device: DeviceLike = None,
    ):
        super().__init__(
            spec, transforms, loss_state, [outdir], [seed],
            params=None if params is None else [params],
            compute_dtype=compute_dtype, linearmodel=linearmodel, device=device,
        )

    @property
    def params(self) -> Dict[str, Any]:
        return self.member_params(0)

    @property
    def best_val_loss(self) -> float:
        return float(self.best_val_losses[0])

    def train(self, train_x, train_y, val_x, val_y, num_epochs: int, batch_size: int,
              **kwargs) -> Tuple[np.ndarray, np.ndarray]:
        """The supervised loop (see ``_MemberStack._train`` for the keyword
        arguments); returns (per-batch train losses, per-epoch val metrics)."""
        losses, vms = self._train(train_x, train_y, val_x, val_y, num_epochs, batch_size, **kwargs)
        return np.array(losses[0]), np.array(vms[0])

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """Physical parameters (B, D) or (D,) -> the emulated data vector in
        sigma-scaled space: x transform -> network + pre-model -> y
        transform."""
        one = x.dim() == 1
        if one:
            x = x[None, :]
        pred = N.apply_model(self.spec, self.params, self.transforms.x_transform(x),
                             linearmodel=self.linearmodel)
        out = self.transforms.y_transform(pred)
        return out[0] if one else out


def lr_range_test(
    trainer: Trainer,
    train_x: np.ndarray,
    train_y: np.ndarray,
    start_lr: float = 1e-4,
    end_lr: float = 5e-3,
    num_iter: int = 100,
    smooth_f: float = 0.05,
    diverge_th: float = 5.0,
    outdir: Optional[str] = None,
) -> float:
    """Exponential lr sweep; the lr at the steepest smoothed-loss descent
    (reference linna/predictor_gpu.py:222-246), read from or persisted to
    ``outdir/lr.npy``.  The batch order comes from
    ``np.random.default_rng(1234)``, so the raw loss trace is the JAX
    package's."""
    if trainer._batch_size is None:
        raise ValueError("set the trainer's batch size (trainer.train sets it) first")
    data = trainer._prepare(train_x, train_y)
    return float(trainer._auto_lr(data, start_lr, end_lr, num_iter, smooth_f, diverge_th,
                                  outdirs=[outdir])[0])


def smooth_and_pick_lr(
    lrs: np.ndarray,
    raw_losses,
    smooth_f: float = 0.05,
    diverge_th: float = 5.0,
):
    """Exponentially smooth a raw lr-sweep loss trace, truncate at the
    divergence threshold, and pick the lr at the steepest smoothed descent,
    skipping the first 10 and last 5 points (torch_lr_finder's convention).
    Returns (lr, smoothed_losses, truncated_lrs)."""
    losses: List[float] = []
    best_loss = np.inf
    for i, loss in enumerate(np.asarray(raw_losses, dtype=np.float64)):
        if i > 0:
            loss = smooth_f * loss + (1 - smooth_f) * losses[-1]
        if loss < best_loss:
            best_loss = loss
        losses.append(float(loss))
        if loss > diverge_th * best_loss:
            break
    lrs = np.asarray(lrs)[: len(losses)]
    skip_start, skip_end = 10, 5
    window = np.array(losses[skip_start : len(losses) - skip_end])
    if len(window) >= 3:
        pick = skip_start + int(np.gradient(window).argmin())
    else:
        pick = int(np.gradient(np.array(losses)).argmin())
    lr = float(lrs[pick])
    if lr > 1.0:
        lr = lr / 100.0
    return lr, losses, lrs
