"""Tensor-parallel training of one emulator over the ``('data', 'model')``
grid.

Counterpart of ``linna_tpu/parallel/dtrain.py`` (test-only there: nothing
in ``ml_sampler_core`` reaches it, and nothing here does).  JAX writes
sharding annotations and GSPMD inserts the collectives; the port writes
them by hand, as ``autograd.Function``s whose backward is the conjugate
collective over the rank's ``model`` group:

- after a row-parallel product (``lin1`` of each residual block,
  ``layer6``) the ranks' partial sums are all-reduced, and the whole bias is
  added once, after the sum; the backward is the identity;
- the whole input of a column-parallel product that every rank holds
  (``lin2``'s) passes forward as it is, and its gradient, each rank's share,
  is all-reduced in the backward;
- the skip projection ``skip_w`` is column-parallel on a sharded block
  input, which it needs whole: the blocks are all-gathered forward (padded
  to the common block size, GSPMD's uneven split), and the backward
  all-reduces the gradient of the whole input and keeps this rank's block.

Each minibatch is split over the ``data`` ranks (every rank is handed the
whole minibatch and takes its block of rows); each rank sums its rows'
losses over the whole minibatch size and one all-reduce over the ``data``
group sums the gradient with the loss beside it.  Parameters outside the
model-parallel products (``layer7``, ``layer8``, the row-parallel biases)
get the same gradient on every rank of a model group.

The optimizer is the port's functional AdamW
(:func:`linna_tpu_torch.train.adamw_step_`, ``optax.adamw``'s arithmetic)
on this rank's parameters, concatenated into one (1, P) row per step; the
parameters are updated in place and returned (JAX donates and returns new
ones).  With no process group every collective is the identity and the
step is one rank's whole step; with a group, each collective runs at one
rank too.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from .. import losses as L
from .. import nn as N
from ..device import DeviceLike, resolve_device
from ..train import AdamWState, _walk, adamw_init, adamw_step_
from ..transforms import TransformSet
from . import multihost as MH
from .mesh import Mesh, block, param_shardings, shard_params

__all__ = [
    "AdamW",
    "adamw",
    "sharded_apply",
    "make_sharded_train_step",
    "make_sharded_epoch",
    "init_sharded",
    "gather_params",
]


class AdamW(NamedTuple):
    """The hyperparameters of ``optax.adamw(learning_rate, weight_decay)``."""

    learning_rate: float = 1e-3
    weight_decay: float = 1e-4


def adamw(learning_rate: float, weight_decay: float = 1e-4) -> AdamW:
    return AdamW(float(learning_rate), float(weight_decay))


# ------------------------------------------------------------ collectives


class _ToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return MH.all_reduce(g.contiguous().clone(), group=ctx.group), None


class _FromModel(torch.autograd.Function):
    """The partial sums added over the model group; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return MH.all_reduce(x.contiguous().clone(), group=group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherModel(torch.autograd.Function):
    """The last dimension's blocks of every rank of the model group, whole;
    the backward sums the whole gradient over the group and keeps this
    rank's block."""

    @staticmethod
    def forward(ctx, x, group, width, parts, index):
        ctx.group, ctx.cut = group, block(width, parts, index)
        c = -(-width // parts)
        pad = torch.nn.functional.pad(x, (0, c - x.shape[-1])).contiguous()
        pieces = MH.all_gather(pad, group=group)
        return torch.cat([p[..., :block(width, parts, i).stop - block(width, parts, i).start]
                          for i, p in enumerate(pieces)], dim=-1)

    @staticmethod
    def backward(ctx, g):
        whole = MH.all_reduce(g.contiguous().clone(), group=ctx.group)
        return whole[..., ctx.cut], None, None, None, None


def _to_model(x, group):
    return x if group is None else _ToModel.apply(x, group)


def _from_model(x, group):
    return x if group is None else _FromModel.apply(x, group)


def _gather_model(x, group, mesh: Mesh, width: int):
    if group is None:
        return x
    index, parts = mesh.index("model")
    return _GatherModel.apply(x, group, int(width), parts, index)


# ---------------------------------------------------------------- forward


def sharded_apply(spec: N.ModelSpec, params: Dict[str, Any], x: torch.Tensor, mesh: Mesh
                  ) -> torch.Tensor:
    """The network on this rank's parameter blocks
    (:func:`linna_tpu_torch.parallel.mesh.shard_params`): the whole output
    for rows ``x`` (every rank of a model group passes the same rows), as
    :func:`linna_tpu_torch.nn.apply_model` computes it, up to the order of
    the row-parallel sums."""
    group = mesh.groups()[0]
    widths = spec.widths
    s = torch.relu(N._linear(params["layer1"], _to_model(x, group)))
    for rb, width in zip(("rb1", "rb2", "rb3"), widths[:3]):
        p = params[rb]
        h = torch.relu(_from_model(s @ p["lin1"]["w"], group) + p["lin1"]["b"])
        whole = _gather_model(s, group, mesh, width)
        lin2 = N._linear(p["lin2"], _to_model(h, group))
        s = torch.relu(N._affine(N._scaled(lin2, 0.1), whole, p["skip_w"]))
    s = torch.relu(_from_model(s @ params["layer6"]["w"], group) + params["layer6"]["b"])
    s = torch.relu(N._linear(params["layer7"], s))
    out = N._linear(params["layer8"], s)
    if spec.linear_bypass:
        out = out + N._scaled(N._linear(params["linear_bypass"], x), 1e-3)
    return out


# ------------------------------------------------------------------ steps


def _leaves(params: Dict[str, Any]) -> List[torch.Tensor]:
    return [leaf for _, leaf in _walk(params)]


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                           dtype=torch.float32).to(device)


def make_sharded_train_step(
    spec: N.ModelSpec,
    transforms: TransformSet,
    loss_state: L.LossState,
    optimizer: AdamW,
    mesh: Mesh,
) -> Callable:
    """``step(params, opt_state, bx, by) -> (params, opt_state, loss)``:
    one AdamW step of this rank's parameter blocks on the minibatch
    ``bx``/``by`` (every rank passes the whole minibatch and takes its
    ``data`` block of rows); ``loss`` is the whole minibatch's mean."""
    model_group, data_group = mesh.groups()

    def step(params, opt_state: AdamWState, bx, by):
        leaves = _leaves(params)
        dev = leaves[0].device
        bx, by = _f32(bx, dev), _f32(by, dev)
        bs = bx.shape[0]
        d, n_data = mesh.index("data")
        rows = block(bs, n_data, d)
        live = [v.detach().requires_grad_(True) for v in leaves]
        tree = _rebuild(params, iter(live))
        pred = sharded_apply(spec, tree, transforms.x_transform(bx[rows]), mesh)
        per_row = L.chi2_ratio(loss_state, pred, *L.target_terms(loss_state, transforms, by[rows]))
        loss = per_row.sum() / bs
        grads = torch.autograd.grad(loss, live)
        grad = torch.cat([g.reshape(-1) for g in grads] + [loss.detach().reshape(1)])[None]
        if data_group is not None:
            grad = MH.all_reduce(grad, group=data_group)
        with torch.no_grad():
            flat = torch.cat([v.reshape(-1) for v in leaves])[None]
            lr = torch.full((1, 1), optimizer.learning_rate, device=dev)
            wd = torch.full((1, 1), optimizer.weight_decay, device=dev)
            adamw_step_(flat, grad[:, :-1], opt_state, lr, wd)
            for v, new in zip(leaves, torch.split(flat[0], [v.numel() for v in leaves])):
                v.copy_(new.view_as(v))
        return params, opt_state, grad[0, -1]

    return step


def _rebuild(tree, leaves):
    return {k: _rebuild(v, leaves) if isinstance(v, dict) else next(leaves)
            for k, v in tree.items()}


def make_sharded_epoch(
    spec: N.ModelSpec,
    transforms: TransformSet,
    loss_state: L.LossState,
    optimizer: AdamW,
    mesh: Mesh,
    batch_size: int,
) -> Callable:
    """``epoch(params, opt_state, perm, train_x, train_y, val_x, val_y) ->
    (params, opt_state, batch_losses, val_metric)``: the minibatch steps in
    the order of ``perm`` (the epoch's permutation of the training rows,
    cut to ``nb * batch_size``; a ``torch.Generator`` draws one), then the
    validation metric of every validation row.  JAX's epoch draws its
    permutation from a key; a test hands both the same one."""
    step = make_sharded_train_step(spec, transforms, loss_state, optimizer, mesh)
    bs = int(batch_size)

    def epoch(params, opt_state, perm, train_x, train_y, val_x, val_y):
        dev = _leaves(params)[0].device
        train_x, train_y = _f32(train_x, dev), _f32(train_y, dev)
        n = train_x.shape[0]
        nb = max(n // bs, 1)
        if isinstance(perm, torch.Generator):
            perm = torch.randperm(n, generator=perm)
        order = torch.as_tensor(np.asarray(perm) if not torch.is_tensor(perm) else perm)
        order = order[: nb * bs].reshape(nb, bs).to(dev)
        losses = torch.empty(nb, device=dev)
        for b in range(nb):
            params, opt_state, losses[b] = step(params, opt_state, train_x[order[b]],
                                                train_y[order[b]])
        with torch.no_grad():
            vx = transforms.x_transform(_f32(val_x, dev))
            pred = sharded_apply(spec, params, vx, mesh)
            vm = L.val_metric_fn(loss_state, transforms, pred, _f32(val_y, dev))
        return params, opt_state, losses, vm

    return epoch


def init_sharded(
    seed: int,
    spec: N.ModelSpec,
    optimizer: AdamW,
    mesh: Mesh,
    device: DeviceLike = None,
) -> Tuple[Dict[str, Any], AdamWState]:
    """Every rank builds the whole model from ``seed`` (the same weights on
    every rank, :func:`linna_tpu_torch.nn.init_model`) and keeps its blocks,
    with a fresh AdamW state for them (``optimizer`` is what the steps
    use)."""
    del optimizer  # AdamW's state does not depend on its hyperparameters
    device = resolve_device(device)
    params = shard_params(N.init_model(spec, seed=seed, device=device), mesh)
    n = sum(v.numel() for v in _leaves(params))
    return params, adamw_init(torch.zeros((1, n), device=device))


def gather_params(spec: N.ModelSpec, params: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """The whole parameter dict as host numpy, on every rank, from every
    rank's blocks: one all-gather of their bytes over the world, each block
    padded to rank 0's (the largest) and cut back; the first data row's
    blocks are put together."""
    full = _map(N.init_model(spec, seed=0, device="cpu"),
                lambda t: np.zeros(tuple(t.shape), np.float32))
    rules = [param_shardings(full, Mesh(mesh.world, mesh.model, rank=r)) for r in range(mesh.model)]
    padded = []
    for (_, dst), (_, sh), (_, v) in zip(_walk(full), _walk(rules[0]), _walk(params)):
        big = torch.zeros(tuple(len(range(*s.indices(n))) for s, n in
                                zip(sh.slices(dst.shape), dst.shape)), device=v.device)
        big[tuple(slice(0, n) for n in v.shape)] = v.detach()
        padded.append(big)
    per_rank = MH.gather_packed(padded)
    for r, rule in enumerate(rules):
        for (_, dst), (_, sh), got in zip(_walk(full), _walk(rule), per_rank[r]):
            cut = sh.slices(dst.shape)
            dst[cut] = got[tuple(slice(0, len(range(*s.indices(n))))
                                 for s, n in zip(cut, dst.shape))]
    return full


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}
