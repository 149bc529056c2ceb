"""Which rank holds which ensemble members and which walkers.

Counterpart of the ensemble part of ``linna_tpu/parallel/mesh.py``
(``make_ensemble_mesh``, ``member_sharding``): the ranks form an
``(ens, data)`` grid, ``ens = gcd(K, world)``, rank r at row ``r // data``
and column ``r % data`` (JAX's ``devices.reshape(ens, data)``).  Grid row e
holds the contiguous members ``[e K/ens, (e+1) K/ens)``, as ``P("ens")``
shards the stacked member axis, and each of those members' minibatches is
split over the row's ``data`` ranks, which average the gradient in their
own process group.

:class:`WalkerShard` is the sampler's layout (the JAX package's
``shard_over_walkers`` specs): the ensemble is carried as two
half-ensembles, and rank r holds block r of each half, ``half / world``
walkers, ``2 half / world`` in all.  Draws taken for the whole ensemble are
cut to the block; the complementary half is gathered whole once per
half-update.

The tensor-parallel ``make_mesh`` / ``param_shardings`` / ``shard_params``
of the JAX module are not ported.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import multihost as MH

__all__ = ["EnsembleMesh", "make_ensemble_mesh", "WalkerShard", "walker_shard"]


class EnsembleMesh:
    """The ``(ens, data)`` grid of ``world`` ranks for ``n_members``
    stacked members (see the module docstring)."""

    def __init__(self, n_members: int, world: int):
        if n_members < 1 or world < 1:
            raise ValueError(f"{n_members} members over {world} ranks")
        self.n_members = int(n_members)
        self.world = int(world)
        self.ens = math.gcd(self.n_members, self.world)
        self.data = self.world // self.ens
        self.grid = np.arange(self.world).reshape(self.ens, self.data)

    @property
    def shape(self) -> Dict[str, int]:
        return {"ens": self.ens, "data": self.data}

    def coords(self, rank: int) -> Tuple[int, int]:
        """(ens row, data column) of ``rank``."""
        return divmod(int(rank), self.data)

    def members(self, rank: int) -> range:
        """The contiguous block of members ``rank`` holds."""
        per = self.n_members // self.ens
        e = self.coords(rank)[0]
        return range(e * per, (e + 1) * per)

    def row_leaders(self) -> List[int]:
        """One rank of each grid row (its data column 0), in member order."""
        return [int(r) for r in self.grid[:, 0]]

    def batch_slice(self, rank: int, n: int) -> slice:
        """``rank``'s contiguous share of an ``n``-row minibatch (the first
        ``n % data`` columns take one row more)."""
        d = self.coords(rank)[1]
        base, extra = divmod(int(n), self.data)
        start = d * base + min(d, extra)
        return slice(start, start + base + (d < extra))

    def data_group(self, rank: int):
        """The process group of ``rank``'s grid row (None when ``data`` is
        1: no rank shares a member).  Every rank must call this at the same
        point the first time: it creates every row's group."""
        if self.data == 1 or not MH.process_count() > 1:
            return None
        groups = [MH.subgroup(row, "data" + str([int(r) for r in row]).replace(" ", ""))
                  for row in self.grid]
        return groups[self.coords(rank)[0]]

    def gather_members(self, tensors: Sequence[torch.Tensor], axes: Sequence[int]
                       ) -> List[np.ndarray]:
        """Host numpy of every member: ``tensors[i]`` holds this rank's
        members along ``axes[i]``; one all-gather over the world brings each
        grid row's (from its column 0) and they are put in member order."""
        per_rank = MH.gather_packed(tensors)
        if len(per_rank) == 1:
            return per_rank[0]
        rows = [per_rank[r] for r in self.row_leaders()]
        return [np.concatenate([row[i] for row in rows], axis=ax) for i, ax in enumerate(axes)]


def make_ensemble_mesh(n_members: int, world: Optional[int] = None) -> EnsembleMesh:
    """The ``(ens, data)`` grid for ``n_members`` over ``world`` ranks (the
    current process group's size by default).  On 8 ranks: K=4 ->
    (4, 2), each member on its own 2-rank data group; K=1 -> (1, 8), pure
    data parallelism."""
    return EnsembleMesh(n_members, MH.process_count() if world is None else world)


class WalkerShard(NamedTuple):
    """This rank's block of the ensemble (see the module docstring)."""

    rank: int
    world: int
    nwalkers: int

    @property
    def half(self) -> int:
        return self.nwalkers // 2

    @property
    def local(self) -> int:
        """Walkers on this rank."""
        return 2 * (self.half // self.world)

    @property
    def block(self) -> slice:
        """This rank's block of a half-ensemble."""
        hb = self.half // self.world
        return slice(self.rank * hb, (self.rank + 1) * hb)

    def take(self, t: Union[torch.Tensor, np.ndarray], dim: int = 0):
        """This rank's walkers of a whole-ensemble ``t`` (walkers on ``dim``)."""
        shape = tuple(t.shape)
        two = t.reshape(shape[:dim] + (2, self.half) + shape[dim + 1:])
        idx = (slice(None),) * (dim + 1) + (self.block,)
        return two[idx].reshape(shape[:dim] + (self.local,) + shape[dim + 1:])

    def gather_half(self, x: torch.Tensor) -> torch.Tensor:
        """A whole half-ensemble from every rank's block ``x`` (walkers on
        axis 0): one all-gather."""
        return torch.cat(MH.all_gather(x), dim=0)

    def gather(self, tensors: Sequence[torch.Tensor], dims) -> List[np.ndarray]:
        """Host numpy of the whole ensemble from this rank's walkers of each
        tensor (walkers on ``dims[i]``, or on ``dims`` for all); 0-d
        tensors are replicated and returned as they are.  One all-gather."""
        dims = [dims] * len(tensors) if isinstance(dims, int) else list(dims)
        sharded = [i for i, t in enumerate(tensors) if t.dim() > 0]
        out = [None if t.dim() > 0 else t.detach().cpu().numpy() for t in tensors]
        if not sharded:
            return out
        per_rank = MH.gather_packed([tensors[i] for i in sharded])
        for j, i in enumerate(sharded):
            d = dims[i]
            parts = []
            for pieces in per_rank:
                a = pieces[j]
                parts.append(a.reshape(a.shape[:d] + (2, a.shape[d] // 2) + a.shape[d + 1:]))
            whole = np.concatenate(parts, axis=d + 1)
            out[i] = whole.reshape(whole.shape[:d] + (self.nwalkers,) + whole.shape[d + 2:])
        return out


def walker_shard(nwalkers: int, world: Optional[int] = None, rank: Optional[int] = None
                 ) -> WalkerShard:
    """The current rank's block of ``nwalkers`` walkers; each half-ensemble
    must divide over the ranks."""
    world = MH.process_count() if world is None else int(world)
    rank = MH.process_index() if rank is None else int(rank)
    if nwalkers % (2 * world):
        raise ValueError(
            f"half-ensemble size {nwalkers // 2} must divide over the {world}-rank walker mesh"
        )
    return WalkerShard(rank, world, int(nwalkers))
