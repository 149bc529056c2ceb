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

The tensor-parallel half (``make_mesh``, ``replicated``,
``batch_sharding``, ``param_shardings``, ``shard_params``) lays the ranks
out as a ``('data', 'model')`` grid, rank r at row ``r // model`` and column
``r % model`` (JAX's ``devices.reshape(n // n_model, n_model)``).  A
:class:`Sharding` is a ``PartitionSpec``-like tuple over a tensor's
dimensions, each entry None (whole), ``"data"``, ``"model"`` or
``("data", "model")``; a sharded dimension of size n is cut into blocks of
``ceil(n / parts)`` (the last ones shorter, or empty), where GSPMD pads it
to that size: at hidden 1000 and ``model=2`` the 125-wide trunk splits 63 +
62.  The parameter rule is JAX's (Megatron's column/row alternation):
``layer1`` column-parallel (weight and bias on the output dimension); in
each residual block ``lin1`` row-parallel (weight on the input dimension,
bias whole), ``lin2`` and ``skip_w`` column-parallel; ``layer6``
row-parallel; ``layer7``, ``layer8`` and ``linear_bypass`` whole on every
rank.  :mod:`linna_tpu_torch.parallel.dtrain` writes the collectives those
layouts need.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import multihost as MH

__all__ = [
    "EnsembleMesh",
    "make_ensemble_mesh",
    "WalkerShard",
    "walker_shard",
    "Mesh",
    "Sharding",
    "make_mesh",
    "replicated",
    "batch_sharding",
    "param_shardings",
    "shard_params",
]


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


# ------------------------------------------------------ tensor parallelism


def block(n: int, parts: int, i: int) -> slice:
    """Block ``i`` of ``parts`` of a dimension of size ``n``: blocks of
    ``ceil(n / parts)``, the last ones shorter or empty (GSPMD's padded
    split)."""
    c = -(-int(n) // int(parts))
    return slice(min(i * c, n), min((i + 1) * c, n))


class Mesh:
    """The ``('data', 'model')`` grid of ``world`` ranks (see the module
    docstring), seen from ``rank``."""

    def __init__(self, world: int, n_model: int = 1, rank: int = 0):
        if n_model < 1 or world % n_model:
            raise ValueError(f"{world} ranks not divisible by n_model={n_model}")
        self.world, self.model = int(world), int(n_model)
        self.data = self.world // self.model
        self.rank = int(rank)
        self.grid = np.arange(self.world).reshape(self.data, self.model)
        self._groups = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    def coords(self, rank: Optional[int] = None) -> Tuple[int, int]:
        """(data row, model column) of ``rank`` (this rank by default)."""
        return divmod(self.rank if rank is None else int(rank), self.model)

    def index(self, axis) -> Tuple[int, int]:
        """(this rank's position, the number of parts) along a mesh axis or
        a tuple of them (flattened row-major, as a ``P(("data", "model"))``
        dimension)."""
        d, m = self.coords()
        if axis == "data":
            return d, self.data
        if axis == "model":
            return m, self.model
        if tuple(axis) == ("data", "model"):
            return self.rank, self.world
        raise ValueError(f"unknown mesh axis {axis!r}")

    def groups(self) -> Tuple[Any, Any]:
        """(model group, data group) of this rank: the ranks of its grid row
        and of its column.  None for both without a process group, where
        the collectives of :mod:`linna_tpu_torch.parallel.dtrain` are the
        identity; with one, each group makes its collectives at one rank
        too.  Every rank must make the first call at the same point: it
        creates every row's and every column's group."""
        if self._groups is None:
            if MH.backend() is None:
                self._groups = (None, None)
            else:
                name = lambda kind, ranks: kind + str([int(r) for r in ranks]).replace(" ", "")
                rows = [MH.subgroup(row, name("model", row)) for row in self.grid]
                cols = [MH.subgroup(col, name("data", col)) for col in self.grid.T]
                d, m = self.coords()
                self._groups = (rows[d], cols[m])
        return self._groups


def make_mesh(n_model: Optional[int] = None, world: Optional[int] = None,
              rank: Optional[int] = None) -> Mesh:
    """The ``('data', 'model')`` grid over the current process group (or
    ``world`` ranks, seen from ``rank``).  ``n_model``, the tensor-parallel
    size, defaults to 1: pure data parallelism."""
    world = MH.process_count() if world is None else int(world)
    rank = MH.process_index() if rank is None else int(rank)
    return Mesh(world, 1 if n_model is None else int(n_model), rank)


class Sharding(NamedTuple):
    """How a tensor lies on the mesh: ``spec[i]`` shards dimension i over a
    mesh axis (None: whole); dimensions past the spec are whole."""

    mesh: Mesh
    spec: Tuple = ()

    def slices(self, shape) -> Tuple[slice, ...]:
        """This rank's block of a tensor of the full ``shape``."""
        out = []
        for i, n in enumerate(shape):
            axis = self.spec[i] if i < len(self.spec) else None
            if axis is None:
                out.append(slice(None))
            else:
                out.append(block(n, self.mesh.index(axis)[1], self.mesh.index(axis)[0]))
        return tuple(out)

    def take(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of the full tensor ``t`` (a contiguous copy)."""
        return t[self.slices(t.shape)].contiguous().clone()


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def batch_sharding(mesh: Mesh, also_model: bool = False) -> Sharding:
    """A (batch, feature) tensor's rows over ``data`` (or over the whole
    grid, ``("data", "model")``, for work such as walkers that every rank
    splits)."""
    return Sharding(mesh, ((("data", "model") if also_model else "data"), None))


def _linear_sharding(mesh: Mesh, kind: str) -> Dict[str, Sharding]:
    """``col`` shards a weight's output dimension and its bias, ``row`` the
    weight's input dimension (bias whole)."""
    if kind == "col":
        return {"w": Sharding(mesh, (None, "model")), "b": Sharding(mesh, ("model",))}
    return {"w": Sharding(mesh, ("model", None)), "b": Sharding(mesh, ())}


def param_shardings(params: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """The :class:`Sharding` of every leaf of an emulator parameter dict
    (:func:`linna_tpu_torch.nn.init_model`), by JAX's rule."""
    out: Dict[str, Any] = {}
    for name, p in params.items():
        if name == "layer1":
            rule = _linear_sharding(mesh, "col")
        elif name.startswith("rb"):
            rule = {"lin1": _linear_sharding(mesh, "row"), "lin2": _linear_sharding(mesh, "col"),
                    "skip_w": Sharding(mesh, (None, "model"))}
        elif name == "layer6":
            rule = _linear_sharding(mesh, "row")
        else:  # layer7, layer8, linear_bypass
            rule = {k: replicated(mesh) for k in p}
        out[name] = {k: v for k, v in rule.items() if k in p}
    return out


def shard_params(params: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's blocks of a full emulator parameter dict, by
    :func:`param_shardings` (copies; the full dict is left as it is)."""

    def cut(tree, rule):
        return {k: cut(v, rule[k]) if isinstance(v, dict) else rule[k].take(v)
                for k, v in tree.items()}

    return cut(params, param_shardings(params, mesh))
