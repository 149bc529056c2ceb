"""Multi-process runs with ``torch.distributed``: initialize, the primary's
write gate, barrier, broadcast and fetch.

Counterpart of ``linna_tpu/parallel/multihost.py``.  Execution model: every
rank runs the same program (the driver, the orchestrator loop, the sharded
training and sampling), and every host decision is taken from values that
are identical on every rank: gathered with :func:`fetch`, or read by the
primary and shipped with :func:`broadcast` / :func:`broadcast_from_primary`
/ :func:`primary_flag`.  Only rank 0 touches the run directory, and
:func:`barrier` separates its writes from the next phase's reads.

A run that never called :func:`initialize` (or that found no cluster in its
arguments or environment) makes no ``torch.distributed`` call: every helper
is then the identity.  Once a process group exists, every helper makes its
collective, at world size 1 too.

The backend is the caller's: ``nccl`` for a CUDA device, ``gloo`` for the
CPU, and ``gloo`` on a CUDA device only when the caller asks for it (two
ranks sharing one card, which NCCL refuses).  gloo takes the CUDA tensors
of ``all_reduce`` and ``all_gather`` itself (it copies them through host
memory); host values (flags, pickled payloads, gathers bound for numpy) are
exchanged from host tensors under gloo and from the card under nccl.

Every collective of the package goes through this module, directly or from
:mod:`linna_tpu_torch.parallel.mesh`, and is counted by kind and by group
(:func:`collective_counts`), which :mod:`linna_tpu_torch.parallel.census`
reads.
"""

from __future__ import annotations

import collections
import functools
import os
import pickle
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

__all__ = [
    "initialize",
    "shutdown",
    "process_count",
    "process_index",
    "is_primary",
    "primary_only",
    "barrier",
    "broadcast",
    "broadcast_from_primary",
    "primary_flag",
    "fetch",
    "all_gather",
    "all_reduce",
    "collective_counts",
    "reset_collective_counts",
    "subgroup",
    "backend",
]

# the JAX package's manual-cluster variables
ENV_COORDINATOR = "LINNA_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "LINNA_NUM_PROCESSES"
ENV_PROCESS_ID = "LINNA_PROCESS_ID"
BACKENDS = ("nccl", "gloo")

_counts: "collections.Counter[str]" = collections.Counter()
_group_names: Dict[int, str] = {}
_groups: Dict[tuple, Any] = {}


def _dist():
    import torch.distributed as dist

    return dist


def _active() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def _cluster_from_env():
    """(coordinator, world, rank) from the ``LINNA_*`` variables, else from
    torchrun's ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``."""
    coord = os.environ.get(ENV_COORDINATOR)
    nproc = os.environ.get(ENV_NUM_PROCESSES)
    pid = os.environ.get(ENV_PROCESS_ID)
    if coord is None and nproc is None and pid is None and "RANK" in os.environ:
        if "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
            coord = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        nproc, pid = os.environ.get("WORLD_SIZE"), os.environ["RANK"]
    return coord, None if nproc is None else int(nproc), None if pid is None else int(pid)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: DeviceLike = None,
) -> bool:
    """Join the process group; True when the run has more than one rank.

    The decision is taken from the arguments and the environment alone
    (arguments first, then ``LINNA_COORDINATOR_ADDRESS`` /
    ``LINNA_NUM_PROCESSES`` / ``LINNA_PROCESS_ID``, then torchrun's
    variables).  With none of them this is a single-process run and nothing
    is called (returns False).  A cluster named in part raises: this rank
    would write the run directory as its own primary while the others wait
    for it.  ``backend`` defaults to ``nccl`` on a CUDA ``device`` (the
    card by default) and ``gloo`` on the CPU; ``gloo`` on a CUDA device is
    taken only when asked for.  A failed init raises.  Idempotent."""
    if _active():
        return process_count() > 1
    env_coord, env_nproc, env_pid = _cluster_from_env()
    coordinator_address = coordinator_address or env_coord
    num_processes = num_processes if num_processes is not None else env_nproc
    process_id = process_id if process_id is not None else env_pid
    if coordinator_address is None and num_processes is None and process_id is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            f"{ENV_COORDINATOR}/{ENV_NUM_PROCESSES}/{ENV_PROCESS_ID} are set in part "
            f"(coordinator {coordinator_address!r}, processes {num_processes!r}, id "
            f"{process_id!r}); a manual cluster needs all three"
        )
    device = resolve_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, not {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    _dist().init_process_group(
        backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes),
        rank=int(process_id),
    )
    _State.device = device
    return process_count() > 1


class _State:
    # the device this rank computes on (nccl exchanges its tensors)
    device: Optional[torch.device] = None


def shutdown() -> None:
    """Leave the process group (no-op without one)."""
    if _active():
        _dist().destroy_process_group()
    _group_names.clear()
    _groups.clear()
    _State.device = None


def backend(group=None) -> Optional[str]:
    """The process group's backend, or None in a single-process run."""
    return str(_dist().get_backend(group)) if _active() else None


def process_count() -> int:
    return _dist().get_world_size() if _active() else 1


def process_index() -> int:
    return _dist().get_rank() if _active() else 0


def is_primary() -> bool:
    """True on rank 0, the only rank that writes the run directory."""
    return process_index() == 0


def primary_only(fn: Callable) -> Callable:
    """Run ``fn`` on rank 0 only (None elsewhere)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not is_primary():
            return None
        return fn(*args, **kwargs)

    return wrapper


# ------------------------------------------------------------- collectives


def subgroup(ranks: Sequence[int], name: str):
    """The process group of ``ranks``, counted as ``name``; created at the
    first call for that name and those ranks, which every rank must make,
    in the same order."""
    key = (tuple(int(r) for r in ranks), name)
    if key not in _groups:
        _groups[key] = _dist().new_group(list(key[0]))
        _group_names[id(_groups[key])] = name
    return _groups[key]


def _count(kind: str, group) -> None:
    _counts[f"{kind}@{_group_names.get(id(group), 'world')}"] += 1


def collective_counts() -> Dict[str, int]:
    """Collectives made since the last reset, as ``{"kind@group": n}``."""
    return dict(_counts)


def reset_collective_counts() -> None:
    _counts.clear()


def _comm_device(group=None) -> torch.device:
    """Where host values are put for a collective: the card under nccl,
    the host under gloo."""
    if backend(group) == "nccl":
        return _State.device
    return torch.device("cpu")


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over the group's ranks, in place; returns ``t``."""
    if not _active():
        return t
    _count("all_reduce", group)
    _dist().all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's ``t`` (same shape and type on all), in rank order."""
    if not _active():
        return [t]
    _count("all_gather", group)
    n = _dist().get_world_size(group)
    src = t.contiguous()
    out = [torch.empty_like(src) for _ in range(n)]
    _dist().all_gather(out, src, group=group)
    return out


def _broadcast_tensor(t: torch.Tensor, group=None) -> torch.Tensor:
    _count("broadcast", group)
    _dist().broadcast(t, src=0, group=group)
    return t


def barrier(name: str = "barrier") -> None:
    """Block until every rank reaches this point (no-op single-process).
    Every rank must pass the same ``name``, as JAX's
    ``sync_global_devices(name)`` checks: ranks that meet at different
    barriers took different branches, and raise here."""
    if not _active():
        return
    _count("barrier", None)
    tag = torch.tensor([zlib.crc32(name.encode())], dtype=torch.int64, device=_comm_device())
    out = [torch.empty_like(tag) for _ in range(process_count())]
    _dist().all_gather(out, tag)
    tags = [int(t.item()) for t in out]  # the host waits for the exchange
    if len(set(tags)) != 1:
        raise RuntimeError(f"barrier {name!r}: the ranks met at different barriers "
                           f"(name checksums {tags})")


def broadcast(x: Any) -> np.ndarray:
    """Rank 0's numpy value -> every rank (the same shape and type must be
    passed everywhere).  Single-process: the value itself."""
    if not _active():
        return x
    t = torch.from_numpy(np.array(x)).to(_comm_device())
    return _broadcast_tensor(t).cpu().numpy()


def broadcast_from_primary(load_fn: Callable[[], Any]) -> Any:
    """``load_fn()`` evaluated on rank 0 only; every rank gets the result
    bit for bit.

    The way a file on the primary's disk becomes state every rank computes
    with: no other rank opens the file, so a lagging view of a shared
    filesystem can neither fail a read nor give a rank other numbers (and
    a diverged rank deadlocks the next collective).  The payload is a
    pickled byte buffer: arbitrary structure, float64 exact.  These are
    bytes this program's own rank 0 wrote, never a file.  Single-process:
    ``load_fn()``."""
    if not _active():
        return load_fn()
    dev = _comm_device()
    payload = pickle.dumps(load_fn(), protocol=pickle.HIGHEST_PROTOCOL) if is_primary() else b""
    n = int(_broadcast_tensor(torch.tensor([len(payload)], dtype=torch.int64, device=dev)).item())
    buf = torch.zeros(n, dtype=torch.uint8)
    if is_primary():
        buf.copy_(torch.frombuffer(bytearray(payload), dtype=torch.uint8))
    buf = _broadcast_tensor(buf.to(dev)).cpu()
    return pickle.loads(buf.numpy().tobytes())


def primary_flag(value: bool) -> bool:
    """Rank 0's boolean (a filesystem gate, typically) -> every rank.

    An ``os.path.isfile`` taken before collective work must agree on every
    rank, or one rank enters a collective the others skip.  Evaluate the
    condition, pass it here, and branch on the returned primary view."""
    return bool(np.asarray(broadcast(np.int32(bool(value)))))


Tensors = Union[torch.Tensor, Sequence[torch.Tensor]]


def _pack(tensors: Sequence[torch.Tensor], device=None) -> torch.Tensor:
    return torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8).to(device)
                      for t in tensors])


def _unpack(buf: torch.Tensor, like: Sequence[torch.Tensor]) -> List[np.ndarray]:
    buf = buf.cpu().numpy()
    pieces, off = [], 0
    for t in like:
        nbytes = t.numel() * t.element_size()
        pieces.append(buf[off:off + nbytes].view(_NP_TYPES[t.dtype]).reshape(t.shape))
        off += nbytes
    return pieces


def to_host(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """``tensors`` as host numpy, in one copy from the device."""
    return _unpack(_pack(tensors), tensors)


def to_host_async(tensors: Sequence[torch.Tensor]) -> Callable[[], List[np.ndarray]]:
    """Start the copy of ``tensors`` to the host; returns the function that
    waits for it and gives the numpy arrays.  CUDA tensors go, in one
    ``non_blocking`` copy enqueued on the current stream now, to pinned host
    memory, and the wait is on an event recorded behind that copy, so work
    enqueued after this call does not delay it.  Other tensors are copied
    now."""
    if not tensors or not tensors[0].is_cuda:
        host = to_host(tensors)
        return lambda: host
    packed = _pack(tensors)
    buf = torch.empty(packed.shape, dtype=torch.uint8, pin_memory=True)
    buf.copy_(packed, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def wait() -> List[np.ndarray]:
        done.synchronize()
        return _unpack(buf, tensors)

    return wait


def gather_packed(tensors: Sequence[torch.Tensor], group=None) -> List[List[np.ndarray]]:
    """Every rank's ``tensors`` (the same shapes and types on all) as host
    numpy, indexed [rank][i], through ONE all-gather of their bytes
    (single-process: this rank's, in one copy)."""
    if not _active():
        return [to_host(tensors)]
    return [_unpack(buf, tensors)
            for buf in all_gather(_pack(tensors, _comm_device(group)), group)]


_NP_TYPES = {
    torch.float32: np.float32, torch.float64: np.float64, torch.int32: np.int32,
    torch.int64: np.int64, torch.bool: np.bool_, torch.uint8: np.uint8,
    torch.float16: np.float16,
}


def fetch(x: Tensors, shard=None, dim: Union[int, Sequence[int]] = 0):
    """Device tensor(s) -> host numpy, the same on every rank.

    ``shard`` (a :class:`linna_tpu_torch.parallel.mesh.WalkerShard`) marks
    walker-sharded tensors: each holds this rank's walkers along axis
    ``dim`` (one per tensor when a sequence), and all of them come back
    whole through one all-gather (0-d tensors are replicated and returned
    as they are).  Without ``shard``: a copy to the host."""
    single = torch.is_tensor(x)
    xs = [x] if single else list(x)
    if shard is None:
        out = [t.detach().cpu().numpy() for t in xs]
    else:
        out = shard.gather(xs, dim)
    return out[0] if single else tuple(out)
