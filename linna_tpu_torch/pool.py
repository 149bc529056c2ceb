"""Host-side task pools for external theory-model evaluation (a copy of the
JAX package's ``pool.py``; mpi4py is imported only by :class:`MPIPool`).

Role split in the accelerator design: everything the reference used its MPI pool for
*inside* MCMC (per-walker likelihoods, linna/sampler.py:493-503) now runs
on the device as batched tensors — no host pool at all.  What remains host-side is
the embarrassingly-parallel fan-out of the *external* theory code (cosmology
C libraries etc.) when generating training data, which the reference farms
over 128 MPI ranks (reference ``chtoPool``/``chtoMultiprocessPool``,
linna/util.py:100-289, SURVEY §2.8).

Pools here present the same duck type (``map``, ``is_master``, ``bcast``,
``noduplicate``/``noduplicate_close``) so orchestrator code is agnostic:

- :class:`SerialPool` — in-process map (tests, laptops).
- :class:`MultiprocessPool` — fork-based pool for one host.
- :class:`MPIPool` — master/worker farm over mpi4py when available, with the
  reference's ``noduplicate`` function-broadcast optimization (send the
  callable once, then only arguments — linna/util.py:143-158,200-240).
"""

from __future__ import annotations

import multiprocessing
import pickle
from typing import Any, Callable, Iterable, List

__all__ = ["SerialPool", "MultiprocessPool", "MPIPool", "make_pool"]


class SerialPool:
    """In-process pool (no parallelism)."""

    noduplicate = False

    def is_master(self) -> bool:
        return True

    def map(self, fn: Callable, tasks: Iterable) -> List[Any]:
        return [fn(t) for t in tasks]

    def bcast(self, fn: Callable, args: Any = None) -> None:
        pass

    def noduplicate_close(self) -> None:
        pass

    def close(self) -> None:
        pass

    def wait(self) -> None:
        pass


class MultiprocessPool:
    """Single-host process pool (reference ``chtoMultiprocessPool``,
    linna/util.py:258-289).  Order-preserving map.

    Workers are started with a forkserver (spawn fallback) context rather
    than fork: PyTorch is multithreaded once imported and a CUDA context
    does not survive a fork, and forking a multithreaded process can
    deadlock the child — callables must be picklable, which MPI parity
    already requires."""

    noduplicate = False

    def __init__(self, processes: int | None = None):
        try:
            ctx = multiprocessing.get_context("forkserver")
        except ValueError:  # pragma: no cover - platform dependent
            ctx = multiprocessing.get_context("spawn")
        self._pool = ctx.Pool(processes=processes)

    def is_master(self) -> bool:
        return True

    def map(self, fn: Callable, tasks: Iterable) -> List[Any]:
        try:
            return self._pool.map(fn, list(tasks))
        except (AttributeError, TypeError, pickle.PicklingError) as e:
            # lambdas/closures pickled fine under the old fork start method
            # but fail under forkserver/spawn — surface the contract instead
            # of a bare pickling traceback deep inside the pipeline
            if "pickl" not in repr(e).lower():
                raise
            raise RuntimeError(
                f"MultiprocessPool workers use a forkserver/spawn start "
                f"method (fork deadlocks under multithreaded PyTorch), so the "
                f"mapped callable must be picklable — a module-level "
                f"function, not a lambda or closure (got {fn!r})"
            ) from e

    def bcast(self, fn: Callable, args: Any = None) -> None:
        pass

    def noduplicate_close(self) -> None:
        pass

    def close(self) -> None:
        self._pool.close()
        self._pool.join()

    def wait(self) -> None:
        pass


class _TaskError:
    """A worker-side exception shipped back to the master (picklable)."""

    def __init__(self, message: str):
        self.message = message


class MPIPool:
    """Master/worker task farm over mpi4py (reference ``chtoPool``,
    linna/util.py:100-257).

    Master sends ``(func, task_index, arg)`` per task on a fixed tag (the
    reference used the raw task index as the MPI tag, which exceeds the
    guaranteed MPI_TAG_UB of 32767 for flagship-scale task lists — the index
    rides in the payload instead) and matches replies by the echoed index.
    With ``noduplicate`` enabled the function object is transmitted once per
    worker and subsequent tasks carry a sentinel telling the worker to reuse
    it — the reference's optimization for shipping a large emulator to
    workers only once; a DIFFERENT callable in a later ``map`` automatically
    invalidates the cache (the reference silently ran the stale function
    unless the caller remembered ``noduplicate_close``).  A worker exception
    is caught, shipped back, and re-raised on the master — the reference's
    worker died silently and the master deadlocked waiting for its reply.
    Workers loop in :meth:`wait` until they receive ``None``.
    """

    _REUSE = "__noduplicate__"
    _RESET = "__reset__"

    def __init__(self, comm=None, mpi=None):
        """``comm``/``mpi`` are injectable for testing the master/worker
        protocol with a fake communicator (no mpi4py ranks needed): ``comm``
        must duck-type ``Get_rank``/``Get_size``/``send``/``recv`` and
        ``mpi`` must expose ``Status``/``ANY_SOURCE``/``ANY_TAG``."""
        if comm is None or mpi is None:
            try:
                from mpi4py import MPI
            except ImportError as e:  # pragma: no cover - environment dependent
                raise ImportError("MPIPool requires mpi4py") from e
            mpi = mpi if mpi is not None else MPI
            comm = comm if comm is not None else MPI.COMM_WORLD
        self._mpi = mpi
        self.comm = comm
        self.rank = self.comm.Get_rank()
        self.size = self.comm.Get_size()
        if self.size < 2:
            raise ValueError("MPIPool needs at least 2 ranks")
        self.noduplicate = False
        self._workers_have_func: set[int] = set()
        self._nd_func: Any = None

    def is_master(self) -> bool:
        return self.rank == 0

    def map(self, fn: Callable, tasks: Iterable) -> List[Any]:
        if not self.is_master():
            self.wait()
            return []
        if self.noduplicate and fn is not self._nd_func:
            # a different callable than the one workers cached: resend it
            self._workers_have_func.clear()
            self._nd_func = fn
        tasks = list(tasks)
        n_workers = self.size - 1
        results: List[Any] = [None] * len(tasks)
        next_task = 0
        in_flight = {}
        # prime
        for w in range(1, min(n_workers, len(tasks)) + 1):
            self._send_task(fn, tasks[next_task], w, next_task)
            in_flight[w] = next_task
            next_task += 1
        while in_flight:
            status = self._mpi.Status()
            idx, result = self.comm.recv(
                source=self._mpi.ANY_SOURCE, tag=self._mpi.ANY_TAG, status=status
            )
            w = status.Get_source()
            if isinstance(result, _TaskError):
                # drain the other workers' in-flight replies before raising:
                # leaving them queued would corrupt the next map() on this
                # pool (a stale (idx, result) pair would be consumed as if it
                # belonged to the new task list)
                err = RuntimeError(
                    f"MPI worker {w} failed on task {idx}:\n{result.message}"
                )
                del in_flight[w]
                while in_flight:
                    drain_status = self._mpi.Status()
                    self.comm.recv(
                        source=self._mpi.ANY_SOURCE,
                        tag=self._mpi.ANY_TAG,
                        status=drain_status,
                    )
                    in_flight.pop(drain_status.Get_source(), None)
                raise err
            results[idx] = result
            if next_task < len(tasks):
                self._send_task(fn, tasks[next_task], w, next_task)
                in_flight[w] = next_task
                next_task += 1
            else:
                del in_flight[w]
        return results

    def _send_task(self, fn, arg, worker, idx):
        if self.noduplicate and worker in self._workers_have_func:
            payload = (self._REUSE, idx, arg)
        else:
            payload = (fn, idx, arg)
            if self.noduplicate:
                self._workers_have_func.add(worker)
        self.comm.send(payload, dest=worker, tag=0)

    def noduplicate_close(self) -> None:
        for w in range(1, self.size):
            self.comm.send((self._RESET, 0, None), dest=w, tag=0)
        self._workers_have_func.clear()
        self._nd_func = None
        self.noduplicate = False

    def bcast(self, fn: Callable, args: Any = None) -> None:
        """Run ``fn(args)`` on every worker without collecting results
        (reference linna/util.py:241-256)."""
        for w in range(1, self.size):
            self.comm.send(("__bcast__", 0, (fn, args)), dest=w, tag=0)

    def wait(self) -> None:
        """Worker loop: execute tasks until shutdown.  Exceptions are shipped
        back as :class:`_TaskError` so the master errors instead of hanging."""
        old_func = None
        status = self._mpi.Status()
        while True:
            payload = self.comm.recv(source=0, tag=self._mpi.ANY_TAG, status=status)
            if payload is None:
                break
            func, idx, arg = payload
            if func == self._RESET:
                old_func = None
                continue
            if func == "__bcast__":
                # bcast has no reply channel, so an exception here cannot be
                # shipped back — but letting it propagate would kill the
                # worker loop and deadlock the master's next map() (the very
                # hang class the _TaskError protocol exists to prevent).
                # Report on the worker's stderr and stay alive.
                f, a = arg
                try:
                    f(a)
                except Exception:
                    import sys
                    import traceback

                    print(
                        f"MPI worker {self.rank}: bcast callback failed "
                        f"(worker continues):\n{traceback.format_exc()}",
                        file=sys.stderr,
                        flush=True,
                    )
                continue
            if func == self._REUSE:
                func = old_func
            else:
                old_func = func
            try:
                result = func(arg)
            except Exception as e:
                import traceback

                result = _TaskError(f"{e!r}\n{traceback.format_exc()}")
            self.comm.send((idx, result), dest=0, tag=0)

    def close(self) -> None:
        if self.is_master():
            for w in range(1, self.size):
                self.comm.send(None, dest=w, tag=0)


def make_pool(kind: str = "serial", processes: int | None = None):
    if kind == "serial":
        return SerialPool()
    if kind == "multiprocess":
        return MultiprocessPool(processes)
    if kind == "mpi":
        return MPIPool()
    raise ValueError(f"unknown pool kind {kind!r}")
