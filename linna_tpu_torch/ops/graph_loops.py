"""While loops of CUDA graphs that the card ends.

The JAX package runs the slice move's stepping-out and shrink loops as
``lax.while_loop``s inside one compiled program.  :class:`WhileLoops` does
the same with captured iteration graphs, run one after another, each as a
CUDA conditional while node whose condition a one-thread kernel sets on the
card after every iteration (``csrc/graph_loops.cu``; its comment says how).
A launch enqueues every loop and returns; the host reads no condition.  It
runs on a card only: a build, instantiation or launch error raises.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, Sequence

import torch

from .library import KernelLibrary

__all__ = ["WhileLoops", "LIBRARY"]

SOURCE = Path(__file__).parent / "csrc" / "graph_loops.cu"
# csrc/graph_loops.cu: the most loops a loops graph holds
MAX_LOOPS = 8

_vp, _ci = ctypes.c_void_p, ctypes.c_int
LIBRARY = KernelLibrary(SOURCE, {
    "linna_loops_create": ([_ci, ctypes.POINTER(_vp), _vp, _vp, _vp, _ci, ctypes.POINTER(_vp)],
                           _ci),
    "linna_loops_launch": ([_vp, _vp], _ci),
    "linna_loops_destroy": ([_vp], None),
}, error="linna_loops_error_string", abi=("linna_loops_max_loops", MAX_LOOPS))


class WhileLoops:
    """The graphs ``bodies`` (``torch.cuda.CUDAGraph``s captured with
    ``keep_graph=True``, never replayed themselves) as one CUDA graph of
    while loops, run one after another: loop ``i`` runs ``bodies[i]``, then
    goes on while the bool ``more`` (one element on the card, which every
    body writes) holds and the loop has run fewer than ``max_steps``
    iterations in this launch.  Each body runs at least once a launch.

    :meth:`launch` enqueues the loops on the current stream.  ``total``
    counts each loop's iterations over every launch on the card;
    :meth:`totals` reads it (a wait for the card).  The bodies are held, so
    the memory their kernels use outlives the loops."""

    def __init__(self, bodies: Sequence[torch.cuda.CUDAGraph], more: torch.Tensor,
                 max_steps: int):
        self.bodies = list(bodies)
        n = len(self.bodies)
        if not 0 < n <= MAX_LOOPS:
            raise ValueError(f"{n} loops; a loops graph holds 1 to {MAX_LOOPS}")
        if not more.is_cuda or more.dtype != torch.bool or more.numel() != 1:
            raise ValueError("more: expected one bool on a CUDA device, got "
                             f"{more.dtype} of shape {tuple(more.shape)} on {more.device}")
        if int(max_steps) < 1:
            raise ValueError(f"max_steps {max_steps}: a loop runs at least once")
        lib = LIBRARY.get()
        self.more = more
        self.max_steps = int(max_steps)
        self.device = more.device
        self.iters = torch.zeros(n, dtype=torch.int32, device=self.device)
        self.total = torch.zeros(n, dtype=torch.int64, device=self.device)
        self._handle = ctypes.c_void_p()
        self._lib = lib  # held for __del__, which may run at exit
        raw = (ctypes.c_void_p * n)(*(b.raw_cuda_graph() for b in self.bodies))
        with torch.cuda.device(self.device):
            err = lib.linna_loops_create(
                n, raw, more.data_ptr(), self.iters.data_ptr(), self.total.data_ptr(),
                self.max_steps, ctypes.byref(self._handle))
        if err != 0:
            self._handle = None
        LIBRARY.check(err, "building the while loops graph")

    def launch(self) -> None:
        stream = torch.cuda.current_stream(self.device).cuda_stream
        LIBRARY.check(self._lib.linna_loops_launch(self._handle, stream),
                      "launching the while loops")

    def totals(self) -> List[int]:
        """Each loop's iterations over every launch so far (waits for the
        launches enqueued)."""
        return self.total.tolist()

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.linna_loops_destroy(handle)
            self._handle = None
