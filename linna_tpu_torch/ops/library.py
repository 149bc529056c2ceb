"""The port's hand-written CUDA libraries: built, loaded, checked and counted.

Each kernel module declares one :class:`KernelLibrary`: its ``.cu`` source,
the C functions it exports with their ``ctypes`` signatures, its
error-string function and a constant the module and the source must agree
on.  The library is built by ``nvcc`` at first use
(:func:`compile_library`: into :func:`build_dir`, cached by a hash of the
source and the flags) and loaded once per process.

The counters: ``launches`` and ``plain_calls`` by kernel, ``designs``
(``fused_log_prob``'s launches by design) and the shapes the likelihood
kernels ran at.  Every key is there from the start, whichever kernel
module a run imports.  They tick in Python, so a CUDA graph's replays are
added by its ledger (:mod:`linna_tpu_torch.ops.graphs`).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch

__all__ = ["KernelLibrary", "build_dir", "compile_library", "require", "launches",
           "plain_calls", "designs", "launch_shapes", "plain_shapes", "reset_counts",
           "COUNTERS"]

BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# ------------------------------------------------------------------ counters

KERNELS = ("fused_apply", "fused_log_prob", "adamw", "composition_grad")
LIKELIHOOD_KERNELS = KERNELS[:2]
launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)
plain_calls: Dict[str, int] = dict.fromkeys(KERNELS, 0)
designs: Dict[str, int] = {"tiled": 0, "cluster": 0}
# (rows, in width, out width); a graph's replays run the shapes of its
# capture, so the sets are whole without them
launch_shapes: Dict[str, set] = {k: set() for k in LIKELIHOOD_KERNELS}
plain_shapes: Dict[str, set] = {k: set() for k in LIKELIHOOD_KERNELS}
# the counts a graph's replay repeats, by kind
COUNTERS = {"launches": launches, "plain_calls": plain_calls, "designs": designs}


def reset_counts() -> None:
    for d in COUNTERS.values():
        for k in d:
            d[k] = 0
    for d in (launch_shapes, plain_shapes):
        for k in d:
            d[k].clear()


def require(t: torch.Tensor, name: str, dtype, shape, device, contiguous: bool = True) -> None:
    """``t`` of the type ``dtype`` (or one of a tuple of types), ``shape``
    and ``device``, and contiguous unless ``contiguous`` is False."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: expected {' or '.join(map(str, dtypes))}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


# --------------------------------------------------------------------- build

_private: Optional[Path] = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the "
            "CUDA kernels are built from source at first use"
        )
    return found


def build_dir() -> Path:
    """Where the libraries are built and kept: ``LINNA_COMPILE_CACHE`` when
    it names a directory, a temporary directory of this process when it is
    ``0`` or empty (nothing kept across processes), else the package's
    ``ops/_build/``."""
    global _private
    d = os.environ.get("LINNA_COMPILE_CACHE")
    if d is None:
        return BUILD_DIR
    if d in ("0", ""):
        if _private is None:
            _private = Path(tempfile.mkdtemp(prefix="linna_kernels_"))
        return _private
    return Path(d)


def compile_library(source: Path, stats: Dict[str, float]) -> tuple:
    """``source`` built by ``nvcc`` into :func:`build_dir` as
    ``lib<stem>_<hash>.so``, unless a build of the same source and flags is
    there; returns (the loaded library, the compiler output).  The
    compiler's seconds are added to ``stats["nvcc_s"]``.  Raises with the
    compiler output when ``nvcc`` fails.  Separate processes are kept apart
    by writing a temporary file and renaming it."""
    tag = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    where = build_dir()
    where.mkdir(parents=True, exist_ok=True)
    so = where / f"lib{source.stem}_{tag}.so"
    log_path = so.with_suffix(".log")
    if not so.is_file():
        tmp = where / f".{so.name}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
            capture_output=True, text=True,
        )
        stats["nvcc_s"] += time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {source.name}:\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    return ctypes.CDLL(str(so)), log_path.read_text() if log_path.is_file() else ""


Signature = Tuple[Sequence, object]


class KernelLibrary:
    """One ``.cu`` source as a loaded library.

    ``functions``: each exported C function's (argtypes, restype);
    ``error``: the function that names a ``cudaError``; ``abi``: (a function
    of no arguments, the value it must return), a constant of the source
    the declaring module relies on, checked at load.  ``stats``:
    ``nvcc_s``, the compiler's seconds, and ``foreground_wait_s``, the
    seconds callers spent in :meth:`get` waiting for the build or for a
    thread in :meth:`warming`."""

    def __init__(self, source: Path, functions: Dict[str, Signature], error: str,
                 abi: Tuple[str, int]):
        self.source = Path(source)
        self.name = self.source.stem
        self.functions = functions
        self.error = error
        self.abi = abi
        self.lib: Optional[ctypes.CDLL] = None
        self.log = ""
        self.stats: Dict[str, float] = {"nvcc_s": 0.0, "foreground_wait_s": 0.0}
        # one lock a library: one library's warm-up never blocks another's build
        self._lock = threading.RLock()
        self._warmer: Optional[threading.Thread] = None

    def get(self) -> ctypes.CDLL:
        """The library, built and loaded on the first call of the process.
        Raises with the compiler output when ``nvcc`` fails; the next call
        tries again."""
        if self.lib is not None and self._warmer is None:
            return self.lib
        t0 = time.perf_counter()
        with self._lock:
            try:
                if self.lib is None:
                    self._load()
            finally:
                if self._warmer is not threading.current_thread():
                    self.stats["foreground_wait_s"] += time.perf_counter() - t0
        return self.lib

    def build(self) -> str:
        """:meth:`get`; returns the compiler output (``-Xptxas -v``:
        registers and shared memory per kernel)."""
        self.get()
        return self.log

    @contextlib.contextmanager
    def warming(self):
        """The library held by the calling thread while it makes its first
        launches: other threads' :meth:`get` waits for the block to end and
        counts the wait; this thread's own calls count nothing."""
        with self._lock:
            self._warmer = threading.current_thread()
            try:
                yield self
            finally:
                self._warmer = None

    def check(self, err: int, what: str) -> None:
        """Raises for a nonzero ``cudaError`` of ``what``."""
        if err != 0:
            msg = getattr(self.lib, self.error)(err).decode()
            raise RuntimeError(f"{what} failed: {msg} (cudaError {err})")

    def _load(self) -> None:
        lib, log = compile_library(self.source, self.stats)
        for name, (argtypes, restype) in self.functions.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = list(argtypes), restype
        fn = getattr(lib, self.error)
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        name, want = self.abi
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [], ctypes.c_int
        if fn() != want:
            raise RuntimeError(f"{Path(lib._name).name}: {name}() is {fn()}, this "
                               f"module's {want}")
        self.log, self.lib = log, lib
