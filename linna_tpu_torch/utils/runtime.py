"""Process-level runtime environment checks.

A copy of the JAX package's ``vm.max_map_count`` guard: a long-lived process
that maps many JIT-compiled code objects (the JAX package's test suite, a
multi-analysis server, a long sweep) can cross the kernel's default 65530
mappings, after which ``mmap`` fails mid-compile.  ``ml_sampler_core`` runs
the check at pipeline start, as the JAX package does.

The check only *warns* by default.  Writing the sysctl — a persistent,
system-wide kernel-setting change — is opt-in via ``LINNA_RAISE_MAP_COUNT=1``
(set in CI, where the runner is disposable), never a side effect of merely
importing or running the library on a shared box.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional

__all__ = ["check_map_count", "MAP_LIMIT_PATH", "MIN_MAP_COUNT"]

MAP_LIMIT_PATH = "/proc/sys/vm/max_map_count"
MIN_MAP_COUNT = 262144
RAISE_TO = 1048576


def check_map_count(
    min_required: int = MIN_MAP_COUNT,
    raise_to: int = RAISE_TO,
    allow_write: Optional[bool] = None,
    path: str = MAP_LIMIT_PATH,
) -> Optional[int]:
    """Check (and optionally raise) the kernel's ``vm.max_map_count``.

    Returns the effective limit after the call, or ``None`` when it cannot
    be read (non-Linux / masked procfs).  When the limit is below
    ``min_required``:

    - with ``allow_write`` true (default: the ``LINNA_RAISE_MAP_COUNT=1``
      env var) AND write permission, the limit is raised to ``raise_to``;
    - otherwise a warning explains the expected failure mode and the manual
      fix, and the low limit is returned unchanged.
    """
    if allow_write is None:
        allow_write = os.environ.get("LINNA_RAISE_MAP_COUNT", "") == "1"
    try:
        with open(path) as f:
            limit = int(f.read())
    except (OSError, ValueError):
        return None  # non-Linux / masked procfs: nothing to check
    if limit >= min_required:
        return limit
    if allow_write:
        try:
            with open(path, "w") as f:
                f.write(str(raise_to))
            return raise_to
        except OSError:
            pass  # fall through to the warning
    warnings.warn(
        f"vm.max_map_count={limit} is too low for a long-lived process's "
        "JIT code mappings (a full test session or multi-analysis run "
        "needs ~80k and the kernel default is 65530); expect a crash in a "
        "compiler deep into the session. Fix: "
        f"sysctl -w vm.max_map_count={raise_to} (or set "
        "LINNA_RAISE_MAP_COUNT=1 to let the process raise it itself).",
        stacklevel=2,
    )
    return limit
