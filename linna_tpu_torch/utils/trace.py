"""Per-phase tracing and device profiling.

The reference's only timing is one wall-clock number around the whole run
(reference linna/cosmolike_run.py:169-170,321-323 -> ``time.npy``) plus tqdm
bars.  Here every pipeline phase is timed from the start (SURVEY §5.1):

- :class:`PhaseTimer` accumulates named phase durations and appends them to
  ``<outdir>/trace.json`` so a crashed-and-resumed run keeps its history;
- :func:`device_profile` records a ``torch.profiler`` trace of the host and
  the card (a Chrome trace file), switched on with ``LINNA_PROFILE=<dir>``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Iterator, List, Optional

__all__ = ["PhaseTimer", "device_profile"]

TRACE_FILE = "trace.json"


class PhaseTimer:
    """Accumulate named phase wall times; persist as JSON lines-style list."""

    def __init__(self, outdir: Optional[str] = None):
        self.outdir = outdir
        self.records: List[Dict] = []
        # prior-run history is read ONCE here (not re-read per flush, which
        # was O(n^2) in run length); a truncated file from a mid-write kill
        # is dropped with its corruption noted rather than crashing the
        # resumed pipeline
        self._history: List[Dict] = []
        if outdir is not None:
            path = os.path.join(outdir, TRACE_FILE)
            try:
                if os.path.isfile(path):
                    with open(path) as f:
                        self._history = json.load(f)
            except (OSError, ValueError):
                self._history = [{"phase": "_corrupt_trace_dropped"}]

    @contextlib.contextmanager
    def phase(self, name: str, **meta) -> Iterator[Dict]:
        # yields the record dict so the body can attach extra meta (e.g. the
        # trainer's internal sub-phase breakdown) before it is persisted
        rec = {"phase": name, "seconds": 0.0, "t_end": 0.0, **meta}
        t0 = time.perf_counter()
        try:
            yield rec
        finally:
            rec["seconds"] = time.perf_counter() - t0
            rec["t_end"] = time.time()
            self.records.append(rec)
            self._flush()

    def _flush(self) -> None:
        if self.outdir is None:
            return
        try:
            os.makedirs(self.outdir, exist_ok=True)
            path = os.path.join(self.outdir, TRACE_FILE)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self._history + self.records, f, indent=1)
            os.replace(tmp, path)  # atomic: a kill mid-dump never tears it
        except OSError:
            pass

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for r in self.records:
            out[r["phase"]] = out.get(r["phase"], 0.0) + r["seconds"]
        return out


@contextlib.contextmanager
def device_profile(label: str = "linna") -> Iterator[None]:
    """A ``torch.profiler`` trace of the CPU and, where there is one, the
    CUDA device, written to ``<LINNA_PROFILE>/<label>.json`` (Chrome trace
    format) when the env var ``LINNA_PROFILE`` names a directory; no-op
    otherwise."""
    trace_dir = os.environ.get("LINNA_PROFILE")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"{label}.json"))
