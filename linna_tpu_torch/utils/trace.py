"""Per-phase tracing and device profiling.

The reference's only timing is one wall-clock number around the whole run
(reference linna/cosmolike_run.py:169-170,321-323 -> ``time.npy``) plus tqdm
bars.  Here every pipeline phase is timed from the start (SURVEY §5.1):

- :class:`PhaseTimer` accumulates named phase durations and appends them to
  ``<outdir>/trace.json`` so a crashed-and-resumed run keeps its history;
- :func:`device_profile` records a ``torch.profiler`` trace of the host and
  the card (a Chrome trace file), switched on with ``LINNA_PROFILE=<dir>``;
- :class:`span` times one phase of the trainer, the sampler or the
  orchestrator into a phase dict and, while a profiler records on the
  calling thread, names it in the trace, on the clock the device events
  share: a trace's idle gaps are then named by the phase the host was in;
- :class:`ChunkTimes` times the card's work in the graphed trainer's and
  sampler's chunks with CUDA events the host records between them.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Iterator, List, Optional

import torch

__all__ = ["ChunkTimes", "PhaseTimer", "device_profile", "span"]

TRACE_FILE = "trace.json"


class span:
    """``with span("trainer.dispatch", ps):`` adds the body's wall seconds to
    ``ps["dispatch"]`` (the name's last dotted part; ``into`` None: no
    dict), and opens ``torch.profiler.record_function(name)`` only while a
    profiler records on this thread: ungated, a ``record_function`` costs
    tens of microseconds with no profiler, the flag check a tenth of one.
    A thread the profiler was not started on (the sampler's consumer) gets
    no range, as its ranges would not reach the profiler's events."""

    __slots__ = ("name", "into", "_range", "_t0")

    def __init__(self, name: str, into: Optional[Dict[str, float]] = None):
        self.name, self.into = name, into

    def __enter__(self) -> "span":
        self._range = None
        if torch._C._autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self.into is not None:
            key = self.name.rsplit(".", 1)[-1]
            self.into[key] = self.into.get(key, 0.0) + time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)


class ChunkTimes:
    """The card's time in a runner's chunks, from timing events the host
    records between its operations: ``start()`` before a chunk's first
    operation, ``mark()`` where a chunk is split, ``stop()`` after its
    last replay; none sits inside a graph.

    A chunk's events are read once its stop event has completed, checked
    at the next ``start()`` and in :meth:`record` without waiting: by then
    the caller's fetch of the chunk's results has waited for them.  A chunk
    still running then (one dropped at a stop) is left out.  Read events
    are dropped, so a few chunks' events are held at a time.

    ``chunk_s`` sums start to stop; ``between_chunks_s`` each stop to the
    next chunk's start (the card runs the host's copies and draws between
    chunks, or waits for the host); ``split_s`` lists, per chunk, its last
    mark to its stop."""

    def __init__(self):
        self.chunk_s = self.between_chunks_s = 0.0
        self.split_s: List[float] = []
        self._pending: List[List[torch.cuda.Event]] = []
        self._last_stop = None

    def _event(self) -> torch.cuda.Event:
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def start(self) -> None:
        self._settle()
        self._pending.append([self._event()])

    def mark(self) -> None:
        self._pending[-1].append(self._event())

    stop = mark  # a chunk's last event is its stop

    def _settle(self) -> None:
        while self._pending and self._pending[0][-1].query():
            events = self._pending.pop(0)
            self.chunk_s += events[0].elapsed_time(events[-1]) * 1e-3
            if self._last_stop is not None:
                self.between_chunks_s += self._last_stop.elapsed_time(events[0]) * 1e-3
            if len(events) > 2:
                self.split_s.append(events[-2].elapsed_time(events[-1]) * 1e-3)
            self._last_stop = events[-1]

    def record(self) -> dict:
        self._settle()
        return {"chunk_s": self.chunk_s, "between_chunks_s": self.between_chunks_s}


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
            with span(f"orchestrator.{name}"):
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
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"{label}.json"))
