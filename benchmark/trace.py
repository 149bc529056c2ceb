"""What a traced call's ``torch.profiler`` trace says: the device's busy
time as the union of its operations' intervals (two kernels that overlap
count once), the device time by operation, and the idle gaps named by what
the host was doing then.

The event reader is a frozen copy of ``chip_smoke.kernel_events`` (device
events that are not user annotations, counted and timed by name), reading
the profiler's raw events instead of ``key_averages()``, which builds an
object tree too slow for the hundreds of thousands of kernels a traced
window holds.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
from typing import Optional

import numpy as np

WINDOW_SPAN = "benchmark.window"
TOP = 10  # entries of each breakdown list
NAMED_GAPS = 2000  # the longest gaps named one by one; the rest go under SHORT
SHORT = "(shorter gaps)"


@contextlib.contextmanager
def traced():
    """``torch.profiler`` over the host and the card, with the window span
    around the body; yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()


def _is_device(e) -> bool:
    return e.device_type().name == "CUDA" and not e.is_user_annotation()


def kernel_events(events) -> dict:
    """{name: (device events, device seconds)} of the device-side events
    that are not user annotations."""
    out: dict = {}
    for e in events:
        if _is_device(e):
            n, s = out.get(e.name(), (0, 0.0))
            out[e.name()] = (n + 1, s + e.duration_ns() * 1e-9)
    return out


def union(intervals: np.ndarray) -> np.ndarray:
    """Disjoint, sorted [start, end] rows covering the rows of ``intervals``."""
    if len(intervals) == 0:
        return intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    # a row starts a new block where it begins after every earlier row ended
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    block_end = np.maximum.reduceat(iv[:, 1], np.flatnonzero(new))
    return np.stack([starts, block_end], axis=1)


def busy_and_gaps(intervals: np.ndarray, lo: float, hi: float) -> tuple:
    """(busy time, gaps as [start, end] rows) of the device intervals
    clipped to the window [lo, hi]."""
    iv = np.clip(intervals, lo, hi)
    iv = iv[iv[:, 1] > iv[:, 0]] if len(iv) else iv.reshape(0, 2)
    blocks = union(iv)
    busy = float((blocks[:, 1] - blocks[:, 0]).sum()) if len(blocks) else 0.0
    edges = np.concatenate([[lo], blocks.ravel(), [hi]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    return busy, gaps


def name_gaps(gaps: np.ndarray, host: list) -> list:
    """[[name, seconds]] of the idle time by what the host was doing: the
    innermost host event (an op, a runtime call or a span) running at each
    of the longest gaps' midpoints, under the innermost benchmark span
    around it; gaps past the longest ``NAMED_GAPS`` are summed apart."""
    if len(gaps) == 0:
        return []
    starts = np.array([h[0] for h in host], np.int64) if host else np.zeros(0, np.int64)
    ends = np.array([h[1] for h in host], np.int64) if host else np.zeros(0, np.int64)
    lengths = gaps[:, 1] - gaps[:, 0]
    order = np.argsort(-lengths)
    totals: dict = {}
    for g in order[:NAMED_GAPS]:
        mid = 0.5 * (gaps[g, 0] + gaps[g, 1])
        inside = np.flatnonzero((starts <= mid) & (ends >= mid))
        ops = [i for i in inside if not host[i][3]]
        marks = [i for i in inside if host[i][3]]
        op = min(ops, key=lambda i: ends[i] - starts[i]) if ops else None
        span = min(marks, key=lambda i: ends[i] - starts[i]) if marks else None
        name = "/".join(host[i][2] for i in (span, op) if i is not None) or "(no host event)"
        totals[name] = totals.get(name, 0.0) + lengths[g] * 1e-9
    rest = lengths[order[NAMED_GAPS:]].sum() * 1e-9
    if rest > 0:
        totals[SHORT] = float(rest)
    return sorted(([k, float(v)] for k, v in totals.items()), key=lambda kv: -kv[1])[:TOP]


def kernel_grids(prof, names, path: str) -> dict:
    """{name: {blocks: (launches, device seconds)}} of the kernels whose name
    holds one of ``names``, by the size of their launch grid: read from the
    profiler's trace exported to ``path`` (the raw events carry no grid),
    which is removed after."""
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    out: dict = {k: {} for k in names}
    for e in events:
        key = next((k for k in names if k in e.get("name", "")), None)
        if key is None or e.get("cat") != "kernel":
            continue
        grid = e.get("args", {}).get("grid")
        blocks = None if not grid else math.prod(grid)
        n, sec = out[key].get(blocks, (0, 0.0))
        out[key][blocks] = (n + 1, sec + float(e["dur"]) * 1e-6)
    return out


def read(prof, grids_for=(), workdir: Optional[str] = None) -> Optional[dict]:
    """``busy_s``, ``window_s`` (the window span's length), the device time
    by operation (``kernels``: {name: (events, seconds)}), ``breakdown``
    (the ``TOP`` operations that took most device time, and the idle time by
    what the host was doing), and for each kernel whose name holds a string
    of ``grids_for`` its launches by grid size (``grids``, from
    :func:`kernel_grids`, the trace exported into ``workdir``); None when the
    trace holds no window span."""
    events = prof.profiler.kineto_results.events()
    window = [e for e in events if e.is_user_annotation() and e.name() == WINDOW_SPAN
              and e.device_type().name == "CPU"]
    if not window:
        return None
    lo, hi = window[0].start_ns(), window[0].end_ns()
    device = np.array([(e.start_ns(), e.end_ns()) for e in events if _is_device(e)],
                      np.int64).reshape(-1, 2)
    host = [(e.start_ns(), e.end_ns(), e.name(), e.is_user_annotation()) for e in events
            if e.device_type().name == "CPU" and e.name() != WINDOW_SPAN
            and e.end_ns() >= lo and e.start_ns() <= hi]
    busy, gaps = busy_and_gaps(device, lo, hi)
    kernels = kernel_events(events)
    grids = kernel_grids(prof, grids_for, os.path.join(workdir, "trace.json")) \
        if grids_for else {}
    top = sorted(([k, s] for k, (_, s) in kernels.items()), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy * 1e-9, "window_s": (hi - lo) * 1e-9, "kernels": kernels,
            "device_events": len(device), "grids": grids,
            "breakdown": {"device_ops": top, "idle_gaps": name_gaps(gaps, host)}}
