"""``fused_log_prob``'s share of its roofline in the traced sampling call:
the least time its launches could take (per launch, the larger of its
operations at the float32 peak and its bytes at the HBM rate, at that
launch's rows; ``counts/fused_log_prob.py``) over the profiler's device time
of those launches.  A launch's rows are told by its grid (the program's
launch shape at each row count it ran).  None unless the profiler saw as
many launches as the program's counter and every grid maps to one row
count."""

from benchmark.counts import fused_log_prob as F
from benchmark.counts import peaks

KERNEL = "fused_log_prob"


def read(run):
    trace, call = run.get("trace"), run.get("traced_call")
    if run["kind"] != "sample" or trace is None or call is None:
        return None
    launched = call["kernels"]["launches"][KERNEL]
    grids = trace.get("grids", {}).get(KERNEL, {})
    blocks = run.get("launch_blocks") or {}
    seen = sum(n for n, _ in grids.values())
    device_s = sum(s for _, s in grids.values())
    if not launched or seen != launched or device_s <= 0 or any(b not in blocks for b in grids):
        return None
    bound = 0.0
    for b, (n, _) in grids.items():
        rows, ndim, ndata = blocks[b]
        bound += n * max(F.operations(run["n_weights"], ndata, rows) / peaks.F32_FLOPS,
                         F.bytes_moved(run["n_weights"], ndim, ndata, rows) / peaks.HBM_BYTES)
    return bound / device_s * 100.0
