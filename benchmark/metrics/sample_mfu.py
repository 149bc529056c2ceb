"""FLOPs of the likelihood evaluations the sampling window's chain needed
(the replayed graphs' rows, each through K members and the chi^2, a
gradient evaluation twice a forward) over its wall, as a share of the
card's float32 peak (the program sets no TF32)."""

from benchmark.counts import emulator, peaks


def read(run):
    rec = run["window"].get("graphs") if run["kind"] == "sample" else None
    if not rec or not rec["rows"]:
        return None
    per_row = emulator.likelihood_flops(run["n_weights"], run["ndata"], run["members"],
                                        run["gradient"])
    return rec["rows"] * per_row / run["window_s"] / peaks.F32_FLOPS * 100.0
