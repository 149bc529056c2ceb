"""zeus's slice-loop condition reads a step (``cond_reads`` of
``trace_rec["graphs"]``): each is a round trip in which the card waits for
the host, so ``sampler.turnaround_ms_per_step`` is about this many host
turnarounds; None where no graphed zeus chunk ran or the program counts
none."""


def read(run):
    rec = run["window"].get("graphs") if run["kind"] == "sample" else None
    if not rec or rec.get("cond_reads") is None or not rec["steps"]:
        return None
    return rec["cond_reads"] / rec["steps"]
