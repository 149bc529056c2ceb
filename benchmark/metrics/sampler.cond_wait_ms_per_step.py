"""zeus's host milliseconds a step blocked in the slice loops' condition
reads (``cond_wait_s`` of ``trace_rec["graphs"]``, the ``sampler.cond_wait``
spans): the host waits there for the card, so this is most of
``sampler.host_ms_per_step``'s ``dispatch`` on zeus; None where no graphed
zeus chunk ran or the program times none."""


def read(run):
    rec = run["window"].get("graphs") if run["kind"] == "sample" else None
    if not rec or rec.get("cond_wait_s") is None or not rec["steps"]:
        return None
    return rec["cond_wait_s"] / rec["steps"] * 1e3
