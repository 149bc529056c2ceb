"""The card's milliseconds a step between the sampling window's chunks: the
program's timing events from each chunk's last replay to the next chunk's
first operation (``between_chunks_s`` of ``trace_rec["graphs"]``: the
chunk's copies to the host, zeus's scale tuning, and the card's wait for the
host), over the steps the graphs ran; None where no graph ran or the program
times none."""


def read(run):
    rec = run["window"].get("graphs") if run["kind"] == "sample" else None
    if not rec or rec.get("between_chunks_s") is None or not rec["steps"]:
        return None
    return rec["between_chunks_s"] / rec["steps"] * 1e3
