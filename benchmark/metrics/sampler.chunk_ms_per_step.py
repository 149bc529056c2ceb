"""The card's milliseconds a step inside the sampling window's chunks: the
program's timing events from each chunk's first operation to its last
replay (``chunk_s`` of ``trace_rec["graphs"]``), over the steps the graphs
ran; None where no graph ran or the program times none."""


def read(run):
    rec = run["window"].get("graphs") if run["kind"] == "sample" else None
    if not rec or rec.get("chunk_s") is None or not rec["steps"]:
        return None
    return rec["chunk_s"] / rec["steps"] * 1e3
