"""Likelihood calls a step in the sampling window, from the replayed
graphs' record (``trace_rec["graphs"]``); None where no graph ran."""


def read(run):
    rec = run["window"].get("graphs") if run["kind"] == "sample" else None
    if not rec or not rec["steps"]:
        return None
    return rec["calls"] / rec["steps"]
