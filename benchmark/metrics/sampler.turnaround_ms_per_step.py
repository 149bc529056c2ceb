"""zeus's host milliseconds a step from each slice-loop condition read's
return to the next graph replay's (``turnaround_s`` of
``trace_rec["graphs"]``): at the condition lag of 0 the card has nothing
queued then, so this is the card's wait for the host inside the chunks;
None where no graphed zeus chunk ran or the program times none."""


def read(run):
    rec = run["window"].get("graphs") if run["kind"] == "sample" else None
    if not rec or rec.get("turnaround_s") is None or not rec["steps"]:
        return None
    return rec["turnaround_s"] / rec["steps"] * 1e3
