"""Share of the traced sampling call with no operation on the card: one
minus the union of the profiler's device intervals over the traced window."""


def read(run):
    trace = run.get("trace")
    if run["kind"] != "sample" or trace is None or trace["busy_s"] <= 0:
        return None
    return (1.0 - trace["busy_s"] / trace["window_s"]) * 100.0
