"""Host milliseconds a step in the sampling window: ``run_ensemble``'s
dispatch (graph capture taken out) and host (chain appends, state saves)
seconds over the steps it ran."""


def read(run):
    if run["kind"] != "sample" or not run["steps"]:
        return None
    ps = run["window"]["sampler"]
    return (ps["dispatch"] + ps["host"]) / run["steps"] * 1e3
