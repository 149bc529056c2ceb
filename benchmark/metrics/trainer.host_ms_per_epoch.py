"""Host milliseconds an epoch in the training window: every phase the
trainer times on the host (``phase_seconds``: capture, dispatch,
supervisor, save, plot, the range test) but ``wait_fetch``, the wait for
the card, over the epochs it ran."""


def read(run):
    if run["kind"] != "train" or not run["trainer"]["epochs_run"]:
        return None
    host = sum(v for k, v in run["trainer"]["phase_seconds"].items() if k != "wait_fetch")
    return host / run["trainer"]["epochs_run"] * 1e3
