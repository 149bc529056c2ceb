"""The card's milliseconds an epoch between the training window's chunks:
the program's timing events from each chunk's end to the next chunk's start
(``between_chunks_s`` of ``trainer.graphs["epochs"]``: the permutations'
copy, the metrics' fetch, a speculation's restore point, and the card's
wait for the host), over the epochs run; None where the program times none."""


def read(run):
    if run["kind"] != "train" or not run["trainer"]["epochs_run"]:
        return None
    between_s = run["trainer"]["graphs"].get("between_chunks_s")
    return None if between_s is None else between_s / run["trainer"]["epochs_run"] * 1e3
