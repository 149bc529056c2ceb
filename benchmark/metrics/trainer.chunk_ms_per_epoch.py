"""The card's milliseconds an epoch inside the training window's chunks:
the program's timing events from each chunk's first operation to the end of
its last epoch end (``chunk_s`` of ``trainer.graphs["epochs"]``), over the
epochs run; None where the chunks ran eagerly or the program times none."""


def read(run):
    if run["kind"] != "train" or not run["trainer"]["epochs_run"]:
        return None
    chunk_s = run["trainer"]["graphs"].get("chunk_s")
    return None if chunk_s is None else chunk_s / run["trainer"]["epochs_run"] * 1e3
