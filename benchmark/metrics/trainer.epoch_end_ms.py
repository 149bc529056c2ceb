"""The card's milliseconds of one epoch end (the validation pass, the metric
rows and the best params) in the training window: the median over chunks of
the program's timing events around each chunk's last epoch end
(``epoch_end_s`` of ``trainer.graphs["epochs"]``); None where the program
times none."""

import statistics


def read(run):
    if run["kind"] != "train":
        return None
    ends = run["trainer"]["graphs"].get("epoch_end_s")
    return statistics.median(ends) * 1e3 if ends else None
