"""CUDA graph replays an epoch in the training window
(``trainer.graphs["epochs"]``): one minibatch step a minibatch and one epoch
end, nb + 1; None where the chunks ran eagerly."""


def read(run):
    if run["kind"] != "train":
        return None
    rec = run["trainer"]["graphs"]
    if not rec.get("graphed") or not rec.get("epochs"):
        return None
    return rec["replays"] / rec["epochs"]
