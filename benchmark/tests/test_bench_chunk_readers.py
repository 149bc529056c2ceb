"""The readers of the program's chunk device times and zeus's host
turnaround, condition waits and reads: None on a record without them (the CPU, eager chunks, a program
that times none), the number on a hand-made record, and finite numbers from
short graphed runs on the card."""

import math

import pytest

from benchmark import harness as H
from benchmark import run

TRAIN_READERS = ("trainer.chunk_ms_per_epoch", "trainer.between_chunks_ms_per_epoch",
                 "trainer.epoch_end_ms")
SAMPLE_READERS = ("sampler.chunk_ms_per_step", "sampler.between_chunks_ms_per_step",
                  "sampler.turnaround_ms_per_step", "sampler.cond_wait_ms_per_step",
                  "sampler.cond_reads_per_step")


def _train(graphs: dict) -> dict:
    return {"kind": "train", "trainer": {"epochs_run": 100, "graphs": graphs}}


def _sample(graphs) -> dict:
    window = {"sampler": {}} if graphs is None else {"sampler": {}, "graphs": graphs}
    return {"kind": "sample", "steps": 1000, "window": window}


EAGER = {"graphed": False, "replays": 0, "chunks": 3, "epochs": 100}
GRAPHED = {"graphed": True, "replays": 8100, "chunks": 3, "epochs": 100, "chunk_s": 6.0,
           "between_chunks_s": 0.05, "epoch_end_s": [0.0008, 0.0012, 0.0009]}
STEPS = {"replays": 40_000, "steps": 1000, "calls": 20_000, "rows": 2_560_000}
ZEUS = {**STEPS, "chunk_s": 8.0, "between_chunks_s": 0.1, "cond_reads": 20_000,
        "turnaround_s": 0.9, "cond_wait_s": 7.0}


@pytest.mark.parametrize("record", [_train(EAGER), _train({}), _sample(None), _sample(STEPS)])
def test_readers_read_nothing_without_the_times(record):
    for name in TRAIN_READERS + SAMPLE_READERS:
        assert H.reader(name)(record) is None, name


def test_readers_on_hand_made_records():
    train, zeus = _train(GRAPHED), _sample(ZEUS)
    assert H.reader("trainer.chunk_ms_per_epoch")(train) == pytest.approx(60.0)
    assert H.reader("trainer.between_chunks_ms_per_epoch")(train) == pytest.approx(0.5)
    assert H.reader("trainer.epoch_end_ms")(train) == pytest.approx(0.9)
    assert H.reader("sampler.chunk_ms_per_step")(zeus) == pytest.approx(8.0)
    assert H.reader("sampler.between_chunks_ms_per_step")(zeus) == pytest.approx(0.1)
    assert H.reader("sampler.turnaround_ms_per_step")(zeus) == pytest.approx(0.9)
    assert H.reader("sampler.cond_wait_ms_per_step")(zeus) == pytest.approx(7.0)
    assert H.reader("sampler.cond_reads_per_step")(zeus) == pytest.approx(20.0)
    # NUTS: chunk times, no turnaround
    nuts = _sample({**STEPS, "chunk_s": 21.0, "between_chunks_s": 0.1})
    assert H.reader("sampler.chunk_ms_per_step")(nuts) == pytest.approx(21.0)
    assert all(H.reader(n)(nuts) is None for n in SAMPLE_READERS[2:])
    # a reader of the other kind reads nothing
    assert all(H.reader(n)(zeus) is None for n in TRAIN_READERS)
    assert all(H.reader(n)(train) is None for n in SAMPLE_READERS)


def test_listed_in_their_cells():
    bench = H.benchmark()
    for cell, names in (("des3x2pt.train", TRAIN_READERS),
                        ("des3x2pt.nuts", SAMPLE_READERS[:2]),
                        ("lsst6x2pt.zeus-fused", SAMPLE_READERS)):
        listed = {m["name"] for m in H.per_layer(bench, cell)}
        assert set(names) <= listed
        assert not (set(TRAIN_READERS + SAMPLE_READERS) - set(names)) & listed, cell


@pytest.mark.card
@pytest.mark.parametrize("cell", ["des3x2pt.train", "lsst6x2pt.zeus-fused"])
def test_chunk_times_on_the_card(card, tiny, cell):
    """A short graphed window of each kind at the CPU tests' tiny size (zeus
    through the composition): every reader listed for the cell reads a
    finite number, and the zeus record counts its condition reads."""
    if cell.endswith("zeus-fused"):
        tiny["traffic"].update(use_fused=False)
    res = run.execute(cell, 4242424243, 1.0, False, card, overrides=tiny)
    layer = res["out"]["layer"]
    names = TRAIN_READERS if layer["kind"] == "train" else SAMPLE_READERS
    for name in names:
        value = H.reader(name)(layer)
        assert value is not None and math.isfinite(value) and value >= 0.0, (name, value)
    if layer["kind"] == "sample":
        rec = layer["window"]["graphs"]
        assert rec["cond_reads"] > 0 and rec["cond_wait_s"] > 0.0
