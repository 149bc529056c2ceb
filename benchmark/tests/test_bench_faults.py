"""A run with its timed path broken underneath comes out not correct.

Each fault a cell can have is planted in the program, and the rest of a run
(``run.execute``: everything but the look for a card) goes on the CPU at a
tiny size, judged by the cell's own limits: a step that returns its state
unchanged, half of a minibatch left out with the mean taken over the rest,
AdamW's bias correction stuck at its first step, every step of an epoch
gathering its first minibatch's rows (training), a log-posterior altered where it is
produced (sampling).  The same run with nothing planted comes out correct.
The exchange between chips is no fault of a one-chip cell.
"""

import pytest
import torch

from benchmark import run

CELLS = {"des3x2pt.train": "train",
         "des3x2pt.nuts": "sample", "lsst6x2pt.zeus-fused": "sample"}
FAULTS = {"train": ("sound", "state_unchanged", "half_batch", "bias_frozen", "rows_repeated"),
          "sample": ("sound", "state_unchanged", "answer_altered")}


def _stuck_chunk(log_prob_fn, state, nsteps, *args, **kwargs):
    """A sampler chunk that returns its state unchanged, its chain the
    state repeated."""
    chain = state.coords[None].expand(nsteps, *state.coords.shape).clone()
    return state, chain, state.log_prob[None].expand(nsteps, -1).clone()


def plant(monkeypatch, fault: str) -> None:
    from linna_tpu_torch import likelihood, losses, train
    from linna_tpu_torch.ops import fused
    from linna_tpu_torch.samplers import hmc, slicemove

    if fault == "bias_frozen":
        step = train.adamw_step_

        def frozen(flat, grad, state, lr, wd):
            # the update corrected as at the first step, the count kept
            count = state.count.clone()
            state.count.zero_()
            step(flat, grad, state, lr, wd)
            state.count.copy_(count + 1)

        monkeypatch.setattr(train, "adamw_step_", frozen)
    elif fault == "rows_repeated":
        draw = train._MemberStack._draw_perms

        def first_minibatch(self, *a):
            perms = draw(self, *a)
            bs = self._batch_size
            return perms[..., :bs].repeat(1, 1, perms.shape[-1] // bs)

        monkeypatch.setattr(train._MemberStack, "_draw_perms", first_minibatch)
    elif fault == "state_unchanged":
        monkeypatch.setattr(train, "adamw_step_", lambda *a, **k: None)
        monkeypatch.setattr(hmc, "nuts_chunk", _stuck_chunk)
        monkeypatch.setattr(slicemove, "slice_chunk", _stuck_chunk)
    elif fault == "half_batch":
        ratio = losses.chi2_ratio
        monkeypatch.setattr(losses, "chi2_ratio",
                            lambda *a: (lambda r: r[..., :r.shape[-1] // 2])(ratio(*a)))
    elif fault == "answer_altered":
        chi2, plain = likelihood._chi2, fused.fused_log_prob_plain
        monkeypatch.setattr(likelihood, "_chi2", lambda d, c: chi2(d, c) + 0.2)
        monkeypatch.setattr(fused, "fused_log_prob_plain", lambda *a: plain(*a) - 0.1)


def sized(tiny: dict, cell: str) -> dict:
    """The tiny overrides at widths where the cell's numbers read as on the
    card: a training cell keeps its configuration's widths and theory (only
    its rows are cut), a sampling cell's chi^2 needs more than the tiny 12 data
    points for TF32's rounding to add up as it does at its widths."""
    if CELLS[cell] == "train":
        for key in ("ndim", "ndata", "theory"):
            del tiny["config"][key]
    else:
        tiny["config"].update(ndim=8, ndata=64)
    return tiny


@pytest.mark.parametrize("cell, fault", [(c, f) for c, k in CELLS.items() for f in FAULTS[k]])
def test_fault_fails(monkeypatch, tiny, cell, fault):
    torch.set_num_threads(2)
    tiny = sized(tiny, cell)
    plant(monkeypatch, fault)
    res = run.execute(cell, 20240611, 0.5, False, torch.device("cpu"), overrides=tiny)
    assert res["line"]["correct"] is (fault == "sound"), res["compared"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_fails(tiny, cell):
    """The control, the reference one precision lower in the program's place
    (float8 products for bfloat16 training, TF32 for float32 sampling),
    fails at least one of the cell's limits, and the program none.  A
    training cell's limits are set for 160 steps on the card, and the CPU's
    six steps stay far under them: there the control has to read at least
    five times the program's loss gap (``test_bench_card.py`` holds it to
    the limits at the cell's size)."""
    torch.set_num_threads(2)
    tiny = sized(tiny, cell)
    res = run.execute(cell, 31415926535, 0.5, False, torch.device("cpu"), controls=True,
                      overrides=tiny)
    assert res["line"]["correct"] is True, res["compared"]
    lim = {k: lim for k, (_, lim) in res["compared"].items()}
    control = res["out"]["control"]
    if CELLS[cell] == "train":
        assert control["loss_gap"] > 5 * res["out"]["readings"]["loss_gap"], control
    else:
        assert any(control[k] > lim[k] for k in lim if k in control), (control, lim)
