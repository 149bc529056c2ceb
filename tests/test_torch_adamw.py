"""The trainer's AdamW step (``linna_tpu_torch.ops.adamw``) on the CPU, where
it runs its plain version.

- Given the leaves' gradients in ``Layout`` order it equals the step given
  their float32 concatenation (K, P), bit for bit: float32 and bfloat16
  first moments, K = 1 and 2, lr and wd per member, a member reset on the
  way.  ``train.adamw_step_`` is that step.
- The segment table of the leaves tiles a member's row [0, P) once, in
  order, as ``Layout.entries`` lay it out, for all three model names at the
  DES-Y1 3x2pt and LSST-Y10 6x2pt+N widths, within the kernel's table.
- The wrapper refuses a wrong type, shape or device before it computes
  anything.
- The trainer's minibatch step hands the leaves to the step and counts one
  plain call; its result is the old concatenated path's.
- ``chip_smoke.py``'s 12f check runs here on the plain version.

The kernel itself runs on the card: tests/test_torch_adamw_card.py.
"""

import numpy as np
import pytest
import torch

import chip_smoke as C
from linna_tpu_torch import nn as TN
from linna_tpu_torch import train as TTR
from linna_tpu_torch.ops import adamw as AW
from linna_tpu_torch.ops import library as OL

WIDTHS = {"des": (27, 457), "lsst": (40, 1560)}
MODELS = ("chto_v2", "chto_simple", "chto_v2_linear")


def _leaf_grads(layout, k, dtype, gen, scale):
    """Gradients shaped as the trainer's leaves, in Layout order, each its
    own contiguous tensor as autograd leaves them."""
    full = torch.randn(k, layout.size, generator=gen) * scale
    return [v.to(dtype).contiguous() for v in layout.stacked_views(full)]


@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 2])
def test_leaf_gradients_equal_the_concatenated_gradient(k, mu_dtype):
    layout = TTR.Layout(TN.make_model_spec("chto_v2", 4, 8))
    gen = torch.Generator().manual_seed(7 + k)
    flat = 0.1 * torch.randn(k, layout.size, generator=gen)
    flat_c, start = flat.clone(), flat.clone()
    st, st_c = TTR.adamw_init(flat, mu_dtype), TTR.adamw_init(flat_c, mu_dtype)
    lr = torch.tensor([[3e-3 * (m + 1)] for m in range(k)])
    wd = torch.tensor([[1e-4 + 2e-3 * m] for m in range(k)])
    for step in range(5):
        grads = _leaf_grads(layout, k, mu_dtype, gen, 0.3 + step)
        cat = torch.cat([g.reshape(k, -1) for g in grads], dim=1).to(torch.float32)
        TTR.adamw_step_(flat, grads, st, lr, wd)
        TTR.adamw_step_(flat_c, cat, st_c, lr, wd)
        for a, b in zip((flat, *st), (flat_c, *st_c)):
            assert torch.equal(a, b), step
        if step == 2:
            TTR.adamw_reset_(st, k - 1)
            TTR.adamw_reset_(st_c, k - 1)
    assert st.count.tolist() == [5] * (k - 1) + [2]
    assert st.mu.dtype == mu_dtype and bool((flat != start).all())


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_segment_table_tiles_the_row_in_layout_order(model, width):
    layout = TTR.Layout(TN.make_model_spec(model, *WIDTHS[width]))
    k = 2
    views = layout.stacked_views(torch.zeros(k, layout.size))
    table = AW.segment_table(views, k)
    assert table == [(off, n) for _, _, off, n in layout.entries]
    covered = 0
    for off, n in table:
        assert off == covered and n > 0
        covered += n
    assert covered == layout.size and len(table) <= AW.MAX_SEGMENTS


def _args(k=2, p=10, mu_dtype=torch.bfloat16):
    flat = torch.randn(k, p)
    return {"flat": flat, "grad": [torch.randn(k, 4), torch.randn(k, 1, p - 4)],
            "state": TTR.adamw_init(flat, mu_dtype), "lr": torch.full((k, 1), 1e-3),
            "wd": torch.full((k, 1), 1e-4)}


def _with_state(**kw):
    def edit(a):
        a["state"] = a["state"]._replace(**{n: f(a["state"]) for n, f in kw.items()})
    return edit


BAD = {
    "flat float64": (lambda a: a.update(flat=a["flat"].double()), TypeError),
    "flat 1-D": (lambda a: a.update(flat=a["flat"][0]), ValueError),
    "mu float64": (_with_state(mu=lambda s: s.mu.double()), TypeError),
    "mu shape": (_with_state(mu=lambda s: s.mu[:, :-1]), ValueError),
    "nu bfloat16": (_with_state(nu=lambda s: s.nu.bfloat16()), TypeError),
    "count int64": (_with_state(count=lambda s: s.count.long()), TypeError),
    "lr shape": (lambda a: a.update(lr=a["lr"][0]), ValueError),
    "wd float64": (lambda a: a.update(wd=a["wd"].double()), TypeError),
    "gradient float64": (lambda a: a.update(grad=[g.double() for g in a["grad"]]), TypeError),
    "gradients of two types": (lambda a: a["grad"].__setitem__(0, a["grad"][0].half()),
                               TypeError),
    "gradient short": (lambda a: a["grad"].pop(), ValueError),
    "gradient members": (lambda a: a["grad"].__setitem__(0, torch.randn(3, 4)), ValueError),
    "no gradient": (lambda a: a.update(grad=[]), ValueError),
    "gradient on another device": (lambda a: a["grad"].__setitem__(
        0, torch.empty(2, 4, device="meta")), ValueError),
    "lr on another device": (lambda a: a.update(lr=torch.empty(2, 1, device="meta")),
                             ValueError),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_the_step_refuses_what_the_kernel_does_not_take(case):
    args = _args()
    edit, error = BAD[case]
    edit(args)
    before = [t.clone() for t in (args["flat"], args["state"].count)
              if t.device.type == "cpu"]
    calls = OL.plain_calls["adamw"]
    with pytest.raises(error):
        AW.adamw_(**args)
    after = [t for t in (args["flat"], args["state"].count) if t.device.type == "cpu"]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert OL.plain_calls["adamw"] == calls  # refused before it computed anything


def _trainer(rows=64):
    """A bf16 ``Trainer`` of chto_v2 at 4 -> 8 on random rows, batch 32."""
    from linna_tpu_torch import losses as L
    from linna_tpu_torch import transforms as T

    spec = TN.make_model_spec("chto_v2", 4, 8)
    rng = np.random.default_rng(3)
    tx, ty = rng.normal(size=(rows, 4)), rng.normal(size=(rows, 8))
    ts = T.TransformSet(T.fit_x_transform(tx, None, device="cpu"),
                        T.fit_y_transform(ty, ypositive=False, device="cpu"),
                        T.YTransformData(torch.ones(8)))
    ls = L.build_loss_state(np.zeros(8), np.eye(8), ts)
    tr = TTR.Trainer(spec, ts, ls, seed=5, compute_dtype="bfloat16", device="cpu")
    tr._batch_size = 32
    return tr, tx, ty


def test_the_trainer_step_hands_the_leaves_to_adamw(monkeypatch):
    """``_step`` calls ``train.adamw_step_`` by that name with the leaves'
    gradients, counts one plain call on the CPU, and leaves the parameters
    and state of the concatenated path's step, bit for bit."""
    tr, tx, ty = _trainer()
    data = tr._prepare(tx, ty)
    idx = torch.arange(32)[None]
    start = (tr.flat.clone(), TTR.AdamWState(*(t.clone() for t in tr.opt)))
    seen = []
    step = TTR.adamw_step_
    monkeypatch.setattr(TTR, "adamw_step_", lambda *a: (seen.append(a[1]), step(*a)))
    calls = dict(OL.plain_calls), dict(OL.launches)
    loss = tr._step(data, idx, tr.opt, tr._lr_t, tr._wd_t)
    assert OL.plain_calls["adamw"] == calls[0]["adamw"] + 1 and OL.launches == calls[1]
    (grads,) = seen
    assert len(grads) == len(tr.layout.entries)
    assert all(g.dtype == torch.bfloat16 for g in grads)
    got = (tr.flat.clone(), TTR.AdamWState(*(t.clone() for t in tr.opt)))

    with torch.no_grad():
        tr.flat.copy_(start[0])
    opt = start[1]
    with torch.enable_grad():
        loss_c, leaves = tr._loss(data, idx)
        grad = tr._grad(loss_c, leaves)
    AW.adamw_plain_(tr.flat, grad, opt, tr._lr_t, tr._wd_t)
    assert torch.equal(loss, loss_c.detach())
    for a, b in zip((got[0], *got[1]), (tr.flat, *opt)):
        assert torch.equal(a, b)


def test_the_training_records_count_one_adamw_step_a_minibatch():
    """``trainer.graphs`` holds the AdamW steps of the training call's
    chunks: one plain call a minibatch step on the CPU, no launch."""
    tr, tx, ty = _trainer(rows=96)
    epochs, nb = 3, 96 // 32
    tr.train(tx, ty, tx[:16], ty[:16], num_epochs=epochs, batch_size=32,
             epochs_per_dispatch=2)
    assert tr.graphs["epochs"]["adamw"] == {"launches": 0, "plain_calls": epochs * nb}


def test_phase_adamw_rehearsal():
    """chip_smoke.py's 12f on the CPU: the wrapper's plain path against the
    plain version, bit for bit, at small widths; no timing without a card."""
    res = C.phase_adamw(torch.device("cpu"), widths={"small": (4, 8)}, k=2, steps=4)
    assert set(res) == {"small_bfloat16", "small_float32"}
    for key, rec in res.items():
        assert rec["bit_for_bit"] and rec["steps"] == 4 and "kernel_ms" not in rec
        per = 2 * (4 + (2 if "bfloat16" in key else 4) + 4) + (2 if "bfloat16" in key else 4)
        assert rec["bytes"] == 2 * rec["params_per_member"] * per
