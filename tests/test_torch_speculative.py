"""The trainer's dispatch schedule, its speculative double buffer and the
epoch-level spike recovery, against the JAX package and against the port's
own serial loop.

- ``DispatchSchedule.k_at(quiet=)`` and ``quiet_path_lengths`` equal JAX's
  on the same schedules.
- A speculative run with no intervention equals the serial run bit for bit
  (the same operations on the same values, in the same order).
- A planted intervention drops the speculative chunk and copies the restore
  point back: the run then equals a serial run that draws and discards one
  chunk's permutations at the same point (the documented stream change),
  bit for bit.
- ``device_spike_recover`` against JAX's on a trigger row and a quiet row:
  parameters, optimizer state and metrics exactly (selects only), the
  halved learning rate to float32."""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import optax
import pytest
import torch

import _torch_mh2_worker as W
from linna_tpu import nn as JN
from linna_tpu import train as JTR
from linna_tpu_torch import nn as TN
from linna_tpu_torch import train as TTR
from linna_tpu_torch.parallel.ensemble import EnsembleTrainer

torch.set_num_threads(1)

EPOCHS, EPD, K = 30, 5, 2


@pytest.mark.parametrize("max_epd, num_epochs", [(10, 4500), (50, 1000), (5, 37), (1, 12),
                                                 (300, 130)])
def test_schedule_matches_jax(max_epd, num_epochs):
    tj, tt = JTR.DispatchSchedule(max_epd), TTR.DispatchSchedule(max_epd)
    assert tt.quiet_path_lengths(num_epochs) == tj.quiet_path_lengths(num_epochs)
    for i in (0, 119, 120, 500, num_epochs - 1, num_epochs):
        for q in (None, 0, 1, 3):
            assert tt.k_at(i, num_epochs, quiet=q) == tj.k_at(i, num_epochs, quiet=q)
    for intervened in (False, True, False, False):
        tj.observe(intervened)
        tt.observe(intervened)
        assert tt.k_at(200, num_epochs) == tj.k_at(200, num_epochs)


class _Planted(TTR.Supervisor):
    """A supervisor that returns ``action`` once, at epoch ``at``, for the
    member tagged ``member0`` (a reload needs no random draw: the best params
    are in memory)."""

    at, action = None, None

    def step(self, ep, vm, loss, min_eig, suppressed=False):
        out = super().step(ep, vm, loss, min_eig, suppressed)
        if self.tag == "member0" and ep == self.at and not suppressed:
            return self.action
        return out


class _Burning(EnsembleTrainer):
    """The serial loop with one chunk's permutations drawn and discarded
    before the ``burn_at``-th chunk's own, as a dropped speculative chunk
    draws them."""

    burn_at = None

    def _draw_perms(self, n_epochs, n):
        self._calls = getattr(self, "_calls", 0) + 1
        if self._calls == self.burn_at:
            super()._draw_perms(n_epochs, n)
        return super()._draw_perms(n_epochs, n)


def _run(speculative, cls=EnsembleTrainer, burn_at=None):
    _, spec, tset, loss_state, (tx, ty, vx, vy) = W.emulator_problem()
    tr = cls(spec, tset, loss_state, [None] * K, [7 + m for m in range(K)], device="cpu")
    tr.speculative_dispatch = speculative
    tr.burn_at = burn_at
    losses, vms = tr.train(tx, ty, vx, vy, num_epochs=EPOCHS, batch_size=16, auto_lr=False,
                           epochs_per_dispatch=EPD)
    return tr, losses, vms


def _same(a, b):
    (ta, la, va), (tb, lb, vb) = a, b
    assert torch.equal(ta.flat, tb.flat)
    assert torch.equal(ta._best_flat, tb._best_flat)
    npt.assert_array_equal(ta.best_val_losses, tb.best_val_losses)
    for m in range(K):
        npt.assert_array_equal(la[m], lb[m])
        npt.assert_array_equal(np.array(va[m]), np.array(vb[m]))


def test_speculative_equals_serial_bit_for_bit():
    spec, serial = _run(True), _run(False)
    # chunk 0 has no quiet chunk before it; each later chunk but the last
    # speculates its successor
    assert spec[0].speculation == {"speculated": EPOCHS // EPD - 2, "dropped": 0}
    assert serial[0].speculation == {"speculated": 0, "dropped": 0}
    _same(spec, serial)


@pytest.mark.parametrize("action", ["reload", "hyper"])
def test_planted_intervention_drops_the_speculative_chunk(monkeypatch, action):
    """Member 0 intervenes at epoch 17 (chunk 3, while chunk 4 runs
    speculatively): chunk 4 is dropped, the restore point goes back, the
    intervention applies to it, and chunk 4 runs again with new draws."""
    monkeypatch.setattr(TTR, "Supervisor", _Planted)
    monkeypatch.setattr(_Planted, "at", 17)
    monkeypatch.setattr(_Planted, "action", action)
    spec = _run(True)
    assert spec[0].speculation["dropped"] == 1
    # the run after the drop is the serial run that burned chunk 4's draws
    _same(spec, _run(False, _Burning, burn_at=5))
    # and not the serial run that did not
    plain = _run(False)
    assert not torch.equal(spec[0].flat, plain[0].flat)


def test_spike_recover_matches_jax():
    spec_j = JN.make_model_spec("chto_simple", 3, 4)
    spec_t = TN.make_model_spec("chto_simple", 3, 4)
    layout = TTR.Layout(spec_t)
    opt = JTR._make_optimizer()
    rng = np.random.default_rng(0)
    rows = []
    for m in range(2):
        p = JN.init_model(jax.random.key(m), spec_j)
        best = JN.init_model(jax.random.key(10 + m), spec_j)
        st = opt.init(p)
        for _ in range(3):  # a non-trivial moment and count
            g = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape), jnp.float32), p)
            upd, st = opt.update(g, st, p)
            p = optax.apply_updates(p, upd)
        st.hyperparams["learning_rate"] = jnp.asarray(4e-4, jnp.float32)
        rows.append((p, best, st))
    # member 0 spikes big after epoch 10, member 1 is quiet
    val0 = np.array([50.0, 2.0], np.float32)
    loss = np.array([1.0, 1.5], np.float32)
    prev_val = np.array([2.0, 2.1], np.float32)
    prev_loss = np.array([1.0, 1.6], np.float32)
    ep = 12
    want = [JTR.device_spike_recover(opt, p, st, b, val0[m], loss[m], prev_val[m], prev_loss[m],
                                     ep) for m, (p, b, st) in enumerate(rows)]

    def flat(tree):
        return layout.flatten(jax.device_get(tree))

    adam = [st.inner_state[0] for _, _, st in rows]
    got = TTR.device_spike_recover(
        torch.stack([flat(p) for p, _, _ in rows]),
        TTR.AdamWState(torch.tensor([int(a.count) for a in adam], dtype=torch.int32),
                       torch.stack([flat(a.mu) for a in adam]),
                       torch.stack([flat(a.nu) for a in adam])),
        torch.stack([flat(b) for _, b, _ in rows]),
        torch.tensor([float(st.hyperparams["learning_rate"]) for _, _, st in rows]),
        *(torch.as_tensor(a) for a in (val0, loss, prev_val, prev_loss)), ep)
    g_flat, g_opt, g_lr, g_vm0, g_pv, g_pl, g_trig = got
    npt.assert_array_equal(g_trig.numpy(), [bool(w[5]) for w in want])
    assert g_trig.tolist() == [True, False]
    for m, (p2, st2, vm0, pv, pl, _) in enumerate(want):
        a2 = st2.inner_state[0]
        npt.assert_array_equal(g_flat[m].numpy(), flat(p2).numpy())
        assert int(g_opt.count[m]) == int(a2.count)
        npt.assert_array_equal(g_opt.mu[m].numpy(), flat(a2.mu).numpy())
        npt.assert_array_equal(g_opt.nu[m].numpy(), flat(a2.nu).numpy())
        assert np.float32(g_lr[m]) == np.float32(st2.hyperparams["learning_rate"])
        for got_v, want_v in ((g_vm0, vm0), (g_pv, pv), (g_pl, pl)):
            assert np.float32(got_v[m]) == np.float32(want_v)
    assert float(g_lr[0]) == pytest.approx(2e-4) and float(g_lr[1]) == pytest.approx(4e-4)


def test_spike_recover_nan_and_epoch_zero():
    """A NaN metric triggers (and clamps) at any epoch; a rise at epoch 0
    does not; the lr halves only after epoch 10 and above MIN_LR."""
    k, p = 3, 5
    flat, best = torch.zeros(k, p), torch.ones(k, p)
    opt = TTR.AdamWState(torch.full((k,), 4, dtype=torch.int32), torch.ones(k, p),
                         torch.ones(k, p))
    lr = torch.tensor([1e-3, 1e-3, 1e-6])
    val0 = torch.tensor([float("nan"), 100.0, float("nan")])
    ones = torch.ones(k)
    for ep, trig, lr_want in ((0, [True, False, True], [1e-3, 1e-3, 1e-6]),
                              (20, [True, True, True], [5e-4, 5e-4, 1e-6])):
        f, o, l2, vm0, pv, _, t = TTR.device_spike_recover(flat, opt, best, lr, val0, ones, ones,
                                                           ones, ep)
        assert t.tolist() == trig
        npt.assert_allclose(l2.numpy(), lr_want, rtol=1e-6)
        for m in range(k):
            assert torch.equal(f[m], best[m] if trig[m] else flat[m])
            assert int(o.count[m]) == (0 if trig[m] else 4)
        assert torch.isfinite(vm0[t]).all() and torch.equal(pv[t], ones[t])
