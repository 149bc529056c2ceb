"""The trainer's chunk and range-test programs (``linna_tpu_torch.train_graphs``)
against the loops they replaced and against the JAX package.

- The static-buffer bodies, run eagerly as the CPU and a data group run
  them, equal the member loop the port ran before them (a test-only copy
  below) bit for bit: losses, metric rows, correlations, the chunk's best
  value and params, the parameters and the AdamW state after, and the
  member generators' states, for K = 1 and 3, float32 and bfloat16, with
  and without a pre-model, chunks of 1 and 10 epochs, and rows that leave
  a remainder.  Outputs a chunk returned stay as they were when the next
  chunk runs.
- The range test's program equals the old step loop bit for bit.
- Both stay within tests/test_torch_train.py's rtol 1e-4 of JAX's
  ``EnsembleTrainer._epochs_members`` and ``_lr_sweep_members`` with the
  JAX permutations injected.
- ``_set_hypers``, ``_train``'s optimizer reset, reinit and reload keep
  every tensor's storage, and the next chunk computes with the new values;
  a replaced tensor is refused.
- The graph runners refuse a CPU tensor.
- A dropped speculative chunk over the static buffers gives the serial
  run (tests/test_torch_speculative.py's pattern) in float32 and bfloat16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import _torch_mh2_worker as W
from _torch_parity import train_problem as _problem
from linna_tpu.parallel import ensemble as JE
from linna_tpu_torch import linear_model as TLM
from linna_tpu_torch import losses as TL
from linna_tpu_torch import nn as TN
from linna_tpu_torch import train as TTR
from linna_tpu_torch import train_graphs as TG
from linna_tpu_torch.parallel.ensemble import EnsembleTrainer

torch.set_num_threads(1)

CPU = "cpu"
# tests/test_torch_train.py's tolerance against JAX: f32 on both sides,
# differing in summation order only
CHUNK_RTOL = 1e-4
# 70 rows in minibatches of 16: 4 an epoch, 6 rows left over
NTRAIN, NVAL, BS = 70, 16, 16


def _pre_model(pb):
    """A norder-2 pre-model fitted to the standardized targets."""
    tx, ty = pb["rows"][:2]
    ts = pb["ts_t"]
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    x = ts.x_transform(f32(tx))
    y = TL.target_terms(pb["ls_t"], ts, f32(ty))[0]
    return TLM.fit_linear_model(x.numpy(), y.numpy(), norder=2, device=CPU)


def _stack(pb, k, compute_dtype=None, linearmodel=None, lrs=None):
    tr = EnsembleTrainer(pb["tspec"], pb["ts_t"], pb["ls_t"], [None] * k,
                         [11 + m for m in range(k)], compute_dtype=compute_dtype,
                         linearmodel=linearmodel, device=CPU)
    tr._batch_size = BS
    tr.lrs[:] = lrs if lrs is not None else [1e-3 * (m + 1) for m in range(k)]
    tr.wds[:] = [1e-4 * (m + 1) for m in range(k)]
    tr._set_hypers()
    return tr


# ----------------------------------------- the loops the programs replaced


def _loop_epochs(tr, perms, data):
    """The port's epoch chunk before the programs: a Python loop over
    epochs and minibatches with fresh outputs per chunk (a test-only
    copy)."""
    n_ep, k = perms.shape[0], tr.flat.shape[0]
    bs = tr._batch_size
    nb = perms.shape[-1] // bs
    out = tr.spec.out_size
    losses = torch.empty((n_ep, k, nb))
    vms = torch.empty((n_ep, k, 3))
    corrs = torch.empty((n_ep, k, out, out)) if out <= 16 else None
    best_val = torch.full((k,), torch.inf)
    best_flat = tr.flat.clone()
    ls = tr.loss_state
    for e in range(n_ep):
        order = perms[e].view(k, nb, bs)
        for b in range(nb):
            losses[e, :, b] = tr._step(data, order[:, b], tr.opt, tr._lr_t, tr._wd_t)
        with torch.no_grad():
            pred = TN.apply_model(tr.spec, tr._model, data.val_x)
            if data.val_lm is not None:
                pred = pred + data.val_lm
            loss_v = TL.chi2_ratio(ls, pred, data.val_std, data.val_mask, data.val_denom)
            chisq_nn_d = TL._masked_chi2(pred - ls.data_std, data.val_mask,
                                         ls.inv_transformed_cov)
            vm = TL.val_metric_from_terms(loss_v, data.val_denom, chisq_nn_d)
            vms[e] = vm
            if corrs is not None:
                centered = pred - pred.mean(dim=1, keepdim=True)
                c = centered / (torch.sqrt(torch.mean(centered**2, dim=1, keepdim=True)) + 1e-20)
                corrs[e] = c.transpose(1, 2) @ c / pred.shape[1]
            improved = vm[:, 0] < best_val
            best_val = torch.where(improved, vm[:, 0], best_val)
            best_flat = torch.where(improved[:, None], tr.flat, best_flat)
    return losses, vms, corrs, best_val, best_flat


def _loop_perms(tr, n_epochs, n):
    """The permutations as the port drew them before the pinned buffer."""
    keep = max(n // tr._batch_size, 1) * tr._batch_size
    return torch.stack([
        torch.stack([torch.randperm(n, generator=tr.gens[m])[:keep] for m in tr.local])
        for _ in range(n_epochs)])


def _loop_sweep(tr, data, order, lrs):
    """The range test's step loop before the program (a test-only copy)."""
    bs = tr._batch_size
    nb = max(len(order) // bs, 1)
    k = tr.flat.shape[0]
    backup = tr.flat.clone()
    opt = TTR.adamw_init(tr.flat, tr.compute_dtype)
    order_t = torch.as_tensor(order)
    lrs_t = torch.as_tensor(np.asarray(lrs, np.float32))
    wd = torch.full((k, 1), 1e-4)
    raw = torch.empty((k, len(lrs)))
    for it in range(len(lrs)):
        b = it % nb
        idx = order_t[b * bs:(b + 1) * bs].expand(k, bs)
        raw[:, it] = tr._step(data, idx, opt, lrs_t[it].expand(k, 1), wd)
    with torch.no_grad():
        tr.flat.copy_(backup)
    return raw.numpy().astype(np.float64)


def _state(tr):
    return [tr.flat, *tr.opt]


def _assert_same_chunk(got, want):
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b)


# ------------------------------------------------------- bodies vs the loop


@pytest.mark.parametrize("epochs", [1, 10])
@pytest.mark.parametrize("premodel", [False, True])
@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("k", [1, 3])
def test_eager_bodies_equal_the_member_loop(k, compute_dtype, premodel, epochs):
    """Two chunks through the program against the old loop from the same
    state and generators: every output, the state after and the generators
    bit for bit; the first chunk's outputs survive the second chunk."""
    pb = _problem(seed=k + 2 * premodel)
    lm = _pre_model(pb) if premodel else None
    a = _stack(pb, k, compute_dtype, lm)
    b = _stack(pb, k, compute_dtype, lm)
    data_a, data_b = a._prepare(*pb["rows"]), b._prepare(*pb["rows"])
    firsts = []
    for _ in range(2):
        got = a._epochs_tracked(a._draw_perms(epochs, NTRAIN), data_a)
        want = _loop_epochs(b, _loop_perms(b, epochs, NTRAIN), data_b)
        _assert_same_chunk(got, want)
        firsts.append((got, [t.clone() if t is not None else None for t in want]))
        for x, y in zip(_state(a), _state(b)):
            assert torch.equal(x, y)
        for ga, gb in zip(a.gens, b.gens):
            assert torch.equal(ga.get_state(), gb.get_state())
    _assert_same_chunk(*firsts[0])
    assert a.opt.count.tolist() == [2 * epochs * (NTRAIN // BS)] * k
    assert a._program.record()["chunks"] == 2 and not a._program.graphed


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("k", [1, 3])
def test_sweep_program_equals_the_step_loop(k, compute_dtype):
    pb = _problem(seed=5, ntrain=64)
    a, b = _stack(pb, k, compute_dtype), _stack(pb, k, compute_dtype)
    tx, ty = pb["rows"][:2]
    order = np.random.default_rng(1234).permutation(64)
    lrs = np.geomspace(1e-4, 5e-3, 100)
    before = a.flat.clone()
    got = a._lr_sweep(a._prepare(tx, ty), order, lrs)
    npt.assert_array_equal(got, _loop_sweep(b, b._prepare(tx, ty), order, lrs))
    assert torch.equal(a.flat, before)
    assert a.graphs["lr_sweep"] == {"graphed": False, "capture_s": 0.0, "replays": 0,
                                    "steps": 100}


def test_draw_perms_equals_the_stacked_draws():
    pb = _problem()
    a, b = _stack(pb, 3), _stack(pb, 3)
    got = a._draw_perms(4, NTRAIN)
    assert torch.equal(got, _loop_perms(b, 4, NTRAIN)) and got.shape == (4, 3, 64)


# ------------------------------------------------------------ against JAX


def _jax_members(pb, k, bs):
    jtr = JE.EnsembleTrainer(pb["spec"], pb["ts_j"], pb["ls_j"], ["/unused"] * k,
                             [3 + m for m in range(k)])
    jtr._batch_size = bs
    start = [jax.device_get(jax.tree.map(lambda a: a[m], jtr.params)) for m in range(k)]
    tr = EnsembleTrainer(pb["tspec"], pb["ts_t"], pb["ls_t"], [None] * k, list(range(k)),
                         params=start, device=CPU)
    tr._batch_size = bs
    return jtr, tr


def test_ensemble_chunk_matches_jax_epochs_members():
    """K=3 float32 members through the program against JAX's
    ``_epochs_members`` with its permutations injected."""
    pb = _problem(seed=8, model="chto_v2", ndata=5)
    k, bs, n_epochs = 3, 20, 3
    jtr, tr = _jax_members(pb, k, bs)
    lrs = [1e-3, 2e-3, 5e-4]
    opt = jtr.opt_state
    opt.hyperparams["learning_rate"] = jnp.asarray(lrs, jnp.float32)
    opt.hyperparams["weight_decay"] = jnp.asarray([1e-4] * k, jnp.float32)
    ekeys = jax.random.wrap_key_data(
        jnp.stack([jax.random.key_data(jax.random.key(30 + m)) for m in range(k)]))
    tx, ty, vx, vy = (jnp.asarray(a, jnp.float32) for a in pb["rows"])
    p_j, _, losses_j, vms_j, _, best_j, _ = jax.device_get(jtr._epochs_members(
        jtr.params, opt, ekeys, tx, ty, vx, vy, n_epochs, pb["ts_j"], pb["ls_j"]))
    n = tx.shape[0]
    perms = np.stack([
        np.stack([np.asarray(jax.random.permutation(e, n))[: (n // bs) * bs]
                  for e in jax.random.split(jax.random.key(30 + m), n_epochs)])
        for m in range(k)], axis=1)
    tr.lrs[:] = lrs
    tr._set_hypers()
    losses, vms, _, best, _ = tr._epochs_tracked(torch.as_tensor(perms), tr._prepare(*pb["rows"]))
    npt.assert_allclose(losses.numpy(), np.moveaxis(losses_j, 0, 1), rtol=CHUNK_RTOL)
    npt.assert_allclose(vms.numpy(), np.moveaxis(vms_j, 0, 1), rtol=CHUNK_RTOL)
    npt.assert_allclose(best.numpy(), best_j, rtol=CHUNK_RTOL)
    for m in range(k):
        got = tr.layout.flatten(tr.member_params(m)).numpy()
        want = tr.layout.flatten(jax.tree.map(lambda a: np.asarray(a[m]), p_j)).numpy()
        npt.assert_allclose(got, want, rtol=CHUNK_RTOL, atol=1e-6)


def test_sweep_matches_jax_lr_sweep_members():
    pb = _problem(seed=9, ntrain=64)
    k, bs = 2, 16
    jtr, tr = _jax_members(pb, k, bs)
    tx, ty = pb["rows"][:2]
    order = np.random.default_rng(1234).permutation(64)
    lrs = np.geomspace(1e-4, 5e-3, 100)
    want = np.asarray(jtr._lr_sweep_members(
        jtr.params, jnp.asarray(order), jnp.asarray(lrs, jnp.float32),
        jnp.asarray(tx, jnp.float32), jnp.asarray(ty, jnp.float32), 100, pb["ts_j"],
        pb["ls_j"]))
    got = tr._lr_sweep(tr._prepare(tx, ty), order, lrs)
    npt.assert_allclose(got, want, rtol=CHUNK_RTOL)


# ------------------------------------------------ storage that nothing replaces


def _ptrs(tr):
    prog = tr._program
    return [t.data_ptr() for t in (*_state(tr), tr._lr_t, tr._wd_t, prog.perm_rows, prog.losses,
                                   prog.vms, prog.best_val, prog.best_flat)]


def test_interventions_keep_storage_and_reach_the_next_chunk():
    """Between two chunks: new hypers, an optimizer reset, a reinit and a
    reload, each written in place; the next chunk equals the old loop from
    the same state, so it computed with the new values."""
    pb = _problem(seed=11)
    a, b = _stack(pb, 3), _stack(pb, 3)
    data_a, data_b = a._prepare(*pb["rows"]), b._prepare(*pb["rows"])
    for tr, data in ((a, data_a), (b, data_b)):
        out = tr._epochs_tracked(tr._draw_perms(2, NTRAIN), data)
    ptrs = _ptrs(a)
    for tr in (a, b):
        tr.lrs[:] = [5e-4, 3e-3, 1e-3]
        tr.wds[:] = [2e-4, 1e-4, 4e-4]
        tr._set_hypers()
        tr._reset_optimizer(0)
        tr._reinit_member(1)
        tr._best_flat, tr.best_val_losses[2] = out[4].clone(), 1.0
        assert tr._load_best_member(2)
    assert _ptrs(a) == ptrs
    got = a._epochs_tracked(a._draw_perms(3, NTRAIN), data_a)
    _assert_same_chunk(got, _loop_epochs(b, _loop_perms(b, 3, NTRAIN), data_b))
    assert a.opt.count.tolist() == [12, 12, 20]
    assert _ptrs(a) == ptrs


def test_train_resets_the_optimizer_in_place():
    pb = _problem(seed=12)
    tr = _stack(pb, 2)
    state = [t.data_ptr() for t in (*_state(tr), tr._lr_t, tr._wd_t)]
    tr.train(*pb["rows"], num_epochs=3, batch_size=BS, auto_lr=False)
    assert [t.data_ptr() for t in (*_state(tr), tr._lr_t, tr._wd_t)] == state
    assert tr.graphs["epochs"]["epochs"] == 3 and tr._program is None
    assert tr.opt.count.tolist() == [3 * (NTRAIN // BS)] * 2


def test_a_replaced_tensor_is_refused():
    pb = _problem(seed=13)
    tr = _stack(pb, 2)
    data = tr._prepare(*pb["rows"])
    tr._epochs_tracked(tr._draw_perms(1, NTRAIN), data)
    tr.opt = TTR.adamw_init(tr.flat)
    with pytest.raises(RuntimeError, match="replaced"):
        tr._epochs_tracked(tr._draw_perms(1, NTRAIN), data)


def test_graph_runners_refuse_the_cpu():
    pb = _problem(seed=14)
    tr = _stack(pb, 2)
    data = tr._prepare(*pb["rows"])
    assert not tr._graphed()
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        TG.EpochProgram(tr, data, NTRAIN // BS, 2, graphed=True)
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        TG.lr_sweep(tr, data, np.arange(NTRAIN), np.full(3, 1e-3), TTR.adamw_init(tr.flat),
                    graphed=True)


# ------------------------------------------------------------- speculation


class _Planted(TTR.Supervisor):
    """Member 0 returns ``action`` once, at epoch ``at``."""

    at, action = None, None

    def step(self, ep, vm, loss, min_eig, suppressed=False):
        out = super().step(ep, vm, loss, min_eig, suppressed)
        if self.tag == "member0" and ep == self.at and not suppressed:
            return self.action
        return out


class _Burning(EnsembleTrainer):
    """The serial loop burning one chunk's draws before its ``burn_at``-th
    chunk, as a dropped speculative chunk draws them."""

    burn_at = None

    def _draw_perms(self, n_epochs, n):
        self._calls = getattr(self, "_calls", 0) + 1
        if self._calls == self.burn_at:
            super()._draw_perms(n_epochs, n)
        return super()._draw_perms(n_epochs, n)


def _spec_run(speculative, compute_dtype, cls=EnsembleTrainer, burn_at=None):
    _, spec, tset, loss_state, (tx, ty, vx, vy) = W.emulator_problem()
    tr = cls(spec, tset, loss_state, [None] * 2, [7, 8], compute_dtype=compute_dtype, device=CPU)
    tr.speculative_dispatch = speculative
    tr.burn_at = burn_at
    losses, vms = tr.train(tx, ty, vx, vy, num_epochs=30, batch_size=16, auto_lr=False,
                           epochs_per_dispatch=5)
    return tr, losses, vms


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("action", ["reload", "hyper"])
def test_dropped_speculative_chunk_equals_the_serial_run(monkeypatch, action, compute_dtype):
    monkeypatch.setattr(TTR, "Supervisor", _Planted)
    monkeypatch.setattr(_Planted, "at", 17)
    monkeypatch.setattr(_Planted, "action", action)
    (sa, la, va), (sb, lb, vb) = (_spec_run(True, compute_dtype),
                                  _spec_run(False, compute_dtype, _Burning, burn_at=5))
    assert sa.speculation["dropped"] == 1 and sa.graphs["epochs"]["chunks"] == 7
    for x, y in zip(_state(sa) + [sa._best_flat], _state(sb) + [sb._best_flat]):
        assert torch.equal(x, y)
    npt.assert_array_equal(sa.best_val_losses, sb.best_val_losses)
    for m in range(2):
        npt.assert_array_equal(la[m], lb[m])
        npt.assert_array_equal(np.array(va[m]), np.array(vb[m]))
