"""The port's training stage against the JAX package's on the same numpy
inputs and JAX-initialized weights: AdamW against optax (rtol 1e-6), an
epoch chunk against ``Trainer._epochs_tracked`` with the JAX permutations
injected (rtol 1e-4 on losses, metrics and params), the lr range test's raw
trace and pick, and the supervisor's decisions on the same metric
sequences."""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import optax
import pytest
import torch

from _torch_parity import train_problem as _problem
from linna_tpu import nn as JN
from linna_tpu import train as JTR
from linna_tpu_torch import nn as TN
from linna_tpu_torch import train as TTR

torch.set_num_threads(1)

# f32 on both sides, differing in summation order only; after a few hundred
# AdamW steps the parameters agree to about 1e-5 relative
CHUNK_RTOL = 1e-4


def _jax_params(spec, seed):
    return JN.init_model(jax.random.key(seed), spec)


# ------------------------------------------------------------------- AdamW


def test_adamw_matches_optax_with_runtime_hypers_and_a_reset():
    """Two stacked members with their own lr/wd against two optax
    ``inject_hyperparams(adamw)`` states: 5 steps with the lr and wd changed
    after step 2 and member 1's state reset after step 3."""
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(2, 7)).astype(np.float32)
    grads = rng.normal(size=(5, 2, 7)).astype(np.float32)
    hypers = [((1e-2, 1e-4), (3e-3, 1e-3))] * 2 + [((5e-3, 2e-4), (1e-3, 0.5))] * 3
    opt = optax.inject_hyperparams(optax.adamw)(learning_rate=1e-4, weight_decay=1e-4)
    jp = [jnp.asarray(p0[m]) for m in range(2)]
    js = [opt.init(p) for p in jp]
    flat = torch.as_tensor(p0.copy())
    state = TTR.adamw_init(flat)
    for step in range(5):
        for m in range(2):
            lr, wd = hypers[step][m]
            js[m].hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
            js[m].hyperparams["weight_decay"] = jnp.asarray(wd, jnp.float32)
            upd, js[m] = opt.update(jnp.asarray(grads[step, m]), js[m], jp[m])
            jp[m] = optax.apply_updates(jp[m], upd)
        lr_t = torch.tensor([[hypers[step][0][0]], [hypers[step][1][0]]], dtype=torch.float32)
        wd_t = torch.tensor([[hypers[step][0][1]], [hypers[step][1][1]]], dtype=torch.float32)
        TTR.adamw_step_(flat, torch.as_tensor(grads[step]), state, lr_t, wd_t)
        for m in range(2):
            npt.assert_allclose(flat[m].numpy(), np.asarray(jp[m]), rtol=1e-6, atol=1e-9)
        if step == 2:
            h = dict(js[1].hyperparams)
            js[1] = opt.init(jp[1])
            js[1].hyperparams.update(h)
            TTR.adamw_reset_(state, 1)
    assert state.count.tolist() == [5, 2]


# ------------------------------------------------------------ epoch chunk


def _jax_chunk(pb, params_j, key, n_epochs, bs, lr):
    tr = JTR.Trainer(pb["spec"], pb["ts_j"], pb["ls_j"], params=params_j)
    tr._batch_size = bs
    opt = JTR._set_hyper(tr.optimizer.init(params_j), lr, 1e-4)
    tx, ty, vx, vy = (jnp.asarray(a, jnp.float32) for a in pb["rows"])
    out = tr._epochs_tracked(params_j, opt, key, tx, ty, vx, vy, n_epochs, pb["ts_j"], pb["ls_j"])
    n = tx.shape[0]
    nb = max(n // bs, 1)
    perms = np.stack([np.asarray(jax.random.permutation(k, n))[: nb * bs]
                      for k in jax.random.split(key, n_epochs)])
    return jax.device_get(out), perms


def _torch_trainer(pb, params_np, bs, lr, seed=1234):
    tr = TTR.Trainer(pb["tspec"], pb["ts_t"], pb["ls_t"], seed=seed, params=params_np, device="cpu")
    tr._batch_size = bs
    tr.lrs[:] = lr
    tr._set_hypers()
    return tr


@pytest.mark.parametrize("model,ndata,bs", [("chto_simple", 3, 16), ("chto_v2", 5, 20)])
def test_epoch_chunk_matches_jax_with_injected_permutations(model, ndata, bs):
    pb = _problem(seed=1, ndata=ndata, model=model)
    params_j = _jax_params(pb["spec"], 3)
    params_np = jax.device_get(params_j)
    (p_j, _, losses_j, vms_j, eigs_j, best_j, bestp_j), perms = _jax_chunk(
        pb, params_j, jax.random.key(11), 3, bs, 1e-3)
    tr = _torch_trainer(pb, params_np, bs, 1e-3)
    data = tr._prepare(*pb["rows"])
    losses, vms, corrs, best, best_flat = tr._epochs_tracked(
        torch.as_tensor(perms)[:, None, :], data)
    npt.assert_allclose(losses[:, 0].numpy(), losses_j, rtol=CHUNK_RTOL)
    npt.assert_allclose(vms[:, 0].numpy(), vms_j, rtol=CHUNK_RTOL)
    npt.assert_allclose(float(best[0]), float(best_j), rtol=CHUNK_RTOL)
    eigs = np.linalg.eigvalsh(corrs[:, 0].numpy())[:, 0]
    npt.assert_allclose(eigs, eigs_j, rtol=1e-3, atol=1e-5)
    got, got_best = tr.params, tr.layout.tree(best_flat[0])
    for path, *_ in tr.layout.entries:
        a, b, ab, bb = got, p_j, got_best, bestp_j
        for k in path:
            a, b, ab, bb = a[k], b[k], ab[k], bb[k]
        npt.assert_allclose(a.numpy(), b, rtol=CHUNK_RTOL, atol=1e-6, err_msg=str(path))
        npt.assert_allclose(ab.numpy(), bb, rtol=CHUNK_RTOL, atol=1e-6, err_msg=str(path))


def test_lr_range_test_trace_and_pick_match_jax(monkeypatch):
    pb = _problem(seed=2, ntrain=64)
    params_j = _jax_params(pb["spec"], 5)
    tx, ty = pb["rows"][:2]
    raw = {}
    real = JTR.smooth_and_pick_lr

    def spy(lrs, raw_losses, *a):
        raw["jax"] = np.asarray(raw_losses)
        return real(lrs, raw_losses, *a)

    monkeypatch.setattr(JTR, "smooth_and_pick_lr", spy)
    jtr = JTR.Trainer(pb["spec"], pb["ts_j"], pb["ls_j"], params=params_j)
    jtr._batch_size = 16
    lr_j = JTR.lr_range_test(jtr, jnp.asarray(tx, jnp.float32), jnp.asarray(ty, jnp.float32))
    tr = _torch_trainer(pb, jax.device_get(params_j), 16, 1e-4)
    before = tr.flat.clone()
    lrs = np.geomspace(1e-4, 5e-3, 100)
    got = tr._lr_sweep(tr._prepare(tx, ty), np.random.default_rng(1234).permutation(64), lrs)
    npt.assert_allclose(got[0], raw["jax"], rtol=1e-4)
    assert torch.equal(tr.flat, before)  # the sweep leaves the params as they were
    assert TTR.lr_range_test(tr, tx, ty) == lr_j


# -------------------------------------------------------------- supervisor


def _es_sequences():
    rng = np.random.default_rng(3)
    walk = np.cumsum(rng.normal(0, 0.05, 700)) + 3.0
    return {
        "patience": (dict(patience=10, nqueue=6),
                     [(1.0, 1.0)] + [(0.9 - i * 0.1, 1.0) for i in range(5)] + [(5.0, 1.0)] * 9),
        "stops": (dict(patience=5, nqueue=4), [(1.0, 1.0)] + [(2.0, 1.0)] * 600),
        "overfit": (dict(patience=500, nqueue=8),
                    [(1.0, 1.0)] + [(1.0 + 0.1 * i, 1.0 - 0.05 * i) for i in range(12)]),
        "random walk": (dict(patience=60, nqueue=20),
                        list(zip(np.abs(walk), np.abs(walk[::-1])))),
    }


@pytest.mark.parametrize("case", sorted(_es_sequences()))
def test_early_stopping_decisions_match(case):
    kw, seq = _es_sequences()[case]
    ej, et = JTR.EarlyStopping(**kw), TTR.EarlyStopping(**kw)
    acts = [(ej.step(v, t), et.step(v, t)) for v, t in seq]
    assert [a for a, _ in acts] == [b for _, b in acts]
    assert (ej.num_bad_epochs, ej.cooling, ej.best) == (et.num_bad_epochs, et.cooling, et.best)


def _sup_sequences():
    rng = np.random.default_rng(4)
    spiky = list(np.abs(rng.normal(1.0, 0.3, 200)))
    spiky[37], spiky[90], spiky[150] = np.nan, 40.0, 1e11
    return {
        "flat start": ([1.0 + 1e-6 * e for e in range(30)] + [1.0] * 20, 1.0, np.inf),
        "nan and spikes": (spiky, 1.0, np.inf),
        "collapse": ([3.0] * 12, 1e-9, 1.0),
        "late stall": (list(np.linspace(5, 1, 120)) + [3.5] * 40, 1.0, np.inf),
        "decay": (list(1.0 / (1.0 + 0.05 * np.arange(400))), 1.0, np.inf),
    }


@pytest.mark.parametrize("case", sorted(_sup_sequences()))
def test_supervisor_decisions_match(case):
    vals, min_eig, best = _sup_sequences()[case]
    sj, st = JTR.Supervisor(lr=1e-3, patience=50), TTR.Supervisor(lr=1e-3, patience=50)
    sj.best_val_loss = st.best_val_loss = best
    for ep, v in enumerate(vals):
        vj, vt = np.array([v, 0.0, 0.0]), np.array([v, 0.0, 0.0])
        loss = 1.0 + 0.01 * (ep % 7)
        a = sj.step(ep, vj, loss, min_eig)
        b = st.step(ep, vt, loss, min_eig)
        assert a == b, (ep, a, b)
        assert (sj.lr, sj.wd, sj.stopped) == (st.lr, st.wd, st.stopped)
        np.testing.assert_array_equal(vj, vt)
        if a in ("reinit", "reload") and np.isfinite(v):
            sj.observe_chunk_best(v)
            st.observe_chunk_best(v)


def test_dispatch_schedule_chunk_lengths_match():
    sj, st = JTR.DispatchSchedule(50), TTR.DispatchSchedule(50)
    i, pattern = 0, [False, False, True, False, False, False, True] * 40
    for intervened in pattern:
        k = st.k_at(i, 4500)
        assert k == sj.k_at(i, 4500)
        if k == 0:
            break
        sj.observe(intervened)
        st.observe(intervened)
        i += k
    assert st.k_at(4495, 4500) == 5 and st.k_at(4500, 4500) == 0


def test_smooth_and_pick_lr_matches():
    rng = np.random.default_rng(5)
    lrs = np.geomspace(1e-4, 5e-3, 100)
    raw = np.exp(-np.linspace(0, 3, 100)) + 0.05 * rng.random(100)
    raw[80:] *= np.linspace(1, 30, 20)
    a, b = JTR.smooth_and_pick_lr(lrs, raw), TTR.smooth_and_pick_lr(lrs, raw)
    assert a[0] == b[0] and a[1] == b[1]
    np.testing.assert_array_equal(a[2], b[2])


def test_training_compute_dtype_and_linearmodel_are_not_ported():
    """Both are ported (tests/test_torch_bf16.py, test_torch_linear_model.py):
    the training compute type takes floating-point types only, and a
    pre-model, any callable on the standardized inputs, is taken off the
    training targets once (the network trains on the residual), added to
    the validation prediction and to ``predict``."""
    pb = _problem()
    shift = lambda x: torch.ones(x.shape[0], 3) * 0.25  # noqa: E731
    tr = TTR.Trainer(pb["tspec"], pb["ts_t"], pb["ls_t"], device="cpu", linearmodel=shift)
    bare = TTR.Trainer(pb["tspec"], pb["ts_t"], pb["ls_t"], device="cpu")
    data, plain = tr._prepare(*pb["rows"]), bare._prepare(*pb["rows"])
    assert torch.equal(data.t_std, plain.t_std - 0.25) and data.val_lm.shape == (16, 3)
    assert plain.val_lm is None and torch.equal(data.val_std, plain.val_std)
    x = torch.as_tensor(pb["rows"][0][:4], dtype=torch.float32)
    with torch.no_grad():
        ts = pb["ts_t"]
        want = ts.y_transform(TN.apply_model(pb["tspec"], tr.params, ts.x_transform(x)) + 0.25)
        npt.assert_allclose(tr.predict(x).numpy(), want.numpy(), rtol=1e-6)
    for bad in ("int8", "not_a_type"):
        with pytest.raises(ValueError, match="floating-point"):
            TTR.Trainer(pb["tspec"], pb["ts_t"], pb["ls_t"], device="cpu", compute_dtype=bad)
    tr = TTR.Trainer(pb["tspec"], pb["ts_t"], pb["ls_t"], device="cpu", compute_dtype="bfloat16")
    assert tr.compute_dtype == torch.bfloat16 and tr.opt.mu.dtype == torch.bfloat16
