"""bfloat16 training (``train_compute_dtype``) in the port against the JAX
package: the loss on the same params and rows, AdamW with a bfloat16 first
moment against optax (bit for bit: the update uses the float32 moment and
only the stored copy is rounded), and epoch chunks of ``Trainer`` and
``EnsembleTrainer`` with the JAX permutations injected.

Tolerance: bfloat16 keeps 8 significant bits (0.4% a rounding).  The
forward rounds where JAX's does (each product accumulated in float32 and
rounded once after its bias), so one loss is held to rtol 1e-5 (measured
equal); the backward's products round at different places, so the losses
and validation metrics of a chunk are held to rtol 3e-3 (measured 6e-4).  After a
chunk the weights agree to 5e-4 in the median and 5e-3 at the 99th
percentile (measured 8e-5 and 2.3e-3); a weight whose gradient is near zero
can take AdamW's normalized step the other way, so the largest difference
is bounded only by 2 lr a step (measured 7e-3 after 9 steps of lr 1e-3;
float32 on both sides gives 1.6e-3 there).  The float32 parts (master
weights, the second moment, the validation metric's arithmetic) are the
float32 trainer's."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import optax
import torch

from linna_tpu import train as JTR
from linna_tpu.parallel import ensemble as JE
from linna_tpu_torch import orchestrator as TO
from linna_tpu_torch import train as TTR
from linna_tpu_torch.parallel.ensemble import EnsembleTrainer
from linna_tpu_torch.utils import checkpoint as ckpt
from test_torch_train import _jax_params, _problem

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
CHUNK_RTOL = 3e-3


def _walk(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _assert_params_close(got: dict, want: dict, lr: float, steps: int):
    want = dict(_walk(jax.device_get(want)))
    diff = np.abs(np.concatenate([(v.detach().numpy() - want[path]).ravel()
                                  for path, v in _walk(got)]))
    assert np.median(diff) <= 5e-4 and np.quantile(diff, 0.99) <= 5e-3, diff
    assert diff.max() <= 2 * lr * steps, diff.max()


def test_bf16_loss_matches_jax():
    pb = _problem(seed=4, model="chto_v2", ndata=5)
    params_j = _jax_params(pb["spec"], 2)
    tx, ty = pb["rows"][:2]
    bx, by = jnp.asarray(tx[:32], jnp.float32), jnp.asarray(ty[:32], jnp.float32)
    losses = {}
    for cd in (None, "bfloat16"):
        jtr = JTR.Trainer(pb["spec"], pb["ts_j"], pb["ls_j"], params=params_j, compute_dtype=cd)
        want = float(jtr._loss(params_j, bx, by, pb["ts_j"], pb["ls_j"]))
        tr = TTR.Trainer(pb["tspec"], pb["ts_t"], pb["ls_t"], params=jax.device_get(params_j),
                         compute_dtype=cd, device="cpu")
        tr._batch_size = 32
        data = tr._prepare(tx, ty)
        zero = torch.zeros((1, 1))
        before = tr.flat.clone()
        got = float(tr._step(data, torch.arange(32)[None], TTR.adamw_init(tr.flat), zero, zero)[0])
        assert torch.equal(tr.flat, before)  # lr 0 leaves the weights
        npt.assert_allclose(got, want, rtol=LOSS_RTOL)
        losses[cd] = got
    assert losses[None] != losses["bfloat16"]  # the bf16 forward really ran


def test_adamw_with_a_bf16_first_moment_matches_optax():
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(2, 9)).astype(np.float32)
    grads = rng.normal(size=(6, 2, 9)).astype(np.float32)
    opt = JTR._make_optimizer(mu_dtype="bfloat16")
    jp = [jnp.asarray(p0[m]) for m in range(2)]
    js = [opt.init(p) for p in jp]
    for m, (lr, wd) in enumerate(((1e-2, 1e-4), (3e-3, 1e-3))):
        js[m].hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
        js[m].hyperparams["weight_decay"] = jnp.asarray(wd, jnp.float32)
    flat = torch.as_tensor(p0.copy())
    state = TTR.adamw_init(flat, torch.bfloat16)
    assert state.mu.dtype == torch.bfloat16 and state.nu.dtype == torch.float32
    lr_t, wd_t = torch.tensor([[1e-2], [3e-3]]), torch.tensor([[1e-4], [1e-3]])
    for step in range(6):
        for m in range(2):
            upd, js[m] = opt.update(jnp.asarray(grads[step, m]), js[m], jp[m])
            jp[m] = optax.apply_updates(jp[m], upd)
        TTR.adamw_step_(flat, torch.as_tensor(grads[step]), state, lr_t, wd_t)
        for m in range(2):
            npt.assert_array_equal(flat[m].numpy(), np.asarray(jp[m]))
            mu_j = [x for x in jax.tree.leaves(js[m]) if x.dtype == jnp.bfloat16][0]
            npt.assert_array_equal(state.mu[m].float().numpy(), np.asarray(mu_j, np.float32))


def test_bf16_trainer_chunk_matches_jax():
    pb = _problem(seed=5, model="chto_v2", ndata=5)
    params_j = _jax_params(pb["spec"], 6)
    start = jax.device_get(params_j)  # the chunk donates params_j
    bs, n_epochs, key = 20, 3, jax.random.key(12)
    jtr = JTR.Trainer(pb["spec"], pb["ts_j"], pb["ls_j"], params=params_j,
                      compute_dtype="bfloat16")
    jtr._batch_size = bs
    opt = JTR._set_hyper(jtr.optimizer.init(params_j), 1e-3, 1e-4)
    tx, ty, vx, vy = (jnp.asarray(a, jnp.float32) for a in pb["rows"])
    p_j, _, losses_j, vms_j, _, best_j, _ = jax.device_get(jtr._epochs_tracked(
        params_j, opt, key, tx, ty, vx, vy, n_epochs, pb["ts_j"], pb["ls_j"]))
    n = tx.shape[0]
    perms = np.stack([np.asarray(jax.random.permutation(k, n))[: (n // bs) * bs]
                      for k in jax.random.split(key, n_epochs)])
    tr = TTR.Trainer(pb["tspec"], pb["ts_t"], pb["ls_t"], params=start,
                     compute_dtype="bfloat16", device="cpu")
    tr._batch_size = bs
    tr.lrs[:] = 1e-3
    tr._set_hypers()
    losses, vms, _, best, _ = tr._epochs_tracked(torch.as_tensor(perms)[:, None, :],
                                                 tr._prepare(*pb["rows"]))
    npt.assert_allclose(losses[:, 0].numpy(), losses_j, rtol=CHUNK_RTOL)
    npt.assert_allclose(vms[:, 0].numpy(), vms_j, rtol=CHUNK_RTOL)
    _assert_params_close(tr.params, p_j, 1e-3, perms.size // bs)
    assert tr.opt.mu.dtype == torch.bfloat16 and tr.flat.dtype == torch.float32


def test_bf16_ensemble_chunk_matches_jax():
    pb = _problem(seed=6, model="chto_v2", ndata=5)
    k, bs, n_epochs = 2, 20, 2
    jtr = JE.EnsembleTrainer(pb["spec"], pb["ts_j"], pb["ls_j"], ["/unused"] * k, [3, 4],
                             compute_dtype="bfloat16")
    jtr._batch_size = bs
    params_j = jtr.params
    opt = jtr.opt_state
    opt.hyperparams["learning_rate"] = jnp.asarray([1e-3, 2e-3], jnp.float32)
    opt.hyperparams["weight_decay"] = jnp.asarray([1e-4, 1e-4], jnp.float32)
    ekeys = jnp.stack([jax.random.key_data(jax.random.key(20 + m)) for m in range(k)])
    ekeys = jax.random.wrap_key_data(ekeys)
    tx, ty, vx, vy = (jnp.asarray(a, jnp.float32) for a in pb["rows"])
    start = [jax.device_get(jax.tree.map(lambda a: a[m], params_j)) for m in range(k)]
    p_j, _, losses_j, vms_j, _, _, _ = jax.device_get(jtr._epochs_members(
        params_j, opt, ekeys, tx, ty, vx, vy, n_epochs, pb["ts_j"], pb["ls_j"]))
    n = tx.shape[0]
    perms = np.stack([
        np.stack([np.asarray(jax.random.permutation(e, n))[: (n // bs) * bs]
                  for e in jax.random.split(jax.random.key(20 + m), n_epochs)])
        for m in range(k)], axis=1)
    tr = EnsembleTrainer(pb["tspec"], pb["ts_t"], pb["ls_t"], [None] * k, [0, 1], params=start,
                         compute_dtype="bfloat16", device="cpu")
    tr._batch_size = bs
    tr.lrs[:] = [1e-3, 2e-3]
    tr._set_hypers()
    losses, vms, _, _, _ = tr._epochs_tracked(torch.as_tensor(perms), tr._prepare(*pb["rows"]))
    npt.assert_allclose(losses.numpy(), np.moveaxis(losses_j, 0, 1), rtol=CHUNK_RTOL)
    npt.assert_allclose(vms.numpy(), np.moveaxis(vms_j, 0, 1), rtol=CHUNK_RTOL)
    for m in range(k):
        _assert_params_close(tr.member_params(m), jax.tree.map(lambda a: a[m], p_j),
                             2e-3, perms.shape[0] * perms.shape[2] // bs)


def test_train_emulator_in_bf16_records_it_and_saves_a_float32_moment(tmp_path):
    pb = _problem(seed=7, ntrain=60, nval=12)
    d = str(tmp_path / "iter_0")
    os.makedirs(d)
    tx, ty, vx, vy = pb["rows"]
    np.savetxt(os.path.join(d, "train_samples_x.txt"), tx)
    np.save(os.path.join(d, "train_samples_y.npy"), ty)
    np.savetxt(os.path.join(d, "val_samples_x.txt"), vx)
    np.save(os.path.join(d, "val_samples_y.npy"), vy)
    cov = np.eye(3) * 0.01
    rec = {}
    TO.train_emulator(d, [d], np.ones(3), cov, np.sqrt(np.diag(cov)), None, False, "chto_simple",
                      {"num_epochs": 4, "batch_size": 16, "nensemble": 2,
                       "train_compute_dtype": "bfloat16"}, trace_rec=rec, device="cpu")
    assert rec["compute_dtype"] == "torch.bfloat16"
    # the trainer's chunk record, as trace.json holds it (eager: no device times)
    assert rec["graphs"]["epochs"] == rec["epochs_run"] and not rec["graphs"]["graphed"]
    _, opt, _ = ckpt.load_checkpoint(os.path.join(d, "last.ckpt.npz"), device="cpu")
    mu = dict(_walk(opt["mu"]))
    assert all(v.dtype == torch.float32 for v in mu.values())
    # bf16-stored moments are exact in float32
    assert all(torch.equal(v, v.to(torch.bfloat16).float()) for v in mu.values())
