"""The port's EnsembleTrainer (K members stacked on one device) against K
one-member Trainers with the same seeds: the same epoch chunk on the same
permutations, and the same supervised training run with its artifacts."""

import os

import jax
import numpy as np
import numpy.testing as npt
import torch

from linna_tpu import nn as JN
from linna_tpu_torch import losses as TL
from linna_tpu_torch import nn as TN
from linna_tpu_torch import transforms as TT
from linna_tpu_torch.parallel import EnsembleTrainer
from linna_tpu_torch.train import Trainer
from linna_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

# the same f32 arithmetic, batched over members or not: only the matrix
# products' blocking differs
RTOL = 1e-5


def _problem(seed=0, ntrain=60, nval=12, ndim=3, ndata=4):
    rng = np.random.default_rng(seed)
    data = rng.normal(1.0, 0.1, ndata)
    cov = np.eye(ndata) * 0.01
    sigma = np.sqrt(np.diag(cov))
    proj = rng.normal(size=(ndim, ndata))
    theory = lambda x: np.tanh(x @ proj) * 0.1 + data  # noqa: E731
    tx, vx = rng.uniform(-1, 1, (ntrain, ndim)), rng.uniform(-1, 1, (nval, ndim))
    ts = TT.TransformSet(
        TT.fit_x_transform(tx, device="cpu"),
        TT.fit_y_transform(theory(tx) / sigma, device="cpu"),
        TT.YTransformData(torch.as_tensor(sigma, dtype=torch.float32)),
    )
    spec = TN.make_model_spec("chto_v2", ndim, ndata)
    return spec, ts, TL.build_loss_state(data, cov, ts), (tx, theory(tx), vx, theory(vx))


def test_ensemble_chunk_equals_serial_members():
    spec, ts, ls, rows = _problem()
    jspec = JN.make_model_spec("chto_v2", spec.in_size, spec.out_size)
    params = [jax.device_get(JN.init_model(jax.random.key(s), jspec)) for s in (1, 2, 3)]
    bs, k, n = 16, 3, len(rows[0])
    perms = torch.stack([
        torch.stack([torch.randperm(n, generator=torch.Generator().manual_seed(10 * e + m))[:48]
                     for m in range(k)]) for e in range(3)
    ])
    ens = EnsembleTrainer(spec, ts, ls, [None] * k, [0, 1, 2], params=params, device="cpu")
    ens._batch_size = bs
    ens.lrs[:] = [1e-3, 2e-3, 5e-4]
    ens._set_hypers()
    out_e = ens._epochs_tracked(perms, ens._prepare(*rows))
    for m in range(k):
        tr = Trainer(spec, ts, ls, params=params[m], device="cpu")
        tr._batch_size = bs
        tr.lrs[:] = ens.lrs[m]
        tr._set_hypers()
        losses, vms, _, best, best_flat = tr._epochs_tracked(perms[:, m:m + 1], tr._prepare(*rows))
        npt.assert_allclose(out_e[0][:, m].numpy(), losses[:, 0].numpy(), rtol=RTOL)
        npt.assert_allclose(out_e[1][:, m].numpy(), vms[:, 0].numpy(), rtol=RTOL)
        npt.assert_allclose(float(out_e[3][m]), float(best[0]), rtol=RTOL)
        npt.assert_allclose(ens.flat[m].numpy(), tr.flat[0].numpy(), rtol=RTOL, atol=1e-7)
        npt.assert_allclose(out_e[4][m].numpy(), best_flat[0].numpy(), rtol=RTOL, atol=1e-7)


def test_ensemble_training_equals_serial_trainers(tmp_path):
    """Whole supervised runs (range test, 25 epochs, checkpoints): member k
    of the ensemble and a one-member Trainer with its seed and directory
    pick the same lr and reach the same best val loss and best params."""
    spec, ts, ls, rows = _problem(seed=1)
    seeds = [7, 1007, 2007]
    dirs_e = [str(tmp_path / "ens" / f"m{m}") for m in range(3)]
    ens = EnsembleTrainer(spec, ts, ls, dirs_e, seeds, device="cpu")
    losses_e, vms_e = ens.train(*rows, num_epochs=25, batch_size=16)
    assert ens.epochs_run == 25 and len(vms_e) == 3 and len(vms_e[0]) == 25
    for m, seed in enumerate(seeds):
        d = str(tmp_path / "serial" / f"m{m}")
        tr = Trainer(spec, ts, ls, outdir=d, seed=seed, device="cpu")
        losses, vms = tr.train(*rows, num_epochs=25, batch_size=16)
        assert float(np.load(os.path.join(d, "lr.npy"))) == float(
            np.load(os.path.join(dirs_e[m], "lr.npy")))
        npt.assert_allclose(np.asarray(losses_e[m]), losses, rtol=1e-4)
        npt.assert_allclose(np.asarray(vms_e[m]), vms, rtol=1e-4)
        npt.assert_allclose(ens.best_val_loss[m], tr.best_val_loss, rtol=1e-4)
        for name in ("best.ckpt.npz", "last.ckpt.npz", "lr_tunning.png", "trainniing.png"):
            assert os.path.isfile(os.path.join(dirs_e[m], name)), name
        pe, _, meta_e = ckpt.load_checkpoint(os.path.join(dirs_e[m], "best.ckpt.npz"), device="cpu")
        ps, _, meta_s = ckpt.load_checkpoint(os.path.join(d, "best.ckpt.npz"), device="cpu")
        assert meta_e["epoch"] == meta_s["epoch"]
        npt.assert_allclose(ens.layout.flatten(pe).numpy(), tr.layout.flatten(ps).numpy(),
                            rtol=1e-4, atol=1e-6)
        _, opt, _ = ckpt.load_checkpoint(os.path.join(dirs_e[m], "last.ckpt.npz"), device="cpu")
        assert set(opt) == {"count", "mu", "nu", "hyperparams"}
    # the ensemble also refreshed its progress plot after its first chunk
    assert os.path.isfile(os.path.join(dirs_e[0], "training_progress.png"))


def test_reinit_and_reload_touch_only_their_member():
    spec, ts, ls, rows = _problem(seed=2)
    ens = EnsembleTrainer(spec, ts, ls, [None] * 3, [0, 1, 2], device="cpu")
    ens._batch_size = 20
    data = ens._prepare(*rows)
    ens._epochs_tracked(ens._draw_perms(2, len(rows[0])), data)
    before = ens.flat.clone()
    ens._reinit_member(1)
    assert torch.equal(ens.flat[0], before[0]) and torch.equal(ens.flat[2], before[2])
    assert not torch.equal(ens.flat[1], before[1])
    assert ens.opt.count.tolist() == [6, 0, 6]  # 2 epochs of 3 batches
    # no in-memory best and no directory: a reload finds nothing
    assert not ens._load_best_member(2)
