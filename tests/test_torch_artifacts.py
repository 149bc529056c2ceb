"""Iteration directories cross the packages: one trained by the port loads
in the JAX package's ``retrieve_model`` and predicts what the port predicts
(f32 tolerance), and a finished iteration trained by the JAX package makes
the port's ``train_emulator`` skip."""

import os

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import torch

from linna_tpu import nn as JN
from linna_tpu import orchestrator as JO
from linna_tpu_torch import nn as TN
from linna_tpu_torch import orchestrator as TO
from linna_tpu_torch import sample_gen as TSG

torch.set_num_threads(1)

NDIM, NDATA = 3, 5
DATA = np.linspace(0.5, 1.5, NDATA)
COV = np.diag(np.full(NDATA, 0.04))
SIGMA = np.sqrt(np.diag(COV))
PROJ = np.random.default_rng(0).normal(size=(NDIM, NDATA))


def _theory(task, outdir):
    return np.tanh(np.asarray(task[1]) @ PROJ) * 0.3 + DATA


def _iteration(outdir):
    prior = np.array([[-1.0, 1.0]] * NDIM)
    TSG.generate_training_point(_theory, TSG.NNSampler(outdir, prior), None, outdir, 60, 12,
                                DATA, np.linalg.inv(COV))


def _mtimes(outdir):
    return {f: os.path.getmtime(os.path.join(outdir, f)) for f in os.listdir(outdir)
            if os.path.isfile(os.path.join(outdir, f))}


def test_port_trained_iteration_loads_in_the_jax_package(tmp_path):
    it0 = str(tmp_path / "iter_0")
    _iteration(it0)
    TO.train_emulator(it0, [it0], DATA, COV, SIGMA, None, False, "chto_v2",
                      {"num_epochs": 12, "batch_size": 20, "nensemble": 2}, device="cpu")
    x = np.random.default_rng(1).uniform(-1, 1, (7, NDIM)).astype(np.float32)
    port = TO.retrieve_model(it0, NDIM, NDATA, device="cpu")
    members_t = TO.retrieve_ensemble_params(it0, port)
    jtr = JO.retrieve_model(it0, NDIM, NDATA)
    members_j = JO.retrieve_ensemble_params(it0, jtr)
    assert len(members_t) == len(members_j) == 2
    xt = port.transforms.x_transform(torch.as_tensor(x))
    xj = jtr.transforms.x_transform(jnp.asarray(x))
    for pt, pj in zip(members_t, members_j):
        with torch.no_grad():
            got = TN.apply_model(port.spec, pt, xt).numpy()
        npt.assert_allclose(got, np.asarray(JN.apply_model(jtr.spec, pj, xj)), rtol=1e-5, atol=1e-6)
    want = np.asarray(JO.retrieve_model_wrapper(it0)(jnp.asarray(x)))
    with torch.no_grad():
        npt.assert_allclose(TO.retrieve_model_wrapper(it0, device="cpu")(x).numpy(), want,
                            rtol=1e-5, atol=1e-6)


def test_jax_trained_iteration_makes_the_port_skip(tmp_path):
    it0 = str(tmp_path / "iter_0")
    _iteration(it0)
    params = {"num_epochs": 3, "batch_size": 20, "nensemble": 2}
    JO.train_emulator(it0, [it0], DATA, COV, SIGMA, None, False, "chto_v2", params)
    before = _mtimes(it0), _mtimes(os.path.join(it0, "ens_1"))
    # finish.json gate
    TO.train_emulator(it0, [it0], DATA, COV, SIGMA, None, False, "chto_v2", params, device="cpu")
    assert (_mtimes(it0), _mtimes(os.path.join(it0, "ens_1"))) == before
    # member best.ckpt gate: the marker is written again, nothing is trained
    os.remove(os.path.join(it0, TO.FINISH_MARKER))
    TO.train_emulator(it0, [it0], DATA, COV, SIGMA, None, False, "chto_v2", params, device="cpu")
    assert os.path.isfile(os.path.join(it0, TO.FINISH_MARKER))
    after = _mtimes(it0)
    after.pop(TO.FINISH_MARKER)
    expect = dict(before[0])
    expect.pop(TO.FINISH_MARKER)
    assert after == expect
    # with a member's checkpoint missing the port trains the iteration again
    os.remove(os.path.join(it0, TO.FINISH_MARKER))
    os.remove(os.path.join(it0, "ens_1", TO.BEST_CKPT))
    TO.train_emulator(it0, [it0], DATA, COV, SIGMA, None, False, "chto_v2", params, device="cpu")
    assert os.path.isfile(os.path.join(it0, "ens_1", TO.BEST_CKPT))
    # and the JAX package samples what the port retrained
    jtr = JO.retrieve_model(it0, NDIM, NDATA)
    assert len(JO.retrieve_ensemble_params(it0, jtr)) == 2
