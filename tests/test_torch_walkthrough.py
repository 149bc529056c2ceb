"""``examples/walkthrough_torch.py`` and ``examples/nuts_flagship_demo_torch.py``
on the CPU: the walkthrough's run directory, written by the port, read by
the JAX package, whose emulator, Jacobian and log-posterior gradient agree
with the port's; then the NUTS demo on that directory at small step counts."""

import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linna_tpu_torch
from linna_tpu import priors as JP
from linna_tpu.likelihood import make_grad_log_prob, make_log_prob
from linna_tpu.orchestrator import retrieve_model, retrieve_model_wrapper

REPO = pathlib.Path(linna_tpu_torch.__file__).parent.parent
sys.path.insert(0, str(REPO / "examples"))
import nuts_flagship_demo_torch as D  # noqa: E402
import walkthrough_torch as W  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def walk(tmp_path_factory):
    out = tmp_path_factory.mktemp("walkthrough")
    return str(out), W.main(str(out), device="cpu")


def test_artifacts_and_finite_results(walk):
    out, res = walk
    for it in ("iter_0", "iter_1"):
        for f in ("best.ckpt.npz", "transforms.npz", "finish.json", "train_samples_x.txt"):
            assert os.path.isfile(os.path.join(out, it, f)), (it, f)
    assert res["chain"].ndim == 2 and res["chain"].shape[1] == 2
    for k in ("pred", "jac", "grad"):
        assert np.isfinite(res[k]).all(), k


def test_jax_reads_the_port_directory_and_agrees(walk):
    out, res = walk
    final_dir = os.path.join(out, "iter_1/")
    emulator = retrieve_model_wrapper(final_dir)
    x0 = jnp.asarray(res["x0"], jnp.float32)
    np.testing.assert_allclose(res["pred"], np.asarray(emulator(x0)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res["jac"], np.asarray(jax.jacobian(emulator)(x0)),
                               rtol=1e-5, atol=1e-6)
    trainer = retrieve_model(final_dir, 2, 2)
    pack = JP.priors_from_list([{"param": f"test_{i}", "dist": "flat", "arg1": -2.0,
                                 "arg2": 2.0} for i in range(2)])
    lp = make_log_prob(trainer.spec, trainer.params, trainer.transforms, pack, W.MEANS,
                       np.linalg.inv(W.COV))
    g = np.asarray(make_grad_log_prob(lp)(np.zeros((1, 2), np.float32)))[0]
    np.testing.assert_allclose(res["grad"], g, rtol=1e-5, atol=1e-6)


def test_nuts_demo_on_the_walkthrough_directory(walk, tmp_path):
    out, _ = walk
    np.savetxt(tmp_path / "data.txt", np.stack([np.arange(2), W.MEANS], 1))
    np.savetxt(tmp_path / "cov_triplet.txt", [[i, i, 0.0, W.COV[i, i]] for i in range(2)])
    res = D.main(os.path.join(out, "iter_1"), str(tmp_path), ndim=2, method="zeus",
                 nwalkers=64, m_adapt=20, nuts_warmup=30, nuts_steps=60, tune_rounds=3,
                 tune_steps=20, slice_steps=150, device="cpu")
    for k in ("tau_nuts_max", "tau_slice_max", "ess_per_s_nuts", "ess_per_s_slice"):
        assert np.isfinite(res[k]) and res[k] > 0, k
    assert res["agree_sigma"] < 0.5
    with pytest.raises(ValueError):
        D.main(os.path.join(out, "iter_1"), str(tmp_path), ndim=2, method="zeus",
               m_adapt=20, nuts_warmup=10, device="cpu")
