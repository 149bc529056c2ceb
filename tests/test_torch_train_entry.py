"""Training in a child process: ``train_request.json`` + ``.npz`` written by
either package run in the other (the port's request adds the device, which
the JAX package ignores), and the orchestrator's ``train_subprocess``
branch on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

import linna_tpu_torch
from linna_tpu import train_entry as JTE
from linna_tpu_torch import train_entry as TTE
from linna_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

PARAMS = {"trainingoption": 1, "num_epochs": 6, "batch_size": 10, "nensemble": 1}


def _iteration(d, seed=0, n=40, nval=10):
    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    # positive first column: a request may ask for log10 there
    tx, vx = rng.uniform(0.1, 1, (n, 2)), rng.uniform(0.1, 1, (nval, 2))
    f = lambda x: np.tanh(x @ np.array([[1.0, 0.3], [-0.5, 0.8]])) * 0.1 + 1.0  # noqa: E731
    np.savetxt(os.path.join(d, "train_samples_x.txt"), tx)
    np.save(os.path.join(d, "train_samples_y.npy"), f(tx))
    np.savetxt(os.path.join(d, "val_samples_x.txt"), vx)
    np.save(os.path.join(d, "val_samples_y.npy"), f(vx))
    cov = np.eye(2) * 0.01
    return np.ones(2), cov, np.sqrt(np.diag(cov))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_request_written_by_one_package_runs_in_the_port(tmp_path, writer):
    d = str(tmp_path / "iter_0")
    data, cov, sigma = _iteration(d)
    args = (d, [d], data, cov, sigma, None, False, "chto_simple", dict(PARAMS), False)
    if writer == "jax":
        JTE.write_request(*args)
        assert "device" not in json.loads(open(os.path.join(d, TTE.REQUEST_JSON)).read())
        TTE.run_request(d, device="cpu")
    else:
        TTE.write_request(*args, device="cpu")
        req = json.loads(open(os.path.join(d, TTE.REQUEST_JSON)).read())
        assert req["device"] == "cpu" and req["params"] == PARAMS
        TTE.main([d])  # the request's device
    assert os.path.isfile(os.path.join(d, "finish.json"))
    params, _, meta = ckpt.load_checkpoint(os.path.join(d, "best.ckpt.npz"), device="cpu")
    assert np.isfinite(meta["best_val_loss"])


def test_port_request_runs_in_jax(tmp_path):
    """The JAX package runs a request the port wrote (it ignores the
    device), and its artifacts load in the port."""
    d = str(tmp_path / "iter_0")
    data, cov, sigma = _iteration(d, seed=1)
    TTE.write_request(d, [d], data, cov, sigma, [0], False, "chto_simple", dict(PARAMS), False,
                      device="cpu")
    JTE.run_request(d)
    assert os.path.isfile(os.path.join(d, "finish.json"))
    model = linna_tpu_torch.retrieve_model(d, 2, 2, "chto_simple", device="cpu")
    assert model.transforms.x_transform.log10_mask.tolist() == [True, False]


def test_train_subprocess_branch(tmp_path):
    """``params["train_subprocess"]`` trains each iteration in ``python -m
    linna_tpu_torch.train_entry`` on the parent's device and samples as
    usual; a rerun finds the finish markers and trains nothing."""
    cov, means = np.diag([0.5, 0.2]), np.array([0.1, 1.0])
    priors = [{"param": f"p{i}", "dist": "flat", "arg1": -2.0, "arg2": 2.0} for i in range(2)]
    kw = dict(
        ntrainArr=[20], nvalArr=[5], nkeepArr=[1], ntimesArr=[2], ntautolArr=[0.5],
        meanshiftArr=[100], stdshiftArr=[100], outdir=str(tmp_path), priors=priors,
        theory=lambda x, o: np.asarray(x[1], dtype=np.float64).copy(), data=means, cov=cov,
        init=np.zeros(2), nwalkers=4, temperatureArr=[1.0], method="zeus", seed=2,
        params={"trainingoption": 1, "num_epochs": 3, "batch_size": 5,
                "train_subprocess": True},
        device="cpu",
    )
    chain, _ = linna_tpu_torch.ml_sampler_core(**kw)
    it0 = tmp_path / "iter_0"
    req = json.loads((it0 / TTE.REQUEST_JSON).read_text())
    assert req["device"] == "cpu" and req["params"]["train_subprocess"] is True
    assert (it0 / "finish.json").exists() and (it0 / "best.ckpt.npz").exists()
    assert np.isfinite(chain).all()
    mtime = os.path.getmtime(it0 / "best.ckpt.npz")
    linna_tpu_torch.ml_sampler_core(**kw)
    assert os.path.getmtime(it0 / "best.ckpt.npz") == mtime
