"""``ml_sampler_core`` through the port on the CPU with zeus: the artifact
contract of tests/test_end_to_end.py, the file-gated resume, the
paper-defaults entry, and the pre-model (``linearmodel``) and bf16
inference (``compute_dtype``) parameters."""

import os
from copy import deepcopy

import numpy as np
import numpy.testing as npt
import pytest
import torch

import linna_tpu_torch
from linna_tpu_torch import likelihood as TLK
from linna_tpu_torch import orchestrator as TO
from linna_tpu_torch.samplers import run as TR

torch.set_num_threads(1)

NDIM = 2
COV = np.diag([0.5, 0.2])
MEANS = np.array([0.1, 1.0])
PRIORS = [{"param": f"test_{i}", "dist": "flat", "arg1": -2.0, "arg2": 2.0} for i in range(NDIM)]


def theory(x, outdirs):
    return deepcopy(np.asarray(x[1], dtype=np.float64))


def run(outdir, **overrides):
    kwargs = dict(
        ntrainArr=[20], nvalArr=[5], nkeepArr=[1], ntimesArr=[2], ntautolArr=[0.5],
        meanshiftArr=[100], stdshiftArr=[100], outdir=outdir, theory=theory, priors=PRIORS,
        data=MEANS, cov=COV, init=np.random.default_rng(5).uniform(size=NDIM), pool=None,
        nwalkers=4, device="cpu", temperatureArr=[1.0],
        params={"trainingoption": 1, "num_epochs": 10, "batch_size": 5},
        method="zeus", seed=7,
    )
    kwargs.update(overrides)
    return linna_tpu_torch.ml_sampler_core(**kwargs)


def test_pipeline_end_to_end(tmp_path):
    outdir = str(tmp_path / "out")
    chain, logprob = run(outdir)
    assert chain.ndim == 2 and chain.shape[1] == NDIM and len(chain) > 0
    assert np.all(np.isfinite(chain)) and logprob.shape == (len(chain), 1)
    it0 = os.path.join(outdir, "iter_0")
    for f in ["train_samples_x.txt", "train_samples_y.npy", "val_samples_x.txt",
              "val_samples_y.npy", "transforms.npz", "best.ckpt.npz", "last.ckpt.npz",
              "lr.npy", "finish.json"]:
        assert os.path.isfile(os.path.join(it0, f)), f
    assert TO._open_backend(os.path.join(it0, TR.ZEUS_FILENAME), "zeus").exists()
    assert os.path.isfile(os.path.join(outdir, "trace.json"))


def test_pipeline_resume_reads_same_chain(tmp_path):
    outdir = str(tmp_path / "out")
    chain1, lp1 = run(outdir)
    mtime = os.path.getmtime(os.path.join(outdir, "iter_0", "best.ckpt.npz"))
    chain2, lp2 = run(outdir)
    npt.assert_array_equal(chain1, chain2)
    npt.assert_array_equal(lp1, lp2)
    assert os.path.getmtime(os.path.join(outdir, "iter_0", "best.ckpt.npz")) == mtime


def test_ensemble_members_and_serial_members(tmp_path):
    """nensemble=2 trains member 1 into ens_1/, stacked by default and one
    after another with serial_members; both sample the 2-member likelihood."""
    for serial in (False, True):
        outdir = str(tmp_path / f"serial{serial}")
        chain, _ = run(outdir, params={"trainingoption": 1, "num_epochs": 10, "batch_size": 5,
                                       "nensemble": 2, "serial_members": serial})
        for f in ("best.ckpt.npz", "last.ckpt.npz", "lr.npy"):
            assert os.path.isfile(os.path.join(outdir, "iter_0", "ens_1", f)), f
        assert np.all(np.isfinite(chain))


def test_ml_sampler_turnkey_defaults(monkeypatch):
    captured = {}

    def fake_core(ntrainArr, nvalArr, nkeepArr, ntimesArr, ntautolArr, *args, **kwargs):
        captured.update(ntrainArr=ntrainArr, nkeepArr=nkeepArr, ntimesArr=ntimesArr,
                        ntautolArr=ntautolArr, **kwargs)
        return np.zeros((1, 2)), np.zeros((1, 1))

    monkeypatch.setattr(TO, "ml_sampler_core", fake_core)
    common = dict(outdir="/unused", theory=theory, priors=[], data=np.zeros(3), cov=np.eye(3),
                  init=np.zeros(2), device="cpu")
    TO.ml_sampler(**common)
    assert captured["ntrainArr"] == [10000] * 4 and captured["ntimesArr"] == [5, 5, 10, 50]
    assert captured["params"]["nensemble"] == 4 and captured["method"] == ["zeus"] * 4
    assert captured["temperatureArr"] == [4.0, 2.0, 1.0, 1.0] and captured["device"] == "cpu"
    with pytest.raises(ValueError, match="4 iterations"):
        TO.ml_sampler(method=["zeus", "zeus"], **common)
    # every sampler runs: emcee has its own convergence table, hmc and nuts
    # zeus's (the JAX package's ml_sampler table)
    TO.ml_sampler(method="emcee", **common)
    assert captured["nkeepArr"] == [2, 2, 5, 4] and captured["ntimesArr"] == [5, 5, 10, 15]
    TO.ml_sampler(method=["zeus", "zeus", "zeus", "nuts"], **common)
    assert captured["method"] == ["zeus", "zeus", "zeus", "nuts"]
    assert captured["ntimesArr"] == [5, 5, 10, 50] and captured["ntautolArr"][-1] == 0.01
    with pytest.raises(NotImplementedError):
        TO.ml_sampler(method="not_a_sampler", **common)


@pytest.mark.parametrize("params", [
    {"linearmodel": True},
    {"compute_dtype": "bfloat16"},
])
def test_unported_parameters_raise(params, tmp_path):
    """Both parameters are ported: the pipeline runs with each, the
    pre-model is fitted, saved and retrieved, and a rerun resumes."""
    outdir = str(tmp_path / "out")
    kw = dict(params={"trainingoption": 1, "num_epochs": 2, "batch_size": 5, **params})
    chain, logprob = run(outdir, **kw)
    assert np.all(np.isfinite(chain)) and np.all(np.isfinite(logprob))
    it0 = os.path.join(outdir, "iter_0")
    has_lm = os.path.isfile(os.path.join(it0, TO.LINEAR_MODEL_FILE))
    assert has_lm == ("linearmodel" in params)
    assert (TO.retrieve_model(it0, NDIM, NDIM, device="cpu").linearmodel is not None) == has_lm
    npt.assert_array_equal(run(outdir, **kw)[0], chain)


def test_make_log_prob_refuses_compute_dtype():
    """bf16 inference runs on the composition and returns float32 near the
    float32 result; the float32-only kernel refuses it."""
    from linna_tpu_torch import nn as TN, priors as TP, transforms as TT

    spec = TN.make_model_spec("chto_v2", 3, 4)
    ts = TT.TransformSet(
        TT.XTransform(torch.zeros(3), torch.ones(3), torch.zeros(3, dtype=torch.bool)),
        TT.YTransform(torch.zeros(4), torch.ones(4), False), TT.YTransformData(torch.ones(4)),
    )
    pack = TP.priors_from_list([{"dist": "flat", "arg1": -1, "arg2": 1}] * 3, "cpu")
    args = (spec, TN.init_model(spec, device="cpu"), ts, pack, np.zeros(4), np.eye(4))
    with pytest.raises(ValueError, match="use_fused supports float32 only"):
        TLK.make_log_prob(*args, use_fused=True, compute_dtype="bfloat16", device="cpu")
    x = torch.randn((6, 3), generator=torch.Generator().manual_seed(0)) * 0.3
    lp16 = TLK.make_log_prob(*args, compute_dtype="bfloat16", device="cpu")(x)
    lp32 = TLK.make_log_prob(*args, compute_dtype=None, device="cpu")(x)
    assert lp16.dtype == lp32.dtype == torch.float32 and lp16.shape == (6,)
    assert not torch.equal(lp16, lp32)
    npt.assert_allclose(lp16.numpy(), lp32.numpy(), rtol=0.05, atol=0.05)


def test_entry_points_without_a_card_raise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        run(str(tmp_path / "out"), device=None)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        TO.train_emulator(str(tmp_path), [str(tmp_path)], MEANS, COV, np.ones(2), None, False,
                          "chto_v2", {})
    from linna_tpu_torch import losses as TL, nn as TN, transforms as TT
    from linna_tpu_torch.parallel import EnsembleTrainer

    ts = TT.TransformSet(
        TT.XTransform(torch.zeros(2), torch.ones(2), torch.zeros(2, dtype=torch.bool)),
        TT.YTransform(torch.zeros(2), torch.ones(2), False), TT.YTransformData(torch.ones(2)),
    )
    spec, ls = TN.make_model_spec("chto_v2", 2, 2), TL.build_loss_state(MEANS, COV, ts)
    for make in (lambda: linna_tpu_torch.Trainer(spec, ts, ls),
                 lambda: EnsembleTrainer(spec, ts, ls, [None, None], [0, 1])):
        with pytest.raises(RuntimeError, match="pass device='cpu'"):
            make()
