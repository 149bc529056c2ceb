"""The sampling stage of one iteration, end to end: the JAX package writes
the iteration directory, the port samples it on the CPU through
retrieve_model -> make_log_prob(use_fused=True) -> run_ensemble(zeus) ->
read_chain_and_cut, and the JAX package samples a copy of the same
directory.  The chain files, log-probs and statistics are compared across
the two packages."""

import json
import os
import shutil
import warnings
from types import SimpleNamespace

import h5py
import jax
import numpy as np
import pytest
import torch

from linna_tpu import likelihood as JLK
from linna_tpu import nn as JN
from linna_tpu import orchestrator as JO
from linna_tpu import priors as JP
from linna_tpu import transforms as JT
from linna_tpu.samplers import backends as JB
from linna_tpu.samplers import run as JR
from linna_tpu.utils import checkpoint as JC
from linna_tpu_torch import likelihood as TLK
from linna_tpu_torch import orchestrator as TO
from linna_tpu_torch import priors as TP
from linna_tpu_torch.samplers import backends as TB
from linna_tpu_torch.samplers import run as TR

torch.set_num_threads(1)

CPU = "cpu"
NDIM, NDATA, NWALKERS, STEPS, T2 = 3, 8, 16, 300, 4.0
PRIORS = [
    {"param": "a", "dist": "gauss", "arg1": 0.3, "arg2": 1.0},
    {"param": "b", "dist": "flat", "arg1": -2.0, "arg2": 2.0},
    {"param": "c", "dist": "flat", "arg1": -1.0, "arg2": 3.0},
]
# never converged within the run (tautol), so both packages run all STEPS
# steps and still evaluate the tau checks on their cadence
RUN_KW = dict(method="zeus", check_every=100, max_iterations=STEPS, tautol=1e-12, seed=0)


def _write_iteration_dir(outdir, rng):
    """An iteration directory as the JAX trainer leaves it."""
    os.makedirs(outdir)
    spec = JN.make_model_spec("chto_v2", NDIM, NDATA)
    params = JN.init_model(jax.random.key(1), spec)
    pack = JP.priors_from_list(PRIORS)
    train_x = JP.transform_np(pack, rng.normal(size=(400, NDIM)))
    train_y = 5.0 + train_x @ rng.normal(size=(NDIM, NDATA))
    sigma = 0.05 * np.abs(train_y.mean(axis=0)) + 0.05
    ts = JT.TransformSet(
        JT.fit_x_transform(train_x), JT.fit_y_transform(train_y / sigma),
        JT.YTransformData(sigma.astype(np.float32)),
    )
    np.savetxt(os.path.join(outdir, "train_samples_x.txt"), train_x)
    np.save(os.path.join(outdir, "train_samples_y.npy"), train_y)
    JT.save_transforms(os.path.join(outdir, JO.TRANSFORMS_FILE), ts)
    JC.save_checkpoint(os.path.join(outdir, "best.ckpt.npz"), params, meta={"seed": 1})
    with open(os.path.join(outdir, JO.FINISH_MARKER), "w") as f:
        json.dump({"status": "done"}, f)
    truth = JP.transform_np(pack, 0.3 * rng.normal(size=(1, NDIM)))
    pred = ts.y_data.inverse(ts.y_transform(JN.apply_model(spec, params, ts.x_transform(truth))))
    data = np.asarray(pred[0], np.float64) + sigma * rng.normal(size=NDATA)
    return data, np.diag(sigma**2), truth[0]


def _run_port(outdir, data, cov, x0, **kw):
    model = TO.retrieve_model(outdir, NDIM, NDATA, device=CPU)
    params = TO.retrieve_ensemble_params(outdir, model)
    pack = TP.priors_from_list(PRIORS, CPU)
    lp = TLK.make_log_prob(model.spec, params if len(params) > 1 else model.params,
                           model.transforms, pack, data, np.linalg.inv(cov),
                           temperature=T2, use_fused=True, device=CPU)
    TR.run_ensemble(lp, x0, outdir, transform=lambda x: TP.transform_np(pack, x),
                    device=CPU, **{**RUN_KW, **kw})
    return lp


def _run_jax(outdir, data, cov, x0, **kw):
    trainer = JO.retrieve_model(outdir, NDIM, NDATA)
    pack = JP.priors_from_list(PRIORS)
    lp = JLK.make_log_prob(trainer.spec, trainer.params, trainer.transforms, pack, data,
                           np.linalg.inv(cov), temperature=T2, use_fused=True)
    JR.run_ensemble(lp, x0, outdir, transform=lambda x: JP.transform_np(pack, x),
                    **{**RUN_KW, **kw})
    return lp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("slice_path")
    rng = np.random.default_rng(0)
    fresh = str(root / "fresh")
    data, cov, truth = _write_iteration_dir(fresh, rng)
    init_white = np.asarray(JP.inv_transform(JP.priors_from_list(PRIORS), truth))
    x0 = init_white + 0.001 * rng.standard_normal((NWALKERS, NDIM))
    port_dir, jax_dir = str(root / "port"), str(root / "jax")
    shutil.copytree(fresh, port_dir)
    shutil.copytree(fresh, jax_dir)
    lp_t = _run_port(port_dir, data, cov, x0)
    lp_j = _run_jax(jax_dir, data, cov, x0)
    name = TR.ZEUS_FILENAME
    return SimpleNamespace(
        root=root, fresh=fresh, data=data, cov=cov, x0=x0, lp_t=lp_t, lp_j=lp_j,
        port=os.path.join(port_dir, name), jax=os.path.join(jax_dir, name),
    )


def _layout(path):
    with h5py.File(path, "r") as f:
        datasets = {k: (v.shape, v.dtype.str) for k, v in f.items() if isinstance(v, h5py.Dataset)}
        state = {k: np.asarray(v).dtype.kind for k, v in f[TB.STATE_GROUP].items()}
        return datasets, dict(f.attrs), state, {k: np.asarray(v) for k, v in f[TB.STATE_GROUP].items()}


def test_chain_file_layout_matches_jax(runs):
    assert TB.store_kind() == "hdf5"
    d_t, attrs_t, state_t, blob_t = _layout(runs.port)
    d_j, attrs_j, state_j, blob_j = _layout(runs.jax)
    assert d_t == d_j
    assert d_t["samples"][0] == (STEPS, NWALKERS, NDIM)
    assert int(attrs_t["iteration"]) == int(attrs_j["iteration"]) == STEPS
    # the same exact-resume fields, except the RNG: rng_state here, key in JAX
    assert "rng_state" in state_t and "key" not in state_t and "key" in state_j
    assert {k: v for k, v in state_t.items() if k != "rng_state"} == {
        k: v for k, v in state_j.items() if k != "key"
    }
    for blob in (blob_t, blob_j):
        assert bool(blob["_finished"]) and not bool(blob["_converged"])
        assert blob["_method"].item() == b"zeus" and int(blob["_iteration"]) == STEPS
    assert not TO._chain_incomplete(runs.port, "zeus")
    assert not JO._chain_incomplete(runs.port, "zeus")


def test_jax_log_prob_reproduces_port_chain(runs):
    reader = TB.ZeusBackend(runs.port)
    samples, stored = reader.get_chain(), reader.get_log_prob()
    want = np.asarray(runs.lp_j(samples.reshape(-1, NDIM).astype(np.float32)))
    np.testing.assert_allclose(stored.reshape(-1), want, rtol=1e-4, atol=1e-4)
    assert np.isfinite(stored).all()


def test_port_chain_statistics_agree_with_jax(runs):
    """Independent chains of one posterior (different RNG streams): the
    means agree within 0.5 posterior sigma and the widths within 35% over
    the last 200 steps (16 walkers x 200 steps, ~10 autocorrelation times;
    the standard error of the mean difference is ~0.1 sigma)."""
    tail_t = TB.ZeusBackend(runs.port).get_chain()[-200:].reshape(-1, NDIM)
    tail_j = JB.ZeusBackend(runs.jax).get_chain()[-200:].reshape(-1, NDIM)
    sd = tail_j.std(axis=0)
    assert np.all(np.abs(tail_t.mean(axis=0) - tail_j.mean(axis=0)) < 0.5 * sd)
    np.testing.assert_allclose(tail_t.std(axis=0) / sd, 1.0, atol=0.35)


def test_backends_read_each_others_files(runs):
    for path in (runs.port, runs.jax):
        mine, theirs = TB.ZeusBackend(path), JB.ZeusBackend(path)
        assert mine.initialized and theirs.initialized
        assert mine.iteration == theirs.iteration == STEPS
        np.testing.assert_array_equal(mine.get_chain(), theirs.get_chain())
        np.testing.assert_array_equal(mine.get_log_prob(discard=50, thin=3),
                                      theirs.get_log_prob(discard=50, thin=3))
        np.testing.assert_array_equal(mine.get_last_sample(), theirs.get_last_sample())
        assert mine.load_state().keys() == theirs.load_state().keys()


def test_read_chain_and_cut_matches_jax(runs):
    c_t, l_t, _ = TO.read_chain_and_cut(runs.port, nk=2, ntimes=10, method="zeus", flat=True)
    c_j, l_j, _ = JO.read_chain_and_cut(runs.port, nk=2, ntimes=10, method="zeus", flat=True)
    np.testing.assert_array_equal(c_t, c_j)
    np.testing.assert_array_equal(l_t, l_j)
    assert c_t.shape[1] == NDIM and l_t.shape == (c_t.shape[0], 1)


def test_port_exact_resume_is_bitwise(runs):
    """200 steps, then a restart to 300, equals the uninterrupted run."""
    d = str(runs.root / "resume")
    shutil.copytree(runs.fresh, d)
    _run_port(d, runs.data, runs.cov, runs.x0, max_iterations=200)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # an exact resume warns about nothing
        _run_port(d, runs.data, runs.cov, runs.x0)
    resumed = TB.ZeusBackend(os.path.join(d, TR.ZEUS_FILENAME))
    whole = TB.ZeusBackend(runs.port)
    np.testing.assert_array_equal(resumed.get_chain(), whole.get_chain())
    np.testing.assert_array_equal(resumed.get_log_prob(), whole.get_log_prob())


def test_each_package_resumes_the_others_chain_statistically(runs):
    for src, run, other in ((runs.jax, _run_port, "port"), (runs.port, _run_jax, "jax")):
        d = str(runs.root / f"cross_{other}")
        shutil.copytree(os.path.dirname(src), d)
        with pytest.warns(UserWarning, match="fields do not match"):
            run(d, runs.data, runs.cov, runs.x0, max_iterations=STEPS + 100)
        b = TB.ZeusBackend(os.path.join(d, TR.ZEUS_FILENAME))
        assert b.iteration == STEPS + 100
        np.testing.assert_array_equal(b.get_chain()[:STEPS], TB.ZeusBackend(src).get_chain())
        assert np.isfinite(b.get_log_prob()).all()


def test_retrieval_helpers_match_jax(runs):
    x = JP.transform_np(JP.priors_from_list(PRIORS), runs.x0[:5])
    want = np.asarray(JO.retrieve_model_wrapper(runs.fresh)(x))
    got = TO.retrieve_model_wrapper(runs.fresh, device=CPU)(x)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    one = TO.retrieve_model_wrapper(runs.fresh, device=CPU)(x[0])
    assert one.shape == (NDATA,)
    model, incut, outcut = TO.retrieve_model_exist(runs.fresh, NDIM - 1, NDATA - 2, device=CPU)
    _, j_incut, j_outcut = JO.retrieve_model_exist(runs.fresh, NDIM - 1, NDATA - 2)
    assert (incut, outcut) == (j_incut, j_outcut) == (NDIM, NDATA - 2)
    assert model.spec.out_size == NDATA and model.linearmodel is None
    with pytest.raises(ValueError, match="narrower model"):
        TO.retrieve_model_exist(runs.fresh, NDIM, NDATA + 1, device=CPU)
