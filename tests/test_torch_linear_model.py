"""The PCA + polynomial pre-model (``linear_model``) in the port against the
JAX package's: the monomial powers (exactly), the float64 fit (every field
within rtol 1e-6, also with the feature matrix built in row chunks), the
model's values (rtol 1e-5), its gradient and one-row Hessian at the training
mean where every standardized input is 0 (rtol 1e-5 and 1e-4), the npz
file both ways, the network with the pre-model added, the trainers' loss
and epoch chunks with a frozen pre-model (f32 and bf16), the linear_bypass
rejections, and iteration directories with a pre-model crossing the
packages both ways."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from linna_tpu import linear_model as JLM
from linna_tpu import nn as JN
from linna_tpu import orchestrator as JO
from linna_tpu import train as JTR
from linna_tpu.parallel import ensemble as JE
from linna_tpu_torch import linear_model as TLM
from linna_tpu_torch import nn as TN
from linna_tpu_torch import orchestrator as TO
from linna_tpu_torch import train as TTR
from linna_tpu_torch.parallel.ensemble import EnsembleTrainer

from _torch_parity import CPU, problem, walkers
from test_torch_train import _jax_params, _problem

torch.set_num_threads(1)


def _xy(seed, n=120, ndim=3, nout=5):
    """A smooth map with quadratic and non-polynomial parts, plus noise."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, ndim))
    latent = np.stack([x[:, 0] * x[:, -1] + 0.5 * x[:, 1 % ndim], x[:, -1] ** 2 - x[:, 0],
                       np.sin(2 * x[:, 0])], 1)
    y = latent @ rng.standard_normal((3, nout)) + 3.0
    return x, y + 0.01 * rng.standard_normal(y.shape)


def _carry(jlm) -> TLM.LinearModel:
    """A JAX-fitted model's fields as the port's module."""
    return TLM.LinearModel(*(np.asarray(getattr(jlm, k)) for k in TLM.FIELDS), device=CPU)


def _fit_both(x, y, **kw):
    return JLM.fit_linear_model(x, y, **kw), TLM.fit_linear_model(x, y, device=CPU, **kw)


@pytest.mark.parametrize("ndim,degree", [(1, 3), (2, 2), (4, 3), (27, 2)])
def test_polynomial_powers_equal_jax(ndim, degree):
    got, want = TLM.polynomial_powers(ndim, degree), JLM.polynomial_powers(ndim, degree)
    assert got.dtype == want.dtype == np.int32
    npt.assert_array_equal(got, want)


@pytest.mark.parametrize("npc,norder,weighted,chunk", [
    (2, 2, False, None), (None, 2, False, None), (None, 1, True, None), (3, 3, False, 7),
    (None, 2, True, 16),
])
def test_fit_matches_jax(npc, norder, weighted, chunk, monkeypatch):
    """The same float64 fit: with ``npc`` given and chosen by the s/s0 rule,
    weighted, and with the feature matrix built in row chunks smaller than
    the rows."""
    if chunk is not None:
        monkeypatch.setattr(TLM, "FIT_CHUNK_ROWS", chunk)
    x, y = _xy(0)
    w = np.random.default_rng(1).uniform(0.5, 2.0, len(x)) if weighted else None
    j, t = _fit_both(x, y, norder=norder, npc=npc, sample_weight=w)
    for k in TLM.FIELDS:
        got, want = getattr(t, k).numpy(), np.asarray(getattr(j, k))
        assert got.dtype == want.dtype and got.shape == want.shape, k
        npt.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=k)
    if npc is None:
        assert 1 <= t.vec.shape[0] < y.shape[1]  # the rule dropped components
    assert set(t.state_dict()) == set(TLM.FIELDS)


def test_values_gradient_and_hessian_match_jax_at_the_training_mean():
    """On (B, D) and (D,) rows, and at an input equal to the training mean
    (every standardized lane 0, where a power-rule derivative of x**0 would
    be NaN): the Jacobian against ``jax.jacrev`` and the one-row Hessian
    through ``torch.func.hessian``, as the MAP search takes it, against
    ``jax.hessian``."""
    x, y = _xy(2)
    jlm, tlm = _fit_both(x, y, norder=2)
    xb = walkers(9, 3, seed=3, scale=0.6)
    npt.assert_allclose(tlm(torch.as_tensor(xb)).numpy(), np.asarray(jlm(jnp.asarray(xb))),
                        rtol=1e-5, atol=1e-6)
    one = tlm(torch.as_tensor(xb[0]))
    assert one.shape == (5,)
    npt.assert_allclose(one.numpy(), np.asarray(jlm(jnp.asarray(xb[0]))), rtol=1e-5, atol=1e-6)

    z = np.asarray(jlm.xmean)
    assert np.all(((z - np.asarray(jlm.xmean)) / np.asarray(jlm.xstd)) == 0)
    jac_t = torch.func.jacrev(tlm)(torch.as_tensor(z)).numpy()
    jac_j = np.asarray(jax.jacrev(jlm)(jnp.asarray(z)))
    assert np.isfinite(jac_t).all() and np.abs(jac_j).max() > 0
    npt.assert_allclose(jac_t, jac_j, rtol=1e-5, atol=1e-5 * np.abs(jac_j).max())
    # a degree-2 model's Hessian is the same everywhere: the port's at the
    # mean against JAX's at a row and at the mean, where the JAX package's
    # power rule gives 0 * x**-1 = NaN on every lane of power 1
    hessian_t = torch.func.hessian(lambda v: tlm(v[None, :])[0])
    hess_t = hessian_t(torch.as_tensor(z)).numpy()
    hess_j = np.asarray(jax.hessian(jlm)(jnp.asarray(xb[0])))
    assert hess_t.shape == hess_j.shape == (5, 3, 3) and np.isfinite(hess_t).all()
    npt.assert_allclose(hess_t, hess_j, rtol=1e-4, atol=1e-4 * np.abs(hess_j).max())
    npt.assert_allclose(hessian_t(torch.as_tensor(xb[0])).numpy(), hess_j, rtol=1e-4,
                        atol=1e-4 * np.abs(hess_j).max())
    assert np.isnan(np.asarray(jax.hessian(jlm)(jnp.asarray(z)))).any()
    # autograd's backward at the mean too (the samplers' per-walker path)
    zt = torch.as_tensor(np.repeat(z[None], 4, 0)).requires_grad_(True)
    (g,) = torch.autograd.grad(tlm(zt).sum(), zt)
    npt.assert_allclose(g.numpy()[0], jac_j.sum(0), rtol=1e-5, atol=1e-5 * np.abs(jac_j).max())


def test_npz_round_trip_both_ways(tmp_path):
    """The same keys, dtypes and values from either package's writer; each
    package loads the other's file and computes what it computed."""
    x, y = _xy(4)
    jlm, tlm = _fit_both(x, y, norder=2)
    pj, pt = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    JLM.save_linear_model(pj, jlm)
    TLM.save_linear_model(pt, tlm)
    with np.load(pj) as a, np.load(pt) as b:
        assert sorted(a.files) == sorted(b.files) == sorted(TLM.FIELDS)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            npt.assert_array_equal(a[k], b[k], err_msg=k)
    assert np.load(pt)["powers"].dtype == np.int32
    xb = walkers(6, 3, seed=5)
    npt.assert_array_equal(TLM.load_linear_model(pj, device=CPU)(torch.as_tensor(xb)).numpy(),
                           tlm(torch.as_tensor(xb)).numpy())
    npt.assert_array_equal(np.asarray(JLM.load_linear_model(pt)(jnp.asarray(xb))),
                           np.asarray(jlm(jnp.asarray(xb))))


@pytest.mark.parametrize("model", ["chto_v2", "chto_simple", "chto_v2_linear"])
def test_apply_model_with_the_pre_model_matches_jax(model):
    """The network plus the pre-model; a linear_bypass spec ignores it in
    both packages."""
    pb = problem(ndim=3, ndata=5, model=model)
    jlm = JLM.fit_linear_model(*_xy(5), norder=2)
    xb = walkers(17, 3, seed=6)
    with torch.no_grad():
        got = TN.apply_model(pb.tspec, pb.params_t, torch.as_tensor(xb), linearmodel=_carry(jlm))
        bare = TN.apply_model(pb.tspec, pb.params_t, torch.as_tensor(xb))
    want = np.asarray(JN.apply_model(pb.spec, pb.params_j, jnp.asarray(xb), linearmodel=jlm))
    npt.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, bare) == (model == "chto_v2_linear")


def _pre_model(pb):
    """A pre-model fitted as train_emulator fits it: x-transformed inputs
    against the standardized targets."""
    tx, ty = pb["rows"][:2]
    ts = pb["ts_j"]
    x_in = np.asarray(ts.x_transform(jnp.asarray(tx, jnp.float32)))
    y_std = np.asarray(ts.y_transform.inverse(ts.y_data(jnp.asarray(ty, jnp.float32))))
    return JLM.fit_linear_model(x_in, y_std, norder=2)


@pytest.mark.parametrize("cd,rtol", [(None, 1e-5), ("bfloat16", 4e-4)])
def test_trainer_loss_with_a_pre_model_matches_jax(cd, rtol):
    pb = _problem(seed=4, model="chto_v2", ndata=5)
    jlm = _pre_model(pb)
    params_j = _jax_params(pb["spec"], 2)
    tx, ty = pb["rows"][:2]
    bx, by = jnp.asarray(tx[:32], jnp.float32), jnp.asarray(ty[:32], jnp.float32)
    losses = {}
    for lm in (jlm, None):
        jtr = JTR.Trainer(pb["spec"], pb["ts_j"], pb["ls_j"], params=params_j, compute_dtype=cd,
                          linearmodel=lm)
        losses[lm is None] = float(jtr._loss(params_j, bx, by, pb["ts_j"], pb["ls_j"]))
    tr = TTR.Trainer(pb["tspec"], pb["ts_t"], pb["ls_t"], params=jax.device_get(params_j),
                     compute_dtype=cd, linearmodel=_carry(jlm), device=CPU)
    tr._batch_size = 32
    zero = torch.zeros((1, 1))
    got = float(tr._step(tr._prepare(tx, ty), torch.arange(32)[None], TTR.adamw_init(tr.flat),
                         zero, zero)[0])
    npt.assert_allclose(got, losses[False], rtol=rtol)
    assert abs(losses[True] - losses[False]) > 100 * rtol * losses[False]  # the pre-model counts
    # predict adds it too: x transform -> network + pre-model -> y transform
    pred = tr.predict(torch.as_tensor(tx[:5], dtype=torch.float32)).detach().numpy()
    want = JTR.Trainer(pb["spec"], pb["ts_j"], pb["ls_j"], params=params_j, linearmodel=jlm)
    npt.assert_allclose(pred, np.asarray(want.predict(jnp.asarray(tx[:5], jnp.float32))),
                        rtol=1e-5, atol=1e-5)
    assert tr.predict(torch.as_tensor(tx[0], dtype=torch.float32)).shape == (5,)


@pytest.mark.parametrize("seed", [6, 7])
def test_ensemble_chunk_with_a_shared_pre_model_matches_jax(seed):
    """K=2 members sharing one frozen pre-model: an epoch chunk of the port's
    EnsembleTrainer against the JAX package's in float32, the JAX
    permutations injected (tests/test_torch_train.py's rtol 1e-4)."""
    cd, rtol = None, 1e-4
    pb = _problem(seed=seed, model="chto_v2", ndata=5)
    jlm = _pre_model(pb)
    k, bs, n_epochs = 2, 20, 2
    jtr = JE.EnsembleTrainer(pb["spec"], pb["ts_j"], pb["ls_j"], ["/unused"] * k, [3, 4],
                             compute_dtype=cd, linearmodel=jlm)
    jtr._batch_size = bs
    params_j, opt = jtr.params, jtr.opt_state
    opt.hyperparams["learning_rate"] = jnp.asarray([1e-3, 2e-3], jnp.float32)
    opt.hyperparams["weight_decay"] = jnp.asarray([1e-4, 1e-4], jnp.float32)
    ekeys = jax.random.wrap_key_data(
        jnp.stack([jax.random.key_data(jax.random.key(20 + m)) for m in range(k)]))
    tx, ty, vx, vy = (jnp.asarray(a, jnp.float32) for a in pb["rows"])
    start = [jax.device_get(jax.tree.map(lambda a: a[m], params_j)) for m in range(k)]
    _, _, losses_j, vms_j, _, _, _ = jax.device_get(jtr._epochs_members(
        params_j, opt, ekeys, tx, ty, vx, vy, n_epochs, pb["ts_j"], pb["ls_j"]))
    n = tx.shape[0]
    perms = np.stack([
        np.stack([np.asarray(jax.random.permutation(e, n))[: (n // bs) * bs]
                  for e in jax.random.split(jax.random.key(20 + m), n_epochs)])
        for m in range(k)], axis=1)
    tr = EnsembleTrainer(pb["tspec"], pb["ts_t"], pb["ls_t"], [None] * k, [0, 1], params=start,
                         compute_dtype=cd, linearmodel=_carry(jlm), device=CPU)
    tr._batch_size = bs
    tr.lrs[:] = [1e-3, 2e-3]
    tr._set_hypers()
    losses, vms, _, _, _ = tr._epochs_tracked(torch.as_tensor(perms), tr._prepare(*pb["rows"]))
    npt.assert_allclose(losses.numpy(), np.moveaxis(losses_j, 0, 1), rtol=rtol)
    npt.assert_allclose(vms.numpy(), np.moveaxis(vms_j, 0, 1), rtol=rtol)


def test_linearmodel_rejected_for_linear_bypass_spec(tmp_path):
    """apply_model ignores the pre-model for a linear_bypass spec, so each
    entry point refuses the combination (tests/test_linear_model.py's
    contract)."""
    pb = _problem(seed=0, model="chto_v2_linear", ndata=3)
    tlm = _carry(_pre_model(pb))
    with pytest.raises(ValueError, match="linear_bypass"):
        TTR.Trainer(pb["tspec"], pb["ts_t"], pb["ls_t"], linearmodel=tlm, device=CPU)
    with pytest.raises(ValueError, match="linear_bypass"):
        EnsembleTrainer(pb["tspec"], pb["ts_t"], pb["ls_t"], [str(tmp_path)], [0],
                        linearmodel=tlm, device=CPU)
    priors = [{"param": f"l{i}", "dist": "flat", "arg1": -2.0, "arg2": 2.0} for i in range(2)]
    with pytest.raises(ValueError, match="chto_v2_linear"):
        TO.ml_sampler_core(
            ntrainArr=[40], nvalArr=[10], nkeepArr=[1], ntimesArr=[2], ntautolArr=[0.5],
            meanshiftArr=[100], stdshiftArr=[100], outdir=str(tmp_path / "out"),
            theory=lambda x, o: np.asarray(x[1], np.float64).copy(), priors=priors,
            data=np.zeros(2), cov=np.eye(2), init=np.zeros(2), pool=None, nwalkers=8,
            temperatureArr=[1.0],
            params={"trainingoption": 1, "num_epochs": 5, "batch_size": 10,
                    "linearmodel": {"norder": 1}},
            nnmodel_in="chto_v2_linear", method="emcee", seed=5, device=CPU)
    assert not os.path.exists(tmp_path / "out" / "iter_0" / TO.LINEAR_MODEL_FILE)


# ------------------------------------------- iteration directories, both ways

NDIM = 2
COV = np.diag([0.4, 0.3])
MEANS = np.array([0.2, -0.1])
PRIORS = [{"param": f"l{i}", "dist": "flat", "arg1": -2.0, "arg2": 2.0} for i in range(NDIM)]


def _identity(x, o):
    return np.asarray(x[1], np.float64).copy()


def _pipeline_kwargs(outdir, **params):
    """tests/test_linear_model.py's run: one iteration, 40 training points,
    15 epochs, emcee with 8 walkers, ``linearmodel: {norder: 1}``."""
    return dict(
        ntrainArr=[40], nvalArr=[10], nkeepArr=[1], ntimesArr=[2], ntautolArr=[0.5],
        meanshiftArr=[100], stdshiftArr=[100], outdir=outdir, theory=_identity,
        priors=PRIORS, data=MEANS, cov=COV, init=np.zeros(NDIM), pool=None, nwalkers=8,
        temperatureArr=[1.0],
        params={"trainingoption": 1, "num_epochs": 15, "batch_size": 10,
                "linearmodel": {"norder": 1}, **params},
        method="emcee", seed=5,
    )


def _check_wrappers(it0, x):
    """Both packages retrieve the iteration with its pre-model, and their
    wrappers agree (rtol 1e-5); the pre-model really changes the output."""
    port = TO.retrieve_model(it0, NDIM, NDIM, device=CPU)
    jtr = JO.retrieve_model(it0, NDIM, NDIM)
    assert isinstance(port.linearmodel, TLM.LinearModel) and jtr.linearmodel is not None
    with torch.no_grad():
        got = TO.retrieve_model_wrapper(it0, device=CPU)(x).numpy()
        ts = port.transforms
        bare = ts.y_data.inverse(ts.y_transform(
            TN.apply_model(port.spec, port.params, ts.x_transform(torch.as_tensor(x))))).numpy()
    want = np.asarray(JO.retrieve_model_wrapper(it0)(jnp.asarray(x)))
    npt.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert not np.allclose(got, bare)


def test_jax_iteration_with_a_pre_model_retrieves_in_the_port(tmp_path):
    outdir = str(tmp_path / "out")
    JO.ml_sampler_core(**_pipeline_kwargs(outdir))
    it0 = os.path.join(outdir, "iter_0")
    assert os.path.isfile(os.path.join(it0, JO.LINEAR_MODEL_FILE))
    _check_wrappers(it0, walkers(11, NDIM, seed=7, scale=0.5))


def test_port_iteration_with_a_pre_model_retrieves_in_jax(tmp_path):
    """The port's ml_sampler_core with both keys (the pre-model and bf16
    inference) on the CPU; its directory retrieves in the JAX package.  A
    rerun reloads the saved pre-model and resumes without training."""
    outdir = str(tmp_path / "out")
    chain, logp = TO.ml_sampler_core(**_pipeline_kwargs(outdir, compute_dtype="bfloat16"),
                                     device=CPU)
    assert np.isfinite(chain).all() and np.isfinite(logp).all()
    it0 = os.path.join(outdir, "iter_0")
    lm_path = os.path.join(it0, TO.LINEAR_MODEL_FILE)
    mtime = os.path.getmtime(lm_path)
    _check_wrappers(it0, walkers(11, NDIM, seed=8, scale=0.5))
    import json

    with open(os.path.join(outdir, "trace.json")) as f:
        trace = json.load(f)
    assert [r["linear_model_s"] >= 0 for r in trace if r["phase"] == "train_emulator"] == [True]
    chain2, _ = TO.ml_sampler_core(**_pipeline_kwargs(outdir, compute_dtype="bfloat16"),
                                   device=CPU)
    npt.assert_array_equal(chain, chain2)
    assert os.path.getmtime(lm_path) == mtime
