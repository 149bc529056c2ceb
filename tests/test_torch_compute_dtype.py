"""bfloat16 inference (``make_log_prob(compute_dtype="bfloat16")``) in the
port against the JAX package's, and the rule both packages' networks round
by: each product accumulates in float32, the bias (or a residual block's
skip product) is added in float32, and the sum is rounded once to the
weights' type; Python constants are rounded to that type first.

Tolerances: the JAX test's own rtol = atol = 0.05 on the log-posterior
(tests/test_compute_dtype.py), single emulator and K=2, with and without the
pre-model; beside it the port must sit ten times closer to JAX's bf16 result
than bf16 sits to float32 (measured: 2e-7 against 3e-4 relative).  The
statistical rule of the JAX test for f32 against bf16 posteriors: means
within 0.1 sigma, stds within 10 %."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from linna_tpu import likelihood as JLK
from linna_tpu import linear_model as JLM
from linna_tpu import nn as JN
from linna_tpu_torch import likelihood as TLK
from linna_tpu_torch import linear_model as TLM
from linna_tpu_torch import nn as TN
from linna_tpu_torch import priors as TP
from linna_tpu_torch import transforms as TT
from linna_tpu_torch.samplers import hmc, stretch
from linna_tpu_torch.samplers import run as TR

from _torch_parity import CPU, problem, t, walkers

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bf16_tree(tree):
    return {k: _bf16_tree(v) if isinstance(v, dict) else v.to(torch.bfloat16)
            for k, v in tree.items()}


def _pre_models(pb):
    rng = np.random.default_rng(9)
    x = rng.uniform(-1, 1, (80, pb.spec.in_size))
    y = np.tanh(x @ rng.normal(size=(pb.spec.in_size, pb.spec.out_size)))
    jlm = JLM.fit_linear_model(x, y, norder=2)
    return jlm, TLM.LinearModel(*(np.asarray(getattr(jlm, k)) for k in TLM.FIELDS), device=CPU)


@pytest.mark.parametrize("model", ["chto_v2", "chto_simple"])
def test_bf16_forward_rounds_like_jax(model):
    """The network's bf16 forward against JAX's on the same bf16 weights:
    equal on at least 99 % of the outputs and never more than one bf16 step
    of the output's scale apart.  Rounding the product before adding the
    bias (twice per layer) misses that."""
    pb = problem(ndim=5, ndata=40, model=model)
    x = walkers(256, 5)
    pj = jax.tree.map(lambda a: a.astype(jnp.bfloat16), pb.params_j)
    want = np.asarray(JN.apply_model(pb.spec, pj, jnp.asarray(x, jnp.bfloat16)), np.float32)
    pt = _bf16_tree(pb.params_t)
    with torch.no_grad():
        got = TN.apply_model(pb.tspec, pt, t(x).to(torch.bfloat16))
        twice = torch.relu(t(x).to(torch.bfloat16) @ pt["layer1"]["w"] + pt["layer1"]["b"])
        once = torch.relu(TN._linear(pt["layer1"], t(x).to(torch.bfloat16)))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.mean(got == want) >= 0.99
    assert np.abs(got - want).max() <= 2.0**-7 * np.abs(want).max()
    want1 = np.asarray(jax.nn.relu(JN._linear(pj["layer1"], jnp.asarray(x, jnp.bfloat16))),
                       np.float32)
    npt.assert_array_equal(once.float().numpy(), want1)
    assert np.mean(twice.float().numpy() == want1) < 0.99


@pytest.mark.parametrize("members,premodel", [(1, False), (2, False), (1, True), (2, True)])
def test_bf16_log_prob_matches_jax(members, premodel):
    """Single emulator and K=2, with and without the pre-model (which sees
    the bf16-rounded inputs in both packages): float32 output within the
    JAX test's tolerance, much closer than bf16 is to float32; finite
    float32 gradients."""
    pb = problem(ndim=5, ndata=8)
    if members == 1:
        pj, pt = pb.params_j, pb.params_t
    else:
        pj = [JN.init_model(jax.random.key(10 + k), pb.spec) for k in range(members)]
        pt = [TN.params_from_numpy(jax.device_get(p), CPU) for p in pj]
    jlm, tlm = _pre_models(pb) if premodel else (None, None)
    args = (pb.ts_j, pb.pack_j, pb.data, pb.inv_cov)
    lp16_j = JLK.make_log_prob(pb.spec, pj, *args, linearmodel=jlm, compute_dtype="bfloat16")
    lp32_j = JLK.make_log_prob(pb.spec, pj, *args, linearmodel=jlm)
    lp16_t = TLK.make_log_prob(pb.tspec, pt, pb.ts_t, pb.pack_t, pb.data, pb.inv_cov,
                               linearmodel=tlm, compute_dtype="bfloat16", device=CPU)
    x = walkers(64, 5, seed=3)
    got = lp16_t(t(x))
    assert got.dtype == torch.float32
    want, f32 = np.asarray(lp16_j(jnp.asarray(x))), np.asarray(lp32_j(jnp.asarray(x)))
    npt.assert_allclose(got.numpy(), want, rtol=0.05, atol=0.05)
    rel = lambda a, b: np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b)))  # noqa: E731
    assert 0 < rel(want, f32) and rel(got.numpy(), want) <= 0.1 * rel(want, f32)
    lp, g = hmc.value_and_grad(lp16_t, t(x[:8]))
    assert g.dtype == torch.float32 and torch.isfinite(g).all() and torch.isfinite(lp).all()


def test_bf16_weights_are_cast_once():
    """The parameters are cast at build time (stacked first for an
    ensemble); the caller's tensors are left in float32."""
    pb = problem(ndim=5, ndata=8)
    pt = [pb.params_t, TN.params_from_numpy(jax.device_get(
        JN.init_model(jax.random.key(3), pb.spec)), CPU)]
    lp = TLK.make_log_prob(pb.tspec, pt, pb.ts_t, pb.pack_t, pb.data, pb.inv_cov,
                           compute_dtype="bfloat16", device=CPU)
    w = lp._env["params"]["layer1"]["w"]
    assert w.dtype == torch.bfloat16 and w.shape[0] == 2
    assert pt[0]["layer1"]["w"].dtype == torch.float32


def test_bf16_rejects_fused_and_non_float_types():
    pb = problem(ndim=5, ndata=8)
    args = (pb.tspec, pb.params_t, pb.ts_t, pb.pack_t, pb.data, pb.inv_cov)
    with pytest.raises(ValueError, match="use_fused supports float32 only"):
        TLK.make_log_prob(*args, use_fused=True, compute_dtype="bfloat16", device=CPU)
    with pytest.raises(ValueError, match="floating-point"):
        TLK.make_log_prob(*args, compute_dtype="int8", device=CPU)


def _setup(ndim=3, ndata=5):
    """tests/test_compute_dtype.py's problem: identity transforms, flat
    priors, chto_simple."""
    ts = TT.TransformSet(
        TT.XTransform(torch.zeros(ndim), torch.ones(ndim), torch.zeros(ndim, dtype=torch.bool)),
        TT.YTransform(torch.zeros(ndata), torch.ones(ndata), False),
        TT.YTransformData(torch.ones(ndata)),
    )
    pack = TP.priors_from_list([{"param": "a", "dist": "flat", "arg1": -2.0, "arg2": 2.0}] * ndim,
                               CPU)
    spec = JN.make_model_spec("chto_simple", ndim, ndata)
    params = TN.params_from_numpy(jax.device_get(JN.init_model(jax.random.key(1), spec)), CPU)
    return (TN.make_model_spec("chto_simple", ndim, ndata), params, ts, pack,
            0.1 * np.arange(ndata) - 0.2, np.eye(ndata))


def test_bf16_posterior_parity_statistical():
    """The same emulator posterior sampled in f32 and in bf16 from the same
    draws: means within 0.1 sigma, stds within 10 % (the JAX test's rule)."""
    args = _setup()
    lp32 = TLK.make_log_prob(*args, device=CPU)
    lp16 = TLK.make_log_prob(*args, compute_dtype="bfloat16", device=CPU)
    x0 = 0.1 * torch.randn((32, 3), generator=torch.Generator().manual_seed(7))

    def run(lp):
        g = torch.Generator().manual_seed(11)
        _, chain, _ = stretch.stretch_chunk(lp, stretch.init_state(g, x0, lp), 600, 2.0)
        flat = chain[200:].reshape(-1, 3).double().numpy()
        return flat.mean(axis=0), flat.std(axis=0)

    m32, s32 = run(lp32)
    m16, s16 = run(lp16)
    assert np.all(np.abs(m32 - m16) / s32 < 0.1)
    assert np.all(np.abs(s32 - s16) / s32 < 0.1)


@pytest.mark.parametrize("method", ["emcee", "zeus", "hmc", "nuts"])
def test_every_sampler_runs_through_the_pre_model_in_bf16(method, tmp_path):
    """``run_ensemble`` on a likelihood with the pre-model and bf16
    inference: finite chains, and for HMC and NUTS a MAP search whose
    Hessian (``torch.func.hessian`` through the pre-model) is finite."""
    pb = problem(ndim=5, ndata=8)
    _, tlm = _pre_models(pb)
    lp = TLK.make_log_prob(pb.tspec, pb.params_t, pb.ts_t, pb.pack_t, pb.data, pb.inv_cov,
                           linearmodel=tlm, compute_dtype="bfloat16", device=CPU)
    steps = {"emcee": 20, "zeus": 10, "hmc": 5, "nuts": 5}[method]
    x0 = walkers(8, 5, seed=4, scale=0.1)
    backend = TR.run_ensemble(lp, x0, str(tmp_path), method=method, check_every=steps,
                              max_iterations=steps, convergence_check=False, seed=0, device=CPU)
    chain = backend.get_chain()
    assert chain.shape == (steps, 8, 5) and np.isfinite(chain).all()
    assert np.isfinite(backend.get_log_prob()).all()
    if method in ("hmc", "nuts"):
        pre = TR._load_precond(os.path.join(str(tmp_path), TR.PRECOND_FILENAME))
        assert pre is not None and np.isfinite(pre.scales).all() and np.all(pre.scales > 0)


def test_driver_runs_both_keys_and_the_subprocess_writes_the_pre_model(tmp_path):
    """tests/test_torch_driver.py's CLI run with ``linearmodel: {norder: 1}``,
    ``compute_dtype: bfloat16`` and ``train_subprocess``: the child trains
    with the pre-model and writes ``linear_model.npz`` in each iteration."""
    inputs = tmp_path / "inputs"
    inputs.mkdir()
    np.savetxt(inputs / "data.txt", np.stack([np.arange(2), [0.3, -0.2]], 1))
    np.savetxt(inputs / "cov_triplet.txt", np.array([[0, 0, 0.0, 0.3], [1, 1, 0.25, 0.25]]))
    (tmp_path / "run.yaml").write_text(
        "nwalkers: 8\nnnmodel: chto_v2\ntrainingoption: 1\nnum_epochs: 8\nbatch_size: 16\n"
        "ntrainArr: [40, 40]\nnvalArr: [10, 10]\nnkeepArr: [2, 2]\nntimesArr: [0, 0]\n"
        "ntautolArr: [.inf, .inf]\nmeanshiftArr: [.inf, .inf]\nstdshiftArr: [.inf, .inf]\n"
        "temperatureArr: [2.0, 1.0]\nseed: 7\nmethodArr: [zeus, nuts]\n"
        "linearmodel: {norder: 1}\ncompute_dtype: bfloat16\ntrain_subprocess: true\n"
        f"outdir: {tmp_path}/out\ntheory: identity\nbase_dir: {inputs}\n"
        "data_file: data.txt\ncov_file: cov_triplet.txt\n"
        "sampled_params:\n"
        "  - {param: x0, dist: flat, arg1: -2.0, arg2: 2.0}\n"
        "  - {param: x1, dist: flat, arg1: -2.0, arg2: 2.0}\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "linna_tpu_torch.driver", "zeus", "None",
         str(tmp_path / "run.yaml"), str(tmp_path), "--device", "cpu"],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = tmp_path / "out"
    for i in range(2):
        it = out / f"iter_{i}"
        assert (it / "linear_model.npz").exists() and (it / "train_request.json").exists()
    assert (out / "iter_1" / "precond.npz").exists() and (out / "time.npy").exists()
    lm = TLM.load_linear_model(str(out / "iter_1" / "linear_model.npz"), device=CPU)
    assert lm.powers.shape == (3, 2)  # degree 1 in 2 inputs
