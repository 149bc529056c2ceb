"""``bench_exact_posterior_torch.py`` against the JAX package: the torch
mirror of ``SyntheticSurveyTheory.data_vector`` for the three analysis
classes (float64 against the numpy map, float32 against ``data_vector_jax``),
the exact log-posterior and its gradient against the JAX composition that
``bench_exact_posterior.py`` samples, and a short CPU run that writes the
stored ``EXACT_POSTERIOR*.json``'s keys."""

import importlib
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linna_tpu_torch
from linna_tpu import priors as JP
from linna_tpu.likelihood import gaussian_loglike as j_gaussian_loglike

REPO = pathlib.Path(linna_tpu_torch.__file__).parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
import bench_exact_posterior_torch as E  # noqa: E402
from bench_common import default_config_yaml, theory_tag  # noqa: E402
from linna_tpu_torch.config import yaml_load  # noqa: E402
from linna_tpu_torch.driver import read_triplet_cov  # noqa: E402

torch.set_num_threads(1)

CLASSES = ["examples.des_theory", "examples.des4x2ptn_theory", "examples.lsst_theory"]


def _points(ndim, n=64, seed=0, scale=1.0):
    return np.random.default_rng(seed).uniform(-scale, scale, (n, ndim))


@pytest.mark.parametrize("mod", CLASSES)
def test_theory_mirror_against_numpy_and_jax(mod):
    T = importlib.import_module(mod)
    f = E.data_vector_torch(E.survey_theory(T), "cpu")
    x = _points(T.NDIM)
    want64 = np.stack([T.data_vector(r) for r in x])
    # an entry near 0 keeps the rounding of the vector's scale, not its own
    np.testing.assert_allclose(f(torch.as_tensor(x)).numpy(), want64, rtol=1e-12,
                               atol=1e-12 * np.abs(want64).max())
    x32 = x.astype(np.float32)
    want32 = np.asarray(T.data_vector_jax(jnp.asarray(x32)))
    got32 = f(torch.as_tensor(x32))
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(got32.numpy(), want32, rtol=1e-5, atol=1e-5 * np.abs(want32).max())


def test_the_one_instance_is_found():
    import _torch_tiny_theory as tiny

    assert E.survey_theory(tiny) is tiny._T
    with pytest.raises(ValueError):
        E.survey_theory(json)


def _jax_log_prob(mod):
    """bench_exact_posterior.py:76-107's composition."""
    T = importlib.import_module(mod)
    truth_vec = T.data_vector(T.fiducial() + 0.05)
    inv_cov = np.linalg.inv(read_triplet_cov(T.cov_triplet_rows(T.noise_sigma(truth_vec))))
    cfg = str(REPO / default_config_yaml(theory_tag(mod)))
    pack = JP.priors_from_list(yaml_load(cfg)["sampled_params"])
    data_j, inv_j = jnp.asarray(truth_vec, jnp.float32), jnp.asarray(inv_cov, jnp.float32)

    def log_prob(x):
        x = jnp.asarray(x, jnp.float32)
        m = T.data_vector_jax(JP.transform(pack, x))
        lp = j_gaussian_loglike(m, data_j, inv_j) + JP.lnprior(x)
        return jnp.where(jnp.isnan(lp), -jnp.inf, lp)

    return log_prob


@pytest.mark.parametrize("mod", CLASSES)
def test_exact_log_prob_and_gradient_against_jax(mod):
    prob = E.exact_problem(mod, device="cpu")
    lp_j = _jax_log_prob(mod)
    x = _points(prob.T.NDIM, seed=3, scale=0.3).astype(np.float32)
    xt = torch.as_tensor(x).requires_grad_(True)
    lp_t = prob.log_prob(xt)
    (g_t,) = torch.autograd.grad(lp_t.sum(), xt)
    np.testing.assert_allclose(lp_t.detach().numpy(), np.asarray(lp_j(x)), rtol=1e-5)
    g_j = np.asarray(jax.grad(lambda z: jnp.sum(lp_j(z)))(jnp.asarray(x)))
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=1e-4, atol=1e-4 * np.abs(g_j).max())


def test_short_run_writes_the_stored_keys(tmp_path):
    out = tmp_path / "exact"
    res = E.main(n_steps=20, device="cpu", outdir=str(out))
    stored = json.loads((REPO / "EXACT_POSTERIOR.json").read_text())
    written = json.loads((out / "EXACT_POSTERIOR.json").read_text())
    assert set(res) - {"against_stored"} == set(stored) == set(written)
    assert res["n_steps"] == 20 and res["nwalkers"] == 256 and res["sampler"] == "nuts"
    assert len(res["exact_mean"]) == 27 and np.all(np.array(res["exact_std"]) > 0)
    cmp = res["against_stored"]
    assert cmp == E.compare_with_stored(res, str(REPO / "EXACT_POSTERIOR.json"))
    assert np.isfinite(cmp["max_mean_diff_sigma"]) and cmp["n_steps"]["stored"] == 250
    assert not list(REPO.glob("EXACT_POSTERIOR*.json.*"))
