"""The importance-sampling post-pass and split R-hat against the JAX package.

The JAX package's cases (``tests/test_importance.py:93``, ``:140``, ``:166``,
``:192``): the same subsample, emulator log-probs and theory go through both
packages' ``_importance_sampling``, whose written ``weight_im.npy``
(emulator log-probs, true log-probs, weights) and ``theory.npy`` must agree
within f32 (the true log-prob's prior term is an f32 sum in both); the
port's pipeline with ``nimp`` writes the JAX package's artifacts, and its
subsample weighs the same through JAX's function.  ``gelman_rubin`` on
``tests/test_gaussian33.py:78``'s analytic chains."""

import os
import shutil

import jax  # noqa: F401  (the JAX package on the CPU, as conftest sets it)
import numpy as np
import numpy.testing as npt
import torch

from linna_tpu import priors as JP
from linna_tpu.orchestrator import _importance_sampling as jax_importance
from linna_tpu.samplers import convergence as JC
from linna_tpu_torch import ml_sampler_core
from linna_tpu_torch import priors as TP
from linna_tpu_torch.orchestrator import _importance_sampling as torch_importance
from linna_tpu_torch.samplers import convergence as TC

torch.set_num_threads(1)

PRIORS = [{"param": "a", "dist": "flat", "arg1": -2.0, "arg2": 2.0}]
# weights and log-probs: the prior term is an f32 sum in both packages
RTOL, ATOL = 1e-6, 1e-6


def _identity_theory(task, outdir):
    i, x = task
    return np.asarray(x, np.float64).copy()


def _both(tmp_path, samples, logp_emu, theory_vals=None, priors=PRIORS, data=None,
          inv_cov=None):
    """Each package's post-pass on its own copy of the same pre-seeded
    subsample (and theory values, when given): {package: (chain, log-probs,
    weight_im rows, theory values)}."""
    ndim = samples.shape[1]
    data = np.zeros(ndim) if data is None else data
    inv_cov = np.eye(ndim) if inv_cov is None else inv_cov
    out = {}
    for name in ("jax", "torch"):
        d = tmp_path / name
        d.mkdir()
        np.save(d / "samples_im.npy", samples)
        np.save(d / "log_prob_samples_x.npy", logp_emu)
        if theory_vals is not None:
            np.save(d / "theory.npy", theory_vals)
        rng = np.random.default_rng(0)
        if name == "jax":
            pack = JP.priors_from_list(priors)
            chain, lp = jax_importance(str(d), "unused.h5", {"nimp": len(samples)}, 1, 2,
                                       "emcee", _identity_theory, None, priors, data, inv_cov,
                                       JP.prior_range(pack), rng)
        else:
            pack = TP.priors_from_list(priors, "cpu")
            chain, lp = torch_importance(str(d), "unused.h5", {"nimp": len(samples)}, 1, 2,
                                         "emcee", _identity_theory, None, pack, data, inv_cov,
                                         TP.prior_range(pack), rng)
        out[name] = (chain, lp, np.load(d / "weight_im.npy"), np.load(d / "theory.npy"))
    return out


def _agree(out):
    (jc, jl, jw, jt), (tc, tl, tw, tt) = out["jax"], out["torch"]
    npt.assert_array_equal(tc, jc)
    npt.assert_array_equal(tl, jl)
    npt.assert_array_equal(tt, jt)
    assert tw.shape == jw.shape
    npt.assert_array_equal(tw[0], jw[0])  # the emulator's log-probs, as given
    npt.assert_allclose(tw[1], jw[1], rtol=RTOL, atol=ATOL)
    npt.assert_allclose(tw[2], jw[2], rtol=RTOL, atol=ATOL)
    npt.assert_array_equal(tw[2] == 0, jw[2] == 0)  # the same points zeroed
    return tw


def test_biased_emulator_down_weighted_as_in_jax(tmp_path):
    rng = np.random.default_rng(1)
    samples = np.linspace(-1.0, 1.0, 24).reshape(-1, 1)
    logp_true = -0.5 * samples[:, 0] ** 2
    logp_emu = logp_true + rng.normal(0, 0.05, len(samples))
    logp_emu[3] = logp_true[3] - 50.0
    logp_e, logp_t, w = _agree(_both(tmp_path, samples, logp_emu))
    npt.assert_allclose(logp_t, logp_true, atol=1e-5)
    npt.assert_allclose(np.sum(w), 1.0, rtol=1e-10)
    assert w[3] == 0.0
    others = np.delete(np.arange(len(samples)), 3)
    over = others[(logp_emu - logp_true)[others] > 0.05]
    assert len(over) and np.all(w[over] < np.median(w[others]))


def test_exp_overflow_survived_as_in_jax(tmp_path):
    rng = np.random.default_rng(2)
    samples = np.linspace(-1.0, 1.0, 24).reshape(-1, 1)
    logp_true = -0.5 * samples[:, 0] ** 2
    logp_emu = logp_true + rng.normal(0, 0.05, len(samples))
    logp_emu[5] = logp_true[5] - 800.0
    _, _, w = _agree(_both(tmp_path, samples, logp_emu))
    assert np.all(np.isfinite(w)) and w[5] == 0.0
    npt.assert_allclose(np.sum(w), 1.0, rtol=1e-10)


def test_nan_theory_survived_as_in_jax(tmp_path):
    samples = np.linspace(-1.0, 1.0, 20).reshape(-1, 1)
    logp_emu = -0.5 * samples[:, 0] ** 2
    theory_vals = samples.copy()
    theory_vals[7] = np.nan
    _, logp_t, w = _agree(_both(tmp_path, samples, logp_emu, theory_vals))
    assert np.isnan(logp_t[7])
    assert np.all(np.isfinite(w)) and w[7] == 0.0
    npt.assert_allclose(np.sum(w), 1.0, rtol=1e-10)


def test_pipeline_importance_artifacts_weigh_as_in_jax(tmp_path):
    """The port's pipeline with ``nimp`` writes ``samples_im.npy`` and
    ``weight_im.npy`` as the JAX package's does, and JAX's post-pass on the
    port's subsample gives the port's weights."""
    outdir = tmp_path / "out"
    priors = [{"param": "a", "dist": "flat", "arg1": -2.0, "arg2": 2.0}] * 2
    data, cov = np.array([0.1, 0.5]), np.diag([0.3, 0.2])
    chain, _ = ml_sampler_core(
        ntrainArr=[20], nvalArr=[5], nkeepArr=[1], ntimesArr=[2], ntautolArr=[0.5],
        meanshiftArr=[100], stdshiftArr=[100], outdir=str(outdir), theory=_identity_theory,
        priors=priors, data=data, cov=cov, init=np.zeros(2), pool=None, nwalkers=4,
        temperatureArr=[1.0],
        params={"trainingoption": 1, "num_epochs": 6, "batch_size": 8, "nensemble": 1,
                "nimp": 10},
        method="emcee", seed=3, device="cpu")
    samples = np.load(outdir / "samples_im.npy")
    assert samples.shape == (10, 2) and chain.shape == (10, 2)
    npt.assert_array_equal(chain, samples)
    torch_w = np.load(outdir / "weight_im.npy")
    assert torch_w.shape == (3, 10)
    npt.assert_allclose(np.sum(torch_w[2]), 1.0, rtol=1e-10)

    jdir = tmp_path / "jax"
    jdir.mkdir()
    for f in ("samples_im.npy", "log_prob_samples_x.npy"):
        shutil.copy(outdir / f, jdir / f)
    pack = JP.priors_from_list(priors)
    jchain, _ = jax_importance(str(jdir), "unused.h5", {"nimp": 10}, 1, 2, "emcee",
                               _identity_theory, None, priors, data, np.linalg.inv(cov),
                               JP.prior_range(pack), np.random.default_rng(0))
    npt.assert_array_equal(jchain, samples)
    npt.assert_array_equal(np.load(jdir / "theory.npy"), np.load(outdir / "theory.npy"))
    jax_w = np.load(jdir / "weight_im.npy")
    npt.assert_array_equal(torch_w[0], jax_w[0])
    npt.assert_allclose(torch_w[1:], jax_w[1:], rtol=RTOL, atol=ATOL)
    assert os.path.isdir(outdir / "imp")


def test_gelman_rubin_analytic_as_in_jax():
    """``tests/test_gaussian33.py:78``'s chains: stationary (R ~ 1), walkers
    at different means (R >> 1) and a trend caught by the split; both
    packages' numpy float64 R-hat agree to rounding."""
    rng = np.random.default_rng(0)
    good = rng.standard_normal((2000, 8, 3))
    bad = good + np.arange(8)[None, :, None] * 2.0
    trend = rng.standard_normal((2000, 8, 1)) + np.linspace(0, 6, 2000)[:, None, None]
    for chain in (good, bad, trend):
        for split in (True, False):
            npt.assert_allclose(TC.gelman_rubin(chain, split=split),
                                JC.gelman_rubin(chain, split=split), rtol=1e-12)
    assert np.all(TC.gelman_rubin(good) < 1.02)
    assert np.all(TC.gelman_rubin(bad) > 1.5)
    assert np.all(TC.gelman_rubin(trend) > 1.2)
