"""``run_ensemble``'s emcee, HMC and NUTS paths in the port, on the CPU:
chains in the original space with their acceptance counters and
``precond.npz``, exact resume (bitwise, the MAP search not re-run), the
cross-method and torn-preconditioner fallbacks, and ``ml_sampler_core``'s
default method (emcee, as in the JAX package)."""

import os

import numpy as np
import numpy.testing as npt
import pytest
import torch

import linna_tpu_torch
from _torch_parity import GAUSS_MEAN, gauss_log_probs
from linna_tpu_torch.samplers import precondition as TP
from linna_tpu_torch.samplers import run as TR

torch.set_num_threads(1)

_, LP = gauss_log_probs()
X0 = (0.1 * np.random.default_rng(0).standard_normal((16, 2))).astype(np.float32)


def _shift_lp(x):
    return -0.5 * torch.sum((x - 0.3) ** 2, dim=-1)


@pytest.mark.parametrize("method", ["emcee", "hmc", "nuts"])
def test_chains_are_stored_in_the_original_space(tmp_path, method):
    trace = {}
    backend = TR.run_ensemble(LP, X0, str(tmp_path), method=method,
                              transform=lambda x: 2.0 * x + 1.0, check_every=50,
                              max_iterations=200, convergence_check=False, seed=1,
                              device="cpu", trace_rec=trace)
    chain = backend.get_chain()
    assert chain.shape == (200, 16, 2) and backend.path.endswith(TR.EMCEE_FILENAME)
    if method != "hmc":
        npt.assert_allclose(chain[100:].reshape(-1, 2).mean(axis=0), GAUSS_MEAN, atol=0.2)
    npt.assert_allclose(backend.get_value("chain_transformed"), 2.0 * chain + 1.0, rtol=1e-12)
    # the stored log-probs are the target's at the stored (original) points
    npt.assert_allclose(backend.get_log_prob()[-1],
                        LP(torch.as_tensor(chain[-1], dtype=torch.float32)).numpy(), atol=1e-4)
    with backend._open("r") as f:
        accepted = np.asarray(f["mcmc"]["accepted"][:])
    rate = accepted / 200
    # counts for emcee and hmc; the summed mean alpha for nuts.  HMC's
    # reasonable-epsilon search picks eps 2-4 in the unit-curvature space,
    # where 10 leapfrogs are unstable: most walkers accept ~1% of proposals,
    # in the JAX package as here, so its rate and mean are not pinned
    assert np.all((rate >= 0.0) & (rate <= 1.0)), rate
    if method != "hmc":
        assert np.all(rate > 0.2), rate
    pfile = os.path.join(str(tmp_path), TR.PRECOND_FILENAME)
    assert os.path.isfile(pfile) == (method in TR.GRADIENT_METHODS)
    assert (trace["sampler"]["precond"] > 0) == (method in TR.GRADIENT_METHODS)
    assert trace["steps_run"] == 200
    blob = backend.load_state()
    assert blob["_method"].item() == method.encode() and bool(blob["_finished"])
    assert "rng_state" in blob and "key" not in blob


@pytest.mark.parametrize("method", ["emcee", "zeus", "hmc", "nuts"])
def test_exact_resume_matches_uninterrupted(tmp_path, method, monkeypatch):
    """One chunk, then a resume to three: bitwise the uninterrupted run; the
    gradient samplers reload precond.npz instead of searching again."""
    x0 = (0.2 * np.random.default_rng(0).standard_normal((16, 2))).astype(np.float32)
    kw = dict(method=method, ntimes=1e6, tautol=1e-8, meanshift=1e-8, stdshift=1e-8,
              check_every=10, seed=3, m_adapt=15, device="cpu")
    full = TR.run_ensemble(_shift_lp, x0, str(tmp_path / "full"), max_iterations=30, **kw)
    part = TR.run_ensemble(_shift_lp, x0, str(tmp_path / "part"), max_iterations=10, **kw)
    assert len(part.get_chain()) == 10

    def boom(*a, **k):
        raise AssertionError("calc_hess_mass_mat re-ran on resume")

    monkeypatch.setattr(TP, "calc_hess_mass_mat", boom)
    resumed = TR.run_ensemble(_shift_lp, x0, str(tmp_path / "part"), max_iterations=30, **kw)
    npt.assert_array_equal(resumed.get_chain(), full.get_chain())
    npt.assert_array_equal(resumed.get_log_prob(), full.get_log_prob())


def test_cross_method_resume_falls_back_statistically(tmp_path):
    kw = dict(ntimes=1, tautol=1e9, meanshift=1e9, stdshift=1e9, nk=1, check_every=20,
              seed=11, convergence_check=False, device="cpu")
    n1 = TR.run_ensemble(LP, X0[:8], str(tmp_path), method="emcee", max_iterations=20,
                         **kw).iteration
    with pytest.warns(UserWarning, match="written by method 'emcee'"):
        b2 = TR.run_ensemble(LP, X0[:8], str(tmp_path), method="nuts", max_iterations=40, **kw)
    assert b2.iteration == n1 + 20
    assert b2.load_state()["_method"].item() == b"nuts"


def test_unreadable_precond_reruns_the_search(tmp_path):
    outdir = str(tmp_path)
    kw = dict(method="nuts", ntimes=1e6, tautol=1e-8, meanshift=1e-8, stdshift=1e-8,
              check_every=10, seed=3, m_adapt=15, device="cpu")
    TR.run_ensemble(_shift_lp, X0, outdir, max_iterations=10, **kw)
    with open(os.path.join(outdir, TR.PRECOND_FILENAME), "wb") as f:
        f.write(b"not an npz")  # a torn write
    with pytest.warns(UserWarning, match="unreadable"):
        backend = TR.run_ensemble(_shift_lp, X0, outdir, max_iterations=20, **kw)
    assert backend.iteration == 20
    with np.load(os.path.join(outdir, TR.PRECOND_FILENAME)) as z:
        npt.assert_allclose(z["center"], [0.3, 0.3], atol=1e-2)
    assert not any(f.endswith(".tmp.npz") for f in os.listdir(outdir))


def test_ml_sampler_core_defaults_to_emcee(tmp_path):
    """Without ``method`` the loop runs emcee and writes chemcee_256.h5, as
    the JAX package does (its walkers start 0.1 from the initial point)."""
    cov, means = np.diag([0.5, 0.2]), np.array([0.1, 1.0])
    priors = [{"param": f"p{i}", "dist": "flat", "arg1": -2.0, "arg2": 2.0} for i in range(2)]
    chain, logp = linna_tpu_torch.ml_sampler_core(
        ntrainArr=[20], nvalArr=[5], nkeepArr=[1], ntimesArr=[2], ntautolArr=[0.5],
        meanshiftArr=[100], stdshiftArr=[100], outdir=str(tmp_path), priors=priors,
        theory=lambda x, o: np.asarray(x[1], dtype=np.float64).copy(), data=means, cov=cov,
        init=np.zeros(2), nwalkers=8, temperatureArr=[1.0],
        params={"trainingoption": 1, "num_epochs": 5, "batch_size": 5}, seed=2, device="cpu",
    )
    it0 = tmp_path / "iter_0"
    assert (it0 / TR.EMCEE_FILENAME).exists() and not (it0 / TR.ZEUS_FILENAME).exists()
    assert chain.shape[1] == 2 and np.isfinite(chain).all() and np.isfinite(logp).all()
