"""The port's stretch move (emcee) against the JAX package's: one chunk's
steps with the same injected draws (partners, z-uniforms, log
accept-uniforms) through ``_stretch_scan`` on one device, the Gaussian
moments of a seeded chunk, and the odd-walker check."""

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from _torch_parity import gauss_log_probs, log_probs, problem, walkers
from linna_tpu.samplers import stretch as JS
from linna_tpu_torch.samplers import stretch as TS

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [0, 1])
def test_stretch_steps_match_jax_with_injected_draws(seed):
    """Both packages take the same steps from the same draws.  The
    log-probs differ by f32 summation order only (rtol 1e-5); the accept
    decisions, hence the acceptance counts, are the same."""
    pb = problem(ndim=5, ndata=8, seed=seed)
    lp_j, lp_t = log_probs(pb, temperature=4.0)
    w, d, nsteps, half = 8, 5, 6, 4
    x0 = walkers(w, d, seed=seed + 3, scale=0.5)
    rng = np.random.default_rng(seed + 10)
    partners = rng.integers(0, half, (nsteps, 2, half))
    us = rng.uniform(size=(nsteps, 2, half)).astype(np.float32)
    ln_u = np.log(rng.uniform(size=(nsteps, 2, half))).astype(np.float32)
    lp0 = np.array(lp_j(jnp.asarray(x0)))
    carry_j = (jnp.asarray(x0.reshape(2, half, d)), jnp.asarray(lp0.reshape(2, half)),
               jnp.zeros((2, half), jnp.int32))
    (c_j, l_j, a_j), (ch_j, lps_j) = JS._stretch_scan(
        lp_j, 2.0, d, nsteps, carry_j,
        (jnp.asarray(partners), jnp.asarray(us), jnp.asarray(ln_u)), lambda x: x, None)
    carry_t = (torch.as_tensor(x0.reshape(2, half, d)), torch.as_tensor(lp0.reshape(2, half)),
               torch.zeros((2, half), dtype=torch.int32))
    (c_t, l_t, a_t), (ch_t, lps_t) = TS.stretch_steps(
        lp_t, 2.0, carry_t,
        (torch.as_tensor(partners), torch.as_tensor(us), torch.as_tensor(ln_u)))
    npt.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    assert 0 < int(a_t.sum()) < nsteps * w  # some proposals accepted, some not
    npt.assert_allclose(ch_t.numpy(), np.asarray(ch_j), rtol=1e-5, atol=1e-6)
    npt.assert_allclose(lps_t.numpy(), np.asarray(lps_j), rtol=1e-5, atol=1e-5)
    npt.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-5, atol=1e-6)


def test_stretch_chunk_samples_a_gaussian():
    """A seeded 500-step chunk on the correlated Gaussian: the same moment
    pins as the JAX package's stretch test (tests/test_samplers.py)."""
    _, lp = gauss_log_probs()
    g = torch.Generator().manual_seed(0)
    state = TS.init_state(g, torch.randn((64, 2), generator=g) * 0.1, lp)
    state, chain, lps = TS.stretch_chunk(lp, state, 500)
    assert chain.shape == (500, 64, 2) and lps.shape == (500, 64)
    samples = chain[100:].reshape(-1, 2).numpy().astype(np.float64)
    npt.assert_allclose(samples.mean(axis=0), [1.0, -0.5], atol=0.15)
    npt.assert_allclose(np.cov(samples.T), [[1.0, 0.6], [0.6, 0.8]], atol=0.15)
    acc = state.accepted.numpy() / 500
    assert 0.2 < acc.mean() < 0.9
    npt.assert_array_equal(lps[-1].numpy(), lp(state.coords).numpy())


def test_odd_walker_count_is_refused():
    _, lp = gauss_log_probs()
    with pytest.raises(ValueError, match="nwalkers must be even"):
        TS.init_state(torch.Generator(), torch.zeros((5, 2)), lp)
