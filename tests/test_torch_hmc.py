"""The port's gradient samplers against the JAX package's: the batched
value-and-gradient, a leapfrog and the kinetic energy on the same emulator
(f32, summation order only: rtol 1e-5); the reasonable-epsilon search with
JAX's own momenta (the same powers of two); dual averaging fed the same
alpha sequence (rtol 1e-6); and, as the JAX package's tests pin them, HMC
and NUTS moments on a correlated Gaussian."""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from _torch_parity import GAUSS_COV, GAUSS_MEAN, gauss_log_probs, log_probs, problem, walkers
from linna_tpu.samplers import hmc as JH
from linna_tpu_torch.samplers import hmc as TH

torch.set_num_threads(1)


def test_value_and_grad_leapfrog_and_kinetic_match_jax():
    pb = problem(ndim=5, ndata=8, seed=2)
    lp_j, lp_t = log_probs(pb, temperature=2.0)
    x = walkers(12, 5, seed=4, scale=0.6)
    vg_j = JH._value_and_grad_batched(lp_j)
    v_j, g_j = vg_j(jnp.asarray(x))
    v_t, g_t = TH.value_and_grad(lp_t, torch.as_tensor(x))
    npt.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=1e-5, atol=1e-5)
    npt.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-4, atol=1e-5)
    rng = np.random.default_rng(5)
    r = rng.normal(size=(12, 5)).astype(np.float32)
    eps = rng.uniform(0.05, 0.2, 12).astype(np.float32)
    inv_mass = rng.uniform(0.5, 2.0, 5).astype(np.float32)
    out_j = JH._leapfrog(vg_j, jnp.asarray(x), jnp.asarray(r), g_j, jnp.asarray(eps),
                         jnp.asarray(inv_mass))
    out_t = TH._leapfrog(lp_t, torch.as_tensor(x), torch.as_tensor(r), g_t, torch.as_tensor(eps),
                         torch.as_tensor(inv_mass))
    for a, b in zip(out_t, out_j):
        npt.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)
    npt.assert_allclose(TH._kinetic(torch.as_tensor(r), torch.as_tensor(inv_mass)).numpy(),
                        np.asarray(JH._kinetic(jnp.asarray(r), jnp.asarray(inv_mass))), rtol=1e-6)


def test_non_finite_walkers_get_a_zero_gradient():
    """A walker outside the log-prob's domain (-inf) gets a zero gradient,
    not the NaN of a masked branch; the other rows are untouched."""
    def lp(x):
        v = torch.log(x[:, 0]) - 0.5 * torch.sum(x * x, dim=-1)
        return torch.where(torch.isnan(v), torch.full_like(v, -torch.inf), v)

    x = torch.tensor([[1.0, 2.0], [-1.0, 0.5], [0.5, -1.0]])
    v, g = TH.value_and_grad(lp, x)
    assert torch.isneginf(v[1]) and torch.isfinite(g).all()
    npt.assert_array_equal(g[1].numpy(), [0.0, 0.0])
    npt.assert_allclose(g[[0, 2]].numpy(), [[0.0, -2.0], [1.5, 1.0]], rtol=1e-6)


@pytest.mark.parametrize("mass", [1.0, np.array([0.5, 2.0, 1.0, 1.5, 0.8], np.float32)])
def test_find_reasonable_epsilon_with_jax_momenta(mass):
    """The port's search fed JAX's momenta (the key splits reproduced here)
    halves and doubles to the same step sizes."""
    pb = problem(ndim=5, ndata=8, seed=3)
    lp_j, lp_t = log_probs(pb)
    x0 = walkers(10, 5, seed=6, scale=0.4)
    key = jax.random.key(9)
    eps_j = np.asarray(JH.find_reasonable_epsilon(key, jnp.asarray(x0), lp_j, mass))
    r0 = np.stack([np.asarray(jax.random.normal(k, (5,))) for k in jax.random.split(key, 10)])
    r0 = r0 * np.sqrt(np.broadcast_to(np.asarray(mass, np.float32), (5,)))
    eps_t = TH.find_reasonable_epsilon(torch.Generator(), torch.as_tensor(x0), lp_t, mass,
                                       r0=torch.as_tensor(r0, dtype=torch.float32))
    npt.assert_array_equal(eps_t.numpy(), eps_j)
    assert len(set(eps_j.tolist())) > 1  # the walkers do not all stop alike


def test_dual_averaging_matches_jax_for_the_same_alphas(monkeypatch):
    """Both ``nuts_chunk``s with the tree replaced by the same deterministic
    move (x -> x + 1, alpha a function of x): 8 samples, 5 of them adapting."""
    def alpha_j(x):
        return 0.5 + 0.45 * jnp.sin(3.0 * x[0] + x[1])

    def fake_j(vg1, max_depth, key, x, lp, grad, eps, inv_mass, sqrt_mass):
        return x + 1.0, lp, grad, alpha_j(x), jnp.asarray(1.0)

    def fake_t(log_prob_fn, max_depth, g, x, lp, grad, eps, inv_mass, sqrt_mass):
        a = 0.5 + 0.45 * torch.sin(3.0 * x[:, 0] + x[:, 1])
        return x + 1.0, lp, grad, a, torch.ones_like(a)

    monkeypatch.setattr(JH, "_nuts_single", fake_j)
    monkeypatch.setattr(TH, "_nuts_sample", fake_t)
    w = 6
    x0 = walkers(w, 2, seed=8)
    eps0 = np.random.default_rng(1).uniform(0.1, 1.0, w).astype(np.float32)
    zeros = np.zeros(w, np.float32)
    lp_fn = lambda x: -0.5 * jnp.sum(x * x, axis=-1)  # noqa: E731  (never called by the fake)
    s_j = JH.NUTSState(jnp.asarray(x0), jnp.asarray(zeros), jnp.zeros((w, 2)), jax.random.key(0),
                       jnp.asarray(eps0), jnp.log(10.0 * jnp.asarray(eps0)), jnp.asarray(zeros),
                       jnp.asarray(zeros), jnp.ones(w), jnp.asarray(5, jnp.int32),
                       jnp.asarray(zeros))
    s_j, _, _ = JH.nuts_chunk(lp_fn, s_j, 8, 5)
    t = torch.as_tensor
    s_t = TH.NUTSState(t(x0), t(zeros), torch.zeros((w, 2)), torch.Generator(), t(eps0),
                       torch.log(10.0 * t(eps0)), t(zeros), t(zeros), torch.ones(w),
                       torch.tensor(5, dtype=torch.int32), t(zeros))
    s_t, _, _ = TH.nuts_chunk(lambda x: -0.5 * torch.sum(x * x, dim=-1), s_t, 8, 5)
    for name in ("coords", "epsilon", "h_bar", "log_eps_bar", "m", "accepted"):
        npt.assert_allclose(getattr(s_t, name).numpy(), np.asarray(getattr(s_j, name)),
                            rtol=1e-6, atol=1e-7, err_msg=name)
    assert int(s_t.m_adapt) == int(s_j.m_adapt) == 0
    npt.assert_array_equal(s_t.m.numpy(), np.full(w, 6.0))


def test_hmc_gaussian_moments():
    _, lp = gauss_log_probs()
    g = torch.Generator().manual_seed(2)
    state = TH.init_hmc_state(g, torch.randn((64, 2), generator=g), lp, epsilon=0.3)
    state, chain, lps = TH.hmc_chunk(lp, state, 300, 10)
    samples = chain[100:].reshape(-1, 2).numpy().astype(np.float64)
    assert float(state.accepted.double().mean()) / 300 > 0.5
    npt.assert_allclose(samples.mean(axis=0), GAUSS_MEAN, atol=0.1)
    npt.assert_allclose(np.cov(samples.T), GAUSS_COV, atol=0.15)
    npt.assert_array_equal(lps[-1].numpy(), lp(state.coords).numpy())


def test_nuts_gaussian_moments_and_adaptation():
    _, lp = gauss_log_probs()
    g = torch.Generator().manual_seed(4)
    state = TH.init_nuts_state(g, torch.randn((16, 2), generator=g), lp, m_adapt=60)
    eps_init = state.epsilon.clone()
    state, chain, _ = TH.nuts_chunk(lp, state, 200, 5)
    samples = chain[60:].reshape(-1, 2).numpy().astype(np.float64)
    npt.assert_allclose(samples.mean(axis=0), GAUSS_MEAN, atol=0.1)
    npt.assert_allclose(np.cov(samples.T), GAUSS_COV, atol=0.15)
    eps = state.epsilon
    assert torch.isfinite(eps).all() and (eps > 0).all() and not torch.allclose(eps, eps_init)
    assert int(state.m_adapt) == 0
    mean_alpha = state.accepted / 200
    assert ((mean_alpha > 0.3) & (mean_alpha <= 1.0)).all()
