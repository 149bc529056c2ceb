"""The port's make_log_prob against the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linna_tpu import likelihood as JLK
from linna_tpu import nn as JN
from linna_tpu_torch import likelihood as TLK
from linna_tpu_torch import nn as TN
from linna_tpu_torch.ops import fused as TF

from _torch_parity import CPU, problem, t, walkers

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)


def _both(p, params_j=None, params_t=None, **kw):
    lp_j = JLK.make_log_prob(p.spec, params_j if params_j is not None else p.params_j,
                             p.ts_j, p.pack_j, p.data, p.inv_cov, **kw)
    lp_t = TLK.make_log_prob(p.tspec, params_t if params_t is not None else p.params_t,
                             p.ts_t, p.pack_t, p.data, p.inv_cov, device=CPU, **kw)
    return lp_j, lp_t


@pytest.mark.parametrize("temperature", [1.0, 16.0])
def test_single_emulator_matches_jax(temperature):
    p = problem()
    lp_j, lp_t = _both(p, temperature=temperature)
    x = walkers(37, 5, seed=2)
    np.testing.assert_allclose(lp_t(t(x)).numpy(), np.asarray(lp_j(x)), **TOL)


def _members(k=2):
    spec = JN.make_model_spec("chto_v2", 5, 8)
    pj = [JN.init_model(jax.random.key(10 + i), spec) for i in range(k)]
    return pj, [TN.params_from_numpy(jax.device_get(m), CPU) for m in pj]


def test_ensemble_matches_jax_and_uses_population_std():
    p = problem()
    pj, pt = _members(2)
    lp_j, lp_t = _both(p, params_j=pj, params_t=pt, temperature=4.0, ensemble_k_std=1.5)
    x = walkers(21, 5, seed=3)
    got = lp_t(t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(lp_j(x)), **TOL)

    # ddof=0: rebuild the effective chi^2 from the single-member likelihoods
    prior = -0.5 * np.sum(x.astype(np.float64) ** 2, axis=-1)
    chi2 = np.stack([
        -2.0 * (TLK.make_log_prob(p.tspec, m, p.ts_t, p.pack_t, p.data, p.inv_cov,
                                  device=CPU)(t(x)).double().numpy() - prior)
        for m in pt
    ])
    eff_pop = chi2.mean(0) + 1.5 * chi2.std(0, ddof=0)
    eff_bessel = chi2.mean(0) + 1.5 * chi2.std(0, ddof=1)
    np.testing.assert_allclose(got, -0.5 * eff_pop / 4.0 + prior, rtol=1e-4, atol=1e-3)
    assert not np.allclose(got, -0.5 * eff_bessel / 4.0 + prior, rtol=1e-4, atol=1e-3)


def test_single_member_list_is_single_emulator():
    p = problem()
    _, lp_list = _both(p, params_t=[p.params_t])
    _, lp_one = _both(p)
    x = t(walkers(5, 5, seed=4))
    np.testing.assert_array_equal(lp_list(x).numpy(), lp_one(x).numpy())


def test_out_cut_matches_jax():
    p = problem(ndata=8)
    data, inv_cov = p.data[:5], p.inv_cov[:5, :5]
    lp_j = JLK.make_log_prob(p.spec, p.params_j, p.ts_j, p.pack_j, data, inv_cov, out_cut=5)
    lp_t = TLK.make_log_prob(p.tspec, p.params_t, p.ts_t, p.pack_t, data, inv_cov,
                             out_cut=5, device=CPU)
    x = walkers(11, 5, seed=5)
    np.testing.assert_allclose(lp_t(t(x)).numpy(), np.asarray(lp_j(x)), **TOL)
    with pytest.raises(ValueError, match="exceeds the model's output size"):
        TLK.make_log_prob(p.tspec, p.params_t, p.ts_t, p.pack_t, p.data, p.inv_cov,
                          out_cut=9, device=CPU)


def test_nan_becomes_neg_inf_and_custom_terms_match_jax():
    p = problem()
    x = walkers(6, 5, seed=6)

    def like_j(m, d, ic):
        v = -0.5 * jnp.sum((m - d) ** 2, axis=-1)
        return jnp.where(jnp.arange(m.shape[0]) % 2 == 0, jnp.nan, v)

    def like_t(m, d, ic):
        v = -0.5 * torch.sum((m - d) ** 2, dim=-1)
        return torch.where(torch.arange(m.shape[0]) % 2 == 0, torch.full_like(v, torch.nan), v)

    ext_j = lambda xp: 0.1 * jnp.sum(xp, axis=-1)
    ext_t = lambda xp: 0.1 * torch.sum(xp, dim=-1)
    lp_j = JLK.make_log_prob(p.spec, p.params_j, p.ts_j, p.pack_j, p.data, p.inv_cov,
                             loglike_fn=like_j, external_loglike=ext_j)
    lp_t = TLK.make_log_prob(p.tspec, p.params_t, p.ts_t, p.pack_t, p.data, p.inv_cov,
                             loglike_fn=like_t, external_loglike=ext_t, device=CPU)
    got, want = lp_t(t(x)).numpy(), np.asarray(lp_j(x))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(got).any() and not np.isnan(got).any()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **TOL)
    with pytest.raises(ValueError, match="ensemble likelihood requires"):
        TLK.make_log_prob(p.tspec, _members(2)[1], p.ts_t, p.pack_t, p.data, p.inv_cov,
                          loglike_fn=like_t, device=CPU)


def test_use_fused_on_cpu_runs_the_plain_version():
    p = problem(log10=[0])
    x = walkers(9, 5, seed=7)
    x[2, 0] = -4.0  # a log10 lane at a non-positive physical value
    TF.reset_counts()
    lp_f = TLK.make_log_prob(p.tspec, p.params_t, p.ts_t, p.pack_t, p.data, p.inv_cov,
                             temperature=16.0, use_fused=True, device=CPU)
    got = lp_f(t(x))
    env = lp_f._env
    plain = TF.fused_log_prob_plain(p.tspec, t(x), env, False)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    assert TF.plain_calls["fused_log_prob"] == 2 and TF.launches["fused_log_prob"] == 0
    lp_c = TLK.make_log_prob(p.tspec, p.params_t, p.ts_t, p.pack_t, p.data, p.inv_cov,
                             temperature=16.0, device=CPU)
    comp = lp_c(t(x)).numpy()
    assert got[2] == -np.inf and comp[2] == -np.inf
    np.testing.assert_allclose(got.numpy(), comp, **TOL)


def test_gaussian_loglike_matches_jax():
    rng = np.random.default_rng(8)
    m, d = rng.normal(size=(4, 6)), rng.normal(size=6)
    a = rng.normal(size=(6, 6))
    ic = a @ a.T + np.eye(6)
    np.testing.assert_allclose(
        TLK.gaussian_loglike(t(m), t(d), t(ic)).numpy(),
        np.asarray(JLK.gaussian_loglike(m, d, ic)), rtol=1e-5,  # JAX computes in f32
    )
