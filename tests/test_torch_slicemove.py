"""The port's slice move against the JAX package's, with the JAX random
stream injected: the same partner indices, slice heights, initial offsets
and shrink uniforms give the same update."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linna_tpu.samplers import slicemove as JS
from linna_tpu_torch.samplers import slicemove as TS

from _torch_parity import t

torch.set_num_threads(1)

VAR = np.array([0.5, 1.0, 2.0, 0.1], np.float32)


def lp_jax(x):
    return -0.5 * jnp.sum(x * x / VAR, axis=-1)


def lp_torch(x):
    return -0.5 * torch.sum(x * x / torch.as_tensor(VAR), dim=-1)


def _jax_draws(seed, half, max_steps):
    key = jax.random.key(seed)
    k_l, k_off, k_h, k_u0, k_sh = jax.random.split(key, 5)
    l = jax.random.randint(k_l, (half,), 0, half)
    m = (l + jax.random.randint(k_off, (half,), 1, half)) % half
    expo = jax.random.exponential(k_h, (half,))
    u0 = jax.random.uniform(k_u0, (half,))
    # the shrink loop's per-iteration uniforms, in _slice_half's key order
    us, k = [], k_sh
    for _ in range(max_steps):
        k, kt = jax.random.split(k)
        us.append(np.asarray(jax.random.uniform(kt, (half,))))
    return l, m, expo, u0, k_sh, np.stack(us)


@pytest.mark.parametrize("seed,mu,max_steps", [(0, 1.0, 100), (1, 0.05, 100), (2, 20.0, 100), (3, 1.0, 2)])
def test_slice_half_matches_jax_stream(seed, mu, max_steps):
    rng = np.random.default_rng(seed)
    half = 12
    active = (rng.normal(size=(half, 4)) * np.sqrt(VAR)).astype(np.float32)
    comp = (rng.normal(size=(half, 4)) * np.sqrt(VAR)).astype(np.float32)
    active_lp = np.asarray(lp_jax(active))
    l, m, expo, u0, k_sh, us = _jax_draws(seed, half, max_steps)
    jx, jlp, jne, jnc = JS._slice_half(
        lp_jax, max_steps, active, active_lp, comp, jnp.float32(mu), l, m, expo, u0, k_sh,
    )
    tx, tlp, tne, tnc = TS._slice_half(
        lp_torch, max_steps, t(active), t(active_lp), t(comp), torch.tensor(mu),
        t(np.asarray(l)).long(), t(np.asarray(m)).long(), t(np.asarray(expo)),
        t(np.asarray(u0)), t(us),
    )
    assert int(tne) == int(jne) and int(tnc) == int(jnc)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=1e-5, atol=1e-6)
    if max_steps == 2:  # walkers that exhaust max_steps keep their position
        assert np.any(np.all(tx.numpy() == active, axis=1))


@pytest.mark.parametrize("ne,nc,mu", [(30, 10, 1.0), (0, 50, 1.0), (5, 0, 9e3), (0, 0, 2e-4)])
def test_tune_mu_matches_jax(ne, nc, mu):
    jst = JS.SliceState(jnp.zeros((4, 2)), jnp.zeros(4), jax.random.key(0), jnp.float32(mu),
                        jnp.int32(ne), jnp.int32(nc))
    tst = TS.SliceState(torch.zeros((4, 2)), torch.zeros(4), torch.Generator(),
                        torch.tensor(mu, dtype=torch.float32),
                        torch.tensor(ne, dtype=torch.int32), torch.tensor(nc, dtype=torch.int32))
    jout, tout = JS.tune_mu(jst), TS.tune_mu(tst)
    np.testing.assert_allclose(float(tout.mu), float(jout.mu), rtol=1e-6)
    assert int(tout.n_expand) == int(tout.n_contract) == 0


def test_slice_chunk_samples_the_target_and_keeps_layout():
    rng = torch.Generator().manual_seed(0)
    x0 = torch.as_tensor(np.random.default_rng(0).normal(size=(32, 4)) * 0.01, dtype=torch.float32)
    state = TS.init_slice_state(rng, x0, lp_torch)
    chains = []
    for i in range(6):
        state, chain, lps = TS.slice_chunk(lp_torch, state, 50)
        if i < 3:
            state = TS.tune_mu(state)
        else:
            chains.append(chain.numpy())
        assert chain.shape == (50, 32, 4) and lps.shape == (50, 32)
        np.testing.assert_allclose(lps[-1].numpy(), lp_torch(chain[-1]).numpy(), rtol=1e-6)
    samples = np.concatenate(chains).reshape(-1, 4)
    np.testing.assert_allclose(samples.mean(0), 0.0, atol=0.25 * np.sqrt(VAR).max())
    np.testing.assert_allclose(samples.var(0) / VAR, 1.0, atol=0.35)
    with pytest.raises(ValueError, match="even"):
        TS.init_slice_state(rng, x0[:5], lp_torch)
