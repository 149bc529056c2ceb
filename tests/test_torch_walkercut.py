"""The port's walker cut (numpy k-means, no scikit-learn) against the JAX
package's get_good_walker_list (scikit-learn's KMeans) on walker log-probs
that form well-separated groups, and read_chain_and_cut(walkercut=True)
through both packages on one chain file."""

import numpy as np
import pytest
import torch

from linna_tpu import orchestrator as JO
from linna_tpu.samplers import backends as JB
from linna_tpu_torch import orchestrator as TO

torch.set_num_threads(1)

SEEDS = range(6)


def _groups(seed, spread_below=False, nsteps=200):
    """Mean log-probs in 2-5 well-separated groups; each walker's draws stay
    inside one integer band.  With ``spread_below`` each lower group spreads
    over 10 integers (more than 8 distinct values: k = 8 clusters).  Returns
    the log-probs and the walkers of the top group."""
    rng = np.random.default_rng(seed)
    ngroups = int(rng.integers(2, 6))
    centers = -5.5 - np.cumsum(rng.uniform(40.0, 120.0, ngroups)) + 40.0
    sizes = rng.integers(2, 9, ngroups)
    if spread_below:
        sizes[1:] = 10
    means = []
    for g, (c, n) in enumerate(zip(centers, sizes)):
        if spread_below and g > 0:
            means.append(np.floor(c) + 0.5 - rng.permutation(n))
        else:
            means.append(np.full(n, np.floor(c) + 0.5))
    means = np.concatenate(means)
    order = rng.permutation(len(means))
    means = means[order]
    logp = means[None, :] + rng.uniform(-0.01, 0.01, (nsteps, len(means)))
    top = np.sort(np.where(order < sizes[0])[0])
    return logp, top


@pytest.mark.parametrize("seed", SEEDS)
def test_walker_cut_matches_the_jax_package(seed):
    logp, top = _groups(seed)
    got = TO.get_good_walker_list(logp)
    np.testing.assert_array_equal(got, JO.get_good_walker_list(logp))
    np.testing.assert_array_equal(got, top)


@pytest.mark.parametrize("seed", SEEDS)
def test_walker_cut_with_more_than_8_bands_matches_the_jax_package(seed):
    logp, top = _groups(seed, spread_below=True)
    assert len(np.unique(np.mean(logp, axis=0).astype(int))) > 8
    got = TO.get_good_walker_list(logp)
    np.testing.assert_array_equal(got, JO.get_good_walker_list(logp))
    np.testing.assert_array_equal(got, top)


def test_walker_cut_of_one_band_keeps_every_walker():
    logp = -3.5 + np.random.default_rng(0).uniform(-0.01, 0.01, (50, 6))
    np.testing.assert_array_equal(TO.get_good_walker_list(logp), np.arange(6))


def test_read_chain_and_cut_walkercut_through_both_packages(tmp_path):
    rng = np.random.default_rng(2)
    nsteps, nwalkers, ndim = 300, 8, 2
    chain = rng.normal(0.0, 1.0, (nsteps, nwalkers, ndim))
    logp = -5.5 + rng.uniform(-0.01, 0.01, (nsteps, nwalkers))
    stuck = [2, 4, 7]
    chain[:, stuck, :] = 50.0 + 0.01 * rng.normal(size=(nsteps, len(stuck), ndim))
    logp[:, stuck] = -120.5 + rng.uniform(-0.01, 0.01, (nsteps, len(stuck)))
    path = str(tmp_path / "chemcee_256.h5")
    b = JB.EmceeBackend(path)
    b.reset(nwalkers, ndim)
    b.append(chain, logp, np.zeros(nwalkers), transform=lambda c: c)

    got_chain, got_lp, _ = TO.read_chain_and_cut(path, nk=2, walkercut=True, method="emcee")
    want_chain, want_lp, _ = JO.read_chain_and_cut(path, nk=2, walkercut=True, method="emcee")
    np.testing.assert_array_equal(got_chain, want_chain)
    np.testing.assert_array_equal(got_lp, want_lp)
    assert np.all(got_chain[:, 0] < 10.0)  # the stuck walkers are gone
    full, _, _ = TO.read_chain_and_cut(path, nk=2, method="emcee")
    assert got_chain.shape[0] == full.shape[0] * (nwalkers - len(stuck)) // nwalkers
