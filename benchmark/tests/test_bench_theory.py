"""The frozen copy of the flagship's stand-in theory and the iteration-3
rows drawn from it."""

import numpy as np
import pytest

from benchmark import harness as H
from benchmark import theory as TH

CONFIGS = ("des3x2pt", "lsst6x2pt")


@pytest.fixture(scope="module", params=CONFIGS)
def cfg(request):
    return H.config(H.benchmark(), request.param)


def test_frozen_copy_matches_the_examples(cfg):
    """The configuration's theory seed gives the templates and couplings of
    ``examples/des_theory.py`` / ``lsst_theory.py``."""
    from examples import des_theory, lsst_theory

    original = {"des3x2pt": des_theory._DES, "lsst6x2pt": lsst_theory._LSST}[cfg["name"]]
    copy = TH.make(cfg)
    for name in ("templates", "lin", "quad"):
        np.testing.assert_array_equal(getattr(copy, name), getattr(original, name))
    x = np.random.default_rng(3).uniform(-1, 1, (4, cfg["ndim"]))
    np.testing.assert_allclose(copy.data_vector(x), [original.data_vector(r) for r in x],
                               rtol=1e-12, atol=1e-12)
    truth = np.full(cfg["ndim"], 0.05)
    sigma = original.noise_sigma(original.data_vector(truth))
    rows = original.cov_triplet_rows(sigma)
    cov = copy.covariance(copy.noise_sigma(copy.data_vector(truth)))
    i, j = rows[:, 0].astype(int), rows[:, 1].astype(int)
    np.testing.assert_allclose(cov[i, j], rows[:, 3], rtol=1e-12)
    assert np.count_nonzero(cov) == 2 * len(rows) - len(sigma)


def test_jacobian(cfg):
    theory = TH.make(cfg)
    x = np.random.default_rng(5).uniform(-0.5, 0.5, cfg["ndim"])
    eye = np.eye(cfg["ndim"]) * 1e-6
    numeric = np.stack([(theory.data_vector(x + e) - theory.data_vector(x - e)) / 2e-6
                        for e in eye], axis=1)
    np.testing.assert_allclose(theory.jacobian(x), numeric, atol=1e-6)


def test_iteration_rows(cfg):
    stack = H.traffic("train", cfg)["stack"]
    rows = TH.iteration_rows(cfg, stack, 400, 40, [7, 1])
    assert rows["tx"].shape == (400, cfg["ndim"]) and rows["vy"].shape == (40, cfg["ndata"])
    assert np.all(np.abs(rows["tx"]) < 1) and np.all(np.abs(rows["vx"]) < 1)
    # the T^2 = 1 block lies within a few posterior widths of the truth
    last = rows["tx"][300:] - 0.05
    assert np.all(np.abs(last) < 6 * rows["posterior_sd"])
    # the flat block spreads over the box
    assert np.abs(rows["tx"][:100]).max() > 0.9
    again = TH.iteration_rows(cfg, stack, 400, 40, [7, 1])
    np.testing.assert_array_equal(rows["ty"], again["ty"])
    assert TH.scaled_counts(stack, "n_train", 40_000) == [10_000] * 4
    assert sum(TH.scaled_counts(stack, "n_val", 101)) == 101
