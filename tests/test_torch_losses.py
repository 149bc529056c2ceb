"""The port's chi^2-ratio loss and validation metric against the JAX
package's on the same numpy inputs (rtol = atol = 1e-5): the loss state
(plain and ypositive), each sentinel's masking, the denominator floor, and
the metric's medians over odd and even row counts."""

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from linna_tpu import losses as JL
from linna_tpu import transforms as JT
from linna_tpu_torch import losses as TL
from linna_tpu_torch import transforms as TT

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _setup(ndata=6, nbatch=8, seed=0, ypositive=False):
    rng = np.random.default_rng(seed)
    data = rng.normal(1.0, 0.1, ndata) if not ypositive else rng.uniform(1, 2, ndata)
    a = rng.normal(size=(ndata, ndata)) * 0.05
    cov = np.eye(ndata) * 0.04 + a @ a.T
    sigma = np.sqrt(np.diag(cov))
    train_y = data + rng.normal(0, 0.2, size=(200, ndata)) * sigma
    if ypositive:
        train_y = np.abs(train_y) + 0.1
    ts_j = JT.TransformSet(
        JT.fit_x_transform(rng.normal(size=(100, 2))),
        JT.fit_y_transform(train_y / sigma, ypositive=ypositive),
        JT.YTransformData(jnp.asarray(sigma, jnp.float32)),
    )
    ts_t = TT.transforms_from_numpy(ts_j, "cpu")
    targets = train_y[:nbatch].astype(np.float32)
    preds = np.asarray(ts_j.y_transform.inverse(ts_j.y_data(jnp.asarray(targets))))
    preds = (preds + rng.normal(0, 0.1, preds.shape)).astype(np.float32)
    return ts_j, ts_t, data, cov, preds, targets


def _states(ts_j, ts_t, data, cov):
    return JL.build_loss_state(data, cov, ts_j), TL.build_loss_state(data, cov, ts_t)


@pytest.mark.parametrize("ypositive", [False, True])
def test_build_loss_state_matches(ypositive):
    ts_j, ts_t, data, cov, _, _ = _setup(seed=3 if ypositive else 0, ypositive=ypositive)
    sj, st = _states(ts_j, ts_t, data, cov)
    npt.assert_allclose(st.inv_transformed_cov.numpy(), np.asarray(sj.inv_transformed_cov), **TOL)
    npt.assert_allclose(st.data_std.numpy(), np.asarray(sj.data_std), **TOL)
    assert st.ndata == sj.ndata


def _sentinel_targets(kind, targets):
    t = targets.copy()
    if kind == "high":
        t[0, :3] = 1e10
        t[1, :] = 1e10
    elif kind == "low":
        t[2, 1:4] = 1e-30
        t[3, :] = 1e-30
    return t


@pytest.mark.parametrize("kind", ["none", "high", "low", "data"])
def test_chi2_terms_with_each_sentinel(kind):
    ts_j, ts_t, data, cov, preds, targets = _setup(seed=1)
    if kind == "data":
        data = data.copy()
        data[2] = np.nan  # the standardized data vector carries 1e-30 there
    sj, st = _states(ts_j, ts_t, data, cov)
    t = _sentinel_targets(kind, targets)
    got = TL.chi2_terms(st, ts_t, torch.as_tensor(preds), torch.as_tensor(t))
    want = JL.chi2_terms(sj, ts_j, jnp.asarray(preds), jnp.asarray(t))
    for g, w in zip(got, want):
        npt.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    if kind in ("high", "low"):
        row = 1 if kind == "high" else 3
        assert float(got[0][row]) == 0.0  # a fully masked row adds no chi^2
    npt.assert_allclose(
        TL.loss_fn(st, ts_t, torch.as_tensor(preds), torch.as_tensor(t)).numpy(),
        float(JL.loss_fn(sj, ts_j, jnp.asarray(preds), jnp.asarray(t))), **TOL,
    )


def test_denominator_floor():
    ts_j, ts_t, data, cov, preds, _ = _setup(seed=2)
    _, st = _states(ts_j, ts_t, data, cov)
    on_data = np.tile(data, (len(preds), 1)).astype(np.float32)
    _, c_m_d, _ = TL.chi2_terms(st, ts_t, torch.as_tensor(preds), torch.as_tensor(on_data))
    npt.assert_allclose(c_m_d.numpy(), 0.5 * len(data), rtol=1e-6)


@pytest.mark.parametrize("nbatch", [7, 8, 2])
def test_val_metric_odd_and_even_rows(nbatch):
    ts_j, ts_t, data, cov, preds, targets = _setup(seed=4, nbatch=nbatch)
    sj, st = _states(ts_j, ts_t, data, cov)
    got = TL.val_metric_fn(st, ts_t, torch.as_tensor(preds), torch.as_tensor(targets)).numpy()
    want = np.asarray(JL.val_metric_fn(sj, ts_j, jnp.asarray(preds), jnp.asarray(targets)))
    npt.assert_allclose(got, want, **TOL)
    loss, _, _ = TL.chi2_terms(st, ts_t, torch.as_tensor(preds), torch.as_tensor(targets))
    npt.assert_allclose(got[0], np.median(loss.numpy()), rtol=1e-6)


def test_median_averages_the_middle_pair_and_propagates_nan():
    v = torch.tensor([[4.0, 1.0, 3.0, 2.0], [1.0, np.nan, 0.0, 2.0]])
    m = TL.median(v)
    assert float(m[0]) == 2.5 and torch.isnan(m[1])
    assert float(TL.median(torch.tensor([3.0, 1.0, 2.0]))) == 2.0


def test_stacked_members_get_one_metric_row_each():
    """Predictions of K stacked members (K, B, N) give (K,) losses and
    (K, 3) metrics, each equal to the member's own."""
    ts_j, ts_t, data, cov, preds, targets = _setup(seed=5)
    _, st = _states(ts_j, ts_t, data, cov)
    p = torch.as_tensor(np.stack([preds, preds * 1.1, preds - 0.2]))
    t = torch.as_tensor(targets)
    vm = TL.val_metric_fn(st, ts_t, p, t)
    lf = TL.loss_fn(st, ts_t, p, t)
    for k in range(3):
        npt.assert_allclose(vm[k].numpy(), TL.val_metric_fn(st, ts_t, p[k], t).numpy(), rtol=1e-6)
        npt.assert_allclose(float(lf[k]), float(TL.loss_fn(st, ts_t, p[k], t)), rtol=1e-6)
