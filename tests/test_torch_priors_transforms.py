"""The port's priors and transforms against the JAX package's."""

import numpy as np
import pytest
import torch

from linna_tpu import priors as JP
from linna_tpu import transforms as JT
from linna_tpu_torch import priors as TP
from linna_tpu_torch import transforms as TT

from _torch_parity import CPU, t, walkers

torch.set_num_threads(1)

PRIORS = [
    {"param": "a", "dist": "gauss", "arg1": 0.2, "arg2": 1.1},
    {"param": "b", "dist": "flat", "arg1": -2.0, "arg2": 3.0},
    {"param": "c", "dist": "flat", "arg1": 0.1, "arg2": 0.5},
    {"param": "d", "dist": "gauss", "arg1": -1.0, "arg2": 0.3},
]


def _packs():
    return JP.priors_from_list(PRIORS), TP.priors_from_list(PRIORS, CPU)


def test_transform_and_inverse_match_jax():
    pj, pt = _packs()
    x = walkers(64, 4, seed=1, scale=1.5)
    phys_j = np.asarray(JP.transform(pj, x))
    phys_t = TP.transform(pt, t(x)).numpy()
    np.testing.assert_allclose(phys_t, phys_j, rtol=1e-6, atol=1e-6)
    back_t = TP.inv_transform(pt, t(phys_j)).numpy()
    np.testing.assert_allclose(back_t, np.asarray(JP.inv_transform(pj, phys_j)), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(back_t, x, rtol=1e-3, atol=1e-3)


def test_transform_np_lnprior_and_range_match_jax():
    pj, pt = _packs()
    x = walkers(32, 4, seed=2).astype(np.float64)
    np.testing.assert_allclose(TP.transform_np(pt, x), JP.transform_np(pj, x), rtol=1e-12)
    np.testing.assert_allclose(
        TP.lnprior(t(x.astype(np.float32))).numpy(), np.asarray(JP.lnprior(x.astype(np.float32))),
        rtol=1e-6,
    )
    np.testing.assert_array_equal(TP.prior_range(pt), JP.prior_range(pj))


def test_pack_from_numpy_and_unknown_dist():
    pj, pt = _packs()
    carried = TP.pack_from_numpy(pj, CPU)
    for a, b in zip(carried, pt):
        assert torch.equal(a, b)
    with pytest.raises(NotImplementedError, match="lognormal"):
        TP.priors_from_list([{"dist": "lognormal", "arg1": 0, "arg2": 1}], CPU)


def _transform_sets(log10=(), ypositive=False, seed=0):
    rng = np.random.default_rng(seed)
    mask = np.zeros(4, bool)
    mask[list(log10)] = True
    ts_j = JT.TransformSet(
        JT.XTransform(rng.normal(size=4).astype(np.float32),
                      (1 + rng.uniform(size=4)).astype(np.float32), mask),
        JT.YTransform(rng.normal(size=6).astype(np.float32) * 0.1,
                      (0.5 + rng.uniform(size=6)).astype(np.float32), ypositive),
        JT.YTransformData((0.5 + rng.uniform(size=6)).astype(np.float32)),
    )
    return ts_j, TT.transforms_from_numpy(ts_j, CPU)


def test_x_transform_log10_lanes_match_jax():
    ts_j, ts_t = _transform_sets(log10=(1, 2))
    x = np.abs(walkers(16, 4, seed=3)) + 0.1
    np.testing.assert_allclose(
        ts_t.x_transform(t(x)).numpy(), np.asarray(ts_j.x_transform(x)), rtol=1e-5, atol=1e-6
    )
    # double-where: finite gradient at x <= 0 on an unmasked lane
    xt = torch.tensor([[-1.0, 0.5, 0.5, 0.0]], requires_grad=True)
    ts_t.x_transform(xt).sum().backward()
    assert torch.isfinite(xt.grad).all()


@pytest.mark.parametrize("ypositive", [False, True])
def test_y_transform_matches_jax(ypositive):
    ts_j, ts_t = _transform_sets(ypositive=ypositive)
    y = walkers(8, 6, seed=4, scale=0.5)
    out_t = ts_t.y_transform(t(y)).numpy()
    np.testing.assert_allclose(out_t, np.asarray(ts_j.y_transform(y)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ts_t.y_transform.inverse(t(out_t)).numpy(), y, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        ts_t.y_data.inverse(t(out_t)).numpy(), np.asarray(ts_j.y_data.inverse(out_t)), rtol=1e-6
    )


@pytest.mark.parametrize("ypositive", [False, True])
def test_fit_transforms_match_jax(ypositive):
    rng = np.random.default_rng(5)
    x = np.abs(rng.normal(size=(50, 4))) + 0.1
    y = np.abs(rng.normal(size=(50, 6))) + 0.5
    y[:, 0] = 1.0  # zero MAD -> the 1.0 floor (non-ypositive)
    xj, xt = JT.fit_x_transform(x, [2]), TT.fit_x_transform(x, [2], device=CPU)
    for a, b in zip(xt, xj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    yj, yt = JT.fit_y_transform(y, ypositive), TT.fit_y_transform(y, ypositive, device=CPU)
    np.testing.assert_allclose(yt.mean.numpy(), np.asarray(yj.mean), rtol=1e-6)
    np.testing.assert_allclose(yt.std.numpy(), np.asarray(yj.std), rtol=1e-6)
    assert yt.ypositive == yj.ypositive == ypositive


def test_transforms_npz_cross_load(tmp_path):
    ts_j, ts_t = _transform_sets(log10=(0,), ypositive=True, seed=6)
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    JT.save_transforms(pj, ts_j)
    TT.save_transforms(pt, ts_t)
    with np.load(pj) as a, np.load(pt) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])
    from_j = TT.load_transforms(pj, CPU)
    from_t = JT.load_transforms(pt)
    x = np.abs(walkers(5, 4, seed=7)) + 0.2
    np.testing.assert_allclose(
        from_j.x_transform(t(x)).numpy(), np.asarray(from_t.x_transform(x)), rtol=1e-6
    )
    assert from_j.y_transform.ypositive and from_t.y_transform.ypositive
