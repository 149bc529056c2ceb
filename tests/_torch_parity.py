"""Shared inputs for the PyTorch-port parity tests: one small problem made
from a numpy seed, handed to the JAX package and to the port as the same
numbers (JAX-initialized weights carried across with params_from_numpy)."""

from types import SimpleNamespace

import jax
import numpy as np
import torch

import jax.numpy as jnp

from linna_tpu import losses as JL
from linna_tpu import nn as JN
from linna_tpu import priors as JP
from linna_tpu import transforms as JT
from linna_tpu_torch import losses as TL
from linna_tpu_torch import nn as TN
from linna_tpu_torch import priors as TP
from linna_tpu_torch import transforms as TT

CPU = "cpu"


def problem(ndim=5, ndata=8, seed=0, model="chto_v2", log10=None, ypositive=False):
    rng = np.random.default_rng(seed)
    spec = JN.make_model_spec(model, ndim, ndata)
    params_j = JN.init_model(jax.random.key(seed), spec)
    mask = np.zeros(ndim, bool)
    if log10 is not None:
        mask[list(log10)] = True
    x_mean = (rng.normal(size=ndim) * 0.1).astype(np.float32)
    x_std = (1.0 + 0.1 * rng.uniform(size=ndim)).astype(np.float32)
    if ypositive:
        y_mean = np.zeros(ndata, np.float32)
        y_std = np.full(ndata, 0.05, np.float32)
    else:
        y_mean = (rng.normal(size=ndata) * 0.1).astype(np.float32)
        y_std = np.full(ndata, 1.3, np.float32)
    sigma = np.full(ndata, 0.7, np.float32)
    ts_j = JT.TransformSet(
        JT.XTransform(x_mean, x_std, mask),
        JT.YTransform(y_mean, y_std, ypositive),
        JT.YTransformData(sigma),
    )
    priors = [{"param": "g", "dist": "gauss", "arg1": 0.2, "arg2": 1.1}] + [
        {"param": f"p{i}", "dist": "flat", "arg1": -2.0, "arg2": 2.0}
        for i in range(ndim - 1)
    ]
    data = rng.normal(size=ndata) * 0.3
    if ypositive:
        data = np.abs(data) + 1.0
    a = rng.normal(size=(ndata, ndata)) * 0.05
    inv_cov = np.eye(ndata) + a @ a.T
    return SimpleNamespace(
        spec=spec,
        tspec=TN.make_model_spec(model, ndim, ndata),
        params_j=params_j,
        params_t=TN.params_from_numpy(jax.device_get(params_j), CPU),
        ts_j=ts_j,
        ts_t=TT.transforms_from_numpy(ts_j, CPU),
        pack_j=JP.priors_from_list(priors),
        pack_t=TP.priors_from_list(priors, CPU),
        priors=priors,
        data=data,
        inv_cov=inv_cov,
    )


def walkers(n, ndim, seed=1, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(n, ndim)) * scale).astype(np.float32)


def t(a):
    return torch.as_tensor(np.asarray(a))


def log_probs(pb, temperature=1.0, use_fused=False):
    """The problem's batched log-posterior in both packages: (JAX, port)."""
    from linna_tpu import likelihood as JLK
    from linna_tpu_torch import likelihood as TLK

    lp_j = JLK.make_log_prob(pb.spec, pb.params_j, pb.ts_j, pb.pack_j, pb.data, pb.inv_cov,
                             temperature=temperature)
    lp_t = TLK.make_log_prob(pb.tspec, pb.params_t, pb.ts_t, pb.pack_t, pb.data, pb.inv_cov,
                             temperature=temperature, use_fused=use_fused, device=CPU)
    return lp_j, lp_t


# a correlated 2-D Gaussian target for the samplers (tests/test_hmc.py's)
GAUSS_MEAN = np.array([1.0, -0.5])
GAUSS_COV = np.array([[1.0, 0.6], [0.6, 0.8]])


def gauss_log_probs(mean=GAUSS_MEAN, cov=GAUSS_COV):
    """The Gaussian's log-density in both packages: (JAX, port)."""
    import jax.numpy as jnp

    ic = np.linalg.inv(cov)
    mj, icj = jnp.asarray(mean, jnp.float32), jnp.asarray(ic, jnp.float32)
    mt, ict = torch.as_tensor(mean, dtype=torch.float32), torch.as_tensor(ic, dtype=torch.float32)

    def lp_j(x):
        d = x - mj
        return -0.5 * jnp.einsum("...i,ij,...j->...", d, icj, d)

    def lp_t(x):
        d = x - mt
        return -0.5 * torch.einsum("...i,ij,...j->...", d, ict, d)

    return lp_j, lp_t


def train_problem(seed=0, ntrain=70, nval=16, ndim=2, ndata=3, model="chto_simple"):
    """A small training problem: rows of a seeded tanh theory, the JAX
    transforms and loss state and the port's copies of them."""
    rng = np.random.default_rng(seed)
    data = rng.normal(1.0, 0.1, ndata)
    cov = np.eye(ndata) * 0.01
    sigma = np.sqrt(np.diag(cov))
    proj = rng.normal(size=(ndim, ndata))

    def theory(x):
        return np.tanh(x @ proj) * 0.1 + data

    tx = rng.uniform(-1, 1, (ntrain, ndim))
    vx = rng.uniform(-1, 1, (nval, ndim))
    ts_j = JT.TransformSet(
        JT.fit_x_transform(tx), JT.fit_y_transform(theory(tx) / sigma),
        JT.YTransformData(jnp.asarray(sigma, jnp.float32)),
    )
    ts_t = TT.transforms_from_numpy(ts_j, CPU)
    return dict(
        spec=JN.make_model_spec(model, ndim, ndata), tspec=TN.make_model_spec(model, ndim, ndata),
        ts_j=ts_j, ts_t=ts_t, ls_j=JL.build_loss_state(data, cov, ts_j),
        ls_t=TL.build_loss_state(data, cov, ts_t), rows=(tx, theory(tx), vx, theory(vx)),
    )
