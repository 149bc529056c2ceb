"""Shared inputs for the PyTorch-port parity tests: one small problem made
from a numpy seed, handed to the JAX package and to the port as the same
numbers (JAX-initialized weights carried across with params_from_numpy)."""

from types import SimpleNamespace

import jax
import numpy as np
import torch

from linna_tpu import nn as JN
from linna_tpu import priors as JP
from linna_tpu import transforms as JT
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
