"""Problems for the tests of the composition's value-and-gradient kernel
(``linna_tpu_torch.ops.composition``): K members at a model's widths, with
mixed priors, a dense inverse covariance and the y transforms.  Imports no
JAX, so that the card tests run on a machine with the card alone."""

import numpy as np
import torch

from linna_tpu_torch import likelihood as LK
from linna_tpu_torch import nn as N
from linna_tpu_torch import priors as P
from linna_tpu_torch import transforms as T
from linna_tpu_torch.samplers import hmc

# The card's tolerances (tests/test_torch_composition_grad_card.py,
# chip_smoke.py).  The kernel's products run in 3xTF32 (each operand split in two TF32
# parts, the small-by-small term left out) and sum in the tensor cores'
# float32 accumulators, in other orders than PyTorch's; both are held to
# the composition's float64 autograd.  Values: within 1.0e-5 of |lp| on an
# NVIDIA H100 at the LSST width (1560-long chi^2 sums; 2.5e-7 for
# PyTorch's float32), 3.5e-6 at the DES width.  Gradients, each row's
# error over its norm: 1.3e-5 to 4.6e-5 at the rows away from the points
# where the gradient jumps (PyTorch's float32: 1e-6 to 5e-5), and up to
# 10 % at a row with a ReLU unit within the products' rounding of 0 or, at
# K = 2 with the std term, with the two members' chi^2 within rounding of
# each other: the two sides of a kink, where PyTorch's float32 misses by
# as much.  So every row's value and the median row's gradient are held,
# and the gradient of each row whose ReLU margin passes RELU_MARGIN and
# whose members' chi^2 spread passes SPREAD (:func:`margins`,
# :func:`smooth_rows`).
VALUE_RTOL, VALUE_ATOL = 3e-5, 1e-4
GRAD_RTOL = 2e-4
MEDIAN_GRAD_RTOL = 1e-4
RELU_MARGIN, SPREAD = 3e-6, 1e-2


def problem(device, ndim, ndata, members=2, ypositive=False, k_std=1.0, temperature=4.0,
            seed=0, symmetric=True, **kw):
    """The batched log-posterior of ``members`` untrained ``chto_v2``
    members (seeds ``seed``, ``seed + 1``, ...; one member is passed as one
    emulator) and the spec.  Member k's output bias is shifted by 0.2 k, so
    that the members' chi^2 differ as trained members' do (by tens of per
    cent) and not by the thousandths untrained members' differ by.  The
    inverse covariance is dense, SPD, and with ``symmetric`` False takes an
    antisymmetric part too."""
    rng = np.random.default_rng(seed)
    spec = N.make_model_spec("chto_v2", ndim, ndata)
    params = [N.init_model(spec, seed=seed + k, device=device) for k in range(members)]
    for k, p in enumerate(params):
        p["layer8"]["b"] += 0.2 * k
    priors = [{"param": f"p{i}", "dist": "gauss", "arg1": 0.3, "arg2": 0.1} if i % 3 == 0 else
              {"param": f"p{i}", "dist": "flat", "arg1": -1.0, "arg2": 2.0} for i in range(ndim)]
    y_mean = rng.normal(size=ndata) * 0.1
    y_std = 0.3 + 0.1 * rng.uniform(size=ndata) if ypositive else 1.0 + 0.3 * rng.uniform(size=ndata)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    ts = T.TransformSet(
        T.XTransform(f32(rng.normal(size=ndim) * 0.1), f32(1.0 + 0.1 * rng.uniform(size=ndim)),
                     torch.zeros(ndim, dtype=torch.bool, device=device)),
        T.YTransform(f32(y_mean), f32(y_std), ypositive),
        T.YTransformData(f32(0.5 + rng.uniform(size=ndata))),
    )
    data = rng.normal(size=ndata) * 0.3
    if ypositive:
        data = np.abs(data) + 1.0
    a = rng.normal(size=(ndata, ndata)) / np.sqrt(ndata)
    inv_cov = np.eye(ndata) + 0.1 * a @ a.T
    if not symmetric:
        b = rng.normal(size=(ndata, ndata)) / np.sqrt(ndata)
        inv_cov = inv_cov + 0.05 * (b - b.T)
    pack = P.priors_from_list(priors, device)
    if kw.get("out_cut") is not None:  # a wider checkpoint than the data
        data, inv_cov = data[:kw["out_cut"]], inv_cov[:kw["out_cut"], :kw["out_cut"]]
    lp = LK.make_log_prob(spec, params if members > 1 else params[0], ts, pack, data, inv_cov,
                          temperature=temperature, ensemble_k_std=k_std, device=device, **kw)
    return lp, spec


def walkers(n, ndim, device, seed=1, scale=0.3):
    g = np.random.default_rng(seed)
    return torch.as_tensor(g.normal(size=(n, ndim)) * scale, dtype=torch.float32, device=device)


def composition(log_prob):
    """The same log-posterior through the composition as written: the
    log-prob's ``_pure`` over a copy of its env, which the kernel's route
    does not take."""
    env = dict(log_prob._env)
    return lambda x: log_prob._pure(x, env)


def standardized(log_prob, x):
    """The x transform's output at walkers x: the kernel's input."""
    env = log_prob._env
    return env["transforms"].x_transform(P.transform(env["priors"], x)).detach()


def likelihood(spec, log_prob, x_in, dtype=torch.float64):
    """The composition's tempered log-likelihood at ``x_in`` and its
    gradient with respect to x_in, by PyTorch's autograd in ``dtype``
    (float64 by default: the truth both float32 versions are held to)."""
    env = log_prob._env
    ts = env["transforms"]
    cast = lambda t: _cast(t, dtype)
    params = cast(env["params"])
    y_mean, y_std, sigma = (cast(t) for t in (ts.y_transform.mean, ts.y_transform.std,
                                               ts.y_data.sigma))
    data, inv_cov, temp, k_std = (cast(env[k]) for k in ("data", "inv_cov", "temperature",
                                                           "k_std"))

    def of(xi):
        m = trunk(params, xi)[0] * y_std + y_mean
        if ts.y_transform.ypositive:
            m = torch.exp(m)
        chi2 = LK._chi2(m * sigma - data, inv_cov)
        if chi2.dim() == 2:
            return -0.5 * (chi2.mean(dim=0) + k_std * chi2.std(dim=0, correction=0)) / temp
        return -0.5 * chi2 / temp

    return hmc.value_and_grad(of, x_in.to(dtype))


def trunk(params, x):
    """``nn.apply_model``'s trunk (chto_v2), and each row's ReLU margin:
    the smallest |pre-activation| of any ReLU unit of any member."""
    pre = []

    def relu(t):
        pre.append(t.detach().abs().reshape(*t.shape[:-2], t.shape[-2], -1).amin(dim=-1))
        return torch.relu(t)

    lin = lambda p, a: a @ p["w"] + p["b"]
    s = relu(lin(params["layer1"], x))
    for rb in ("rb1", "rb2", "rb3"):
        p = params[rb]
        hid = relu(lin(p["lin1"], s))
        s = relu(0.1 * lin(p["lin2"], hid) + s @ p["skip_w"])
    s = relu(lin(params["layer6"], s))
    s = relu(lin(params["layer7"], s))
    margin = torch.stack([m.reshape(-1, m.shape[-1]).amin(dim=0) for m in pre]).amin(dim=0)
    return lin(params["layer8"], s), margin


def margins(spec, log_prob, x_in):
    """Each row's distance, in float64, from the points where the
    composition's gradient jumps: (its ReLU margin (:func:`trunk`), the
    members' chi^2 spread std_k / mean_k, inf for one member).  A row
    whose ReLU margin lies within float32 rounding of 0 may switch a unit
    on one side and not on the other, and its gradient then differs by that
    unit's part; the ensemble's std weight (chi2_k - mean) / (K std)
    divides the chi^2's rounding by the spread (at K = 2 it switches sides
    where the two members' chi^2 cross)."""
    env = log_prob._env
    ts = env["transforms"]
    params = _cast(env["params"], torch.float64)
    with torch.no_grad():
        pred, relu_margin = trunk(params, x_in.double())
        m = pred * ts.y_transform.std.double() + ts.y_transform.mean.double()
        if ts.y_transform.ypositive:
            m = torch.exp(m)
        chi2 = LK._chi2(m * ts.y_data.sigma.double() - env["data"].double(),
                        env["inv_cov"].double())
    if chi2.dim() == 1:
        return relu_margin, torch.full_like(chi2, float("inf"))
    return relu_margin, chi2.std(dim=0, correction=0) / chi2.mean(dim=0).abs()


def smooth_rows(spec, log_prob, x_in):
    """The rows whose gradient is held row by row: ReLU margin above
    RELU_MARGIN, and the members' chi^2 spread above SPREAD where the std
    term counts (:func:`margins`)."""
    relu_margin, spread = margins(spec, log_prob, x_in)
    no_std = float(log_prob._env["k_std"]) == 0.0
    return (relu_margin > RELU_MARGIN) & ((spread > SPREAD) | no_std)


def _cast(tree, dtype):
    return {k: _cast(v, dtype) for k, v in tree.items()} if isinstance(tree, dict) else tree.to(dtype)


def row_gaps(got, want):
    """Each row's gradient error over that row's gradient norm."""
    got, want = got.double(), want.double()
    return (got - want).norm(dim=1) / want.norm(dim=1).clamp_min(1e-300)


def row_gap(got, want):
    """The largest of :func:`row_gaps`."""
    return float(row_gaps(got, want).max())
