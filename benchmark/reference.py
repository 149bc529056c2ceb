"""The plain reference that decides ``correct``: the emulator, its training
step and its log-posterior, written again in plain PyTorch from the
published description (LINNA, arXiv:2203.05583; the ``chto_v2`` network of
its reference code), with no kernel, cache, graph or batching of the
program.  It imports nothing of ``linna_tpu_torch`` and no JAX, and it
takes nothing the program made: it fits the transforms, the loss state and
the AdamW update itself from the inputs the benchmark made.

Every product goes through :func:`matmul` at a named precision:

- ``f32``: float32 with TF32 off (the precision the configurations state
  for sampling);
- ``bf16``: the network's forward and backward in bfloat16 on float32
  master weights, as the configurations state for training
  (``train_compute_dtype``);
- ``tf32``: both operands rounded to TF32 (10 mantissa bits), accumulated
  in float32, as the tensor cores compute with TF32 on: the sampling
  cells' control;
- ``fp8``: operands scaled per tensor and rounded to float8 as fp8
  training's hybrid format does (weights and activations e4m3, the
  backward's incoming gradients e5m2): the training cells' control (their
  configurations train in bfloat16).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import numpy as np
import torch

PRECISIONS = ("f32", "bf16", "tf32", "fp8")
# faults the reference can play in the program's place
FAULTS = ("state_unchanged", "half_batch")
SENTINEL_LOW, SENTINEL_HIGH = 1e-30, 1e10
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}  # largest values


# ------------------------------------------------------------- the network


def hidden_size(ndata: int) -> int:
    """The reference code's width rule: 1000 for outputs over 30."""
    return 1000 if ndata > 30 else max(32, 32 * ndata)


def layout(ndim: int, ndata: int) -> list:
    """(path, shape) of every parameter of ``chto_v2`` at ``ndim -> ndata``:
    an input linear, three width-halving residual blocks with inner
    channels 16, 32 and 64 and a linear skip, two ReLU linears and an output
    linear."""
    h = hidden_size(ndata)
    widths = (h, h // 2, h // 4, h // 8)
    out = []

    def linear(path, fan_in, fan_out):
        out.append((path + ("w",), (fan_in, fan_out)))
        out.append((path + ("b",), (fan_out,)))

    linear(("layer1",), ndim, h)
    for i, c in enumerate((16, 32, 64)):
        name = f"rb{i + 1}"
        linear((name, "lin1"), widths[i], c)
        linear((name, "lin2"), c, widths[i + 1])
        out.append(((name, "skip_w"), (widths[i], widths[i + 1])))
    linear(("layer6",), widths[3], 4 * widths[3])
    linear(("layer7",), 4 * widths[3], ndata)
    linear(("layer8",), ndata, ndata)
    return out


def n_weights(ndim: int, ndata: int) -> int:
    return sum(math.prod(shape) for _, shape in layout(ndim, ndata))


def nest(items) -> dict:
    """A parameter dict from (path, tensor) pairs."""
    tree: dict = {}
    for path, value in items:
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value
    return tree


def leaves(tree: dict, prefix=()) -> list:
    """(path, tensor) of a parameter dict in :func:`layout` order."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += leaves(v, prefix + (k,))
        else:
            out.append((prefix + (k,), v))
    return out


def make_weights(ndim: int, ndata: int, members: int, seed: int, device) -> list:
    """``members`` parameter dicts from ``seed``, made on ``device`` in one
    draw: Xavier-uniform weights (skips included) and biases of 1e-2, the
    reference code's initialization."""
    entries = layout(ndim, ndata)
    n_w = sum(math.prod(s) for _, s in entries if len(s) == 2)
    g = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(members * n_w, generator=g, device=device).mul_(2.0).sub_(1.0)
    out, off = [], 0
    for _ in range(members):
        items = []
        for path, shape in entries:
            if len(shape) == 2:
                n = math.prod(shape)
                limit = math.sqrt(6.0 / (shape[0] + shape[1]))
                items.append((path, u[off:off + n].view(shape).mul_(limit)))
                off += n
            else:
                items.append((path, torch.full(shape, 1e-2, device=device)))
        out.append(nest(items))
    return out


# -------------------------------------------------------------- precisions


def _round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest (ties to even) at 10 mantissa bits."""
    i = t.contiguous().view(torch.int32).to(torch.int64)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    i = torch.where(i >= 2**31, i - 2**32, i)
    return i.to(torch.int32).view(torch.float32)


def _round_fp8(t: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """float32 scaled per tensor into a float8 type's range, rounded to it
    and scaled back."""
    scale = FP8_MAX[dtype] / t.detach().abs().amax().clamp(min=1e-30)
    return (t * scale).to(dtype).to(torch.float32) / scale


def _round_fp8_grad(t: torch.Tensor) -> torch.Tensor:
    return _round_fp8(t, torch.float8_e5m2)


_ROUND = {"tf32": _round_tf32, "fp8": _round_fp8}
# the backward's incoming gradient, where a format rounds it otherwise
_ROUND_GRAD = {"tf32": _round_tf32, "fp8": _round_fp8_grad}


class _RoundedMatmul(torch.autograd.Function):
    """``a @ b`` with every operand of the forward and of the backward's
    two products rounded to a lower precision first."""

    @staticmethod
    def forward(ctx, a, b, precision):
        r = _ROUND[precision]
        ctx.precision = precision
        ctx.save_for_backward(a, b)
        return r(a) @ r(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        r, g = _ROUND[ctx.precision], _ROUND_GRAD[ctx.precision](g)
        ga = g @ r(b).transpose(-1, -2) if ctx.needs_input_grad[0] else None
        gb = r(a).transpose(-1, -2) @ g if ctx.needs_input_grad[1] else None
        return ga, gb, None


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    if precision == "f32":
        return a @ b
    if precision not in _ROUND:
        raise ValueError(f"precision {precision!r}; one of {PRECISIONS}")
    return _RoundedMatmul.apply(a, b, precision)


@contextlib.contextmanager
def full_f32():
    """TF32 off for every float32 product inside, as it was after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def forward(params: dict, x: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """The network's output for rows ``x`` (standardized inputs), float32.
    ``bf16``: parameters and inputs cast to bfloat16 and every operation in
    it, the output cast back."""
    if precision == "bf16":
        low = nest((path, t.to(torch.bfloat16)) for path, t in leaves(params))
        return forward(low, x.to(torch.bfloat16)).to(torch.float32)

    def lin(p, h):
        return matmul(h, p["w"], precision) + p["b"]

    s = torch.relu(lin(params["layer1"], x))
    for name in ("rb1", "rb2", "rb3"):
        p = params[name]
        h = torch.relu(lin(p["lin1"], s))
        s = torch.relu(0.1 * lin(p["lin2"], h) + matmul(s, p["skip_w"], precision))
    s = torch.relu(lin(params["layer6"], s))
    s = torch.relu(lin(params["layer7"], s))
    return lin(params["layer8"], s)


# ---------------------------------------------------------- the likelihood


def log_prob(members: list, x: torch.Tensor, prob: dict, precision: str = "f32",
             block: int = 16384) -> torch.Tensor:
    """The tempered log-posterior of whitened positions ``x`` (rows, D):
    each flat prior's probability transform to physical parameters, the
    input standardization, every member's network, the output
    destandardization and data scaling, chi^2 against the data; with K > 1
    members the effective chi^2 is their mean plus ``k_std`` times their
    population spread; the whitened unit-normal prior; NaN -> -inf.
    ``prob``: the tensors of :func:`benchmark.problem.sampling_problem`.
    Computed in blocks of ``block`` rows."""
    out = []
    with torch.no_grad():
        for x_b in torch.split(x.to(torch.float32), block):
            u = 0.5 * (1.0 + torch.special.erf(x_b / math.sqrt(2.0)))
            phys = u * (prob["hi"] - prob["lo"]) + prob["lo"]
            x_in = (phys - prob["x_mean"]) / prob["x_std"]
            chi2 = []
            for p in members:
                m = (forward(p, x_in, precision) * prob["y_std"] + prob["y_mean"]) * prob["sigma"]
                d = m - prob["data"]
                chi2.append((matmul(d, prob["inv_cov"], precision) * d).sum(-1))
            chi2 = torch.stack(chi2)
            eff = chi2[0] if len(members) == 1 else (
                chi2.mean(0) + prob["k_std"] * chi2.std(0, correction=0))
            lp = -0.5 * eff / prob["temperature"] - 0.5 * (x_b * x_b).sum(-1)
            out.append(torch.where(torch.isnan(lp), torch.full_like(lp, -math.inf), lp))
    return torch.cat(out)


# ------------------------------------------------------------ the training


def _median0(y: torch.Tensor) -> torch.Tensor:
    """Median over axis 0, the two middle values averaged for an even count."""
    s = torch.sort(y, dim=0).values
    n = y.shape[0]
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


def fit_training(tx: np.ndarray, ty: np.ndarray, data: np.ndarray, cov: np.ndarray,
                 device) -> dict:
    """The standardizations and the loss state a training call works in,
    fitted on every training row: inputs by mean and std (ddof 1), outputs
    scaled by sigma = sqrt(diag(cov)) and then by median and MAD (a MAD
    under 1e-10 taken as 1), and the inverse of the covariance mapped into
    that standardized space (float64)."""
    x64 = torch.as_tensor(np.asarray(tx, np.float64), device=device)
    sigma = np.sqrt(np.diag(np.asarray(cov, np.float64)))
    y64 = torch.as_tensor(np.asarray(ty, np.float64), device=device) / torch.as_tensor(
        sigma, device=device)
    med = _median0(y64)
    mad = _median0((y64 - med).abs())
    mad = torch.where(mad < 1e-10, torch.ones_like(mad), mad)
    med, mad = med.cpu().numpy(), mad.cpu().numpy()
    cov_std = np.asarray(cov, np.float64) / np.outer(sigma, sigma) / np.outer(mad, mad)
    data_std = (np.asarray(data, np.float64) / sigma - med) / mad
    data_std = np.nan_to_num(data_std, nan=SENTINEL_LOW)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return {"x_mean": f32(x64.mean(0).cpu().numpy()),
            "x_std": f32(x64.std(0, correction=1).cpu().numpy()),
            "sigma": f32(sigma), "y_med": f32(med), "y_mad": f32(mad),
            "inv_cov": f32(np.linalg.inv(cov_std)), "data_std": f32(data_std),
            "ndata": int(np.shape(data)[-1])}


def _chi2(d, mask, inv_cov):
    d = torch.where(mask, torch.zeros_like(d), d)
    return ((d @ inv_cov) * d).sum(-1)


def row_losses(params: dict, tx: torch.Tensor, ty: torch.Tensor, fit: dict,
               precision: str = "f32") -> torch.Tensor:
    """The chi^2-ratio loss of each row: chi^2(network, target) over
    chi^2(target, data) floored at ndata / 2, in the standardized output
    space, with sentinel entries (1e-30, 1e10) left out of both."""
    x = (tx - fit["x_mean"]) / fit["x_std"]
    target = (ty / fit["sigma"] - fit["y_med"]) / fit["y_mad"]
    mask = (ty == SENTINEL_LOW) | (ty == SENTINEL_HIGH) | (fit["data_std"] == SENTINEL_LOW)
    with torch.no_grad():
        denom = torch.clamp(_chi2(target - fit["data_std"], mask, fit["inv_cov"]),
                            min=0.5 * fit["ndata"])
    pred = forward(params, x, precision)
    return _chi2(target - pred, mask, fit["inv_cov"]) / denom


def val_loss(params: dict, vx: torch.Tensor, vy: torch.Tensor, fit: dict,
             block: int = 4096) -> torch.Tensor:
    """The validation loss at an epoch's end: the median over the validation
    rows of their loss, the network in float32, in blocks of ``block``
    rows."""
    with torch.no_grad():
        rows = torch.cat([row_losses(params, x, y, fit)
                          for x, y in zip(torch.split(vx, block), torch.split(vy, block))])
    return _median0(rows[:, None])[0]


def epoch_orders(seed: int, n_epochs: int, n: int, batch_size: int) -> torch.Tensor:
    """(n_epochs, nb * batch_size) row orders of one member: each epoch a
    ``torch.randperm`` of the ``n`` rows from the member's own host
    generator seeded with ``seed``, cut to whole minibatches (the order
    the trainer documents for each member's stream)."""
    g = torch.Generator().manual_seed(int(seed))
    keep = max(n // batch_size, 1) * batch_size
    return torch.stack([torch.randperm(n, generator=g)[:keep] for _ in range(n_epochs)])


def training_call(params: dict, rows: tuple, orders: torch.Tensor, fit: dict, lr: float,
                  wd: float, batch_size: int, precision: str = "f32",
                  mu_dtype: torch.dtype = torch.float32, fault: Optional[str] = None) -> dict:
    """One member through one training call from fresh optimizer state:
    for each epoch of ``orders`` its minibatches in that order, each one
    AdamW step (b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias
    correction by the step count, decay ``lr * wd * p`` on every
    parameter) with the moments carried from step to step, the first
    moment stored in ``mu_dtype``; at each epoch's end the validation loss.
    ``rows``: (tx, ty, vx, vy) on the device.  Returns the loss of every
    step, the validation loss of every epoch, and the parameters and the
    second moment after the last step, by leaf.  ``fault`` plays a broken
    program: steps that leave the parameters unchanged
    (``state_unchanged``), or a loss that is the mean over the first half
    of each minibatch (``half_batch``)."""
    tx, ty, vx, vy = rows
    current = {path: t.detach().clone() for path, t in leaves(params)}
    mu = {p: torch.zeros_like(t, dtype=mu_dtype) for p, t in current.items()}
    nu = {p: torch.zeros_like(t) for p, t in current.items()}
    losses, vals, count = [], [], 0
    for order in orders.to(tx.device):
        for idx in torch.split(order, batch_size):
            if fault == "half_batch":
                idx = idx[:len(idx) // 2]
            leaf = {path: t.clone().requires_grad_(True) for path, t in current.items()}
            loss = row_losses(nest(leaf.items()), tx[idx], ty[idx], fit, precision).mean()
            grads = torch.autograd.grad(loss, list(leaf.values()))
            losses.append(loss.detach())
            if fault == "state_unchanged":
                continue
            count += 1
            with torch.no_grad():
                for (path, p), g in zip(current.items(), grads):
                    m = mu[path].to(torch.float32) * ADAM_B1 + (1.0 - ADAM_B1) * g
                    mu[path] = m.to(mu_dtype)
                    nu[path] = nu[path] * ADAM_B2 + (1.0 - ADAM_B2) * (g * g)
                    m_hat = m / (1.0 - ADAM_B1**count)
                    v_hat = nu[path] / (1.0 - ADAM_B2**count)
                    current[path] = p - lr * (m_hat / (torch.sqrt(v_hat) + ADAM_EPS) + wd * p)
        vals.append(val_loss(nest(current.items()), vx, vy, fit))
    return {"losses": torch.stack(losses).double().cpu().numpy().tolist(),
            "val": torch.stack(vals).double().cpu().numpy().tolist(),
            "params": current, "nu": nu, "steps": count}
