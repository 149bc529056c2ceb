"""PCA + polynomial-regression pre-model (PyTorch).

Counterpart of ``linna_tpu/linear_model.py``: an additive baseline under the
emulator network (``apply_model(..., linearmodel=...)``).  The fit is the
same float64 host computation: standardize inputs and outputs, PCA the
outputs (SVD of y^T y, keeping components with s/s0 > 0.05 when ``npc`` is
None), and fit a polynomial regression in PC space by least squares.
:class:`LinearModel` evaluates it on the device as a differentiable module
whose fields are buffers, so ``.to(device)`` moves it.

The fitted model round-trips through ``linear_model.npz`` with the JAX
package's keys and dtypes: a file written by either package loads in the
other.
"""

from __future__ import annotations

from itertools import combinations_with_replacement
from typing import Optional

import numpy as np
import torch

from .device import DeviceLike, resolve_device

__all__ = ["LinearModel", "fit_linear_model", "polynomial_powers",
           "save_linear_model", "load_linear_model"]

FIELDS = ("xmean", "xstd", "ymean", "ystd", "vec", "coef", "powers")
# rows of the float64 (rows, P, D) block built at once in the fit: at degree
# 2 and 27 inputs, 1024 x 406 x 27 x 8 B = 90 MB
FIT_CHUNK_ROWS = 1024


def polynomial_powers(ndim: int, degree: int) -> np.ndarray:
    """All monomial exponent vectors with total degree <= ``degree``, in
    scikit-learn's ``PolynomialFeatures.powers_`` order: by degree, then
    lexicographic combinations."""
    rows = []
    for deg in range(degree + 1):
        for combo in combinations_with_replacement(range(ndim), deg):
            p = np.zeros(ndim, dtype=np.int32)
            for i in combo:
                p[i] += 1
            rows.append(p)
    return np.stack(rows)


def _factor_index(powers: np.ndarray) -> np.ndarray:
    """Each monomial as ``degree`` indices into ``[1, x_1, ..., x_D]``: the
    input lanes repeated by their powers, padded with 0 (the constant 1)."""
    degree = max(int(powers.sum(axis=1).max()), 1)
    idx = np.zeros((len(powers), degree), dtype=np.int64)
    for r, p in enumerate(powers):
        lanes = np.repeat(np.arange(1, len(p) + 1), p)
        idx[r, : len(lanes)] = lanes
    return idx


class LinearModel(torch.nn.Module):
    """A fitted PCA + polynomial model; called on (B, D) or (D,) inputs as
    the JAX package's ``LinearModel.__call__`` is.

    Each monomial is a product of ``degree`` gathered factors from
    ``[1, xn_1, ..., xn_D]``, not a product of powers: multiplying by 1 is
    exact, so the values are those of ``prod(xn ** powers)``, while the
    gradient has no ``x ** 0`` term (whose power-rule derivative is NaN at
    ``xn == 0``) and no data-dependent branch for ``torch.func`` to refuse."""

    def __init__(self, xmean, xstd, ymean, ystd, vec, coef, powers, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
        for name, a in zip(FIELDS[:-1], (xmean, xstd, ymean, ystd, vec, coef)):
            self.register_buffer(name, f32(a))
        powers = np.asarray(powers, np.int32)
        self.register_buffer("powers", torch.as_tensor(powers, device=device))
        self.register_buffer("factors", torch.as_tensor(_factor_index(powers), device=device),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        one = x.dim() == 1
        if one:
            x = x[None, :]
        xn = (x - self.xmean) / self.xstd
        aug = torch.cat([torch.ones_like(xn[:, :1]), xn], dim=1)
        feats = aug[:, self.factors[:, 0]]
        for j in range(1, self.factors.shape[1]):
            feats = feats * aug[:, self.factors[:, j]]
        pc = feats @ self.coef  # (B, npc)
        out = pc @ self.vec * self.ystd + self.ymean
        return out[0] if one else out

    def arrays(self) -> dict:
        """The fields as numpy arrays under the npz keys."""
        return {k: getattr(self, k).cpu().numpy() for k in FIELDS}


def _features(xn: np.ndarray, powers: np.ndarray) -> np.ndarray:
    """``prod(xn ** powers)`` per row and monomial in float64, built in row
    chunks (the JAX package builds the whole (rows, P, D) block at once;
    each row's values are the same)."""
    out = np.empty((len(xn), len(powers)), dtype=np.float64)
    for s in range(0, len(xn), FIT_CHUNK_ROWS):
        out[s : s + FIT_CHUNK_ROWS] = np.prod(
            xn[s : s + FIT_CHUNK_ROWS, None, :] ** powers[None, :, :], axis=-1
        )
    return out


def fit_linear_model(
    train_x: np.ndarray,
    train_y: np.ndarray,
    norder: int = 2,
    npc: Optional[int] = None,
    sample_weight: Optional[np.ndarray] = None,
    device: DeviceLike = None,
) -> LinearModel:
    """Fit on the host in float64; the model lives on ``device``."""
    x = np.asarray(train_x, dtype=np.float64)
    y = np.asarray(train_y, dtype=np.float64)
    xmean, xstd = x.mean(axis=0), x.std(axis=0, ddof=1)
    ymean, ystd = y.mean(axis=0), y.std(axis=0, ddof=1)
    xstd = np.where(xstd == 0, 1.0, xstd)
    ystd = np.where(ystd == 0, 1.0, ystd)
    xn = (x - xmean) / xstd
    yn = (y - ymean) / ystd

    vec, s, _ = np.linalg.svd(yn.T @ yn)
    if npc is None:
        keep = np.where(s / s[0] > 0.05)[0]
        npc = int(keep[-1]) + 1 if len(keep) else 1
    y_pc = yn @ vec[:, :npc]

    powers = polynomial_powers(x.shape[1], norder)
    feats = _features(xn, powers)
    if sample_weight is not None:
        w = np.sqrt(np.asarray(sample_weight, dtype=np.float64))[:, None]
        coef, *_ = np.linalg.lstsq(feats * w, y_pc * w, rcond=None)
    else:
        coef, *_ = np.linalg.lstsq(feats, y_pc, rcond=None)
    return LinearModel(xmean, xstd, ymean, ystd, vec[:, :npc].T, coef, powers, device=device)


def save_linear_model(path: str, model: LinearModel) -> None:
    np.savez(path, **model.arrays())


def load_linear_model(path: str, device: DeviceLike = None) -> LinearModel:
    with np.load(path) as f:
        return LinearModel(*(f[k] for k in FIELDS), device=device)
