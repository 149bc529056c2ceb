"""Input/output standardization transforms for the emulator (PyTorch).

Counterpart of ``linna_tpu/transforms.py``: the network sees standardized
inputs ``(x' - mean)/std`` (``x'`` takes log10 at masked indices) and emits
standardized outputs mapped back by a median/MAD affine map, optionally
through ``exp`` for strictly positive data vectors; the data vector itself
is scaled by ``1/sqrt(diag(cov))``.  Fitting: X statistics use the
Bessel-corrected std, Y statistics median + MAD with a ``< 1e-10 -> 1``
floor.  ``transforms.npz`` has the same keys in both packages.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .device import DeviceLike, resolve_device

__all__ = [
    "XTransform",
    "YTransformData",
    "YTransform",
    "TransformSet",
    "fit_x_transform",
    "fit_y_transform",
    "save_transforms",
    "load_transforms",
    "transforms_from_numpy",
]


class XTransform(NamedTuple):
    """Parameter standardization with log10 at the masked indices."""

    mean: torch.Tensor  # f32[D]
    std: torch.Tensor  # f32[D]
    log10_mask: torch.Tensor  # bool[D]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        # double-where: log10 never sees the unselected lanes, whose
        # gradient would otherwise be NaN at x <= 0 (0 * inf through where)
        safe = torch.where(self.log10_mask, x, torch.ones_like(x))
        x1 = torch.where(self.log10_mask, torch.log10(safe), x)
        return (x1 - self.mean) / self.std


class YTransformData(NamedTuple):
    """Data-vector scaling ``y -> y/sigma`` with ``sigma = sqrt(diag(cov))``."""

    sigma: torch.Tensor  # f32[N]

    def __call__(self, y: torch.Tensor) -> torch.Tensor:
        return y / self.sigma

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        return y * self.sigma

    def transform_cov(self, cov: np.ndarray) -> np.ndarray:
        """``D^-1 C D^-1`` with ``D = diag(sigma)``, in float64 on the host."""
        inv_sigma = 1.0 / self.sigma.detach().cpu().numpy().astype(np.float64)
        return cov * inv_sigma[:, None] * inv_sigma[None, :]


class YTransform(NamedTuple):
    """Network-output destandardization: ``y*std + mean``, then ``exp``
    when ``ypositive``."""

    mean: torch.Tensor  # f32[N]
    std: torch.Tensor  # f32[N]
    ypositive: bool

    def __call__(self, y: torch.Tensor) -> torch.Tensor:
        out = y * self.std + self.mean
        if self.ypositive:
            out = torch.exp(out)
        return out

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        if self.ypositive:
            y = torch.log(y)
        return (y - self.mean) / self.std

    def transform_cov(self, cov: np.ndarray, data: Optional[np.ndarray] = None) -> np.ndarray:
        """Map a sigma-scaled covariance into the standardized network-output
        space, in float64 on the host.  For ``ypositive`` the covariance is
        first taken to log space as ``log(1 + C/(d_i d_j))`` around the data
        vector ``data``."""
        std = self.std.detach().cpu().numpy().astype(np.float64)
        if self.ypositive:
            if data is None:
                raise ValueError("ypositive covariance transform needs the data vector")
            d = np.asarray(data, dtype=np.float64)
            cov0 = cov / (d[:, None] * d[None, :])
            cov0 = np.where(cov0 <= -1.0, 1e-10 - 1.0, cov0)
            cov = np.log1p(cov0)
        inv_std = 1.0 / std
        return cov * inv_std[:, None] * inv_std[None, :]


class TransformSet(NamedTuple):
    """All transforms of one trained emulator iteration (``transforms.npz``)."""

    x_transform: XTransform
    y_transform: YTransform
    y_data: YTransformData

    def to(self, device) -> "TransformSet":
        xt, yt, yd = self
        return TransformSet(
            XTransform(*(t.to(device) for t in xt)),
            YTransform(yt.mean.to(device), yt.std.to(device), yt.ypositive),
            YTransformData(yd.sigma.to(device)),
        )


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)


def _make_set(x_mean, x_std, x_mask, y_mean, y_std, ypositive, sigma, device) -> TransformSet:
    return TransformSet(
        XTransform(
            _f32(x_mean, device),
            _f32(x_std, device),
            torch.as_tensor(np.asarray(x_mask, dtype=bool), device=device),
        ),
        YTransform(_f32(y_mean, device), _f32(y_std, device), bool(ypositive)),
        YTransformData(_f32(sigma, device)),
    )


def transforms_from_numpy(ts, device: DeviceLike = None) -> TransformSet:
    """Carry a transform set across from its array form: any object shaped
    like :class:`TransformSet` whose leaves are arrays (for example the JAX
    package's ``TransformSet`` after ``jax.device_get``)."""
    xt, yt, yd = ts.x_transform, ts.y_transform, ts.y_data
    return _make_set(
        xt.mean, xt.std, xt.log10_mask, yt.mean, yt.std, yt.ypositive,
        yd.sigma, resolve_device(device),
    )


def fit_x_transform(
    train_x: np.ndarray,
    dolog10index: Optional[Sequence[int]] = None,
    device: DeviceLike = None,
) -> XTransform:
    """Mean/std (ddof=1) over the (log10-mapped) training inputs."""
    x = np.array(train_x, dtype=np.float64)
    mask = np.zeros(x.shape[-1], dtype=bool)
    if dolog10index is not None:
        for ind in dolog10index:
            mask[ind] = True
            x[:, ind] = np.log10(x[:, ind])
    device = resolve_device(device)
    return XTransform(
        _f32(x.mean(axis=0), device),
        _f32(x.std(axis=0, ddof=1), device),
        torch.as_tensor(mask, device=device),
    )


def fit_y_transform(
    train_y_scaled: np.ndarray, ypositive: bool = False, device: DeviceLike = None
) -> YTransform:
    """Median/MAD of the sigma-scaled training outputs (log space for
    ``ypositive``, where the MAD floor is not applied)."""
    y = np.array(train_y_scaled, dtype=np.float64)
    if ypositive:
        y = np.log(y)
    median = np.median(y, axis=0)
    mad = np.median(np.abs(y - median), axis=0)
    if not ypositive:
        mad = np.where(mad < 1e-10, 1.0, mad)
    device = resolve_device(device)
    return YTransform(_f32(median, device), _f32(mad, device), ypositive)


def save_transforms(path: str, ts: TransformSet) -> None:
    """Persist the transform set as one ``.npz`` (atomic: tmp + rename)."""
    tmp = path + ".tmp.npz"  # keep .npz so savez doesn't append a suffix
    cpu = lambda t: t.detach().cpu().numpy()
    np.savez(
        tmp,
        x_mean=cpu(ts.x_transform.mean),
        x_std=cpu(ts.x_transform.std),
        x_log10_mask=cpu(ts.x_transform.log10_mask),
        y_mean=cpu(ts.y_transform.mean),
        y_std=cpu(ts.y_transform.std),
        y_positive=np.array(ts.y_transform.ypositive),
        sigma=cpu(ts.y_data.sigma),
    )
    os.replace(tmp, path)


def load_transforms(path: str, device: DeviceLike = None) -> TransformSet:
    with np.load(path) as z:
        return _make_set(
            z["x_mean"], z["x_std"], z["x_log10_mask"], z["y_mean"],
            z["y_std"], bool(z["y_positive"]), z["sigma"], resolve_device(device),
        )
