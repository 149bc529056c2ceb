"""Posterior-weighted chi^2-ratio training loss and validation metric
(PyTorch).

Counterpart of ``linna_tpu/losses.py``.  Every chi^2 term lives in the
emulator's standardized output space, with the covariance mapped through the
1/sigma data scaling and the median/MAD output standardization; entries
carrying sentinel values (1e-30 failed theory, 1e10 clipped, and 1e-30 in
the standardized data vector) are masked out of the residuals; the
denominator chi^2(target, data) is floored at 0.5*ndata.

    loss = mean_i [ chi^2(NN_i, target_i) / max(chi^2(target_i, data), ndata/2) ]

All functions are batched over leading axes, so K stacked ensemble members
(predictions of shape (K, B, N)) get one loss and one metric row each.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .transforms import TransformSet

__all__ = [
    "LossState",
    "build_loss_state",
    "chi2_terms",
    "loss_fn",
    "val_metric_fn",
    "median",
    "SENTINEL_LOW",
    "SENTINEL_HIGH",
]

SENTINEL_LOW = 1e-30
SENTINEL_HIGH = 1e10


class LossState(NamedTuple):
    """Precomputed tensors for the chi^2-ratio loss (standardized space)."""

    inv_transformed_cov: torch.Tensor  # f32[N, N]
    data_std: torch.Tensor  # f32[N]
    ndata: int

    def to(self, device) -> "LossState":
        return LossState(self.inv_transformed_cov.to(device), self.data_std.to(device), self.ndata)


def build_loss_state(data: np.ndarray, cov: np.ndarray, transforms: TransformSet) -> LossState:
    """Map the covariance into standardized space and invert it there, in
    float64 on the host; standardize the data vector (NaN -> 1e-30).  The
    state lives on the transforms' device."""
    device = transforms.y_data.sigma.device
    cov_scaled = transforms.y_data.transform_cov(np.asarray(cov, dtype=np.float64))
    cov_std = transforms.y_transform.transform_cov(cov_scaled, data=data)
    inv_cov_std = np.linalg.inv(cov_std)
    data_t = torch.as_tensor(np.asarray(data, dtype=np.float32), device=device)
    data_std = transforms.y_transform.inverse(transforms.y_data(data_t)).cpu().numpy()
    data_std = np.nan_to_num(data_std, nan=SENTINEL_LOW)
    return LossState(
        torch.as_tensor(inv_cov_std, dtype=torch.float32, device=device),
        torch.as_tensor(data_std, dtype=torch.float32, device=device),
        int(np.asarray(data).shape[-1]),
    )


def target_terms(state: LossState, transforms: TransformSet, y_target_raw: torch.Tensor):
    """What the loss needs of the targets alone, row by row: the targets in
    standardized space, the sentinel mask and the floored chi^2(target,
    data).  The trainers compute it once per training call."""
    y_target_std = transforms.y_transform.inverse(transforms.y_data(y_target_raw))
    mask = (
        (y_target_raw == SENTINEL_LOW)
        | (y_target_raw == SENTINEL_HIGH)
        | (state.data_std == SENTINEL_LOW)
    )
    chisq_m_d = _masked_chi2(y_target_std - state.data_std, mask, state.inv_transformed_cov)
    return y_target_std, mask, torch.clamp(chisq_m_d, min=0.5 * state.ndata)


def _masked_chi2(delta: torch.Tensor, mask: torch.Tensor, inv_cov: torch.Tensor) -> torch.Tensor:
    d = torch.where(mask, torch.zeros_like(delta), delta)
    return torch.sum((d @ inv_cov) * d, dim=-1)


def chi2_ratio(state: LossState, y_pred_std, y_target_std, mask, chisq_m_d):
    """Per-row loss from precomputed target terms: chi^2(NN, target) over
    the floored chi^2(target, data)."""
    chisq_m_nn = _masked_chi2(y_target_std - y_pred_std, mask, state.inv_transformed_cov)
    return chisq_m_nn / chisq_m_d


def chi2_terms(
    state: LossState,
    transforms: TransformSet,
    y_pred_std: torch.Tensor,
    y_target_raw: torch.Tensor,
):
    """Per-row (loss, chi2_target_data, chi2_nn_data); ``y_pred_std`` is the
    network output (standardized), ``y_target_raw`` the theory targets in
    raw data units."""
    y_target_std, mask, chisq_m_d = target_terms(state, transforms, y_target_raw)
    chisq_nn_d = _masked_chi2(y_pred_std - state.data_std, mask, state.inv_transformed_cov)
    loss = chi2_ratio(state, y_pred_std, y_target_std, mask, chisq_m_d)
    return loss, chisq_m_d, chisq_nn_d


def loss_fn(state: LossState, transforms: TransformSet, y_pred_std, y_target_raw) -> torch.Tensor:
    """Training loss: the mean over the row axis."""
    loss, _, _ = chi2_terms(state, transforms, y_pred_std, y_target_raw)
    return torch.mean(loss, dim=-1)


def median(v: torch.Tensor) -> torch.Tensor:
    """Median over the last axis with the two middle values averaged for an
    even count (``torch.median`` returns the lower one), NaN when any value
    is NaN, as ``numpy.median`` and the JAX package's ``jnp.median``."""
    s = torch.sort(v, dim=-1).values
    n = v.shape[-1]
    mid = 0.5 * (s[..., (n - 1) // 2] + s[..., n // 2])
    return torch.where(torch.isnan(v).any(dim=-1), torch.full_like(mid, torch.nan), mid)


def val_metric_from_terms(loss, chisq_m_d, chisq_nn_d) -> torch.Tensor:
    """[median(loss), max|chi2_nn,d/chi2_M,d - 1|, median(|.|)] over the row
    axis."""
    fracerr = torch.abs(chisq_nn_d / chisq_m_d - 1.0)
    return torch.stack([median(loss), torch.amax(fracerr, dim=-1), median(fracerr)], dim=-1)


def val_metric_fn(state: LossState, transforms: TransformSet, y_pred_std, y_target_raw) -> torch.Tensor:
    """The validation metric row of :func:`val_metric_from_terms`."""
    return val_metric_from_terms(*chi2_terms(state, transforms, y_pred_std, y_target_raw))
