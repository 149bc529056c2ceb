"""Model FLOPs of the emulator's work, counted from its weights: a product
of a row with a weight matrix is two operations a weight (biases and
activations are left out, as they are a rounding error beside them)."""

from __future__ import annotations

from .. import reference as R


def weights(ndim: int, ndata: int) -> int:
    """Parameters of one ``chto_v2`` member at ``ndim -> ndata``."""
    return R.n_weights(ndim, ndata)


def train_epoch_flops(n_weights: int, rows: int, val_rows: int, members: int) -> float:
    """One epoch of K members: forward, backward with the weight gradient
    (6 operations a weight a row) over the training rows, and the epoch
    end's forward (2) over the validation rows."""
    return float(members) * n_weights * (6.0 * rows + 2.0 * val_rows)


def likelihood_flops(n_weights: int, ndata: int, members: int, gradient: bool) -> float:
    """One walker's log-posterior through K members: each member's forward
    (2 a weight) and its chi^2 quadratic form (2 ndata^2); a gradient with
    respect to the walker's position adds a backward of the same size (the
    weights need no gradient)."""
    forward = members * (2.0 * n_weights + 2.0 * ndata * ndata)
    return 2.0 * forward if gradient else forward
