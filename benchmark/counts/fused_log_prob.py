"""Operations and bytes of one ``fused_log_prob`` launch: whitened rows ->
prior transform -> standardize -> the emulator -> chi^2 -> log-posterior,
one float32 a row.  Each input is counted once (weights, the rows, the
inverse covariance, six length-ndim and four length-ndata vectors) and each
output once, whatever the kernel reads again."""

from __future__ import annotations


def operations(n_weights: int, ndata: int, rows: int) -> float:
    return float(rows) * (2.0 * n_weights + 2.0 * ndata * ndata)


def bytes_moved(n_weights: int, ndim: int, ndata: int, rows: int) -> float:
    return 4.0 * (n_weights + rows * ndim + ndata * ndata + 6 * ndim + 4 * ndata + rows)
