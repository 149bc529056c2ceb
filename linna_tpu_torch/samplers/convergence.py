"""Chain convergence diagnostics (a copy of ``linna_tpu/samplers/convergence.py``,
which imports nothing of JAX; the port keeps its own copy).

Host-side NumPy implementations (the chain chunks live on host for HDF5
persistence anyway, and these run once per ~100 device steps):

- integrated autocorrelation time via the FFT method with Sokal's automated
  windowing (the "dfm" estimator both emcee's ``get_autocorr_time`` and the
  reference's zeus configuration use — reference linna/sampler.py:538,
  linna/sampler.py:729 ``method='dfm'``);
- the split-half mean/std stationarity test
  (reference linna/sampler.py:370-387 ``checkmeanstd``).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "autocorr_function_1d",
    "integrated_time",
    "check_mean_std",
    "gelman_rubin",
]


def _next_pow_two(n: int) -> int:
    i = 1
    while i < n:
        i <<= 1
    return i


def autocorr_function_1d(x: np.ndarray) -> np.ndarray:
    """Normalized autocorrelation of a 1-D series via FFT."""
    x = np.atleast_1d(np.asarray(x, dtype=np.float64))
    n = _next_pow_two(len(x))
    f = np.fft.fft(x - np.mean(x), n=2 * n)
    acf = np.fft.ifft(f * np.conjugate(f))[: len(x)].real
    if acf[0] == 0:
        return np.ones_like(acf)
    return acf / acf[0]


def _auto_window(taus: np.ndarray, c: float) -> int:
    """Sokal (1989) automated windowing: smallest M with M >= c * tau(M)."""
    m = np.arange(len(taus)) < c * taus
    if np.any(m):
        return int(np.argmin(m))
    return len(taus) - 1


def integrated_time(
    chain: np.ndarray, c: float = 5.0, max_walkers: int | None = None
) -> np.ndarray:
    """Per-parameter integrated autocorrelation time tau[D].

    ``chain`` has shape (nsteps, nwalkers, ndim); the autocorrelation is
    averaged over walkers before integration (dfm estimator). No reliability
    gate — equivalent to emcee's ``get_autocorr_time(tol=0)`` as the
    reference uses it (linna/sampler.py:538).

    The per-walker autocorrelations are computed as one batched real FFT per
    parameter (this runs on the host between every device chunk — the
    per-series loop was the sampling loop's hidden host bottleneck at
    production window sizes: 27 params x 128 walkers = 3456 separate FFTs
    per convergence check).

    ``max_walkers``: when set and ``nwalkers`` exceeds it, the walker-mean
    autocorrelation is taken over a deterministic stride subset of
    ``<= max_walkers`` walkers.  Each walker's ACF is an independent,
    identically-distributed estimate of the same function, so subsetting
    only raises the estimator's standard error by sqrt(nwalkers/subset) —
    e.g. 64 of 256 walkers doubles it, still far below emcee's default
    regime (32 walkers total) — while cutting the per-check FFT cost
    proportionally.
    """
    chain = np.asarray(chain)
    if chain.ndim != 3:
        raise ValueError("chain must be (nsteps, nwalkers, ndim)")
    if max_walkers is not None and chain.shape[1] > max_walkers:
        chain = chain[:, :: -(-chain.shape[1] // max_walkers), :]
    nsteps, nwalkers, ndim = chain.shape
    try:  # pocketfft: multithreaded batched transforms, fast non-pow2 sizes
        from scipy import fft as sfft

        n = sfft.next_fast_len(2 * nsteps, real=True)
        rfft = lambda x: sfft.rfft(x, n=n, axis=0, workers=-1)
        irfft = lambda x: sfft.irfft(x, n=n, axis=0, workers=-1)
        # single precision is ample for a normalized ACF (rel err ~1e-5
        # on 1e5-length series) and halves both time and memory
        dtype = np.float32
    except ImportError:  # pragma: no cover
        n = 2 * _next_pow_two(nsteps)
        rfft = lambda x: np.fft.rfft(x, n=n, axis=0)
        irfft = lambda x: np.fft.irfft(x, n=n, axis=0)
        dtype = np.float64
    taus = np.empty(ndim)
    for d in range(ndim):
        x = np.asarray(chain[:, :, d], dtype=dtype)
        x = x - np.mean(x, axis=0)
        fx = rfft(x)
        acf = irfft(fx * np.conjugate(fx))[:nsteps].astype(np.float64)
        acf0 = acf[0]  # (nwalkers,)
        safe = np.where(acf0 == 0.0, 1.0, acf0)
        acf = np.where(acf0 == 0.0, 1.0, acf / safe)
        f = np.mean(acf, axis=1)
        cum = 2.0 * np.cumsum(f) - 1.0
        window = _auto_window(cum, c)
        taus[d] = cum[window]
    return taus


def check_mean_std(samples: np.ndarray, meanshift: float, stdshift: float) -> bool:
    """Split-half stationarity test (reference linna/sampler.py:370-387):
    median over parameters of |mean1 - mean2|/std2 must be below ``meanshift``
    and median of (std1 - std2)/std2 below ``stdshift``."""
    samples = np.asarray(samples, dtype=np.float64)
    half = len(samples) // 2
    first = samples[:half].reshape(-1, samples.shape[-1])
    second = samples[half:].reshape(-1, samples.shape[-1])
    if len(first) == 0 or len(second) == 0:
        return False
    std2 = np.std(second, axis=0)
    mean_shift = np.median(
        np.abs(np.mean(first, axis=0) - np.mean(second, axis=0)) / std2
    )
    std_shift = np.median((np.std(first, axis=0) - std2) / std2)
    return bool((mean_shift < meanshift) & (std_shift < stdshift))


def gelman_rubin(chain: np.ndarray, split: bool = True) -> np.ndarray:
    """Split-chain potential scale reduction R-hat per parameter
    (Gelman & Rubin 1992 with the rank-free split variant).

    Not in the reference (its criteria are tau + split-half shifts); added
    because the north-star metric is wall-clock to R-1 < 0.01
    (BASELINE.md).  ``chain`` is (nsteps, nwalkers, ndim); each walker is a
    chain, optionally split in half to detect trends.
    """
    chain = np.asarray(chain, dtype=np.float64)
    if chain.ndim != 3:
        raise ValueError("chain must be (nsteps, nwalkers, ndim)")
    if split:
        half = chain.shape[0] // 2
        chain = np.concatenate([chain[:half], chain[half : 2 * half]], axis=1)
    n, m, _ = chain.shape
    chain_means = np.mean(chain, axis=0)  # (m, d)
    grand_mean = np.mean(chain_means, axis=0)
    b = n / (m - 1) * np.sum((chain_means - grand_mean) ** 2, axis=0)
    w = np.mean(np.var(chain, axis=0, ddof=1), axis=0)
    var_hat = (n - 1) / n * w + b / n
    return np.sqrt(var_hat / w)
