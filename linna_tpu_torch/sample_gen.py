"""Training-point generation (a copy of the JAX package's ``sample_gen.py``): Latin hypercubes, chain-focused sampling,
physical cuts, optimizer-centred points.

Reference: linna/util.py:736-897 (``NN_samplerv1``),
linna/util.py:1167-1258 (``generate_training_point``),
linna/util.py:38-48 (``makepositivedefinite``),
linna/util.py:1260-1270 (``chisqcut_all``).

Everything here is host-side NumPy by design: these run once per outer
iteration on a handful of 10^4-point arrays, while the expensive part — the
theory-model fan-out — goes through the host pool (see
:mod:`linna_tpu_torch.pool`).  The Latin hypercube (pyDOE2 "center" criterion) and
the chain-eigenspace LHS (the external ``sample_generator`` dependency) are
reimplemented here so the framework is self-contained.
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable, Optional, Sequence

import numpy as np

from .data import sample_x_path, sample_y_path

__all__ = ["NNSampler", "generate_training_point", "make_positive_definite", "lhs_center"]


def lhs_center(n_dim: int, n_samples: int, rng: np.random.Generator) -> np.ndarray:
    """Centred Latin hypercube on [0,1]^D: one point at the centre of each of
    ``n_samples`` equal slices per dimension, independently permuted
    (pyDOE2 ``lhs(criterion="center")`` semantics used at
    linna/util.py:790-791)."""
    centers = (np.arange(n_samples) + 0.5) / n_samples
    out = np.empty((n_samples, n_dim))
    for d in range(n_dim):
        out[:, d] = rng.permutation(centers)
    return out


def make_positive_definite(matrix: np.ndarray, keep: float = 0.99) -> np.ndarray:
    """Eigen-floor a symmetric matrix to positive definite (reference
    ``makepositivedefinite``, linna/util.py:38-49): negatives zeroed, then
    every eigenvalue from the one closest to the ``keep`` cumulative-spectrum
    point onward is FLOORED at that eigenvalue — the tail is regularized, not
    truncated, so the inverse (used as a proposal covariance,
    linna/util.py:1239-1243) stays well-conditioned."""
    vals, vecs = np.linalg.eigh(matrix)
    vals, vecs = vals[::-1], vecs[:, ::-1]
    vals = np.maximum(vals, 0.0)
    cum = np.cumsum(vals)
    cum = cum / cum.max()
    ind = int(np.argmin(np.abs(cum - keep)))
    vals[ind:] = vals[ind]
    return (vecs * vals) @ vecs.T


def _apply_omegab2cut(samples: np.ndarray, omegab2cut: Optional[Sequence]) -> np.ndarray:
    """Physical window cuts: [i_omegab, i_h, lo, hi, (i2, lo2, hi2),
    (i3, lo3, hi3)] — the first pair forms an Omega_b h^2 window
    (reference linna/util.py:804-811)."""
    if omegab2cut is None:
        return np.ones(len(samples), bool)
    ombh2 = samples[:, omegab2cut[0]] * samples[:, omegab2cut[1]] ** 2
    keep = (ombh2 > omegab2cut[2]) & (ombh2 < omegab2cut[3])
    if len(omegab2cut) > 4:
        keep &= (samples[:, omegab2cut[4]] > omegab2cut[5]) & (
            samples[:, omegab2cut[4]] < omegab2cut[6]
        )
    # second extra window gated at > 7 (not the reference's > 6, which
    # IndexErrors on a 7-element one-extra-window list; identical behavior
    # for the reference's valid 4- and 10-element inputs)
    if len(omegab2cut) > 7:
        keep &= (samples[:, omegab2cut[7]] > omegab2cut[8]) & (
            samples[:, omegab2cut[7]] < omegab2cut[9]
        )
    return keep


class NNSampler:
    """Per-iteration training-point generator (reference ``NN_samplerv1``,
    linna/util.py:736-897).  ``prior_range`` is a [D, 2] array of sampling
    bounds; the fixed seed reproduces the reference's deterministic
    training-point layout (linna/util.py:748)."""

    def __init__(self, outdir: str, prior_range: np.ndarray, seed: int = 123456):
        self.outdir = outdir
        self.prior_range = np.asarray(prior_range, dtype=np.float64)
        self.seed = seed
        self.model = None

    # -- A_s-style handling: parameter index 1 sampled in log space when its
    #    upper bound is tiny (reference linna/util.py:795-803,836-840)
    def _log_param1(self) -> bool:
        return self.prior_range.shape[0] > 1 and self.prior_range[1][1] < 1e-5

    def gensample_flat(
        self,
        n_samples: int,
        omegab2cut: Optional[Sequence] = None,
        seed: Optional[int] = None,
    ) -> np.ndarray:
        """Centred LHS over the prior box, with the physical cut applied and
        the hypercube regrown until ``n_samples`` survive
        (reference linna/util.py:775-814).  ``seed`` overrides the sampler
        seed — used to decorrelate the validation draw from the training draw
        (see generate_training_point)."""
        n_samples = int(n_samples)
        rng = np.random.default_rng(self.seed if seed is None else seed)
        n_try = n_samples
        while True:
            unit = lhs_center(len(self.prior_range), n_try, rng) * 2.0 - 1.0
            samples = np.empty_like(unit)
            for ind, prior in enumerate(self.prior_range):
                lo, hi = prior
                logspace = ind == 1 and self._log_param1()
                if logspace:
                    lo, hi = np.log(lo), np.log(hi)
                half_width = (hi - lo) / 2.0
                mid = (hi + lo) / 2.0
                samples[:, ind] = unit[:, ind] * half_width + mid
                if logspace:
                    samples[:, ind] = np.exp(samples[:, ind])
            samples = samples[_apply_omegab2cut(samples, omegab2cut)]
            if len(samples) >= n_samples:
                return samples[:n_samples]
            n_try += 1000

    def gensample_chain(
        self,
        n_samples: int,
        chain: np.ndarray,
        nsigma: float,
        omegab2cut: Optional[Sequence] = None,
        seed: Optional[int] = None,
    ) -> np.ndarray:
        """LHS in the chain's covariance eigenspace scaled to ``nsigma``,
        rejecting points outside the prior box
        (reference linna/util.py:816-861 + the external
        ``sample_generator.SampleGenerator`` LH mode)."""
        n_samples = int(n_samples)
        chain = np.array(chain, dtype=np.float64)
        prior = np.array(self.prior_range)
        log1 = self._log_param1()
        if log1:
            chain[:, 1] = np.log(1e10 * chain[:, 1])
            prior[1] = np.log(1e10 * prior[1])
        mean = chain.mean(axis=0)
        cov = np.cov(chain.T)
        vals, vecs = np.linalg.eigh(cov)
        vals = np.maximum(vals, 0.0)
        rng = np.random.default_rng(self.seed if seed is None else seed)
        n_factor = 1
        while True:
            unit = lhs_center(chain.shape[1], n_factor * n_samples, rng) * 2.0 - 1.0
            # eigen-coordinates scaled to +/- nsigma standard deviations
            coords = unit * nsigma * np.sqrt(vals)
            x = mean + coords @ vecs.T
            # cut applied in chain space like the reference
            # (linna/util.py:845-853; the windowed params are never the
            #  log-mapped index 1 in practice)
            x = x[_apply_omegab2cut(x, omegab2cut)]
            inside = np.all((x > prior[:, 0]) & (x < prior[:, 1]), axis=1)
            x = x[inside]
            if log1:
                x = x.copy()
                x[:, 1] = np.exp(x[:, 1]) / 1e10
            if len(x) >= n_samples:
                return x[:n_samples]
            n_factor += 1

    def gensample_chain_randomsample(
        self,
        n_samples: int,
        chain: np.ndarray,
        nsigma: float = 0,
        omegab2cut: Optional[Sequence] = None,
        seed: Optional[int] = None,
    ) -> np.ndarray:
        """Random draw of chain rows inside the prior box and physical cuts —
        the production default, trainingoption=1
        (reference linna/util.py:864-897, linna/main.py:72)."""
        chain = np.array(chain, dtype=np.float64)
        chain = chain[_apply_omegab2cut(chain, omegab2cut)]
        inside = np.all(
            (chain > self.prior_range[:, 0]) & (chain < self.prior_range[:, 1]), axis=1
        )
        chain = chain[inside]
        rng = np.random.default_rng(self.seed if seed is None else seed)
        return chain[rng.integers(0, len(chain), int(n_samples))]

    def generate_training_data(
        self, samples, theory: Callable, pool=None, args=None
    ) -> np.ndarray:
        """Fan the theory model out over the pool; ``theory`` receives
        ``([index, x], scratch_dir)`` exactly like the reference
        (linna/util.py:750-774); the scratch dir is wiped before and after."""
        scratch = args[0] if args else self.outdir
        os.makedirs(scratch, exist_ok=True)
        _wipe(scratch)
        tasks = [((i, np.asarray(x)), scratch) for i, x in samples]
        fn = _TheoryTask(theory)
        if pool is not None:
            results = list(pool.map(fn, tasks))
        else:
            results = list(map(fn, tasks))
        _wipe(scratch)
        return np.array(results)


class _TheoryTask:
    """Picklable single-arg wrapper for pool.map."""

    def __init__(self, theory):
        self.theory = theory

    def __call__(self, task):
        (i, x), scratch = task
        return self.theory([i, x], scratch)


def _wipe(path: str) -> None:
    for f in os.listdir(path):
        fp = os.path.join(path, f)
        if os.path.isfile(fp):
            os.remove(fp)


def generate_training_point(
    theory: Callable,
    nnsampler: NNSampler,
    pool,
    outdir: str,
    ntrain: int,
    nval: int,
    data: np.ndarray,
    invcov: np.ndarray,
    chain: Optional[np.ndarray] = None,
    nsigma: float = 1,
    omegab2cut: Optional[Sequence] = None,
    options: int = 0,
    negloglike: Optional[Callable] = None,
    nbest_in: Optional[int] = None,
    chisqcut: Optional[float] = None,
) -> None:
    """Master-only, file-gated training-point driver
    (reference linna/util.py:1167-1258): every artifact is skipped when its
    file already exists, giving idempotent crash recovery."""
    if pool is not None and not pool.is_master():
        return
    os.makedirs(outdir, exist_ok=True)

    def _gen(n, salt):
        # salt=0 train, salt=1 val.  The reference re-seeds identically on
        # every call (linna/util.py:881 np.random.seed(self.seed)), which for
        # the chain-randomsample production path makes the validation set the
        # EXACT first-nval prefix of the training draw — the trainer then
        # validates on training rows and overfitting is undetectable.
        # Salting the val draw is a deliberate deviation from the reference.
        seed = nnsampler.seed + salt
        if chain is None:
            return nnsampler.gensample_flat(n, omegab2cut=omegab2cut, seed=seed)
        if options == 0:
            return nnsampler.gensample_chain(
                n, chain, nsigma, omegab2cut=omegab2cut, seed=seed
            )
        if options == 1:
            return nnsampler.gensample_chain_randomsample(
                n, chain, nsigma, omegab2cut=omegab2cut, seed=seed
            )
        raise ValueError(f"options={options} not recognized")

    for salt, (name, n) in enumerate((("train", ntrain), ("val", nval))):
        xpath = sample_x_path(outdir, name)
        if not os.path.isfile(xpath):
            np.savetxt(xpath, _gen(n, salt))

    for name in ("train", "val"):
        ypath = sample_y_path(outdir, name)
        if not os.path.isfile(ypath):
            # ndmin=2: a single-parameter (one-column) file must stay (N, 1)
            x = np.loadtxt(sample_x_path(outdir, name), ndmin=2)
            scratch = os.path.join(outdir, name)
            os.makedirs(scratch, exist_ok=True)
            y = nnsampler.generate_training_data(
                zip(range(len(x)), x), theory, pool=pool, args=[scratch]
            )
            np.save(ypath, y)

    if negloglike is not None:
        _generate_best_points(
            theory, nnsampler, pool, outdir, ntrain, nval, negloglike, nbest_in
        )

    if chisqcut is not None:
        names = ["train", "val"] + (["best", "best_val"] if negloglike is not None else [])
        for name in names:
            _chisqcut_files(
                data,
                invcov,
                chisqcut,
                sample_y_path(outdir, name),
                sample_x_path(outdir, name),
            )


def _generate_best_points(
    theory, nnsampler, pool, outdir, ntrain, nval, negloglike, nbest_in
) -> None:
    """Optimizer-centred extra training points: Nelder-Mead MAP, PSD-clipped
    Hessian, multivariate-normal draws (reference linna/util.py:1234-1252)."""
    from scipy.optimize import minimize
    from scipy.stats import multivariate_normal

    bx_path = sample_x_path(outdir, "best")
    if not os.path.isfile(bx_path):
        train_x = np.loadtxt(sample_x_path(outdir, "train"), ndmin=2)
        best = minimize(negloglike, train_x[0], method="Nelder-Mead", tol=1e-6).x
        hess = _numerical_hessian(negloglike, best)
        inv_hess = np.linalg.inv(make_positive_definite(hess))
        bestx = multivariate_normal.rvs(mean=best, cov=inv_hess, size=int(nbest_in))
        np.savetxt(bx_path, np.atleast_2d(bestx))
        n_val = max(int(nbest_in / ntrain * nval), 1)
        bestx_val = multivariate_normal.rvs(mean=best, cov=inv_hess, size=n_val)
        np.savetxt(sample_x_path(outdir, "best_val"), np.atleast_2d(bestx_val))
    for name in ("best", "best_val"):
        ypath = sample_y_path(outdir, name)
        if not os.path.isfile(ypath):
            x = np.loadtxt(sample_x_path(outdir, name), ndmin=2)
            with tempfile.TemporaryDirectory() as tmp:
                y = nnsampler.generate_training_data(
                    zip(range(len(x)), x), theory, pool=pool, args=[tmp]
                )
            np.save(ypath, y)


def _numerical_hessian(f: Callable, x: np.ndarray, eps: float = 1e-4) -> np.ndarray:
    """Central-difference Hessian (replaces the reference's numdifftools
    dependency, linna/util.py:1239)."""
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    h = eps * np.maximum(np.abs(x), 1.0)
    hess = np.empty((n, n))
    for i in range(n):
        for j in range(i, n):
            ei = np.zeros(n)
            ej = np.zeros(n)
            ei[i] = h[i]
            ej[j] = h[j]
            fpp = f(x + ei + ej)
            fpm = f(x + ei - ej)
            fmp = f(x - ei + ej)
            fmm = f(x - ei - ej)
            hess[i, j] = hess[j, i] = (fpp - fpm - fmp + fmm) / (4 * h[i] * h[j])
    return hess


def _chisqcut_files(data, invcov, chisqcut, fnamey, fnamex) -> None:
    """Drop rows with y^T C^-1 y above the cut (reference
    linna/util.py:1260-1270 — note the cut is on the raw prediction norm,
    not the residual).  ``ndmin=2`` keeps single-row best-point files 2-D
    (np.loadtxt squeezes them to 1-D otherwise, crashing the boolean index),
    and both cuts are computed before either file is replaced so a crash
    here cannot leave misaligned (x, y) artifacts for the resume."""
    y = np.atleast_2d(np.load(fnamey))
    x = np.loadtxt(fnamex, ndmin=2)
    chisq = np.einsum("ij,jk,ik->i", y, invcov, y)
    keep = chisq < chisqcut
    y_keep, x_keep = y[keep], x[keep]
    np.save(fnamey + ".tmp.npy", y_keep)
    np.savetxt(fnamex + ".tmp", x_keep)
    os.replace(fnamey + ".tmp.npy", fnamey)
    os.replace(fnamex + ".tmp", fnamex)
