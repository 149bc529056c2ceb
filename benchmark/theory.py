"""The flagship's stand-in theory and the rows an iteration-3 training call
sees, made from ``--seed``.  Nothing here imports the program.

:class:`SurveyTheory` is a frozen copy of ``SyntheticSurveyTheory``
(``examples/des_theory.py``; ``examples/lsst_theory.py`` instantiates it at
the LSST width): the smooth nonlinear map from parameters to data vector
that ``examples/des_synthetic.yaml`` trains its emulators on, with the
same draw order, so the configuration's ``theory.seed`` (2026 for DES,
2027 for LSST) gives its templates and couplings exactly.  The data vector
and covariance follow ``examples/make_des_inputs.py``: the noiseless theory
at the truth (0.05 in every coordinate), and the banded covariance of
``noise_sigma`` / ``cov_triplet_rows``.

:func:`iteration_rows` draws the stack an iteration-3 training call holds:
the first iteration's rows over the prior box (a centred Latin hypercube,
as ``sample_gen.NNSampler.gensample_flat``), then one block from each
earlier iteration's chain.  A chain at temperature T^2 is taken as the
Gaussian (Laplace) approximation of the theory's tempered posterior at the
truth, covariance T^2 F^-1 from the Fisher matrix F, cut to the prior box
as ``gensample_chain_randomsample`` cuts chain rows.
"""

from __future__ import annotations

import numpy as np


class SurveyTheory:
    """``SyntheticSurveyTheory`` of ``examples/des_theory.py``: templates
    and couplings drawn from ``seed`` in its order."""

    def __init__(self, ndim: int, ndata: int, n_templates: int, seed: int):
        self.ndim, self.ndata, self.n_templates = ndim, ndata, n_templates
        rng = np.random.default_rng(seed)
        t = np.linspace(0.0, 1.0, ndata)
        slopes = rng.uniform(-1.5, 1.5, n_templates)
        phases = rng.uniform(0, 2 * np.pi, n_templates)
        freqs = rng.uniform(1.0, 25.0, n_templates)
        raw = np.stack([(1.0 + t) ** slopes[k] * (1.0 + 0.3 * np.sin(freqs[k] * np.pi * t
                                                                      + phases[k]))
                        for k in range(n_templates)])
        q, _ = np.linalg.qr(raw.T)
        self.templates = q.T * np.sqrt(ndata)
        self.lin = rng.standard_normal((n_templates, ndim)) * 0.5
        self.quad = rng.standard_normal((n_templates, ndim)) * 0.15

    def data_vector(self, x: np.ndarray) -> np.ndarray:
        """The data vector of each row of ``x`` (..., ndim), float64."""
        x = np.asarray(x, dtype=np.float64)
        u = x @ self.lin.T
        amps = u + (x * x) @ self.quad.T + 0.2 * np.tanh(3.0 * u)
        return amps @ self.templates / np.sqrt(self.n_templates)

    def jacobian(self, x: np.ndarray) -> np.ndarray:
        """d data_vector / dx at one point (ndata, ndim)."""
        x = np.asarray(x, dtype=np.float64)
        u = self.lin @ x
        damps = (self.lin * (1.0 + 0.6 * (1.0 - np.tanh(3.0 * u) ** 2))[:, None]
                 + 2.0 * self.quad * x[None, :])
        return self.templates.T @ damps / np.sqrt(self.n_templates)

    def noise_sigma(self, data: np.ndarray) -> np.ndarray:
        return 1.0 * (np.abs(np.asarray(data)) + 0.1)

    def covariance(self, sigma: np.ndarray) -> np.ndarray:
        """Diagonal sigma^2 with 0.25 sigma_i sigma_j on the first off-diagonals
        (``cov_triplet_rows``), as a dense matrix."""
        sigma = np.asarray(sigma, dtype=np.float64)
        cov = np.diag(sigma**2)
        off = 0.25 * sigma[:-1] * sigma[1:]
        idx = np.arange(len(sigma) - 1)
        cov[idx, idx + 1] = off
        cov[idx + 1, idx] = off
        return cov


def make(cfg: dict) -> SurveyTheory:
    th = cfg["theory"]
    return SurveyTheory(cfg["ndim"], cfg["ndata"], th["n_templates"], th["seed"])


def analysis(cfg: dict) -> dict:
    """The configuration's theory, truth, data vector and covariance, and
    the Fisher matrix's inverse at the truth (float64)."""
    theory = make(cfg)
    truth = np.full(cfg["ndim"], float(cfg["theory"]["truth_offset"]))
    data = theory.data_vector(truth)
    cov = theory.covariance(theory.noise_sigma(data))
    jac = theory.jacobian(truth)
    fisher = jac.T @ np.linalg.solve(cov, jac)
    return {"theory": theory, "truth": truth, "data": data, "cov": cov,
            "posterior_cov": np.linalg.inv(fisher)}


def lhs_center(n_dim: int, n: int, rng: np.random.Generator) -> np.ndarray:
    """A centred Latin hypercube on [0, 1]^n_dim: each coordinate takes the
    midpoints of its n strata in its own random order."""
    mid = (np.arange(n) + 0.5) / n
    return np.stack([mid[rng.permutation(n)] for _ in range(n_dim)], axis=1)


def _block(source: dict, n: int, lo: np.ndarray, hi: np.ndarray, truth: np.ndarray,
           chol: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    if n == 0:
        return np.zeros((0, len(lo)))
    if source["from"] == "flat":
        return lo + lhs_center(len(lo), n, rng) * (hi - lo)
    scale = np.sqrt(float(source["temperature2"]))
    out = np.zeros((0, len(lo)))
    while len(out) < n:
        x = truth + scale * rng.standard_normal((2 * n, len(lo))) @ chol.T
        out = np.concatenate([out, x[np.all((x > lo) & (x < hi), axis=1)]])
    return out[:n]


def scaled_counts(stack: list, key: str, total: int) -> list:
    """Each block's rows under ``key``, scaled to sum to ``total`` (the
    stack's own counts where they already do)."""
    counts = np.array([b[key] for b in stack], dtype=np.int64)
    if counts.sum() == total:
        return counts.tolist()
    scaled = np.floor(counts * total / counts.sum()).astype(np.int64)
    scaled[-1] += total - scaled.sum()
    return scaled.tolist()


def iteration_rows(cfg: dict, stack: list, n_train: int, n_val: int, seed_seq) -> dict:
    """The stack's training and validation rows (float32) and their targets,
    with the data vector and covariance they are trained against (float64).
    ``seed_seq``: the seed of the numpy generator the rows draw from."""
    an = analysis(cfg)
    lo = np.full(cfg["ndim"], float(cfg["prior"]["arg1"]))
    hi = np.full(cfg["ndim"], float(cfg["prior"]["arg2"]))
    chol = np.linalg.cholesky(an["posterior_cov"])
    rng = np.random.default_rng(seed_seq)
    parts = {}
    for key, total in (("n_train", n_train), ("n_val", n_val)):
        counts = scaled_counts(stack, key, total)
        parts[key] = np.concatenate([_block(b, n, lo, hi, an["truth"], chol, rng)
                                     for b, n in zip(stack, counts)])
    f32 = lambda a: np.asarray(a, np.float32)
    tx, vx = f32(parts["n_train"]), f32(parts["n_val"])
    theory = an["theory"]
    return {"tx": tx, "ty": f32(theory.data_vector(tx)), "vx": vx,
            "vy": f32(theory.data_vector(vx)), "data": an["data"], "cov": an["cov"],
            "posterior_sd": np.sqrt(np.diag(an["posterior_cov"]))}
