"""A 3 -> 12 synthetic survey theory of the examples' family, with the
module-level names ``bench_full_torch.py`` and ``bench_exact_posterior_torch.py``
read from a theory module (the examples' flagship classes at a test's size)."""

from examples.des_theory import SyntheticSurveyTheory

NDIM, NDATA = 3, 12
_T = SyntheticSurveyTheory(NDIM, NDATA, 8, seed=1)
data_vector = _T.data_vector
noise_sigma = _T.noise_sigma
cov_triplet_rows = _T.cov_triplet_rows
fiducial = _T.fiducial


def make_theory(params):
    return _T
