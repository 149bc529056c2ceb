"""The FLOP and byte counts against values worked by hand at both widths."""

import pytest

from benchmark.counts import emulator as E
from benchmark.counts import fused_log_prob as F
from benchmark.counts import peaks

# (ndim, ndata, weights): layer1 + rb1 + rb2 + rb3 + layer6 + layer7 + layer8
WIDTHS = {
    "des3x2pt": (27, 457, 28_000 + 524_516 + 149_282 + 55_439 + 63_000 + 228_957 + 209_306),
    "lsst6x2pt": (40, 1560, 41_000 + 524_516 + 149_282 + 55_439 + 63_000 + 781_560
                  + 2_435_160),
}


@pytest.mark.parametrize("name", sorted(WIDTHS))
def test_weights(name):
    ndim, ndata, w = WIDTHS[name]
    assert E.weights(ndim, ndata) == w == {"des3x2pt": 1_258_500, "lsst6x2pt": 4_049_957}[name]


@pytest.mark.parametrize("name, epoch", [("des3x2pt", 614_148_000_000),
                                         ("lsst6x2pt", 1_976_379_016_000)])
def test_train_epoch(name, epoch):
    # K = 2 members x weights x (6 x 40,000 training rows + 2 x 2,000 validation rows)
    _, _, w = WIDTHS[name]
    assert E.train_epoch_flops(w, 40_000, 2_000, 2) == epoch


def test_likelihood():
    _, _, w = WIDTHS["des3x2pt"]
    # K = 2: 2 x (2 x 1,258,500 + 2 x 457^2) forward, twice that with the gradient
    assert E.likelihood_flops(w, 457, 2, False) == 5_869_396
    assert E.likelihood_flops(w, 457, 2, True) == 11_738_792
    # a NUTS sample of depth 5: 31 gradient evaluations, 364 MFLOP a walker
    assert 31 * E.likelihood_flops(w, 457, 2, True) == 363_902_552
    _, _, w = WIDTHS["lsst6x2pt"]
    assert E.likelihood_flops(w, 1560, 1, False) == 12_967_114


@pytest.mark.parametrize("name, ops, nbytes, bound_ms", [
    # 128 rows: 128 x (2W + 2 ndata^2); 4 x (W + 128 ndim + ndata^2 + 6 ndim + 4 ndata + 128)
    ("des3x2pt", 375_641_344, 4 * (1_258_500 + 3_456 + 208_849 + 162 + 1_828 + 128), 0.0056066),
    ("lsst6x2pt", 1_659_790_592, 4 * (4_049_957 + 5_120 + 2_433_600 + 240 + 6_240 + 128),
     0.0247730),
])
def test_fused_log_prob(name, ops, nbytes, bound_ms):
    ndim, ndata, w = WIDTHS[name]
    assert F.operations(w, ndata, 128) == ops
    assert F.bytes_moved(w, ndim, ndata, 128) == nbytes
    bound = max(ops / peaks.F32_FLOPS, nbytes / peaks.HBM_BYTES) * 1e3
    assert bound == pytest.approx(bound_ms, rel=1e-5)  # operations bound it, at both widths
