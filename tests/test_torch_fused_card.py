"""``fused_log_prob``'s CUDA kernel on the card against its plain PyTorch
version, at the DES-Y1 3x2pt and LSST-Y10 6x2pt+N widths.

Marked ``card``: each test skips without a CUDA device.  This file imports
no JAX, so that it runs on a machine with the card alone:

    python -m pytest tests/test_torch_fused_card.py --noconftest -m card
"""

import numpy as np
import pytest
import torch

from linna_tpu_torch import likelihood as LK
from linna_tpu_torch import nn as N
from linna_tpu_torch import priors as P
from linna_tpu_torch import transforms as T
from linna_tpu_torch.ops import fused as F
from linna_tpu_torch.ops import library as OL

pytestmark = pytest.mark.card

WIDTHS = {"des": (27, 457), "lsst": (40, 1560)}
ROWS = (1, 37, 128, 256, 4096)
# The kernel runs its products in 3xTF32 (each operand split in two TF32
# parts, the small-by-small term left out, f32 sums) and sums in other
# orders than the plain version's cuBLAS products; both are f32-accurate,
# and the log-posteriors (tens to thousands of nats) agree to a few 1e-6
# relative on the card.  chip_smoke.py holds them to the same bound.
RTOL = ATOL = 2e-4


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _problem(device, ndim, ndata, log10=(), ypositive=False, seed=0):
    """Random weights, transforms, mixed flat and Gaussian priors, data and a
    dense SPD inverse covariance (chip_smoke.make_problem's recipe)."""
    rng = np.random.default_rng(seed)
    spec = N.make_model_spec("chto_v2", ndim, ndata)
    params = N.init_model(spec, seed=seed, device=device)
    mask = np.zeros(ndim, bool)
    mask[list(log10)] = True
    priors = [{"param": f"p{i}", "dist": "gauss", "arg1": 0.3, "arg2": 0.1} if i % 3 == 0 else
              {"param": f"p{i}", "dist": "flat", "arg1": -1.0, "arg2": 2.0} for i in range(ndim)]
    if ypositive:
        y_mean, y_std = np.zeros(ndata), np.full(ndata, 0.05)
    else:
        y_mean, y_std = rng.normal(size=ndata) * 0.1, 1.0 + 0.3 * rng.uniform(size=ndata)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    ts = T.TransformSet(
        T.XTransform(f32(rng.normal(size=ndim) * 0.1), f32(1.0 + 0.1 * rng.uniform(size=ndim)),
                     torch.as_tensor(mask, device=device)),
        T.YTransform(f32(y_mean), f32(y_std), ypositive),
        T.YTransformData(f32(0.5 + rng.uniform(size=ndata))),
    )
    data = rng.normal(size=ndata) * 0.3
    if ypositive:
        data = np.abs(data) + 1.0
    a = rng.normal(size=(ndata, ndata)) / np.sqrt(ndata)
    inv_cov = np.eye(ndata) + 0.1 * a @ a.T
    pack = P.priors_from_list(priors, device)
    return [LK.make_log_prob(spec, params, ts, pack, data, inv_cov, temperature=16.0,
                             use_fused=fused, device=device) for fused in (True, False)]


def _close(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    assert torch.equal(torch.isneginf(got), torch.isneginf(want)), "-inf rows differ"
    fin = ~torch.isneginf(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=RTOL, atol=ATOL)


CASES = {"mixed priors": {}, "log10 lanes": {"log10": (0, 3)}, "ypositive": {"ypositive": True}}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_kernel_matches_its_plain_version(card, width, case):
    ndim, ndata = WIDTHS[width]
    kernel, plain = _problem(card, ndim, ndata, **CASES[case])
    gen = torch.Generator().manual_seed(1)
    OL.reset_counts()
    with torch.no_grad():
        for rows in ROWS:
            x = torch.randn((rows, ndim), generator=gen).to(card)
            if case == "log10 lanes":
                x[: (rows + 1) // 2, 0] = -3.0  # a physical value <= 0 on a log10 lane
            got = kernel(x)
            torch.cuda.synchronize()
            _close(got, plain(x))
            if case == "log10 lanes":
                assert torch.isneginf(got[: (rows + 1) // 2]).all()
    assert OL.launches["fused_log_prob"] == len(ROWS)


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_a_rows_value_does_not_depend_on_the_rows_beside_it(card, width):
    ndim, ndata = WIDTHS[width]
    kernel, _ = _problem(card, ndim, ndata)
    x = torch.randn((4096, ndim), generator=torch.Generator().manual_seed(2)).to(card) * 0.3
    with torch.no_grad():
        whole = kernel(x)
        for rows in (1, 16, 128, 256):
            assert torch.equal(kernel(x[:rows]), whole[:rows]), rows


# the design each width takes (fused.log_prob_design): a cluster of the
# cluster design holds 24 walkers at the DES width, 8 at the LSST width
DESIGNS = {"des": "cluster", "lsst": "tiled"}


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_launch_shape_names_the_design_and_tells_the_row_counts_apart(card, width):
    ndim, ndata = WIDTHS[width]
    spec = N.make_model_spec("chto_v2", ndim, ndata)
    dims = F.kernel_dims(spec)
    assert F.log_prob_design(F.cluster_walkers(dims)) == DESIGNS[width]
    shapes = {rows: F.launch_shape(spec, rows, "fused_log_prob") for rows in (1, 128, 256)}
    assert len({s["blocks"] for s in shapes.values()}) == 3
    for rows, s in shapes.items():
        assert s["design"] == DESIGNS[width]
        if s["design"] == "cluster":
            assert s["max_active_clusters"] >= 1 and s["split_walkers"] == F.cluster_walkers(dims)
        else:
            assert s["blocks"] <= s["capacity"] == s["sms"] * s["blocks_per_sm"]
            assert s["split"] == F.log_prob_splits(dims)
            assert s["blocks"] == F.log_prob_plan(dims, rows, s["sms"], s["blocks_per_sm"])["blocks"]


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_each_launch_counts_its_design(card, width):
    ndim, ndata = WIDTHS[width]
    kernel, _ = _problem(card, ndim, ndata)
    OL.reset_counts()
    with torch.no_grad():
        for rows in (1, 128, 256):
            kernel(torch.zeros((rows, ndim), device=card))
    assert OL.launches["fused_log_prob"] == OL.designs[DESIGNS[width]] == 3
    assert sum(OL.designs.values()) == 3


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_a_captured_launch_replays_the_eager_one(card, width):
    ndim, ndata = WIDTHS[width]
    kernel, _ = _problem(card, ndim, ndata)
    x = torch.randn((128, ndim), generator=torch.Generator().manual_seed(3)).to(card)
    with torch.no_grad():
        eager = kernel(x)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            kernel(x)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = kernel(x)
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(out, eager)
