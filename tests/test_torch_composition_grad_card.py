"""``composition_grad``'s CUDA kernel on the card against the K-member
composition, at the DES-Y1 3x2pt and LSST-Y10 6x2pt+N widths and the
walkthrough's.

Marked ``card``: each test skips without a CUDA device.  This file imports
no JAX, so that it runs on a machine with the card alone:

    python -m pytest tests/test_torch_composition_grad_card.py --noconftest -m card
"""

import numpy as np
import pytest
import torch

from linna_tpu_torch.ops import library as OL
from linna_tpu_torch.samplers import graphs as G
from linna_tpu_torch.samplers import hmc

from _torch_composition import (GRAD_RTOL, MEDIAN_GRAD_RTOL, VALUE_ATOL, VALUE_RTOL, likelihood,
                                problem, row_gaps, smooth_rows, standardized, walkers)

pytestmark = pytest.mark.card

# the walkthrough's 2 -> 2 besides: its gradient takes the kernel on a card
WIDTHS = {"des": (27, 457), "lsst": (40, 1560), "walkthrough": (2, 2)}
ROWS = (1, 37, 128, 256, 4096)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("k_std", [0.0, 1.0])
@pytest.mark.parametrize("ypositive", [False, True], ids=["linear", "ypositive"])
@pytest.mark.parametrize("members", [1, 2, 4])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_kernel_is_the_composition(card, width, members, ypositive, k_std):
    ndim, ndata = WIDTHS[width]
    lp, spec = problem(card, ndim, ndata, members, ypositive=ypositive, k_std=k_std,
                       symmetric=False)
    x_in = standardized(lp, walkers(max(ROWS), ndim, card, seed=5))
    want_lp, want_g = likelihood(spec, lp, x_in)
    smooth = smooth_rows(spec, lp, x_in)
    # enough rows away from the kinks that the check means something
    assert smooth.double().mean() > 0.1
    route = lp._route
    for rows in ROWS:
        got_lp, got_g = route.value_and_grad(x_in[:rows])
        torch.cuda.synchronize()
        torch.testing.assert_close(got_lp.double(), want_lp[:rows], rtol=VALUE_RTOL,
                                   atol=VALUE_ATOL)
        gaps = row_gaps(got_g, want_g[:rows])
        assert float(gaps.median()) < MEDIAN_GRAD_RTOL, rows
        if smooth[:rows].any():
            assert float(gaps[smooth[:rows]].max()) < GRAD_RTOL, rows


@pytest.mark.parametrize("width", list(WIDTHS))
def test_a_row_is_the_same_alone_and_in_a_batch(card, width):
    ndim, ndata = WIDTHS[width]
    lp, spec = problem(card, ndim, ndata, 2)
    x_in = standardized(lp, walkers(256, ndim, card, seed=6))
    route = lp._route
    alone = route.value_and_grad(x_in[:16])
    for rows in (1, 37, 128, 256):
        got = route.value_and_grad(x_in[:rows])
        n = min(rows, 16)
        assert torch.equal(got[0][:n], alone[0][:n]) and torch.equal(got[1][:n], alone[1][:n])


def test_gradient_calls_count_launches(card):
    lp, _ = problem(card, *WIDTHS["des"], 2)
    x = walkers(64, WIDTHS["des"][0], card)
    OL.reset_counts()
    hmc.value_and_grad(lp, x)
    with torch.no_grad():
        lp(x)
    assert OL.launches["composition_grad"] == 1 and OL.plain_calls["composition_grad"] == 0
    OL.reset_counts()


@pytest.mark.parametrize("members", [1, 2])
def test_graphed_nuts_chunk_is_the_eager_chunk(card, members):
    ndim, ndata = WIDTHS["des"]
    lp, _ = problem(card, ndim, ndata, members, temperature=1.0)
    x0 = walkers(256, ndim, card, seed=8, scale=0.05)
    depth, n = 3, 4
    state = hmc.init_nuts_state(torch.Generator(device=card).manual_seed(7), x0, lp)
    g0 = state.rng.get_state()
    runner = G.graphed_chunks("nuts", lp, state, n, a=2.0, n_leapfrog=10, max_depth=depth,
                              max_steps=100)
    state.rng.set_state(g0)
    OL.reset_counts()
    graphed = runner(state, n)
    torch.cuda.synchronize()
    replayed = OL.launches["composition_grad"]
    g_after = state.rng.get_state()
    state.rng.set_state(g0)
    OL.reset_counts()
    eager = hmc.nuts_chunk(lp, state, n, depth)
    torch.cuda.synchronize()
    assert torch.equal(state.rng.get_state(), g_after)
    (gs, gc, gl), (es, ec, el) = graphed, eager
    for a, b in ((gc, ec), (gl, el), (gs.coords, es.coords), (gs.log_prob, es.log_prob),
                 (gs.grad, es.grad)):
        assert torch.equal(a, b)
    assert replayed == OL.launches["composition_grad"] == n * (2 ** depth - 1)
    assert OL.plain_calls["composition_grad"] == 0
    OL.reset_counts()
    assert np.isfinite(gl.cpu().numpy()).all()
