"""zeus's slice loops ended on the card (``ops/graph_loops.py``,
``ops/csrc/graph_loops.cu``): CUDA while nodes in the graphed zeus chunk
against the eager ``slice_chunk``, whose host reads each loop's condition.

Marked ``card``: each test skips without a CUDA device.  This file imports
no JAX, so that it runs on a machine with the card alone:

    python -m pytest tests/test_torch_slice_loops_card.py --noconftest -m card

(from the repository's root, which holds ``chip_smoke.py``).

The card runs the same iterations, with the same kernels on the same
inputs and the same draws, as the eager chunk, so the two are held to each
other bit for bit: chain, log-probs, state, counters and the generator's
state after the chunk; and the graphed chunk's counted likelihood calls,
loop iterations and kernel launches are the eager chunk's.
"""

import itertools

import numpy as np
import pytest
import torch

import chip_smoke as C
from linna_tpu_torch import likelihood as LK
from linna_tpu_torch import nn as N
from linna_tpu_torch.ops import graph_loops as GL
from linna_tpu_torch.ops import library as OL
from linna_tpu_torch.samplers import graphs as G
from linna_tpu_torch.samplers import slicemove as S

pytestmark = pytest.mark.card

NWALKERS = 256


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the loops run on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _fused_lsst(device):
    """One emulator at the LSST-Y10 6x2pt+N width through ``fused_log_prob``
    (its tiled design: a cooperative launch in the loop bodies)."""
    return C.fused_problem(device, 40, 1560, NWALKERS)


def _composition_des(device):
    """Two members at the DES-Y1 3x2pt width through the K-member
    composition (cuBLAS products and device-to-device copies in the
    bodies)."""
    spec, _, ts, pack, data, inv_cov = C.make_problem(device, 27, 457)
    members = [N.init_model(spec, seed=10 + k, device=device) for k in range(2)]
    lp = LK.make_log_prob(spec, members, ts, pack, data, inv_cov, temperature=C.TEMPERATURE,
                          device=device)
    return lp, 0.1 * np.random.default_rng(4).standard_normal((NWALKERS, 27))


ROUTES = {"lsst-fused": _fused_lsst, "des-k2": _composition_des}


class _Counted:
    """The likelihood, recording the rows of each call: a stepping-out
    call holds the half-ensemble twice, a shrink call once."""

    def __init__(self, fn):
        self.fn, self.rows = fn, []

    def __call__(self, x):
        self.rows.append(x.shape[0])
        return self.fn(x)


def _chunks(device, route, nsteps, max_steps):
    """A graphed and an eager chunk from one state and generator state:
    each one's result, generator state after, kernel counters, and the
    graphed record's and the eager calls' counts."""
    lp, x0 = ROUTES[route](device)
    g = torch.Generator(device=device).manual_seed(7)
    state = S.init_slice_state(g, torch.as_tensor(x0, dtype=torch.float32, device=device), lp)
    g0 = g.get_state()
    runner = G.graphed_chunks("zeus", lp, state, nsteps, a=2.0, n_leapfrog=10, max_depth=5,
                              max_steps=max_steps)
    before = runner.record()
    OL.reset_counts()
    got = runner(state, nsteps)
    torch.cuda.synchronize()
    graphed = {"out": got, "rng": g.get_state(), "record": runner.record(),
               "launches": dict(OL.launches), "designs": dict(OL.designs)}
    graphed["record"]["before"] = before
    g.set_state(g0)
    OL.reset_counts()
    counted = _Counted(lp)
    want = S.slice_chunk(counted, state, nsteps, max_steps)
    torch.cuda.synchronize()
    eager = {"out": want, "rng": g.get_state(), "rows": counted.rows,
             "launches": dict(OL.launches), "designs": dict(OL.designs)}
    return graphed, eager


def _assert_equal(graphed, eager):
    (gs, gc, gl), (es, ec, el) = graphed["out"], eager["out"]
    for name, a, b in (("chain", gc, ec), ("log-probs", gl, el), ("coords", gs.coords, es.coords),
                       ("state log-probs", gs.log_prob, es.log_prob), ("mu", gs.mu, es.mu),
                       ("n_expand", gs.n_expand, es.n_expand),
                       ("n_contract", gs.n_contract, es.n_contract)):
        assert a.shape == b.shape and torch.equal(a, b), name
    assert torch.equal(graphed["rng"], eager["rng"]), "generator state after the chunk"


def _loop_runs(rows):
    """Each loop's iterations, in order, from the eager calls' rows: a
    half-update makes a run of stepping-out calls, then one of shrink
    calls."""
    return [(r, len(list(run))) for r, run in itertools.groupby(rows)]


@pytest.mark.parametrize("max_steps", [1, 4, 50])
def test_while_loops_run_until_the_card_says_stop(card, max_steps):
    """Two toy bodies, each counting its runs and writing ``more``: each
    loop runs until its body writes False or it has run ``max_steps``
    times, at least once a launch; ``total`` counts every iteration."""
    count = torch.zeros(2, dtype=torch.int64, device=card)
    limit = torch.zeros(2, dtype=torch.int64, device=card)
    more = torch.zeros((), dtype=torch.bool, device=card)
    bodies = []
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    for i in range(2):
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph, stream=side):
            count[i].add_(1)
            more.copy_(count[i] < limit[i])
        bodies.append(graph)
    torch.cuda.current_stream().wait_stream(side)
    loops = GL.WhileLoops(bodies, more, max_steps)
    want_total = [0, 0]
    for limits in ((3, 0), (0, 7), (100, 100), (2, 2)):
        count.zero_()
        limit.copy_(torch.tensor(limits))
        loops.launch()
        want = [min(max(lim, 1), max_steps) for lim in limits]
        assert count.tolist() == want, limits
        want_total = [t + w for t, w in zip(want_total, want)]
        assert loops.totals() == want_total


CASES = [("lsst-fused", 1, 100), ("lsst-fused", 100, 100), ("lsst-fused", 20, 2),
         ("des-k2", 1, 100), ("des-k2", 100, 100), ("des-k2", 20, 2)]


@pytest.mark.parametrize("route,nsteps,max_steps", CASES)
def test_graphed_loops_match_the_eager_chunk(card, route, nsteps, max_steps):
    graphed, eager = _chunks(card, route, nsteps, max_steps)
    _assert_equal(graphed, eager)
    rec, before = graphed["record"], graphed["record"]["before"]
    runs = _loop_runs(eager["rows"])
    assert len(runs) == 2 * 2 * nsteps  # two loops a half-update, two halves a step
    assert all(n <= max_steps for _, n in runs)
    if max_steps < 100:
        assert max(n for _, n in runs) == max_steps  # loops ended at the cap
    out_iters = sum(n for r, n in runs if r == NWALKERS)
    in_iters = sum(n for r, n in runs if r == NWALKERS // 2)
    assert out_iters + in_iters == len(eager["rows"])
    assert rec["loop_iters"]["out"] - before["loop_iters"]["out"] == out_iters
    assert rec["loop_iters"]["in"] - before["loop_iters"]["in"] == in_iters
    assert rec["calls"] - before["calls"] == len(eager["rows"])
    assert rec["rows"] - before["rows"] == sum(eager["rows"])
    assert rec["cond_reads"] == 0 and rec["cond_wait_s"] == 0.0 and rec["turnaround_s"] == 0.0
    assert graphed["launches"] == eager["launches"]
    assert graphed["designs"] == eager["designs"]
    if route == "lsst-fused":
        assert eager["launches"]["fused_log_prob"] == len(eager["rows"])
        assert eager["designs"] == {"tiled": len(eager["rows"]), "cluster": 0}
    else:
        assert eager["launches"]["fused_log_prob"] == 0


def test_a_chunk_is_enqueued_without_a_host_wait(card):
    """Once captured, a 100-step chunk runs no operation that waits for the
    card (torch's sync debug mode raises on one); a second chunk from the
    first one's end continues it as the eager chunk does."""
    lp, x0 = _fused_lsst(card)
    g = torch.Generator(device=card).manual_seed(11)
    state = S.init_slice_state(g, torch.as_tensor(x0, dtype=torch.float32, device=card), lp)
    g0 = g.get_state()
    runner = G.graphed_chunks("zeus", lp, state, 100, a=2.0, n_leapfrog=10, max_depth=5,
                              max_steps=100)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first = runner(state, 100)
        second = runner(first[0], 100)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    got_rng = g.get_state()
    g.set_state(g0)
    want = S.slice_chunk(lp, state, 100)
    want2 = S.slice_chunk(lp, want[0], 100)
    _assert_equal({"out": first, "rng": got_rng}, {"out": want, "rng": got_rng})
    _assert_equal({"out": second, "rng": got_rng}, {"out": want2, "rng": g.get_state()})
    assert runner.record()["cond_reads"] == 0
