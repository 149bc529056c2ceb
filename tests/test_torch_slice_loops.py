"""The bookkeeping of zeus's loops ended on the card, on the CPU: the loops
graph itself runs on a card only (``tests/test_torch_slice_loops_card.py``),
but what the host does with its counts runs anywhere.

- ``StepGraph.replayed`` adds runs the host did not launch to the graph's
  replays and its launch ledger;
- the graphed zeus runner's ``settle`` reads the card's loop counts once and
  advances each body by the iterations since its last read, and ``record``
  reports them as ``loop_iters`` with the likelihood calls, rows and kernel
  counts they imply; the host-driven loops' ``cond_reads``, ``cond_wait_s``
  and ``turnaround_s`` stay in the record and read 0, and so do the
  benchmark's metrics that read them;
- ``WhileLoops`` refuses what its library cannot take before it builds it;
- ``chip_smoke.py`` phase 11's loop record.

The runner and its graphs are stand-ins built around the real methods: no
CUDA graph is captured here.
"""

import sys
from pathlib import Path

import pytest
import torch

from linna_tpu_torch.ops import graph_loops as GL
from linna_tpu_torch.ops import graphs as OG
from linna_tpu_torch.samplers import graphs as TG
from linna_tpu_torch.samplers import slicemove as TS

ROOT = str(Path(__file__).resolve().parent.parent)
W = 8  # walkers: a stepping-out call takes W rows, a shrink call W / 2


class _Graph:
    """A captured graph as the runner counts it: ``StepGraph``'s own
    counting on a ledger that one capture filled."""

    def __init__(self, counters, per_replay):
        self.ledger = OG.LaunchLedger(*counters)
        self.ledger.per_replay = per_replay
        self.replays = 0

    replayed = OG.StepGraph.replayed


class _Loops:
    """The loops graph's device counter of each loop's iterations."""

    def __init__(self):
        self.now = [0, 0]
        self.reads = 0

    def totals(self):
        self.reads += 1
        return list(self.now)


def _runner(launches, designs):
    """A graphed zeus runner on the CPU: the real ``_SliceChunks`` methods
    over stand-in graphs, whose loop bodies launch one tiled
    ``fused_log_prob`` each."""
    state = TS.init_slice_state(torch.Generator().manual_seed(0), torch.zeros(W, 2),
                                lambda x: -0.5 * (x * x).sum(-1))
    runner = TG._SliceChunks.__new__(TG._SliceChunks)
    TG._Chunks.__init__(runner, state, 10)
    one = [{"fused_log_prob": 1}, {"tiled": 1}]
    none = [{"fused_log_prob": 0}, {"tiled": 0}]
    runner.begin = [_Graph((launches, designs), none) for _ in range(2)]
    runner.end = [_Graph((launches, designs), none) for _ in range(2)]
    runner.out = _Graph((launches, designs), one)
    runner.inward = _Graph((launches, designs), one)
    runner.graphs = [*runner.begin, runner.out, runner.inward, *runner.end]
    runner.calls_by_graph = [(runner.out, 1, W), (runner.inward, 1, W // 2)]
    runner.loops = _Loops()
    runner.loop_iters = [0, 0]
    return runner


def test_replayed_counts_runs_and_their_launches():
    launches, designs = {"fused_log_prob": 2}, {"tiled": 2}
    graph = _Graph((launches, designs), [{"fused_log_prob": 3}, {"tiled": 3}])
    graph.replayed()
    graph.replayed(4)
    graph.replayed(0)
    assert graph.replays == 5
    assert launches == {"fused_log_prob": 2 + 5 * 3} and designs == {"tiled": 2 + 5 * 3}


def test_settle_advances_the_bodies_by_the_loops_the_card_ran():
    launches, designs = {"fused_log_prob": 0}, {"tiled": 0}
    runner = _runner(launches, designs)
    for g in (*runner.begin, *runner.end):  # two steps: each half's start and end
        g.replayed(2)
    runner.steps = 2
    runner.loops.now = [7, 12]
    rec = runner.record()
    assert runner.loops.reads == 1  # one read of the card's counter a record
    assert rec["loop_iters"] == {"out": 7, "in": 12}
    assert rec["calls"] == 19 and rec["rows"] == 7 * W + 12 * (W // 2)
    assert rec["replays"] == 8 + 19 and rec["steps"] == 2
    assert launches == {"fused_log_prob": 19} and designs == {"tiled": 19}
    # nothing new on the card: nothing counted twice
    assert runner.record() == rec
    assert launches == {"fused_log_prob": 19}
    # a later chunk: only its iterations are added
    runner.loops.now = [10, 20]
    runner.settle()
    rec = runner.record()
    assert rec["loop_iters"] == {"out": 10, "in": 20} and rec["calls"] == 30
    assert runner.out.replays == 10 and runner.inward.replays == 20
    assert launches == {"fused_log_prob": 30} and designs == {"tiled": 30}


def test_the_host_reads_of_the_old_loops_read_zero():
    rec = _runner({"fused_log_prob": 0}, {"tiled": 0}).record()
    assert {"cond_reads", "cond_wait_s", "turnaround_s", "loop_iters", "calls", "rows",
            "replays", "steps", "chunk_s", "between_chunks_s"} <= set(rec)
    assert rec["cond_reads"] == 0 and rec["cond_wait_s"] == 0.0 and rec["turnaround_s"] == 0.0


def test_the_benchmark_reads_zero_not_nothing():
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import harness as H

    runner = _runner({"fused_log_prob": 0}, {"tiled": 0})
    runner.steps = 100
    runner.loops.now = [800, 1200]
    run = {"kind": "sample", "steps": 100, "window": {"sampler": {}, "graphs": runner.record()}}
    for name in ("sampler.turnaround_ms_per_step", "sampler.cond_wait_ms_per_step",
                 "sampler.cond_reads_per_step"):
        assert H.reader(name)(run) == 0.0, name
    assert H.reader("sampler.calls_per_step")(run) == pytest.approx(20.0)


@pytest.mark.parametrize("case", ["no loops", "too many loops", "more on the CPU",
                                  "more not bool", "more not one", "max_steps 0"])
def test_while_loops_refuse_before_building(monkeypatch, case):
    """Checked before ``nvcc`` runs (the build here would fail: no card)."""
    monkeypatch.setattr(GL.LIBRARY, "get", lambda: pytest.fail("built"))
    more = _on_card(torch.zeros((), dtype=torch.bool))
    bodies, max_steps = [object()], 5
    if case == "no loops":
        bodies = []
    elif case == "too many loops":
        bodies = [object()] * (GL.MAX_LOOPS + 1)
    elif case == "more on the CPU":
        more = torch.zeros((), dtype=torch.bool)
    elif case == "more not bool":
        more = _on_card(torch.zeros(()))
    elif case == "more not one":
        more = _on_card(torch.zeros(2, dtype=torch.bool))
    else:
        max_steps = 0
    with pytest.raises(ValueError):
        GL.WhileLoops(bodies, more, max_steps)


def _on_card(t):
    """``t`` as a loops graph would see a card's tensor: only ``is_cuda``
    differs on the CPU."""

    class OnCard(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    return t.as_subclass(OnCard)


def test_chip_smoke_loop_record():
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke

    before = {"loop_iters": {"out": 10, "in": 30}, "cond_reads": 0}
    after = {"loop_iters": {"out": 90, "in": 230}, "cond_reads": 0}
    rec = chip_smoke._loop_record(before, after, 20, "zeus")
    assert rec == {"loop_iters_per_step": {"out": 4.0, "in": 10.0}, "cond_reads": 0}
    with pytest.raises(AssertionError, match="read 3 loop conditions"):
        chip_smoke._loop_record(before, {**after, "cond_reads": 3}, 20, "zeus")
