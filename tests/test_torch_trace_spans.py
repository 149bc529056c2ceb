"""The port's phase spans and chunk device times.

- ``utils.trace.span`` adds its seconds into a phase dict under the name's
  last part, and names its body in a ``torch.profiler`` trace only while a
  profiler records on the calling thread (no ``record_function`` is made
  otherwise); ``PhaseTimer.phase`` opens ``orchestrator.<phase>``.
- The trainer's ``phase_seconds`` and ``run_ensemble``'s
  ``trace_rec["sampler"]`` keep their keys, and their spans reach a CPU
  trace; eager chunks record no device times.
- zeus's ``LateFlags`` counts its reads, times their waits and the host's
  turnaround from each read to the next launch.
- ``utils.trace.ChunkTimes`` reads a chunk's events once they have
  completed, with stand-in events (the CPU has no CUDA event).
"""

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import _torch_mh2_worker as W
from linna_tpu_torch.parallel.ensemble import EnsembleTrainer
from linna_tpu_torch.samplers import run as TR
from linna_tpu_torch.samplers import slicemove as TS
from linna_tpu_torch.utils import trace as TT

torch.set_num_threads(1)

TRAINER_KEYS = {"auto_lr", "capture", "dispatch", "wait_fetch", "supervisor", "save", "plot"}
SAMPLER_KEYS = {"precond", "init", "setup", "capture", "dispatch", "device_wait", "host",
                "tau_checks", "loop"}
DEVICE_KEYS = {"chunk_s", "between_chunks_s", "epoch_end_s"}


def _names(prof) -> set:
    return {e.name for e in prof.events()}


def test_span_adds_its_seconds_and_names_the_trace():
    ps = {"dispatch": 1.0}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with TT.span("trainer.dispatch", ps):
            time.sleep(0.01)
        with TT.span("sampler.cond_wait"):
            pass
    assert set(ps) == {"dispatch"} and ps["dispatch"] >= 1.01
    assert {"trainer.dispatch", "sampler.cond_wait"} <= _names(prof)


def test_span_makes_no_range_without_a_profiler_on_its_thread(monkeypatch):
    made = []
    real = torch.profiler.record_function

    def counted(name):
        made.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    ps = {}
    for _ in range(100):
        with TT.span("sampler.dispatch", ps):
            pass
    assert made == [] and ps["dispatch"] >= 0.0
    with profile(activities=[ProfilerActivity.CPU]):
        # a thread the profiler was not started on gets no range
        worker = threading.Thread(target=lambda: TT.span("sampler.host", ps).__enter__())
        worker.start()
        worker.join(timeout=30)
        assert not worker.is_alive()
        with TT.span("sampler.dispatch", ps):
            pass
    assert made == ["sampler.dispatch"]


def test_phase_timer_names_its_phase():
    timer = TT.PhaseTimer(None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.phase("mcmc", iteration=0) as rec:
            time.sleep(0.005)
    assert "orchestrator.mcmc" in _names(prof)
    assert rec["seconds"] >= 0.005 and timer.summary() == {"mcmc": rec["seconds"]}


def test_trainer_phases_keep_their_keys_and_reach_the_trace():
    _, spec, tset, loss_state, (tx, ty, vx, vy) = W.emulator_problem()
    tr = EnsembleTrainer(spec, tset, loss_state, [None] * 2, [7, 8], device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.train(tx, ty, vx, vy, num_epochs=12, batch_size=16, auto_lr=True,
                 epochs_per_dispatch=5)
    assert set(tr.phase_seconds) == TRAINER_KEYS
    assert all(v >= 0.0 for v in tr.phase_seconds.values())
    assert tr.phase_seconds["auto_lr"] > 0.0 and tr.phase_seconds["dispatch"] > 0.0
    assert {f"trainer.{k}" for k in TRAINER_KEYS} | {"trainer.draw_perms"} <= _names(prof)
    rec = tr.graphs["epochs"]
    # eager chunks: no device times
    assert not rec["graphed"] and not DEVICE_KEYS & set(rec)
    assert rec["epochs"] == tr.epochs_run == 12


@pytest.mark.parametrize("method", ["zeus", "nuts"])
def test_sampler_phases_keep_their_keys_and_reach_the_trace(tmp_path, method):
    rec = {}
    x0 = 0.3 * np.random.default_rng(3).standard_normal((8, 2))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        TR.run_ensemble(lambda x: -0.5 * (x * x).sum(-1), x0, str(tmp_path), method=method,
                        check_every=10, max_iterations=30, convergence_check=False, seed=4,
                        trace_rec=rec, device="cpu")
    ps = rec["sampler"]
    assert set(ps) == SAMPLER_KEYS and all(v >= 0.0 for v in ps.values())
    assert ps["dispatch"] <= ps["loop"] and rec["steps_run"] == 30
    # eager chunks: no graph record
    assert "graphs" not in rec
    want = {"sampler.init", "sampler.dispatch", "sampler.loop"}
    want |= {"sampler.precond"} if method == "nuts" else {"sampler.cond_wait"}
    assert want <= _names(prof)


def test_late_flags_count_reads_and_time_their_waits():
    flags = TS.LateFlags("cpu", 0)
    seen = []

    def body(it):
        seen.append(it)
        flags.launched()
        return torch.tensor(it < 3)

    assert TS.late_loop(body, 10, flags) == 4
    # iterations 1..4 each read the condition after the one before; the
    # first launch follows no read, so adds no turnaround
    assert seen == [0, 1, 2, 3]
    assert flags.reads == 4 and flags.seconds["cond_wait"] >= 0.0
    turned = flags.turnaround_s
    assert turned >= 0.0
    # the last read (which ended the loop) turns around at the next launch
    time.sleep(0.01)
    flags.launched()
    assert flags.turnaround_s >= turned + 0.01
    turned = flags.turnaround_s
    flags.launched()  # no read since
    assert flags.turnaround_s == turned


class _Event:
    """A stand-in CUDA event: records the next time of a test's clock (ms)
    and completes when the test says so."""

    clock = []
    done = set()

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None

    def record(self):
        self.t = _Event.clock.pop(0)

    def query(self):
        return self.t in _Event.done

    def elapsed_time(self, other):
        assert self.query() and other.query()
        return other.t - self.t


def test_chunk_times_read_completed_chunks_only(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(_Event, "clock", [0.0, 40.0, 50.0, 52.0, 100.0, 110.0, 130.0, 140.0])
    monkeypatch.setattr(_Event, "done", set())
    times = TT.ChunkTimes()
    times.start()
    times.mark()
    times.stop()
    _Event.done |= {0.0, 40.0, 50.0}
    times.start()  # reads chunk 1: start 0, mark 40, stop 50
    times.mark()
    times.stop()
    assert times.record() == {"chunk_s": pytest.approx(0.05), "between_chunks_s": 0.0}
    assert times.split_s == [pytest.approx(0.01)]
    # chunk 2 (52 .. 110) is read once its stop event has completed
    _Event.done |= {52.0, 100.0, 110.0}
    rec = times.record()
    assert rec == {"chunk_s": pytest.approx(0.05 + 0.058),
                   "between_chunks_s": pytest.approx(0.002)}
    assert times.split_s == [pytest.approx(0.01), pytest.approx(0.01)]
    # a third chunk still running when recorded is left out
    times.start()
    times.stop()
    assert times.record() == rec
