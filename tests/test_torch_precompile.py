"""The port's warm-up thread (``parallel/precompile``): its gate (JAX's
conditions, ``LINNA_PRECOMPILE=0``), where ``ml_sampler_core`` starts it and
with what, the build lock, and a broken compiler, which the thread keeps to
itself and the foreground's build raises again (there is no fallback to the
plain version).  The CPU has no ``nvcc``: a stand-in compiler script (it
fails, as a broken toolchain does) takes its place."""

import stat
import threading

import numpy as np
import pytest
import torch

from linna_tpu_torch import orchestrator as TO
from linna_tpu_torch.ops import fused as TF
from linna_tpu_torch.parallel import precompile as PC

torch.set_num_threads(1)


@pytest.fixture
def broken_nvcc(tmp_path, monkeypatch):
    """A compiler that logs when it starts and ends, sleeps, and fails; a
    fresh build directory; no library loaded."""
    log = tmp_path / "nvcc.log"
    script = tmp_path / "nvcc"
    script.write_text(f"#!/bin/sh\necho start $(date +%s.%N) >> {log}\nsleep 0.3\n"
                      f"echo end $(date +%s.%N) >> {log}\necho 'fatal: broken toolchain' >&2\n"
                      "exit 3\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(TF, "_nvcc", lambda: str(script))
    monkeypatch.setenv("LINNA_COMPILE_CACHE", str(tmp_path / "build"))
    monkeypatch.setattr(TF._Library, "lib", None)
    monkeypatch.setattr(TF._Library, "stats", {"nvcc_s": 0.0, "foreground_wait_s": 0.0})
    return log


def test_gate_follows_jax(monkeypatch):
    monkeypatch.delenv("LINNA_PRECOMPILE", raising=False)
    assert PC.enabled() and PC.should_warm({})
    assert PC.should_warm({"use_fused": True, "nensemble": 4})
    for params, kw in (({"train_subprocess": True}, {}), ({"linearmodel": {"norder": 2}}, {}),
                       ({}, {"ypositive": True}), ({}, {"nbest": 3}), ({}, {"chisqcut": 9.0})):
        assert not PC.should_warm(params, **kw), (params, kw)
    monkeypatch.setenv("LINNA_PRECOMPILE", "0")
    assert not PC.enabled() and not PC.should_warm({})
    # off: no thread even for a card
    assert PC.warm_pipeline("chto_v2", 3, 4, 8, 16, True, "cuda:0") is None


def test_no_thread_off_the_card(monkeypatch):
    monkeypatch.delenv("LINNA_PRECOMPILE", raising=False)
    assert PC.warm_pipeline("chto_v2", 3, 4, 8, 16, True, "cpu") is None


def test_compile_cache_dir(monkeypatch, tmp_path):
    monkeypatch.delenv("LINNA_COMPILE_CACHE", raising=False)
    assert PC.compile_cache_dir() == str(TF.BUILD_DIR) and PC.compile_cache_enabled()
    monkeypatch.setenv("LINNA_COMPILE_CACHE", str(tmp_path))
    assert PC.compile_cache_dir() == str(tmp_path) == str(TF.build_dir())
    monkeypatch.setenv("LINNA_COMPILE_CACHE", "0")
    assert PC.compile_cache_dir() is None and not PC.compile_cache_enabled()
    private = TF.build_dir()
    assert private != TF.BUILD_DIR and private == TF.build_dir()


def _run(tmp_path, **params):
    kw = {k: params.pop(k) for k in ("ypositive", "chisqcut") if k in params}
    return TO.ml_sampler_core(
        ntrainArr=[40], nvalArr=[10], nkeepArr=[1], ntimesArr=[0], ntautolArr=[np.inf],
        meanshiftArr=[np.inf], stdshiftArr=[np.inf], outdir=str(tmp_path / "run"),
        theory=lambda x, o: np.abs(np.asarray(x[1], dtype=np.float64)) + 0.5,
        priors=[{"param": f"p{i}", "dist": "flat", "arg1": -2.0, "arg2": 2.0}
                for i in range(3)],
        data=np.array([0.6, 0.7, 0.8]), cov=np.diag([0.5, 0.2, 0.3]), init=np.zeros(3),
        pool=None, nwalkers=8, device="cpu", temperatureArr=[1.0],
        params={"trainingoption": 1, "num_epochs": 2, "batch_size": 10, **params},
        method="emcee", seed=7, **kw)


@pytest.mark.parametrize("params, call", [
    ({"use_fused": True}, (True, 16)),
    ({"use_fused": True, "nensemble": 2}, (False, 16)),
    ({"use_fused": True, "batch_size": 20}, (True, 20)),
    ({}, (False, 16)),
    ({"use_fused": True, "ypositive": True}, None),
    ({"use_fused": True, "chisqcut": 1e9}, None),
])
def test_ml_sampler_core_starts_the_warm_up(tmp_path, monkeypatch, params, call):
    monkeypatch.delenv("LINNA_PRECOMPILE", raising=False)
    seen = []
    monkeypatch.setattr(PC, "warm_pipeline", lambda *a, **k: seen.append(a))
    params.setdefault("batch_size", 16)
    _run(tmp_path, **params)
    if call is None:
        assert seen == []
    else:
        (model, ndim, ndata, nwalkers, batch, use_kernel, device), = seen
        assert (model, ndim, ndata, nwalkers, str(device)) == ("chto_v2", 3, 3, 8, "cpu")
        assert (use_kernel, batch) == call


def test_broken_compiler_fails_the_foreground_after_the_thread(broken_nvcc, monkeypatch):
    monkeypatch.delenv("LINNA_PRECOMPILE", raising=False)
    # a card's run: the thread builds first (and fails before any CUDA call)
    t = PC.warm_pipeline("chto_v2", 3, 4, 8, 16, True, "cuda:0")
    assert t is not None and t.name == TF.WARM_THREAD
    t.join(30)
    assert isinstance(PC.last_error, RuntimeError) and "nvcc failed (3)" in str(PC.last_error)
    assert "broken toolchain" in str(PC.last_error)
    assert TF._Library.stats["foreground_wait_s"] == 0.0 and TF._Library.lib is None
    # the foreground's first launch builds again and raises the same error
    with pytest.raises(RuntimeError, match=r"nvcc failed \(3\)"):
        TF.build()
    assert TF._Library.stats["foreground_wait_s"] > 0.0
    assert broken_nvcc.read_text().count("start") == 2


def test_builds_never_overlap(broken_nvcc):
    """Four threads build at once: the lock runs the compiler once at a time."""
    errors = []

    def build():
        try:
            TF.build()
        except RuntimeError as e:
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(30)
    assert len(errors) == 4
    stamps = [(w, float(v)) for w, v in (line.split() for line in broken_nvcc.read_text().split("\n") if line)]
    assert [w for w, _ in stamps] == ["start", "end"] * 4
    assert all(a <= b for (_, a), (_, b) in zip(stamps, stamps[1:]))
    assert not any(p.name.endswith(".tmp") for p in (broken_nvcc.parent / "build").iterdir())
