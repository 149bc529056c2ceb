"""The port's warm-up thread (``parallel/precompile``) and the kernel
libraries it warms (``ops/library``): the gate (JAX's conditions,
``LINNA_PRECOMPILE=0``), where ``ml_sampler_core`` starts it and with what,
each library's build lock, its hold while a thread warms it and its check
of the constants it shares with its module, and a broken compiler, which
the thread keeps to itself and the foreground's build raises again (there
is no fallback to the plain version).  The CPU has no ``nvcc``: a stand-in
compiler script (it fails, as a broken toolchain does) takes its place, or
a stand-in for the loaded library."""

import os
import stat
import sys
import threading
import time

import numpy as np
import pytest
import torch

from linna_tpu_torch import ops as TOPS
from linna_tpu_torch import orchestrator as TO
from linna_tpu_torch.ops import fused as TF
from linna_tpu_torch.ops import library as TL
from linna_tpu_torch.parallel import precompile as PC

NAMES = [lib.name for lib in TOPS.LIBRARIES]


def _library(name):
    return next(lib for lib in TOPS.LIBRARIES if lib.name == name)

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
    monkeypatch.setattr(TL, "_nvcc", lambda: str(script))
    monkeypatch.setenv("LINNA_COMPILE_CACHE", str(tmp_path / "build"))
    for lib in TOPS.LIBRARIES:
        monkeypatch.setattr(lib, "lib", None)
        monkeypatch.setattr(lib, "stats", {"nvcc_s": 0.0, "foreground_wait_s": 0.0})
    return log


class _Loaded:
    """A loaded library's stand-in: each function returns ``value``."""

    def __init__(self, path, value):
        self._name = str(path)
        self.value = value

    def __getattr__(self, name):
        def fn(*args):
            return self.value
        setattr(self, name, fn)
        return fn


@pytest.fixture
def loaded(tmp_path, monkeypatch):
    """Builds that load a stand-in whose ABI function returns what its
    module expects plus ``loaded["off"]``; no library loaded before."""
    setting = {"off": 0}

    def compile_library(source, stats):
        lib = next(lib for lib in TOPS.LIBRARIES if lib.source == source)
        return _Loaded(tmp_path / f"lib{source.stem}_0.so", lib.abi[1] + setting["off"]), "log"

    monkeypatch.setattr(TL, "compile_library", compile_library)
    for lib in TOPS.LIBRARIES:
        monkeypatch.setattr(lib, "lib", None)
        monkeypatch.setattr(lib, "stats", {"nvcc_s": 0.0, "foreground_wait_s": 0.0})
    return setting


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
    assert PC.compile_cache_dir() == str(TL.BUILD_DIR) and PC.compile_cache_enabled()
    monkeypatch.setenv("LINNA_COMPILE_CACHE", str(tmp_path))
    assert PC.compile_cache_dir() == str(tmp_path) == str(TL.build_dir())
    monkeypatch.setenv("LINNA_COMPILE_CACHE", "0")
    assert PC.compile_cache_dir() is None and not PC.compile_cache_enabled()
    private = TL.build_dir()
    assert private != TL.BUILD_DIR and private == TL.build_dir()


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
    assert t is not None and t.name == PC.THREAD_NAME
    t.join(30)
    assert isinstance(PC.last_error, RuntimeError) and "nvcc failed (3)" in str(PC.last_error)
    assert "broken toolchain" in str(PC.last_error)
    assert TF.LIBRARY.stats["foreground_wait_s"] == 0.0 and TF.LIBRARY.lib is None
    # the foreground's first launch builds again and raises the same error
    with pytest.raises(RuntimeError, match=r"nvcc failed \(3\)"):
        TF.build()
    assert TF.LIBRARY.stats["foreground_wait_s"] > 0.0
    assert broken_nvcc.read_text().count("start") == 2


@pytest.mark.parametrize("name", NAMES)
def test_a_failed_build_raises_and_the_next_call_tries_again(broken_nvcc, name):
    lib = _library(name)
    for _ in range(2):
        with pytest.raises(RuntimeError, match=rf"nvcc failed \(3\) building {lib.source.name}"):
            lib.get()
    assert lib.lib is None and broken_nvcc.read_text().count("start") == 2
    assert lib.stats["nvcc_s"] > 0.0 and lib.stats["foreground_wait_s"] > 0.0


@pytest.mark.parametrize("name", NAMES)
def test_builds_never_overlap(broken_nvcc, name):
    """Four threads build at once: the lock runs the compiler once at a time."""
    lib = _library(name)
    errors = []

    def build():
        try:
            lib.get()
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


def test_one_library_warming_never_blocks_another(broken_nvcc):
    """A thread warming one library leaves the others' builds free."""
    first, *others = TOPS.LIBRARIES
    errors = []

    def build(lib):
        try:
            lib.get()
        except RuntimeError as e:
            errors.append(e)

    with first.warming():
        for lib in others:
            th = threading.Thread(target=build, args=(lib,))
            th.start()
            th.join(30)
            assert not th.is_alive()
    assert len(errors) == len(others) == broken_nvcc.read_text().count("start")


def test_warming_makes_other_threads_wait(tmp_path):
    """While a thread warms a library, the other threads' getters wait for
    it and each counts its wait; the warming thread's own calls count
    nothing.  More threads than cores, with a short switch interval."""
    lib = TL.KernelLibrary(tmp_path / "stand_in.cu", {}, error="stand_in_error_string",
                           abi=("stand_in_version", 1))
    lib.lib = object()  # built and loaded
    n, hold = 2 * (os.cpu_count() or 1) + 2, 0.3
    got = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with lib.warming():
            assert lib.get() is lib.lib and lib.stats["foreground_wait_s"] == 0.0
            threads = [threading.Thread(target=lambda: got.append(lib.get())) for _ in range(n)]
            for th in threads:
                th.start()
            time.sleep(hold)
            assert not got and all(th.is_alive() for th in threads)
        for th in threads:
            th.join(30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads) and got == [lib.lib] * n
    # every wait counted: none lost to another thread's update
    assert lib.stats["foreground_wait_s"] >= n * hold / 2
    waited = lib.stats["foreground_wait_s"]
    assert lib.get() is lib.lib and lib.stats["foreground_wait_s"] == waited


@pytest.mark.parametrize("name", NAMES)
def test_abi_mismatch_raises_and_names_the_library(loaded, name):
    lib = _library(name)
    loaded["off"] = 1
    abi, want = lib.abi
    with pytest.raises(RuntimeError, match=rf"lib{name}_0\.so: {abi}\(\) is {want + 1}, "
                                           rf"this module's {want}"):
        lib.get()
    assert lib.lib is None
    loaded["off"] = 0
    assert lib.build() == "log" and lib.lib is not None
    for fn, (argtypes, restype) in lib.functions.items():
        assert getattr(lib.lib, fn).argtypes == list(argtypes)
        assert getattr(lib.lib, fn).restype is restype


@pytest.mark.parametrize("use_kernel", [True, False])
def test_warm_up_builds_every_library(loaded, use_kernel):
    """The warm-up builds every registered library (the likelihood's only
    when the run takes the kernel), reports each one's seconds by name,
    and its own builds count no foreground wait."""
    report = PC._warm("chto_v2", 3, 4, 8, 16, use_kernel, torch.device("cpu"))
    built = [lib.name for lib in TOPS.LIBRARIES if use_kernel or lib is not TF.LIBRARY]
    assert list(report["build_s"]) == built
    assert report["launches"] == {"fused_apply": 0, "fused_log_prob": 0, "adamw": 0,
                                  "composition_grad": 0}
    for lib in TOPS.LIBRARIES:
        assert (lib.lib is not None) == (lib.name in built)
        assert lib.stats["foreground_wait_s"] == 0.0
