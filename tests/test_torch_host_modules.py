"""The port's host-only modules (data, pool, sample_gen, utils) run the
cases of tests/test_data.py, test_pool.py, test_sample_gen.py,
test_reference_fixture.py and test_utils.py, and give the JAX package's
numpy outputs for the same seeds and files, bit for bit."""

import os
from collections import deque

import numpy as np
import numpy.testing as npt
import pytest
import torch

import linna_tpu.data as JD
import linna_tpu.pool as JPOOL
import linna_tpu.sample_gen as JSG
import linna_tpu_torch.data as TD
import linna_tpu_torch.pool as TPOOL
import linna_tpu_torch.sample_gen as TSG
from linna_tpu_torch import orchestrator as TO
from linna_tpu_torch.samplers import backends as TB
from linna_tpu_torch.utils import metrics, plots, runtime, trace

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "test_data", "2dgaussian_ref", "iter_0")


def _identity_theory(task, outdir):
    i, x = task
    return np.asarray(x, np.float64).copy()


def _square(x):
    return x * x


# -------------------------------------------------------------------- data


def _write_split(outdir, name, x, y):
    os.makedirs(outdir, exist_ok=True)
    np.savetxt(TD.sample_x_path(outdir, name), x)
    np.save(TD.sample_y_path(outdir, name), y)


def _write_iteration(outdir, n, ndim=2, ndata=3, seed=0, sentinels=False):
    rng = np.random.default_rng(seed)
    for name, rows in (("train", n), ("val", max(n // 4, 1))):
        x = rng.uniform(-1, 1, (rows, ndim))
        y = x @ rng.standard_normal((ndim, ndata))
        if sentinels:
            y[0, 0], y[-1, -1] = 5e10, -2e5
        _write_split(outdir, name, x, y)


def _stack_fields(stack):
    return [stack.train_x, stack.train_y, stack.val_x, stack.val_y, stack.train_y_for_stats]


def _case_usebest(tmp):
    dirs = [os.path.join(tmp, f"iter_{i}") for i in range(3)]
    for i, d in enumerate(dirs):
        _write_iteration(d, 8, seed=i)
    rng = np.random.default_rng(9)
    bx = rng.uniform(-1, 1, (4, 2))
    by = bx @ rng.standard_normal((2, 3))
    _write_split(dirs[2], "best", bx, by)
    _write_split(dirs[2], "best_val", bx[:1], by[:1])
    return lambda D: _stack_fields(D.load_iteration_stack(dirs, usebest=True))


def _case_one_parameter(tmp):
    d = os.path.join(tmp, "iter_0")
    _write_iteration(d, 6, ndim=1)
    return lambda D: _stack_fields(D.load_iteration_stack([d]))


def _case_curated(tmp, ypositive=False):
    dirs = []
    for i in range(3):
        d = os.path.join(tmp, f"iter_{i}")
        rng = np.random.default_rng(10 + i)
        for name, rows in (("train", 8 + i), ("val", 3)):
            x = rng.uniform(-1, 1, (rows, 2))
            y = x @ rng.standard_normal((2, 3))
            if ypositive:
                y = np.abs(y) + 0.1
                y[0] = 1e-30
                y[1, 2] = 1e-30
            else:
                y[0, 0], y[-1, -1] = 5e10, -2e5
            _write_split(d, name, x, y)
        dirs.append(d)

    def run(D):
        D.clear_cache()
        ref = D.curate(D.load_iteration_stack(dirs), ypositive=ypositive)
        return _stack_fields(ref) + _stack_fields(D.load_curated_stack(dirs, ypositive=ypositive))

    return run


def _case_empty_iteration(tmp):
    d0, d1 = os.path.join(tmp, "iter_0"), os.path.join(tmp, "iter_1")
    _write_iteration(d0, 6, seed=0)
    _write_split(d1, "train", np.empty((0, 2)), np.empty((0, 3)))
    _write_split(d1, "val", np.empty((0, 2)), np.empty((0, 3)))
    return lambda D: _stack_fields(D.load_curated_stack([d0, d1]))


def _case_reference_fixture(tmp):
    return lambda D: _stack_fields(D.load_iteration_stack([FIXTURE]))


DATA_CASES = {
    "usebest": _case_usebest,
    "one parameter": _case_one_parameter,
    "curated": _case_curated,
    "curated ypositive": lambda tmp: _case_curated(tmp, ypositive=True),
    "empty iteration": _case_empty_iteration,
    "reference fixture": _case_reference_fixture,
}


@pytest.mark.parametrize("case", sorted(DATA_CASES))
def test_data_loaders_match(case, tmp_path):
    run = DATA_CASES[case](str(tmp_path))
    for a, b in zip(run(TD), run(JD)):
        npt.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_data_errors_and_cache(tmp_path):
    d = str(tmp_path / "iter_0")
    _write_iteration(d, 8)
    first = TD.load_curated_stack([d])
    with pytest.raises(ValueError):
        TD._DIR_CACHE[d][1][1][0, 0] = 1.0  # cached entries are read-only
    ypath = TD.sample_y_path(d, "train")
    st = os.stat(ypath)
    np.save(ypath, np.load(ypath) + 1.0)  # same size; forge the mtime back
    os.utime(ypath, ns=(st.st_atime_ns, st.st_mtime_ns))
    npt.assert_allclose(TD.load_curated_stack([d]).train_y, first.train_y + 1.0, rtol=1e-5)
    np.save(ypath, np.load(ypath)[:-1])
    with pytest.raises(ValueError, match="misaligned"):
        TD.load_iteration_stack([d])
    TD.clear_cache()
    assert not TD._DIR_CACHE
    empty = str(tmp_path / "empty")
    _write_split(empty, "train", np.empty((0, 2)), np.empty((0, 3)))
    _write_split(empty, "val", np.empty((0, 2)), np.empty((0, 3)))
    with pytest.raises(ValueError, match="no 'train' sample rows"):
        TD.load_iteration_stack([empty])


def test_reference_fixture_chain_regression_values():
    """The reference-written chain of the fixture through the port's reader:
    the reference's own regression moments (tests/test_main.py:50-51)."""
    chain, lp, _ = TO.read_chain_and_cut(os.path.join(FIXTURE, "chemcee_256.h5"), nk=1,
                                         ntimes=2, method="emcee")
    npt.assert_almost_equal(np.mean(chain), 0.15151080063411168, decimal=5)
    npt.assert_almost_equal(np.std(chain), 0.9633211647095377, decimal=5)
    assert lp.shape[0] == chain.shape[0] // 4
    b = TB.EmceeBackend(os.path.join(FIXTURE, "chemcee_256.h5"))
    assert b.iteration == 200 and b.get_chain().shape == (200, 4, 2)


# -------------------------------------------------------------- sample_gen


def _sg_cases():
    rng = np.random.default_rng(8)
    chain = rng.normal(0, 1, size=(4000, 2))
    chain_as = np.stack([rng.normal(0.3, 0.05, 3000), np.exp(rng.normal(-20.7, 0.1, 3000))], 1)
    return {
        "lhs_center": lambda S: S.lhs_center(3, 16, np.random.default_rng(0)),
        "flat": lambda S: S.NNSampler("/unused", np.array([[-2.0, 4.0], [10.0, 20.0]])).gensample_flat(32),
        "flat log param1": lambda S: S.NNSampler(
            "/unused", np.array([[0.1, 0.9], [1e-12, 1e-8]])).gensample_flat(64),
        "flat omegab2cut": lambda S: S.NNSampler(
            "/unused", np.array([[0.01, 0.09], [0.4, 1.0], [-1.0, 1.0]])
        ).gensample_flat(50, omegab2cut=[0, 1, 0.02, 0.025]),
        "chain": lambda S: S.NNSampler("/unused", np.array([[-50.0, 50.0]] * 2)).gensample_chain(
            500, chain, 3.0),
        "chain log param1": lambda S: S.NNSampler(
            "/unused", np.array([[0.0, 1.0], [1e-10, 1e-8]])).gensample_chain(200, chain_as, 2),
        "chain randomsample": lambda S: S.NNSampler(
            "/unused", np.array([[-10.0, 10.0]] * 2)).gensample_chain_randomsample(50, chain),
        "positive definite": lambda S: S.make_positive_definite(
            np.array([[2.0, 0.3, 0.1], [0.3, -0.5, 0.0], [0.1, 0.0, 1.0]])),
        "hessian": lambda S: S._numerical_hessian(
            lambda x: float(x @ np.array([[2.0, 0.3], [0.3, 1.0]]) @ x), np.array([0.3, -0.2])),
        "omegab2cut windows": lambda S: S._apply_omegab2cut(
            np.array([[0.05, 0.7, 0.5], [0.05, 0.7, 2.0], [0.5, 0.7, 0.5]]),
            [0, 1, 0.01, 0.1, 2, 0.0, 1.0]),
    }


@pytest.mark.parametrize("case", sorted(_sg_cases()))
def test_sample_gen_matches(case):
    fn = _sg_cases()[case]
    npt.assert_array_equal(fn(TSG), fn(JSG))


@pytest.mark.parametrize("options", [None, 0, 1])
def test_generate_training_point_writes_the_same_files(options, tmp_path):
    """Flat LHS (iteration 0), chain eigenspace and chain random draw, each
    with its salted validation draw; a second call is a no-op."""
    chain = None if options is None else np.random.default_rng(8).normal(0, 1, size=(4000, 2))
    prior = np.array([[-5.0, 5.0]] * 2)
    out = {}
    for name, S in (("t", TSG), ("j", JSG)):
        d = str(tmp_path / name / "iter_1")
        S.generate_training_point(_identity_theory, S.NNSampler(d, prior), None, d, 40, 10,
                                  np.zeros(2), np.eye(2), chain=chain, options=options or 0)
        out[name] = [np.loadtxt(TD.sample_x_path(d, s)) for s in ("train", "val")] + [
            np.load(TD.sample_y_path(d, s)) for s in ("train", "val")]
        mtime = os.path.getmtime(TD.sample_y_path(d, "train"))
        S.generate_training_point(_identity_theory, S.NNSampler(d, prior), None, d, 40, 10,
                                  np.zeros(2), np.eye(2), chain=chain, options=options or 0)
        assert os.path.getmtime(TD.sample_y_path(d, "train")) == mtime
    for a, b in zip(out["t"], out["j"]):
        npt.assert_array_equal(a, b)
    train, val = out["t"][:2]
    assert not np.array_equal(train[: len(val)], val)


def test_best_points_and_chisqcut_match(tmp_path):
    center, a = np.array([0.5, -0.25]), np.array([[4.0, 0.0], [0.0, 9.0]])

    def negloglike(x):
        d = np.asarray(x) - center
        return float(d @ a @ d)

    out = {}
    for name, S in (("t", TSG), ("j", JSG)):
        d = str(tmp_path / name)
        os.makedirs(d)
        np.savetxt(TD.sample_x_path(d, "train"), np.random.default_rng(6).normal(size=(5, 2)))
        np.random.seed(3)  # scipy's multivariate_normal draws from numpy's global stream
        S._generate_best_points(_identity_theory, S.NNSampler(d, np.array([[-5.0, 5.0]] * 2)),
                                None, d, ntrain=1000, nval=200, negloglike=negloglike,
                                nbest_in=300)
        S._chisqcut_files(center, np.eye(2), 0.4, TD.sample_y_path(d, "best"),
                          TD.sample_x_path(d, "best"))
        out[name] = [np.loadtxt(TD.sample_x_path(d, s)) for s in ("best", "best_val")]
    for x, y in zip(out["t"], out["j"]):
        npt.assert_array_equal(x, y)
    assert os.path.isfile(tmp_path / "t" / "best_samples_x_val.txt")


# -------------------------------------------------------------------- pool


class _FakeStatus:
    def __init__(self):
        self._source = None

    def Get_source(self):
        return self._source


class _FakeMPI:
    ANY_SOURCE = -1
    ANY_TAG = -1
    Status = _FakeStatus


class _FakeMasterComm:
    """Runs the worker protocol inline on send and queues the replies."""

    def __init__(self, pool_cls, size=3):
        self.cls, self._size = pool_cls, size
        self._replies = deque()
        self._worker_func = {w: None for w in range(1, size)}
        self.func_transmissions = 0
        self.shutdown = set()

    def Get_rank(self):
        return 0

    def Get_size(self):
        return self._size

    def send(self, payload, dest, tag):
        if payload is None:
            self.shutdown.add(dest)
            return
        func, idx, arg = payload
        if func == self.cls._RESET:
            self._worker_func[dest] = None
            return
        if func == self.cls._REUSE:
            func = self._worker_func[dest]
        else:
            self._worker_func[dest] = func
            self.func_transmissions += 1
        self._replies.append((dest, (idx, func(arg))))

    def recv(self, source=None, tag=None, status=None):
        w, r = self._replies.popleft()
        if status is not None:
            status._source = w
        return r


@pytest.mark.parametrize("noduplicate", [False, True])
def test_mpi_pool_protocol_matches(noduplicate):
    results = {}
    for name, mod in (("t", TPOOL), ("j", JPOOL)):
        comm = _FakeMasterComm(mod.MPIPool)
        pool = mod.MPIPool(comm=comm, mpi=_FakeMPI)
        pool.noduplicate = noduplicate
        out = pool.map(_square, list(range(11)))
        pool.close()
        results[name] = (out, comm.func_transmissions, comm.shutdown)
    assert results["t"] == results["j"]
    assert results["t"][0] == [i * i for i in range(11)]
    assert results["t"][1] == (2 if noduplicate else 11)


def test_serial_and_multiprocess_pools(tmp_path):
    assert TPOOL.make_pool("serial").map(_square, [1, 2, 3]) == [1, 4, 9]
    pool = TPOOL.MultiprocessPool(processes=2)
    try:
        x = np.arange(12, dtype=np.float64).reshape(4, 3)
        y = TSG.NNSampler(str(tmp_path), np.array([[-1.0, 1.0]] * 3)).generate_training_data(
            zip(range(len(x)), x), _identity_theory, pool=pool, args=[str(tmp_path / "scratch")])
        npt.assert_array_equal(y, x)
    finally:
        pool.close()
    with pytest.raises(ValueError):
        TPOOL.make_pool("nope")


# ------------------------------------------------------------------- utils


def test_utils_trace_metrics_plots(tmp_path, monkeypatch):
    timer = trace.PhaseTimer(str(tmp_path))
    with timer.phase("a", iteration=0) as rec:
        rec["extra"] = 1
    trace.PhaseTimer(str(tmp_path))._flush()
    again = trace.PhaseTimer(str(tmp_path))
    with again.phase("a"):
        pass
    assert [r["phase"] for r in again._history] == ["a"] and "a" in again.summary()
    (tmp_path / "trace.json").write_text("{broken")
    assert trace.PhaseTimer(str(tmp_path))._history == [{"phase": "_corrupt_trace_dropped"}]
    monkeypatch.delenv("LINNA_PROFILE", raising=False)
    with trace.device_profile("x"):
        pass
    monkeypatch.setenv("LINNA_PROFILE", str(tmp_path / "prof"))
    with trace.device_profile("lbl"):
        torch.ones(3).sum()
    assert os.path.isfile(tmp_path / "prof" / "lbl.json")
    p = tmp_path / "p.json"
    p.write_text('{"lr": 0.1}')
    params = metrics.Params(str(p))
    assert params.dict["lr"] == 0.1
    ra = metrics.RunningAverage()
    ra.update(1.0)
    ra.update(3.0)
    assert ra() == 2.0
    plots.plot_lr_range([1e-4, 1e-3], [1.0, 0.5], str(tmp_path / "lr.png"))
    plots.plot_training_progress([1.0, 0.5], [np.array([1.0, 0, 0])], str(tmp_path / "t.png"))
    limit = tmp_path / "max_map_count"
    limit.write_text("65530")
    with pytest.warns(UserWarning, match="max_map_count"):
        assert runtime.check_map_count(path=str(limit), allow_write=False) == 65530
    assert runtime.check_map_count(path=str(limit), allow_write=True) == runtime.RAISE_TO
