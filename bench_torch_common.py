"""Shared pieces of the port's measurement scripts: ``bench_torch.py``,
``bench_fused_torch.py``, ``bench_bf16_torch.py``, ``bench_train_torch.py``,
``bench_train_profile_torch.py``, ``bench_dispatch_torch.py`` and
``bench_allopts_torch.py``, each the counterpart of the JAX script without
``_torch``.  They import ``linna_tpu_torch`` only.

- :func:`build_problem`: the synthetic flagship problem of
  ``__graft_entry__._build_problem`` (``chto_v2`` at ``ndim -> ndata``,
  identity transforms, flat priors on [-2, 2], data 0.1 x N(0, 1), an
  identity inverse covariance).  The weights and data come from seeds here,
  or from outside (the JAX package's, as numpy), so both packages can be
  held to the same numbers.
- :func:`training_set` and :func:`training_problem`: the seeded training
  rows shared by ``bench_train.py``, ``bench_dispatch.py`` and
  ``bench_train_profile.py`` (``np.random.default_rng(0)``, so both packages
  get the same rows) and their fitted transforms and loss state.
- :func:`stretch_rate`: stretch-move walker evaluations per second, chunks
  dispatched back to back with one synchronize at the end (``bench.py``'s
  method).  On a card each chunk replays the step's CUDA graph
  (``samplers/graphs.py``, the production path of ``run_ensemble``); on the
  CPU the eager chunk runs.
- :func:`card_line`, :func:`parse_argv`, :func:`result_path`: the card's
  name and power limit, the command line, and where a result goes.

Nothing is written at the repository root: a script's result goes to
``linna_<name>_torch/`` in the temporary directory (``$TMPDIR``, else
``/tmp``), or to an ``out=`` path; an ``out`` outside that directory that
exists already is refused.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

NDIM, NDATA = 27, 457  # DES-Y1-3x2pt (examples/des_synthetic.yaml)
N_TRAIN, N_VAL = 40_000, 2_000  # the DES schedule's fourth iteration
CHUNK = 100  # sampler steps a chunk (run_ensemble's check cadence)
# run_ensemble's step options; the stretch move reads ``a`` only
STEP_OPTIONS = {"a": 2.0, "n_leapfrog": 10, "max_depth": 5, "max_steps": 100}


def card_line(device) -> str:
    """The card a run used, its name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them, or
    ``cpu``."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return smi.splitlines()[device.index or 0]


def parse_argv(argv) -> tuple:
    """``--device DEV``, ``key=value`` entries and bare words of a command
    line: (device or None, {key: value}, [words])."""
    device, kv, words = None, {}, []
    args = list(argv)
    while args:
        arg = args.pop(0)
        if arg == "--device":
            device = args.pop(0)
        elif "=" in arg:
            k, _, v = arg.partition("=")
            kv[k] = v
        else:
            words.append(arg)
    return device, kv, words


def int_list(kv: dict, key: str, default) -> tuple:
    """A ``key=1,2,3`` entry of :func:`parse_argv`'s dict as ints, else
    ``default``."""
    return tuple(int(v) for v in kv[key].split(",") if v) if key in kv else default


def run_dir(name: str) -> str:
    """A script's directory in the temporary directory."""
    return os.path.join(tempfile.gettempdir(), f"linna_{name}_torch")


def result_path(directory: str, out: str | None, default: str) -> str:
    """Where a result goes: ``out`` (taken inside ``directory`` when
    relative), else ``default`` there.  An ``out`` outside ``directory``
    that exists already is refused."""
    base = os.path.abspath(directory)
    path = os.path.abspath(os.path.join(base, out or default))
    if os.path.exists(path) and os.path.commonpath([path, base]) != base:
        raise FileExistsError(f"{path} exists; the measurement scripts never overwrite a file "
                              "outside their own directory")
    return path


def write_result(path: str, result: dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=1)


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build_problem(ndim: int, ndata: int, seed: int = 0, device=None, params=None, data=None,
                  **make_log_prob_kw) -> SimpleNamespace:
    """The synthetic flagship problem at ``ndim -> ndata`` on ``device``:
    ``spec``, ``params``, ``transforms``, ``pack``, ``data``, ``inv_cov``
    and ``log_prob`` (``make_log_prob`` at temperature 1 with
    ``make_log_prob_kw``).  ``params`` (a parameter dict of arrays, e.g.
    the JAX package's) and ``data`` default to ``init_model`` from ``seed``
    and 0.1 x N(0, 1) from ``np.random.default_rng(seed)``."""
    from linna_tpu_torch import likelihood as LK
    from linna_tpu_torch import nn as N
    from linna_tpu_torch import priors as P
    from linna_tpu_torch import transforms as T
    from linna_tpu_torch.device import resolve_device

    device = resolve_device(device)
    spec = N.make_model_spec("chto_v2", ndim, ndata)
    params = (N.init_model(spec, seed=seed, device=device) if params is None
              else N.params_from_numpy(params, device))
    transforms = T.TransformSet(
        T.XTransform(torch.zeros(ndim, device=device), torch.ones(ndim, device=device),
                     torch.zeros(ndim, dtype=torch.bool, device=device)),
        T.YTransform(torch.zeros(ndata, device=device), torch.ones(ndata, device=device), False),
        T.YTransformData(torch.ones(ndata, device=device)),
    )
    priors = [{"param": f"p{i}", "dist": "flat", "arg1": -2.0, "arg2": 2.0}
              for i in range(ndim)]
    pack = P.priors_from_list(priors, device)
    if data is None:
        data = np.random.default_rng(seed).standard_normal(ndata) * 0.1
    data = np.asarray(data, np.float64)
    inv_cov = np.eye(ndata, dtype=np.float64)
    log_prob = LK.make_log_prob(spec, params, transforms, pack, data, inv_cov, temperature=1.0,
                                device=device, **make_log_prob_kw)
    return SimpleNamespace(spec=spec, params=params, transforms=transforms, pack=pack,
                           data=data, inv_cov=inv_cov, log_prob=log_prob)


def walkers(n: int, ndim: int, device, seed: int = 1) -> torch.Tensor:
    """``n`` whitened walker positions, N(0, 1) from ``np.random.default_rng(seed)``."""
    x = np.random.default_rng(seed).standard_normal((n, ndim)).astype(np.float32)
    return torch.as_tensor(x, device=device)


def training_set(ndim: int = NDIM, ndata: int = NDATA, n_train: int = N_TRAIN,
                 n_val: int = N_VAL) -> tuple:
    """The JAX training scripts' seeded linear problem: (tx, ty, vx, vy),
    float32 numpy, from ``np.random.default_rng(0)`` in their draw order
    (``bench_train.py:44-49``)."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((ndim, ndata)) / np.sqrt(ndim)
    tx = np.asarray(rng.uniform(-1, 1, (n_train, ndim)), np.float32)
    ty = np.asarray(tx @ w, np.float32)
    vx = np.asarray(rng.uniform(-1, 1, (n_val, ndim)), np.float32)
    vy = np.asarray(vx @ w, np.float32)
    return tx, ty, vx, vy


def training_problem(tx: np.ndarray, ty: np.ndarray, device) -> tuple:
    """(spec, transforms, loss state) of the training rows: x mean/std and
    y median/MAD fitted on them, unit sigma, zero data and an identity
    covariance (``bench_train.py:50-54``)."""
    from linna_tpu_torch import losses as L
    from linna_tpu_torch import nn as N
    from linna_tpu_torch import transforms as T

    ndim, ndata = tx.shape[1], ty.shape[1]
    tset = T.TransformSet(T.fit_x_transform(tx, None, device=device),
                          T.fit_y_transform(ty, ypositive=False, device=device),
                          T.YTransformData(torch.ones(ndata, device=device)))
    loss_state = L.build_loss_state(np.zeros(ndata), np.eye(ndata), tset)
    return N.make_model_spec("chto_v2", ndim, ndata), tset, loss_state


@contextlib.contextmanager
def plots_off():
    """The trainer's progress and range-test plots skipped inside, as the
    JAX training scripts skip them (their host time is the same in every
    case and would pull each ratio toward 1); put back after."""
    from linna_tpu_torch.utils import plots

    saved = plots.plot_training_progress, plots.plot_lr_range
    plots.plot_training_progress = plots.plot_lr_range = lambda *a, **k: None
    try:
        yield
    finally:
        plots.plot_training_progress, plots.plot_lr_range = saved


def stretch_rate(log_prob, nwalkers: int, ndim: int, device, chunk: int = CHUNK, reps: int = 9,
                 chunks_per_rep: int = 5, warm: int = 2) -> dict:
    """Stretch-move walker log-prob evaluations a second (``bench.py:41-79``):
    ``warm`` chunks, then ``reps`` repetitions of ``chunks_per_rep`` chunks
    dispatched back to back with one synchronize at the end.  Returns the
    best, median and IQR of the repetitions' rates, the rates, and the
    timed path."""
    from linna_tpu_torch.samplers import graphs, stretch

    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(2)
    state = stretch.init_state(g, walkers(nwalkers, ndim, device), log_prob)
    if device.type == "cuda":
        # the step captured once as a CUDA graph and replayed a step, as
        # run_ensemble samples on a card
        runner = graphs.graphed_chunks("emcee", log_prob, state, chunk, **STEP_OPTIONS)
        run, path = (lambda st: runner(st, chunk)), "cuda_graphs"
    else:
        run, path = (lambda st: stretch.stretch_chunk(log_prob, st, chunk,
                                                      STEP_OPTIONS["a"])), "eager"
    for _ in range(warm):
        state, chain, _ = run(state)
    synchronize(device)
    rates = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(chunks_per_rep):
            state, chain, _ = run(state)
        synchronize(device)
        # one stretch step evaluates log_prob for every walker once
        rates.append(nwalkers * chunk * chunks_per_rep / (time.perf_counter() - t0))
    rates = np.asarray(rates)
    q1, med, q3 = np.percentile(rates, [25, 50, 75])
    return {"best": float(rates.max()), "median": float(med), "iqr": float(q3 - q1),
            "rates": rates.tolist(), "path": path,
            "finite": bool(torch.isfinite(chain).all())}
