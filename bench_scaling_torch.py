"""Scaling measurements through the PyTorch port.

    python bench_scaling_torch.py [--device DEV] [--max-ranks N]
                                  [--backend nccl|gloo] [--epochs N] [--out FILE.json]

The counterpart of ``bench_scaling.py``, at its shapes (8 parameters -> 64
data points, 2,000 / 200 seeded rows, batch 250, 40 epochs):

1. **Ensemble training**: the port's ``EnsembleTrainer`` (K members stacked
   in one batched pass) against K serial ``Trainer`` runs at K=2 and K=4,
   the same seeds, batches and epochs.  Each side trains once to warm up,
   then once timed; on a card both replay the trainer's CUDA graphs
   (``train_graphs.py``), whose capture at the start of each call is left
   out of the timed seconds (as the JAX script's timed call finds its
   program compiled).  Each side's graph replays an epoch are reported.
2. **Sampler chunk throughput**: walker-sharded ``stretch_chunk`` at 1024
   walkers, chunks of 50 steps, 3 repetitions after one warm chunk, at 1,
   2, 4 and 8 ranks, capped by the cards present under nccl (one process a
   card) and by ``--max-ranks`` otherwise (default 1).  One rank runs in
   this process and replays the step's CUDA graph on a card (the port's
   one-program chunk); more ranks are separate processes started here with
   ``LINNA_COORDINATOR_ADDRESS`` / ``LINNA_NUM_PROCESSES`` /
   ``LINNA_PROCESS_ID``, whose sharded chunks run eagerly.  ``--backend
   gloo`` puts several ranks on one card (nccl refuses two ranks on one
   device); the CPU always takes gloo.
3. **The collective censuses** of ``linna_tpu_torch.parallel.census`` on the
   largest world the run has: ``trainer_collective_census(k=4)`` under
   ``hlo`` and ``sampler_collective_census`` (every method) under
   ``sampler_hlo``, the JAX script's keys.  They count the collectives the
   port's helpers issue; the port compiles no XLA program, so there is no
   HLO to count.

Prints the card's name and power limit first and the result as one JSON
line last (``bench_scaling.py``'s keys, ``device`` for ``platform``, plus
``path``); the result goes to ``SCALING_torch.json`` in
``$TMPDIR/linna_bench_scaling_torch/`` (see ``bench_torch_common``), never
over the repository's ``SCALING.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import bench_torch_common as BC  # noqa: E402
from linna_tpu_torch.launch import run_ranks  # noqa: E402

NDIM, NDATA = 8, 64
N_TRAIN, N_VAL, BATCH = 2000, 200, 250
EPOCHS = 40
KS = (2, 4)
WALKERS, CHUNK, REPS = 1024, 50, 3
RANKS = (1, 2, 4, 8)
CENSUS_WALKERS = 256
RANK_TIMEOUT = 900
RESULT_FILE = "SCALING_torch.json"
COUNTED = ("collective calls the port's parallel.multihost helpers issue, counted by kind "
           "and group while the production code runs on the process group; not HLO "
           "instructions (the port compiles no XLA program)")


def _problem(device) -> tuple:
    """``bench_scaling._problem``: the seeded linear rows (``np.random.
    default_rng(0)``, the JAX script's draw order), the x mean/std and y
    median/MAD transforms of the sigma-scaled rows, a unit covariance, the
    loss state and the ``chto_v2`` spec; float32 numpy rows."""
    from linna_tpu_torch import losses as L
    from linna_tpu_torch import nn as N
    from linna_tpu_torch import transforms as T

    rng = np.random.default_rng(0)
    w = rng.standard_normal((NDIM, NDATA))
    tx = np.asarray(rng.uniform(-1, 1, (N_TRAIN, NDIM)), np.float32)
    ty = np.asarray(tx @ w, np.float32)
    vx = np.asarray(rng.uniform(-1, 1, (N_VAL, NDIM)), np.float32)
    vy = np.asarray(vx @ w, np.float32)
    cov = np.eye(NDATA)
    sigma = np.sqrt(np.diag(cov))
    xt = T.fit_x_transform(tx, None, device=device)
    yt = T.fit_y_transform(ty / sigma, ypositive=False, device=device)
    tset = T.TransformSet(xt, yt, T.YTransformData(
        torch.as_tensor(sigma, dtype=torch.float32, device=device)))
    loss_state = L.build_loss_state(np.zeros(NDATA), cov, tset)
    spec = N.make_model_spec("chto_v2", NDIM, NDATA)
    return spec, tset, loss_state, tx, ty, vx, vy


def _timed_train(trainers, rows, epochs: int, device) -> tuple:
    """Each trainer trains once to warm up, then all once more, timed:
    (seconds without the graphs' capture, capture seconds, graph replays
    an epoch summed over the trainers, graphed)."""
    kw = dict(batch_size=BATCH, auto_lr=False, initfrombest=False, epochs_per_dispatch=epochs)
    for tr in trainers:
        tr.train(*rows, num_epochs=epochs, **kw)  # capture + warm
    BC.synchronize(device)
    t0 = time.perf_counter()
    for tr in trainers:
        tr.train(*rows, num_epochs=epochs, **kw)
    BC.synchronize(device)
    wall = time.perf_counter() - t0
    capture = sum(tr.phase_seconds["capture"] for tr in trainers)
    recs = [tr.graphs["epochs"] for tr in trainers]
    replays = sum(r["replays"] / max(r["epochs"], 1) for r in recs)
    return wall - capture, capture, replays, all(r["graphed"] for r in recs)


def bench_trainer(k: int, tmpdir: str, device, epochs: int = EPOCHS) -> dict:
    """Steady-state seconds of ``epochs`` epochs x K members: the K-member
    ``EnsembleTrainer`` against K serial ``Trainer`` runs."""
    from linna_tpu_torch.parallel.ensemble import EnsembleTrainer
    from linna_tpu_torch.train import Trainer

    spec, tset, loss_state, *rows = _problem(device)
    seeds = [100 + i for i in range(k)]
    mesh = EnsembleTrainer(spec, tset, loss_state,
                           [os.path.join(tmpdir, f"mesh{k}_{m}") for m in range(k)], seeds,
                           device=device)
    serial = [Trainer(spec, tset, loss_state, outdir=os.path.join(tmpdir, f"ser{k}_{m}"),
                      seed=seeds[m], device=device) for m in range(k)]
    with BC.plots_off():
        mesh_s, mesh_cap, mesh_rep, mesh_graphed = _timed_train([mesh], rows, epochs, device)
        serial_s, serial_cap, serial_rep, serial_graphed = _timed_train(serial, rows, epochs,
                                                                        device)
    return {"k": k, "mesh_s": mesh_s, "serial_s": serial_s, "speedup": serial_s / mesh_s,
            "mesh_capture_s": mesh_cap, "serial_capture_s": serial_cap,
            "mesh_replays_per_epoch": mesh_rep, "serial_replays_per_epoch": serial_rep,
            "graphed": mesh_graphed and serial_graphed}


def _sampler_problem(device):
    """``bench_scaling.bench_sampler``'s likelihood: a random-weight
    ``chto_v2`` (``init_model`` from seed 0) on the problem's transforms,
    flat priors on [-2, 2], zero data and a unit inverse covariance."""
    from linna_tpu_torch import likelihood as LK
    from linna_tpu_torch import nn as N
    from linna_tpu_torch import priors as PR

    spec, tset, *_ = _problem(device)
    pack = PR.priors_from_list([{"param": f"p{i}", "dist": "flat", "arg1": -2.0, "arg2": 2.0}
                                for i in range(NDIM)], device)
    return LK.make_log_prob(spec, N.init_model(spec, seed=0, device=device), tset, pack,
                            np.zeros(NDATA), np.eye(NDATA), device=device)


def rank_counts(backend: str, max_ranks) -> list:
    """The rank counts of ``RANKS`` this run measures: under nccl at most
    one a card (and at most ``max_ranks``), otherwise at most ``max_ranks``
    (default 1)."""
    if backend == "nccl":
        cap = torch.cuda.device_count()
        cap = cap if max_ranks is None else min(cap, max_ranks)
    else:
        cap = 1 if max_ranks is None else max_ranks
    return [d for d in RANKS if d <= cap]


def _run_ranks(n: int, outdir: str, args: list, timeout: float) -> list:
    """This script as ``n`` ranks of one cluster (``--sampler-rank``); each
    rank's record from ``rank_<k>.json`` under ``outdir``."""
    run_ranks([[sys.executable, os.path.abspath(__file__), "--sampler-rank", outdir, *args]] * n,
              outdir, timeout)
    out = []
    for k in range(n):
        with open(os.path.join(outdir, f"rank_{k}.json")) as f:
            out.append(json.load(f))
    return out


def _censuses(log_prob, device) -> tuple:
    """(trainer census at K=4, sampler census) on the current process group
    (none: one rank)."""
    from linna_tpu_torch.parallel import census as CE

    hlo = {**CE.trainer_collective_census(k=4, device=device), "counted": COUNTED}
    sampler_hlo = {**CE.sampler_collective_census(log_prob_fn=log_prob, ndim=NDIM,
                                                  walkers=CENSUS_WALKERS, device=device),
                   "counted": COUNTED}
    return hlo, sampler_hlo


def _sharded_chunks(log_prob, shard, device, walkers: int, chunk: int, reps: int) -> tuple:
    """One warm chunk, then ``reps`` chunks timed with one synchronize at
    the end: (seconds, chain finite)."""
    from linna_tpu_torch.samplers import stretch

    x0 = shard.take(BC.walkers(walkers, NDIM, "cpu")).to(device)
    state = stretch.init_state(torch.Generator(device=device).manual_seed(2), x0, log_prob)
    state, chain, _ = stretch.stretch_chunk(log_prob, state, chunk, 2.0, shard=shard)
    BC.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        state, chain, _ = stretch.stretch_chunk(log_prob, state, chunk, 2.0, shard=shard)
    BC.synchronize(device)
    return time.perf_counter() - t0, bool(torch.isfinite(chain).all())


def sampler_rank(outdir: str, device_name: str, backend: str, walkers: int, chunk: int,
                 reps: int, census: bool) -> int:
    """One rank of a sampler row (``bench_scaling_torch.py --sampler-rank
    OUTDIR ...``): the sharded chunks' seconds, and the censuses when asked,
    to ``OUTDIR/rank_<k>.json``."""
    from linna_tpu_torch.parallel import multihost as MH
    from linna_tpu_torch.parallel.mesh import walker_shard

    device = torch.device(device_name)
    if device.type == "cuda" and backend == "nccl":
        device = torch.device("cuda", int(os.environ["LINNA_PROCESS_ID"]))
    MH.initialize(backend=backend, device=device)
    log_prob = _sampler_problem(device)
    seconds, finite = _sharded_chunks(log_prob, walker_shard(walkers), device, walkers, chunk,
                                      reps)
    rec = {"rank": MH.process_index(), "world": MH.process_count(), "backend": MH.backend(),
           "device": str(device), "seconds": seconds, "finite": finite}
    if census:
        rec["hlo"], rec["sampler_hlo"] = _censuses(log_prob, device)
    with open(os.path.join(outdir, f"rank_{rec['rank']}.json"), "w") as f:
        json.dump(rec, f)
    MH.barrier("bench-scaling")
    MH.shutdown()
    return 0


def bench_sampler(device, backend: str, counts, workdir: str, walkers: int = WALKERS,
                  chunk: int = CHUNK, reps: int = REPS) -> tuple:
    """Walker-sharded stretch-chunk throughput at each rank count of
    ``counts``; returns (rows, hlo, sampler_hlo), the censuses from the
    largest count."""
    evals = walkers * chunk * reps
    rows, hlo, sampler_hlo = [], None, None
    for d in counts:
        census = d == counts[-1]
        if d == 1:
            log_prob = _sampler_problem(device)
            rate = BC.stretch_rate(log_prob, walkers, NDIM, device, chunk=chunk, reps=1,
                                   chunks_per_rep=reps, warm=1)
            row = {"devices": 1, "evals_per_s": rate["best"], "graphed":
                   rate["path"] == "cuda_graphs", "backend": None, "finite": rate["finite"]}
            if census:
                hlo, sampler_hlo = _censuses(log_prob, device)
        else:
            args = ["--device", str(device), "--backend", backend, "--walkers", str(walkers),
                    "--chunk", str(chunk), "--reps", str(reps)] + (["--census"] if census else [])
            recs = _run_ranks(d, os.path.join(workdir, f"ranks{d}"), args, RANK_TIMEOUT)
            row = {"devices": d, "evals_per_s": evals / max(r["seconds"] for r in recs),
                   "graphed": False, "backend": recs[0]["backend"],
                   "finite": all(r["finite"] for r in recs)}
            if census:
                hlo, sampler_hlo = recs[0]["hlo"], recs[0]["sampler_hlo"]
        rows.append(row)
        print(f"sampler at {d} rank(s): {row['evals_per_s']:.1f} evals/s "
              f"(graphed {row['graphed']}, backend {row['backend']})", flush=True)
    return rows, hlo, sampler_hlo


NOTE = (
    "One card.  The trainer rows are real: the K-member EnsembleTrainer (K members stacked in "
    "one batched pass, one graph replay a minibatch step) against K serial Trainers on the "
    "same device, the graphs' capture left out of both.  The sampler rows above one rank share "
    "one card's memory and SMs, and under gloo every collective copies through the host; their "
    "chunks run eagerly (walker-sharded chunks are not captured), while one rank replays the "
    "step's CUDA graph, so the rank rows measure the multi-process layer's overhead on one "
    "device, not scaling over cards.  Several cards under nccl (one process a card) would "
    "measure that; they were not measured here.  The censuses count the port's collective "
    "calls on the largest world of the run: the K-member training chunk issues only the "
    "per-member gradient all-reduce within each member's data group and nothing across "
    "'ens'."
)
SAMPLER_NOTE = (
    "Walker-sharded chunk census on the run's largest world: the stretch and slice moves "
    "issue 2 all-gathers a step (the complementary half-ensemble), zeus one all-reduce of "
    "its counters a chunk, HMC and NUTS none; every gathered tensor is (walkers, ndim)-sized, "
    "so nothing scales with the data-vector width."
)


def main(device=None, max_ranks=None, backend=None, epochs: int = EPOCHS, ks=KS,
         walkers: int = WALKERS, chunk: int = CHUNK, reps: int = REPS,
         out: str | None = None) -> dict:
    from linna_tpu_torch.device import resolve_device

    device = resolve_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type != "cuda" and backend != "gloo":
        raise ValueError(f"the {backend} backend needs a CUDA device")
    out_path = BC.result_path(BC.run_dir("bench_scaling"), out, RESULT_FILE)
    card = BC.card_line(device)
    print(f"device: {card}", flush=True)
    counts = rank_counts(backend, max_ranks)
    result = {
        "device": card,
        "n_devices": counts[-1],
        "shape": {"ndim": NDIM, "ndata": NDATA, "n_train": N_TRAIN, "batch": BATCH,
                  "epochs": epochs},
        "note": NOTE,
    }
    with tempfile.TemporaryDirectory() as td:
        result["trainer"] = []
        for k in ks:
            row = bench_trainer(k, td, device, epochs)
            result["trainer"].append(row)
            print(f"trainer K={k}: mesh {row['mesh_s']:.3f} s, serial {row['serial_s']:.3f} s, "
                  f"speedup {row['speedup']:.3f}", flush=True)
        result["sampler"], result["hlo"], result["sampler_hlo"] = bench_sampler(
            device, backend, counts, td, walkers, chunk, reps)
    result["sampler_hlo_note"] = SAMPLER_NOTE
    result["path"] = {
        "trainer": ("train_graphs: one minibatch-step graph and one epoch-end graph replayed "
                    "nb + 1 times an epoch" if device.type == "cuda"
                    else "train_graphs' eager bodies (the CPU)"),
        "sampler": ("one rank: the stretch step's CUDA graph replayed a step; more ranks: "
                    f"eager walker-sharded chunks over {backend}" if device.type == "cuda"
                    else f"eager chunks; more ranks walker-sharded over {backend}"),
        "excludes": "the trainers' graph capture at the start of each timed call",
    }
    BC.write_result(out_path, result)
    print(json.dumps(result), flush=True)
    return result


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="torch device (default cuda:0)")
    p.add_argument("--max-ranks", type=int, default=None,
                   help="most sampler ranks (default: the cards under nccl, else 1)")
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                   help="torch.distributed backend (default nccl on a card, gloo on the CPU)")
    p.add_argument("--epochs", type=int, default=EPOCHS)
    p.add_argument("--out", default=None, help="result file (default SCALING_torch.json)")
    # one rank of a sampler row, started by this script
    p.add_argument("--sampler-rank", default=None, help=argparse.SUPPRESS)
    p.add_argument("--walkers", type=int, default=WALKERS, help=argparse.SUPPRESS)
    p.add_argument("--chunk", type=int, default=CHUNK, help=argparse.SUPPRESS)
    p.add_argument("--reps", type=int, default=REPS, help=argparse.SUPPRESS)
    p.add_argument("--census", action="store_true", help=argparse.SUPPRESS)
    return p


if __name__ == "__main__":
    a = _parser().parse_args()
    if a.sampler_rank is not None:
        sys.exit(sampler_rank(a.sampler_rank, a.device, a.backend, a.walkers, a.chunk, a.reps,
                              a.census))
    main(a.device, a.max_ranks, a.backend, epochs=a.epochs, out=a.out)
