"""One rank of the port's two-process tests (tests/test_torch_parallel_2proc.py).

Started twice with ``LINNA_COORDINATOR_ADDRESS`` / ``LINNA_NUM_PROCESSES`` /
``LINNA_PROCESS_ID`` set; both ranks run this same program over gloo on the
CPU and rank 0 writes what it fetched under ``argv[1]`` for the test to
compare with one rank's run of the same functions (importable from here)
and with the JAX package.  It imports the port and never JAX.
"""

import json
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)

from linna_tpu_torch import likelihood as TLK  # noqa: E402
from linna_tpu_torch import losses as TL  # noqa: E402
from linna_tpu_torch import nn as TN  # noqa: E402
from linna_tpu_torch import priors as TP  # noqa: E402
from linna_tpu_torch import transforms as TT  # noqa: E402
from linna_tpu_torch.parallel import census as CE  # noqa: E402
from linna_tpu_torch.parallel import dtrain as DT  # noqa: E402
from linna_tpu_torch.parallel import mesh as ME  # noqa: E402
from linna_tpu_torch.parallel import multihost as MH  # noqa: E402
from linna_tpu_torch.parallel.ensemble import EnsembleTrainer  # noqa: E402
from linna_tpu_torch.samplers import hmc as TH  # noqa: E402
from linna_tpu_torch.samplers import run as TR  # noqa: E402
from linna_tpu_torch.samplers import slicemove as TS  # noqa: E402
from linna_tpu_torch.samplers import stretch as TST  # noqa: E402
from linna_tpu_torch.train import _walk  # noqa: E402
from chip_smoke import WriteAudit  # noqa: E402

NDIM, NDATA = 3, 6
NWALKERS = 16


# ------------------------------------------------ shared with the test side


def gauss_lp(x):
    """An analytic target, the same arithmetic in both packages."""
    return -0.5 * torch.sum(((x - 0.3) / 0.7) ** 2, dim=-1)


def emulator_problem(seed=0):
    """A random-weight chto_v2 emulator likelihood at NDIM -> NDATA (its
    products make a row's value depend on the kernel the row count picks,
    where the BLAS does), with its training rows."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((NDIM, NDATA))
    tx = rng.uniform(-1, 1, (64, NDIM))
    ty = tx @ w + 0.1 * np.sin(3 * tx).sum(1, keepdims=True)
    vx = rng.uniform(-1, 1, (16, NDIM))
    vy = vx @ w + 0.1 * np.sin(3 * vx).sum(1, keepdims=True)
    tset = TT.TransformSet(TT.fit_x_transform(tx, device="cpu"),
                           TT.fit_y_transform(ty, device="cpu"),
                           TT.YTransformData(torch.ones(NDATA)))
    spec = TN.make_model_spec("chto_v2", NDIM, NDATA)
    pack = TP.priors_from_list(
        [{"param": f"p{i}", "dist": "flat", "arg1": -2.0, "arg2": 2.0} for i in range(NDIM)], "cpu")
    lp = TLK.make_log_prob(spec, TN.init_model(spec, seed=seed, device="cpu"), tset, pack,
                           np.zeros(NDATA), np.eye(NDATA), device="cpu")
    loss_state = TL.build_loss_state(np.zeros(NDATA), np.eye(NDATA), tset)
    return lp, spec, tset, loss_state, (tx, ty, vx, vy)


def x0(nwalkers=NWALKERS, scale=0.3, seed=3):
    return torch.as_tensor(scale * np.random.default_rng(seed).standard_normal((nwalkers, NDIM)),
                           dtype=torch.float32)


def emcee_chunk(lp, shard, nsteps=12):
    g = torch.Generator().manual_seed(5)
    take = (lambda a: a) if shard is None else shard.take
    state = TST.init_state(g, take(x0()), lp)
    state, chain, lps = TST.stretch_chunk(lp, state, nsteps, shard=shard)
    return MH.fetch((chain, lps, state.accepted), shard, dim=(1, 1, 0))


def gradient_chunks(shard, nsteps=6):
    """HMC then NUTS chunks on the analytic target, from one generator."""
    g = torch.Generator().manual_seed(9)
    take = (lambda a: a) if shard is None else shard.take
    out = []
    s = TH.init_hmc_state(g, take(x0(scale=0.5)), gauss_lp, shard=shard)
    s, chain, lps = TH.hmc_chunk(gauss_lp, s, nsteps, 5, shard=shard)
    out += MH.fetch((chain, lps, s.accepted, s.epsilon), shard, dim=(1, 1, 0, 0))
    s = TH.init_nuts_state(g, take(x0(scale=0.5)), gauss_lp, m_adapt=3, shard=shard)
    s, chain, lps = TH.nuts_chunk(gauss_lp, s, nsteps, 4, shard=shard)
    out += MH.fetch((chain, lps, s.accepted, s.epsilon), shard, dim=(1, 1, 0, 0))
    return out


def zeus_step(draws, shard, max_steps=20):
    """One slice step (both half-updates) with every draw injected: the
    step-fixed draws and the shrink loop's uniforms, all (…, half)-wide and
    cut to this rank's block.  Returns the new coords and log-probs, and
    the expansion and contraction counts (summed over the ranks)."""
    blk = slice(None) if shard is None else shard.block
    gather = (lambda a: a) if shard is None else shard.gather_half
    c2 = torch.as_tensor(draws["coords"])[:, blk]
    lp2 = gauss_lp(c2)
    t = {k: torch.as_tensor(draws[k])[..., blk] for k in ("l", "m", "expo", "u0", "shrink")}
    mu = torch.tensor(1.0)
    nx0, nlp0, ne0, nc0 = TS._slice_half(gauss_lp, max_steps, c2[0], lp2[0], gather(c2[1]), mu,
                                         t["l"][0], t["m"][0], t["expo"][0], t["u0"][0],
                                         t["shrink"][0])
    nx1, nlp1, ne1, nc1 = TS._slice_half(gauss_lp, max_steps, c2[1], lp2[1], gather(nx0), mu,
                                         t["l"][1], t["m"][1], t["expo"][1], t["u0"][1],
                                         t["shrink"][1])
    local = torch.stack([ne0 + ne1, nc0 + nc1])
    total = MH.all_reduce(local.clone())
    coords, lps = MH.fetch((torch.stack([nx0, nx1]).reshape(-1, NDIM),
                            torch.stack([nlp0, nlp1]).reshape(-1)), shard, dim=0)
    return coords, lps, local.numpy(), total.numpy()


def zeus_moments(shard, nsteps=150):
    g = torch.Generator().manual_seed(11)
    take = (lambda a: a) if shard is None else shard.take
    s = TS.init_slice_state(g, take(x0(64, scale=0.2)), gauss_lp)
    chains, counts = [], []
    for _ in range(3):
        s, chain, _ = TS.slice_chunk(gauss_lp, s, nsteps // 3, shard=shard)
        counts.append([int(s.n_expand), int(s.n_contract)])
        s = TS.tune_mu(s)
        chains.append(MH.fetch(chain, shard, dim=1))
    return np.concatenate(chains), np.asarray(counts)


def _trained(k, mesh, epochs, speculative=True, epochs_per_dispatch=None):
    _, spec, tset, loss_state, (tx, ty, vx, vy) = emulator_problem()
    tr = EnsembleTrainer(spec, tset, loss_state, [None] * k, [7 + m for m in range(k)],
                         mesh=mesh, device="cpu")
    tr.speculative_dispatch = speculative
    tr.train(tx, ty, vx, vy, num_epochs=epochs, batch_size=16, auto_lr=False,
             epochs_per_dispatch=epochs_per_dispatch)
    return tr


def train_members(k, mesh, epochs=1):
    """``epochs`` epochs of K members (no range test, no files) on
    ``mesh``; every member's final params and best val loss."""
    tr = _trained(k, mesh, epochs)
    return tr._gather([tr.flat], [0])[0], tr.best_val_losses


def speculative_members(mesh, speculative=True, k=2, epochs=30):
    """30 epochs of K=2 in 5-epoch chunks (no intervention on this
    problem): the params, best val losses and the chunks speculated and
    dropped."""
    tr = _trained(k, mesh, epochs, speculative, epochs_per_dispatch=5)
    return (tr._gather([tr.flat], [0])[0], tr.best_val_losses,
            np.array([tr.speculation["speculated"], tr.speculation["dropped"]]))


# the tensor-parallel epochs: 6 -> 40 is hidden 1000 (an output over 30
# wide), so the 125-wide trunk splits 63 + 62 over two model ranks; 4 -> 8
# is hidden 256, every width even
TP_SHAPES = ((6, 40), (4, 8))
TP_ROWS, TP_VAL, TP_BATCH, TP_SEED, TP_LR = 64, 16, 16, 3, 1e-3


def tp_inputs(ndim, ndata):
    """The tensor-parallel problem as numpy: transforms, data, covariance
    and rows (the JAX side builds its objects from the same numbers)."""
    rng = np.random.default_rng(17)
    w = rng.standard_normal((ndim, ndata))
    tx = rng.uniform(-1, 1, (TP_ROWS, ndim))
    ty = tx @ w + 0.1 * np.sin(3 * tx).sum(1, keepdims=True) + 2.0
    vx = rng.uniform(-1, 1, (TP_VAL, ndim))
    vy = vx @ w + 0.1 * np.sin(3 * vx).sum(1, keepdims=True) + 2.0
    a = 0.05 * rng.standard_normal((ndata, ndata))
    return {
        "x_mean": tx.mean(0).astype(np.float32), "x_std": tx.std(0, ddof=1).astype(np.float32),
        "y_mean": (ty / 0.5).mean(0).astype(np.float32),
        "y_std": (ty / 0.5).std(0, ddof=1).astype(np.float32),
        "sigma": np.full(ndata, 0.5, np.float32), "data": 2.0 + 0.1 * rng.normal(size=ndata),
        "cov": 0.25 * (np.eye(ndata) + a @ a.T),
        "tx": tx, "ty": ty, "vx": vx, "vy": vy,
    }


def tp_epoch(n_model, perm, ndim, ndata):
    """One tensor-parallel epoch from ``init_sharded(TP_SEED)`` over the
    current process group (``n_model`` model ranks; none: one rank's whole
    step): the batch losses, the validation metric, and the whole
    parameters after it, flattened in ``init_model``'s order."""
    d = tp_inputs(ndim, ndata)
    spec = TN.make_model_spec("chto_v2", ndim, ndata)
    tset = TT.TransformSet(
        TT.XTransform(torch.as_tensor(d["x_mean"]), torch.as_tensor(d["x_std"]),
                      torch.zeros(ndim, dtype=torch.bool)),
        TT.YTransform(torch.as_tensor(d["y_mean"]), torch.as_tensor(d["y_std"]), False),
        TT.YTransformData(torch.as_tensor(d["sigma"])))
    loss_state = TL.build_loss_state(d["data"], d["cov"], tset)
    mesh = ME.make_mesh(n_model)
    opt = DT.adamw(TP_LR)
    params, state = DT.init_sharded(TP_SEED, spec, opt, mesh, device="cpu")
    epoch = DT.make_sharded_epoch(spec, tset, loss_state, opt, mesh, TP_BATCH)
    params, state, losses, vm = epoch(params, state, perm, d["tx"], d["ty"], d["vx"], d["vy"])
    full = DT.gather_params(spec, params, mesh)
    return losses.numpy(), vm.numpy(), np.concatenate([a.reshape(-1) for _, a in _walk(full)])


def run_kwargs(**kw):
    return dict(ntimes=1, tautol=100.0, meanshift=1e9, stdshift=1e9, seed=5, device="cpu",
                convergence_check=False, **kw)


def pipeline(outdir, lp_seed=0):
    """One ml_sampler_core iteration (identity theory, K=2, emcee)."""
    from linna_tpu_torch import orchestrator as TO

    cov = np.diag([0.5, 0.2, 0.3])
    return TO.ml_sampler_core(
        ntrainArr=[40], nvalArr=[10], nkeepArr=[1], ntimesArr=[0], ntautolArr=[np.inf],
        meanshiftArr=[np.inf], stdshiftArr=[np.inf], outdir=outdir, theory=identity_theory,
        priors=[{"param": f"p{i}", "dist": "flat", "arg1": -2.0, "arg2": 2.0}
                for i in range(NDIM)],
        data=np.array([0.1, -0.2, 0.3]), cov=cov, init=np.zeros(NDIM), pool=None,
        nwalkers=NWALKERS, device="cpu", temperatureArr=[1.0],
        params={"trainingoption": 1, "num_epochs": 6, "batch_size": 10, "nensemble": 2},
        method="emcee", seed=7,
    )


def identity_theory(x, outdir):
    return np.asarray(x[1], dtype=np.float64).copy()


# ------------------------------------------------------------------- ranks


def main() -> None:
    work = sys.argv[1]
    assert MH.initialize(backend="gloo", device="cpu"), "expected two ranks from the environment"
    rank, world = MH.process_index(), MH.process_count()
    assert world == 2
    primary = rank == 0
    shared = os.path.join(work, "shared")
    audit = WriteAudit(shared) if not primary else None
    out = {}

    # collectives: float64 exact through the byte broadcast, rank 0's flag
    blob = MH.broadcast_from_primary(lambda: {"v": np.array([1.0 + 2.0**-52, -3.5]), "n": 7})
    assert blob["n"] == 7 and blob["v"][0] == 1.0 + 2.0**-52
    assert MH.primary_flag(primary) is True
    MH.barrier("start")

    shard = ME.walker_shard(NWALKERS)
    lp = emulator_problem()[0]
    res = {"emcee": emcee_chunk(lp, shard), "gradient": gradient_chunks(shard)}

    # the JAX comparison's injected stretch draws
    with np.load(os.path.join(work, "stretch_draws.npz")) as z:
        d = {k: z[k] for k in z.files}
    blk = shard.block
    carry = tuple(torch.as_tensor(d[k])[:, blk] for k in ("c2", "lp2", "acc2"))
    xs = tuple(torch.as_tensor(d[k])[..., blk] for k in ("partners", "us", "ln_u"))
    (c2, lp2, acc2), (chain2, lps2) = TST.stretch_steps(gauss_lp, 2.0, carry, xs,
                                                        shard.gather_half)
    nsteps = chain2.shape[0]
    res["stretch_injected"] = MH.fetch(
        (c2.reshape(-1, NDIM), lp2.reshape(-1), chain2.reshape(nsteps, -1, NDIM),
         lps2.reshape(nsteps, -1)), shard, dim=(0, 0, 1, 1))

    with np.load(os.path.join(work, "zeus_draws.npz")) as z:
        res["zeus_step"] = zeus_step({k: z[k] for k in z.files}, ME.walker_shard(NWALKERS))
    zeus_local = MH.gather_packed([torch.as_tensor(res["zeus_step"][2])])
    res["zeus_local"] = np.stack([p[0] for p in zeus_local])
    res["zeus_moments"] = zeus_moments(ME.walker_shard(64))

    res["train_k1"] = train_members(1, ME.make_ensemble_mesh(1))
    res["train_k2"] = train_members(2, ME.make_ensemble_mesh(2))
    # speculative dispatch over the ens ranks: every rank takes the same
    # speculate/accept branches, from the gathered metrics
    res["spec_k2"] = speculative_members(ME.make_ensemble_mesh(2))
    with np.load(os.path.join(work, "tp_perm.npz")) as z:
        for ndim, ndata in TP_SHAPES:
            res[f"tp_epoch_{ndim}_{ndata}"] = tp_epoch(2, z["perm"], ndim, ndata)
    out["census_tp"] = CE.tensor_parallel_census(n_model=2, device="cpu")
    from linna_tpu_torch import pod_accept

    accept = {}
    out["pod_accept"] = (pod_accept.structural_gates(accept, torch.device("cpu")), accept)
    out["census_sampler"] = CE.sampler_collective_census(device="cpu")
    out["census_k1"] = CE.trainer_collective_census(k=1, device="cpu")
    out["census_k2"] = CE.trainer_collective_census(k=2, device="cpu")

    # exact resume across ranks: 16 steps, then resumed to 32
    for n in (16, 32):
        TR.run_ensemble(lp, x0().numpy(), os.path.join(shared, "resume"), method="emcee",
                        check_every=8, max_iterations=n, **run_kwargs())
        MH.barrier(f"resume-{n}")
    for n in (4, 8):
        TR.run_ensemble(gauss_lp, x0().numpy(), os.path.join(shared, "nuts"), method="nuts",
                        check_every=4, max_iterations=n, m_adapt=4, max_depth=3,
                        **run_kwargs())
        MH.barrier(f"nuts-{n}")

    # the pipeline over both ranks in the shared directory
    chain, logp = pipeline(os.path.join(shared, "run"))
    MH.barrier("pipeline")
    res["pipeline"] = (chain, logp)

    # the write gate with per-rank directories
    mine = os.path.join(work, f"gate_{rank}")
    _, spec, tset, loss_state, (tx, ty, vx, vy) = emulator_problem()
    ens = EnsembleTrainer(spec, tset, loss_state, [mine, os.path.join(mine, "ens_1")], [11, 12],
                          device="cpu")
    ens.train(tx, ty, vx, vy, num_epochs=3, batch_size=16)
    # only rank 0's checkpoints exist: True on both ranks means the payload
    # came from rank 0
    ens2 = EnsembleTrainer(spec, tset, loss_state, [mine, os.path.join(mine, "ens_1")], [11, 12],
                           device="cpu")
    out["loaded_best"] = [bool(ens2._load_best_member(m)) for m in (0, 1)]
    TR.run_ensemble(gauss_lp, x0().numpy(), mine, method="zeus", check_every=8,
                    max_iterations=8, **run_kwargs())
    MH.barrier("done")
    # ranks that meet at barriers of different names raise on every rank
    try:
        MH.barrier(f"side-{rank}")
        out["barrier_mismatch"] = None
    except RuntimeError as e:
        out["barrier_mismatch"] = str(e)

    if audit is not None:
        out["writes"] = audit.seen
    out["collectives"] = MH.collective_counts()
    with open(os.path.join(work, f"report_{rank}.json"), "w") as f:
        json.dump(out, f)
    if primary:
        flat = {}
        for name, value in res.items():
            for i, a in enumerate(value if isinstance(value, (tuple, list)) else [value]):
                flat[f"{name}/{i}"] = np.asarray(a)
        np.savez(os.path.join(work, "ranks.npz"), **flat)
    MH.shutdown()
    print(f"WORKER-OK p{rank}", flush=True)


if __name__ == "__main__":
    main()
