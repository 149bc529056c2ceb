"""Collective census: the structural check of the multi-process design.

Counterpart of ``linna_tpu/parallel/census.py``.  The JAX package compiles
the production programs on the mesh and counts the collectives in the HLO;
the port has no compiled program, so it runs the production code on the
current process group and counts the calls that
:mod:`linna_tpu_torch.parallel.multihost` makes, by kind and group.  Each
census runs the same chunk at two lengths from the same start: the
difference gives the collectives per step, the rest are per chunk.  The
thresholds are the JAX package's (``examples/pod_accept.py``):

- emcee and zeus chunks: at most 2 per step (the two complementary-half
  all-gathers); zeus adds one all-reduce of its counters per chunk;
- HMC and NUTS chunks: none;
- the K-member training epochs: one ``all_reduce`` per step within each
  member's data group (none when the group has one rank), nothing that
  crosses the ``ens`` axis.

:func:`tensor_parallel_census` counts one tensor-parallel training step
(:mod:`linna_tpu_torch.parallel.dtrain`) by kind and group; it has no JAX
threshold (JAX's ``dtrain`` has no census).  JAX's
``hlo_census_by_computation`` parses compiled XLA HLO and has no
counterpart here: the port compiles no XLA program.

Every rank must call a census at the same point: they are collective.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from . import multihost as MH
from .mesh import make_ensemble_mesh, walker_shard

__all__ = [
    "sampler_collective_census",
    "trainer_collective_census",
    "tensor_parallel_census",
    "per_step_and_chunk",
]

METHODS = ("emcee", "zeus", "hmc", "nuts")
# the census problems: a random-weight emulator and its training rows;
# each census runs at two lengths (sampler steps, training epochs)
NDIM, NDATA = 6, 16
SAMPLER_STEPS = (2, 4)
TRAIN_DIM, TRAIN_DATA, N_TRAIN, N_VAL, BATCH = 4, 8, 64, 16, 16
TRAIN_EPOCHS = (1, 2)


def per_step_and_chunk(run: Callable[[int], None], n1: int, n2: int) -> Dict[str, dict]:
    """Collectives of ``run(n)`` split into per step and per chunk, from
    runs of ``n1`` and ``n2`` steps."""
    counts = []
    for n in (n1, n2):
        MH.reset_collective_counts()
        run(n)
        counts.append(MH.collective_counts())
    keys = sorted(set(counts[0]) | set(counts[1]))
    per_step = {k: (counts[1].get(k, 0) - counts[0].get(k, 0)) / (n2 - n1) for k in keys}
    per_chunk = {k: counts[0].get(k, 0) - per_step[k] * n1 for k in keys}
    return {"per_step": {k: v for k, v in per_step.items() if v},
            "per_chunk": {k: v for k, v in per_chunk.items() if v}}


def _census_problem(ndim: int, ndata: int, device: torch.device):
    """A random-weight ``chto_v2`` likelihood (the census is a property of
    the program, not of trained values)."""
    from .. import likelihood as LK
    from .. import nn as N
    from .. import priors as P
    from .. import transforms as T

    rng = np.random.default_rng(0)
    tx = rng.uniform(-1, 1, (64, ndim))
    ty = tx @ rng.standard_normal((ndim, ndata)) + 1.0
    tset = T.TransformSet(
        T.fit_x_transform(tx, device=device),
        T.fit_y_transform(ty, device=device),
        T.YTransformData(torch.ones(ndata, device=device)),
    )
    spec = N.make_model_spec("chto_v2", ndim, ndata)
    params = N.init_model(spec, seed=0, device=device)
    pack = P.priors_from_list(
        [{"param": f"p{i}", "dist": "flat", "arg1": -2.0, "arg2": 2.0} for i in range(ndim)],
        device,
    )
    return spec, tset, LK.make_log_prob(spec, params, tset, pack, np.zeros(ndata),
                                        np.eye(ndata), device=device)


def sampler_collective_census(
    log_prob_fn: Optional[Callable] = None,
    ndim: int = NDIM,
    walkers: int = 16,
    device: DeviceLike = None,
) -> dict:
    """Each sampler's walker-sharded chunk on the current process group
    (``walkers`` must divide into two blocks per rank), from a seeded start
    in ``ndim`` dimensions; the counts by kind per step and per chunk.
    ``log_prob_fn`` defaults to a random-weight emulator at ``NDIM`` ->
    ``NDATA``."""
    from ..samplers import hmc, slicemove, stretch

    device = resolve_device(device)
    if log_prob_fn is None:
        log_prob_fn = _census_problem(NDIM, NDATA, device)[2]
    shard = walker_shard(walkers)
    x0 = 0.1 * torch.randn((walkers, ndim), generator=torch.Generator().manual_seed(1))
    x0 = shard.take(x0).to(device)

    def chunk(name):
        def run(n):
            g = torch.Generator(device=device).manual_seed(2)
            if name == "emcee":
                stretch.stretch_chunk(log_prob_fn, stretch.init_state(g, x0, log_prob_fn), n,
                                      shard=shard)
            elif name == "zeus":
                slicemove.slice_chunk(log_prob_fn, slicemove.init_slice_state(g, x0, log_prob_fn),
                                      n, shard=shard)
            elif name == "hmc":
                hmc.hmc_chunk(log_prob_fn, hmc.init_hmc_state(g, x0, log_prob_fn, shard=shard),
                              n, shard=shard)
            else:
                hmc.nuts_chunk(log_prob_fn, hmc.init_nuts_state(g, x0, log_prob_fn, shard=shard),
                               n, 3, shard=shard)
        return run

    out = {"world": MH.process_count(), "walkers": walkers}
    for name in METHODS:
        out[name] = per_step_and_chunk(chunk(name), *SAMPLER_STEPS)
    return out


def trainer_collective_census(k: int = 2, device: DeviceLike = None) -> dict:
    """The K-member training epochs (``_epochs_tracked``) on the current
    process group's (ens, data) grid: the counts per step and per chunk,
    and how many collectives ran in a group other than a member's data
    group (the contract: none)."""
    from .. import losses as L
    from .ensemble import EnsembleTrainer

    device = resolve_device(device)
    spec, tset, _ = _census_problem(TRAIN_DIM, TRAIN_DATA, device)
    rng = np.random.default_rng(0)
    tx = rng.uniform(-1, 1, (N_TRAIN, TRAIN_DIM))
    ty = tx @ rng.standard_normal((TRAIN_DIM, TRAIN_DATA))
    vx = rng.uniform(-1, 1, (N_VAL, TRAIN_DIM))
    vy = vx @ rng.standard_normal((TRAIN_DIM, TRAIN_DATA))
    loss_state = L.build_loss_state(np.zeros(TRAIN_DATA), np.eye(TRAIN_DATA), tset)
    mesh = make_ensemble_mesh(k)
    tr = EnsembleTrainer(spec, tset, loss_state, [None] * k, list(range(k)), mesh=mesh,
                         device=device)
    tr._batch_size = BATCH
    data = tr._prepare(tx, ty, vx, vy)
    res = per_step_and_chunk(lambda e: tr._epochs_tracked(tr._draw_perms(e, N_TRAIN), data),
                             *TRAIN_EPOCHS)
    steps_per_epoch = N_TRAIN // BATCH
    per_step = {key: v / steps_per_epoch for key, v in res["per_step"].items()}
    cross = [key for key in list(per_step) + list(res["per_chunk"])
             if not key.split("@", 1)[1].startswith("data")]
    return {
        "k": k,
        "mesh": mesh.shape,
        "per_step": per_step,
        "per_chunk": res["per_chunk"],
        "cross_member_collectives": len(cross),
    }


def tensor_parallel_census(n_model: int, ndim: int = TRAIN_DIM, ndata: int = TRAIN_DATA,
                           batch: int = BATCH, device: DeviceLike = None) -> dict:
    """One tensor-parallel AdamW step of a random-weight ``chto_v2`` at
    ``ndim`` -> ``ndata`` on the current process group's ``('data',
    'model')`` grid with ``n_model`` model ranks: the collectives per step
    and per chunk, by kind and group."""
    from .. import losses as L
    from . import dtrain as DT
    from .mesh import make_mesh

    device = resolve_device(device)
    spec, tset, _ = _census_problem(ndim, ndata, device)
    loss_state = L.build_loss_state(np.zeros(ndata), np.eye(ndata), tset)
    mesh = make_mesh(n_model)
    opt = DT.adamw(1e-3)
    params, state = DT.init_sharded(0, spec, opt, mesh, device=device)
    step = DT.make_sharded_train_step(spec, tset, loss_state, opt, mesh)
    rng = np.random.default_rng(0)
    bx = rng.uniform(-1, 1, (batch, ndim))
    by = bx @ rng.standard_normal((ndim, ndata))

    def run(n):
        for _ in range(n):
            step(params, state, bx, by)

    return {"mesh": mesh.shape, "spec": [ndim, ndata, spec.hidden],
            **per_step_and_chunk(run, 1, 2)}
