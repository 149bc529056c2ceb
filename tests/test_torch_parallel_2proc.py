"""The port over two real processes (gloo on the CPU), each running
``tests/_torch_mh2_worker.py``: collectives, walker-sharded samplers,
training on the (ens, data) grid, exact resume across ranks, the census,
and one ``ml_sampler_core`` iteration in a shared directory where rank 1
writes nothing.  Every sharded result is held against one rank's run of the
same worker function in this process, and the stretch move also against
the JAX package's ``shard_over_walkers`` on a 2-device mesh.

The tensor-parallel epoch (``parallel/dtrain``, two model ranks at 6 -> 40,
hidden 1000, so the 125-wide trunk splits 63 + 62, and at 4 -> 8, hidden
256) is held against JAX's ``make_sharded_epoch`` on the 8-device
``n_model=2`` mesh with the same permutation and initial weights (JAX's
weights sharded by ``param_shardings`` at 4 -> 8; JAX refuses to place the
uneven 125 split, so at 6 -> 40 they go in replicated), and against one
rank's whole step: losses
and validation metric within rtol 1e-4 (JAX's own test's limit; float32 in
another library and another summation order).  Parameters after the epoch:
AdamW's first steps move an element whose gradient is nearly zero by about
the learning rate whatever the gradient's size, so rounding can flip such an
element's step: all but 1 in 1,000 elements within 1e-5, and none further
than twice the learning rate a step.

Tolerances: the sharded samplers equal one rank bit for bit (the draws are
the whole ensemble's, cut to each block, and a row's log-prob does not
depend on the rows beside it here); the JAX stretch move within rtol 1e-6,
atol 1e-6 (float32, the same arithmetic in another library); trained
parameters after one epoch within atol 1e-6 and best validation losses
within rtol 1e-5 (two data ranks sum their rows' gradients where one rank
takes the mean: float32 rounding apart, 3e-8 here; members split over the
ens ranks train exactly as on one rank)."""

import json
import os
import socket
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import _torch_mh2_worker as W
from linna_tpu import nn as JN
from linna_tpu import orchestrator as JO
from linna_tpu.samplers import stretch as JST
from linna_tpu_torch import nn as TN
from linna_tpu_torch import orchestrator as TO
from linna_tpu_torch.samplers import backends as TB
from linna_tpu_torch.samplers import run as TR

torch.set_num_threads(1)

NSTEPS = 5
HALF = W.NWALKERS // 2
ZEUS_MAX = 20
TP_KEY = jax.random.key(23)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _draws(work):
    rng = np.random.default_rng(21)
    c2 = rng.normal(0.3, 0.5, (2, HALF, W.NDIM)).astype(np.float32)
    lp2 = W.gauss_lp(torch.as_tensor(c2)).numpy()
    np.savez(work / "stretch_draws.npz", c2=c2, lp2=lp2, acc2=np.zeros((2, HALF), np.int32),
             partners=rng.integers(0, HALF, (NSTEPS, 2, HALF)),
             us=rng.uniform(size=(NSTEPS, 2, HALF)).astype(np.float32),
             ln_u=np.log(rng.uniform(size=(NSTEPS, 2, HALF))).astype(np.float32))
    l_ = rng.integers(0, HALF, (2, HALF))
    m_ = (l_ + rng.integers(1, HALF, (2, HALF))) % HALF
    np.savez(work / "zeus_draws.npz", coords=c2, l=l_, m=m_,
             expo=rng.exponential(size=(2, HALF)).astype(np.float32),
             u0=rng.uniform(size=(2, HALF)).astype(np.float32),
             shrink=rng.uniform(size=(2, ZEUS_MAX, HALF)).astype(np.float32))
    # the tensor-parallel epoch's row order: the one JAX's epoch draws
    np.savez(work / "tp_perm.npz", perm=np.asarray(jax.random.permutation(TP_KEY, W.TP_ROWS)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("mh2")
    _draws(work)
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([os.path.dirname(here), here]),
           "LINNA_COORDINATOR_ADDRESS": f"localhost:{_free_port()}",
           "LINNA_NUM_PROCESSES": "2", "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, os.path.join(here, "_torch_mh2_worker.py"),
                               str(work)], env={**env, "LINNA_PROCESS_ID": str(k)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for k in range(2)]
    outs = []
    for k, p in enumerate(procs):
        try:
            outs.append(p.communicate(timeout=300)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError(f"rank {k} timed out (a collective the other skipped?)")
    for k, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"WORKER-OK p{k}" in out, f"rank {k}:\n{out[-4000:]}"
    with np.load(work / "ranks.npz") as z:
        res = {k: z[k] for k in z.files}
    reports = [json.loads((work / f"report_{k}.json").read_text()) for k in range(2)]
    return work, res, reports


def _get(res, name):
    n = sum(1 for k in res if k.startswith(name + "/"))
    return [res[f"{name}/{i}"] for i in range(n)]


def test_sharded_emcee_equals_one_rank_bit_for_bit(ranks):
    _, res, _ = ranks
    want = W.emcee_chunk(W.emulator_problem()[0], None)
    for got, exp in zip(_get(res, "emcee"), want):
        npt.assert_array_equal(got, exp)


def test_sharded_stretch_matches_jax_shard_over_walkers(ranks):
    """The same injected draws through JAX's ``shard_over_walkers`` on a
    2-device mesh and through the port's two ranks."""
    from jax.sharding import Mesh, PartitionSpec as P

    work, res, _ = ranks
    with np.load(work / "stretch_draws.npz") as z:
        d = {k: z[k] for k in z.files}
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("walkers",))
    lp_j = lambda x: -0.5 * jnp.sum(((x - 0.3) / 0.7) ** 2, axis=-1)  # noqa: E731
    ax = "walkers"
    run = JST.shard_over_walkers(
        mesh, partial(JST._stretch_scan, lp_j, 2.0, W.NDIM, NSTEPS),
        (P(None, ax, None), P(None, ax), P(None, ax)), (P(None, None, ax),) * 3,
        (P(None, None, ax, None), P(None, None, ax)))
    (c2, lp2, _), (chain2, lps2) = run(
        tuple(jnp.asarray(d[k]) for k in ("c2", "lp2", "acc2")),
        tuple(jnp.asarray(d[k]) for k in ("partners", "us", "ln_u")))
    got = _get(res, "stretch_injected")
    want = [np.asarray(c2).reshape(-1, W.NDIM), np.asarray(lp2).reshape(-1),
            np.asarray(chain2).reshape(NSTEPS, -1, W.NDIM), np.asarray(lps2).reshape(NSTEPS, -1)]
    for g, w in zip(got, want):
        npt.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    # and the port's one rank on the same draws, bit for bit
    _, (ch1, lps1) = W.TST.stretch_steps(
        W.gauss_lp, 2.0, tuple(torch.as_tensor(d[k]) for k in ("c2", "lp2", "acc2")),
        tuple(torch.as_tensor(d[k]) for k in ("partners", "us", "ln_u")))
    npt.assert_array_equal(got[2], ch1.reshape(NSTEPS, -1, W.NDIM).numpy())
    npt.assert_array_equal(got[3], lps1.reshape(NSTEPS, -1).numpy())


def test_sharded_zeus_step_sums_its_counters(ranks):
    """Every draw injected (the shrink loop's too): the two ranks' step is
    one rank's, and the expansion and contraction counts are the sum of the
    ranks' own."""
    work, res, _ = ranks
    with np.load(work / "zeus_draws.npz") as z:
        want = W.zeus_step({k: z[k] for k in z.files}, None, ZEUS_MAX)
    got = _get(res, "zeus_step")
    npt.assert_array_equal(got[0], want[0])
    npt.assert_array_equal(got[1], want[1])
    npt.assert_array_equal(got[3], want[2])
    npt.assert_array_equal(res["zeus_local/0"].sum(axis=0), got[3])
    assert got[3][0] > 0 and got[3][1] > 0
    assert not np.array_equal(res["zeus_local/0"][0], res["zeus_local/0"][1])


def test_sharded_zeus_pins_the_moments(ranks):
    """Per-rank shrink streams: the sharded chain agrees with the target in
    distribution (mean 0.3, std 0.7 per parameter)."""
    _, res, _ = ranks
    chain, counts = _get(res, "zeus_moments")
    samples = chain[len(chain) // 3:].reshape(-1, W.NDIM)
    npt.assert_allclose(samples.mean(axis=0), 0.3, atol=0.1)
    npt.assert_allclose(samples.std(axis=0), 0.7, atol=0.1)
    assert np.all(counts > 0), counts  # each chunk's counts, summed over the ranks


@pytest.mark.parametrize("index, name", [(0, "hmc chain"), (1, "hmc log-probs"),
                                         (2, "hmc acceptances"), (3, "hmc step sizes"),
                                         (4, "nuts chain"), (5, "nuts log-probs"),
                                         (6, "nuts acceptances"), (7, "nuts step sizes")])
def test_sharded_hmc_and_nuts_equal_one_rank(ranks, index, name):
    """Both gradient samplers draw for the whole ensemble and cut to the
    block (NUTS runs every doubling level), so two ranks give one rank's
    chains exactly."""
    _, res, _ = ranks
    npt.assert_array_equal(_get(res, "gradient")[index], W.gradient_chunks(None)[index],
                           err_msg=name)


@pytest.mark.parametrize("k", [1, 2])
def test_training_over_two_ranks_matches_one(ranks, k):
    """K=1 over 2 data ranks, K=2 over 2 ens ranks: one epoch against one
    rank's trainer."""
    _, res, _ = ranks
    flat, best = _get(res, f"train_k{k}")
    flat1, best1 = W.train_members(k, None)
    npt.assert_allclose(flat, flat1, rtol=0, atol=1e-6)
    npt.assert_allclose(best, best1, rtol=1e-5)
    assert flat.shape[0] == k


def test_census_holds_the_jax_thresholds(ranks):
    _, _, reports = ranks
    for rep in reports:
        s = rep["census_sampler"]
        assert s["world"] == 2
        for m in ("emcee", "zeus"):
            assert sum(s[m]["per_step"].values()) == 2, s[m]
            assert set(s[m]["per_step"]) == {"all_gather@world"}
        assert s["zeus"]["per_chunk"] == {"all_reduce@world": 1}
        assert s["emcee"]["per_chunk"] == {}
        for m in ("hmc", "nuts"):
            assert s[m] == {"per_step": {}, "per_chunk": {}}
        k1, k2 = rep["census_k1"], rep["census_k2"]
        assert k1["mesh"] == {"ens": 1, "data": 2} and k2["mesh"] == {"ens": 2, "data": 1}
        assert k1["per_step"] == {"all_reduce@data[0,1]": 1.0} and k1["per_chunk"] == {}
        assert k2["per_step"] == {} and k2["per_chunk"] == {}
        assert k1["cross_member_collectives"] == k2["cross_member_collectives"] == 0


@pytest.mark.parametrize("method", ["emcee", "nuts"])
def test_resume_across_ranks_is_one_ranks_uninterrupted_chain(ranks, tmp_path, method):
    """Two ranks: a run, then the same run resumed further (rank 0's state
    blob and preconditioner broadcast); one rank: the whole run at once."""
    work, _, _ = ranks
    if method == "emcee":
        lp, total, kw = W.emulator_problem()[0], 32, dict(check_every=8)
    else:
        lp, total, kw = W.gauss_lp, 8, dict(check_every=4, m_adapt=4, max_depth=3)
    TR.run_ensemble(lp, W.x0().numpy(), str(tmp_path), method=method, max_iterations=total,
                    **kw, **W.run_kwargs())
    store = TR.EMCEE_FILENAME
    shared = work / "shared" / ("resume" if method == "emcee" else "nuts")
    got = TB.EmceeBackend(str(shared / store))
    want = TB.EmceeBackend(str(tmp_path / store))
    assert got.iteration == total
    npt.assert_array_equal(got.get_chain(), want.get_chain())
    npt.assert_array_equal(got.get_log_prob(), want.get_log_prob())


def test_pipeline_writes_from_rank_0_only(ranks):
    work, res, reports = ranks
    assert reports[1]["writes"] == [], reports[1]["writes"][:10]
    gate1 = [p for p in (work / "gate_1").rglob("*") if p.is_file()] \
        if (work / "gate_1").exists() else []
    assert gate1 == [], gate1
    assert any(p.is_file() for p in (work / "gate_0").rglob("*"))
    assert all(r["loaded_best"] == [True, True] for r in reports)
    it0 = work / "shared" / "run" / "iter_0"
    for f in ("finish.json", "transforms.npz", "best.ckpt.npz", "lr.npy",
              os.path.join("ens_1", "best.ckpt.npz")):
        assert (it0 / f).is_file(), f
    assert TB.EmceeBackend(str(it0 / TR.EMCEE_FILENAME)).initialized
    chain, logp = _get(res, "pipeline")
    assert chain.shape[1] == W.NDIM and np.all(np.isfinite(chain)) and len(logp) == len(chain)
    # every rank's reads went through rank 0: collectives of each kind ran
    counts = reports[0]["collectives"]
    assert counts.get("broadcast@world", 0) > 0 and counts.get("barrier@world", 0) > 0


def test_two_rank_run_directory_loads_in_both_packages(ranks):
    work, _, _ = ranks
    it0 = str(work / "shared" / "run" / "iter_0")
    x = np.random.default_rng(1).uniform(-1, 1, (7, W.NDIM)).astype(np.float32)
    port = TO.retrieve_model(it0, W.NDIM, W.NDIM, device="cpu")
    members_t = TO.retrieve_ensemble_params(it0, port)
    jtr = JO.retrieve_model(it0, W.NDIM, W.NDIM)
    members_j = JO.retrieve_ensemble_params(it0, jtr)
    assert len(members_t) == len(members_j) == 2
    xt = port.transforms.x_transform(torch.as_tensor(x))
    xj = jtr.transforms.x_transform(jnp.asarray(x))
    for pt, pj in zip(members_t, members_j):
        with torch.no_grad():
            got = TN.apply_model(port.spec, pt, xt).numpy()
        npt.assert_allclose(got, np.asarray(JN.apply_model(jtr.spec, pj, xj)), rtol=1e-5,
                            atol=1e-6)


def test_barriers_of_different_names_raise_on_every_rank(ranks):
    _, _, reports = ranks
    for r in reports:
        assert r["barrier_mismatch"] and "different barriers" in r["barrier_mismatch"]


def _tp_params_close(got, want, steps):
    d = np.abs(got - want)
    assert np.mean(d > 1e-5) < 1e-3, np.quantile(d, [0.5, 0.999, 1.0])
    assert d.max() <= 2 * W.TP_LR * steps, d.max()


def _tp_jax_epoch(perm, ndim, ndata):
    """JAX's sharded epoch on the 8-device mesh with n_model=2, from the
    port's initial weights.  JAX places a parameter by ``param_shardings``
    only where the model axis divides its dimension (``device_put`` and
    jit outputs both refuse 125 over 2): at 6 -> 40 its weights go in
    replicated, the batch still over ``data``."""
    import optax
    from linna_tpu import losses as JL
    from linna_tpu import parallel as PX
    from linna_tpu import transforms as JT
    from linna_tpu_torch import train as TTR

    d = W.tp_inputs(ndim, ndata)
    spec = JN.make_model_spec("chto_v2", ndim, ndata)
    ts = JT.TransformSet(JT.XTransform(d["x_mean"], d["x_std"], np.zeros(ndim, bool)),
                         JT.YTransform(d["y_mean"], d["y_std"], False),
                         JT.YTransformData(d["sigma"]))
    ls = JL.build_loss_state(d["data"], d["cov"], ts)
    mesh = PX.make_mesh(jax.devices(), n_model=2)
    tspec = TN.make_model_spec("chto_v2", ndim, ndata)
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                          TN.init_model(tspec, seed=W.TP_SEED, device="cpu"))
    if spec.hidden % 16 == 0:  # every trunk width even
        params = PX.shard_params(params, mesh)
        assert params["rb3"]["skip_w"].sharding.spec == jax.sharding.PartitionSpec(None, "model")
    opt = optax.adamw(W.TP_LR)
    state = jax.jit(opt.init)(params)
    bsh = PX.batch_sharding(mesh)
    epoch = PX.make_sharded_epoch(spec, ts, ls, opt, mesh, batch_size=W.TP_BATCH)
    params, _, losses, vm = epoch(params, state, TP_KEY,
                                  *(jax.device_put(jnp.asarray(d[k], jnp.float32), bsh)
                                    for k in ("tx", "ty", "vx", "vy")))
    flat = TTR.Layout(tspec).flatten(jax.device_get(params)).numpy()
    assert np.array_equal(np.asarray(jax.random.permutation(TP_KEY, W.TP_ROWS)), perm)
    return np.asarray(losses), np.asarray(vm), flat


@pytest.mark.parametrize("ndim, ndata", W.TP_SHAPES)
@pytest.mark.parametrize("against", ["jax", "one_rank"])
def test_tensor_parallel_epoch(ranks, against, ndim, ndata):
    work, res, _ = ranks
    with np.load(work / "tp_perm.npz") as z:
        perm = z["perm"]
    losses, vm, flat = _get(res, f"tp_epoch_{ndim}_{ndata}")
    if against == "jax":
        w_losses, w_vm, w_flat = _tp_jax_epoch(perm, ndim, ndata)
    else:
        w_losses, w_vm, w_flat = W.tp_epoch(None, perm, ndim, ndata)
    steps = W.TP_ROWS // W.TP_BATCH
    assert losses.shape == (steps,) and vm.shape == (3,)
    npt.assert_allclose(losses, w_losses, rtol=1e-4)
    npt.assert_allclose(vm, w_vm, rtol=1e-4)
    _tp_params_close(flat, w_flat, steps)


def test_tensor_parallel_census(ranks):
    """One step on data 1 x model 2: the four row-parallel sums and the
    three skip gathers forward, their six conjugates backward, and the
    gradient's all-reduce over the (one-rank) data group."""
    _, _, reports = ranks
    for k, rep in enumerate(reports):
        c = rep["census_tp"]
        assert c["mesh"] == {"data": 1, "model": 2}
        assert c["per_step"] == {"all_reduce@model[0,1]": 10.0, "all_gather@model[0,1]": 3.0,
                                 f"all_reduce@data[{k}]": 1.0}, c
        assert c["per_chunk"] == {}


def test_speculative_training_over_two_ranks(ranks):
    """K=2 over the ens ranks with speculative dispatch: every chunk but the
    first and the last speculates and none is dropped, and the result is
    one rank's serial run."""
    _, res, _ = ranks
    flat, best, counts = _get(res, "spec_k2")
    flat1, best1, counts1 = W.speculative_members(None, speculative=False)
    assert counts.tolist() == [4, 0] and counts1.tolist() == [0, 0]
    npt.assert_allclose(flat, flat1, rtol=0, atol=1e-6)
    npt.assert_allclose(best, best1, rtol=1e-5)


def test_pod_accept_structural_gates_on_two_ranks(ranks):
    _, _, reports = ranks
    for rep in reports:
        ok, accept = rep["pod_accept"]
        assert ok is True
        st = accept["structural"]
        assert st["world"] == 2
        for m, n in (("emcee", 2), ("zeus", 2), ("hmc", 0), ("nuts", 0)):
            assert st["sampler"][m] == {"per_step_collectives": n, "limit": n, "pass": True}
        assert st["trainer"]["pass"] and st["trainer"]["cross_member_collectives"] == 0
