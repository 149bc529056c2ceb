"""The port's sampler programs against the JAX package's and against the
serial port: the K-member likelihood as one batched pass (JAX's vmapped
ensemble), the slice move's loops with their conditions read late (JAX's
``_slice_half`` and the lag-0 loop, with injected draws), the CUDA-graph
launch ledger's arithmetic, and ``run_ensemble``'s double-buffered
dispatch (a stop with a chunk pending, and a resume, bit for bit the serial
order).

Tolerances: float32 likelihoods at rtol 1e-5 (the same products, batched);
bfloat16 at the JAX bf16 test's rtol = atol = 0.05
(tests/test_compute_dtype.py); the slice move at the f32 tolerance of
tests/test_torch_slicemove.py."""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from linna_tpu import likelihood as JLK
from linna_tpu import linear_model as JLM
from linna_tpu import nn as JN
from linna_tpu.samplers import slicemove as JS
from linna_tpu_torch import likelihood as TLK
from linna_tpu_torch import linear_model as TLM
from linna_tpu_torch import nn as TN
from linna_tpu_torch.ops import graphs as OG
from linna_tpu_torch.samplers import backends as TB
from linna_tpu_torch.samplers import graphs as TG
from linna_tpu_torch.samplers import run as TR
from linna_tpu_torch.samplers import slicemove as TS

from _torch_parity import CPU, gauss_log_probs, problem, t, walkers

torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=0.05, atol=0.05)


# ------------------------------------------------- the batched ensemble


def _ensemble(k, variant):
    """JAX's and the port's K-member likelihoods of one problem."""
    pb = problem(ndim=5, ndata=8)
    pj = [JN.init_model(jax.random.key(20 + i), pb.spec) for i in range(k)]
    pt = [TN.params_from_numpy(jax.device_get(p), CPU) for p in pj]
    data, inv_cov = pb.data, pb.inv_cov
    kw_j, kw_t = {}, {}
    if variant == "linearmodel":
        rng = np.random.default_rng(9)
        x = rng.uniform(-1, 1, (80, 5))
        y = np.tanh(x @ rng.normal(size=(5, 8)))
        jlm = JLM.fit_linear_model(x, y, norder=2)
        kw_j["linearmodel"] = jlm
        kw_t["linearmodel"] = TLM.LinearModel(*(np.asarray(getattr(jlm, f)) for f in TLM.FIELDS),
                                              device=CPU)
    elif variant == "out_cut":
        data, inv_cov = data[:5], inv_cov[:5, :5]
        kw_j["out_cut"] = kw_t["out_cut"] = 5
    elif variant == "bfloat16":
        kw_j["compute_dtype"] = kw_t["compute_dtype"] = "bfloat16"
    lp_j = JLK.make_log_prob(pb.spec, pj, pb.ts_j, pb.pack_j, data, inv_cov, temperature=4.0,
                             ensemble_k_std=1.5, **kw_j)
    lp_t = TLK.make_log_prob(pb.tspec, pt, pb.ts_t, pb.pack_t, data, inv_cov, temperature=4.0,
                             ensemble_k_std=1.5, device=CPU, **kw_t)
    return lp_j, lp_t


@pytest.mark.parametrize("variant", ["plain", "linearmodel", "out_cut", "bfloat16"])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_batched_ensemble_matches_jax(k, variant):
    """K stacked members in one batched pass against JAX's vmapped members:
    float32 at rtol 1e-5, bfloat16 at the JAX bf16 test's tolerance."""
    lp_j, lp_t = _ensemble(k, variant)
    assert lp_t._env["params"]["layer1"]["w"].shape[0] == k
    assert lp_t._env["params"]["layer1"]["b"].shape == (k, 1, lp_t._env["params"]["layer1"]["b"].shape[-1])
    x = walkers(33, 5, seed=4)
    with torch.no_grad():
        got = lp_t(t(x))
    assert got.dtype == torch.float32 and got.shape == (33,)
    npt.assert_allclose(got.numpy(), np.asarray(lp_j(jnp.asarray(x))),
                        **(BF16 if variant == "bfloat16" else F32))


# ----------------------------------------------- late condition reads

VAR = np.array([0.5, 1.0, 2.0, 0.1], np.float32)
HALF = 12


def _lp_jax(x):
    return -0.5 * jnp.sum(x * x / VAR, axis=-1)


class _Counted:
    """The port's target, counting each loop's calls by their rows (the
    stepping-out batch holds both ends)."""

    def __init__(self):
        self.rows = []

    def __call__(self, x):
        self.rows.append(x.shape[0])
        return -0.5 * torch.sum(x * x / torch.as_tensor(VAR), dim=-1)


def _slice_inputs(case):
    """(active, comp, mu, max_steps, JAX draws...) of one case."""
    seed, mu, max_steps = {"normal": (0, 1.0, 100), "out_first": (1, 40.0, 100),
                           "exhausted": (2, 1.0, 2), "shrink_first": (3, 0.5, 100)}[case]
    rng = np.random.default_rng(seed)
    active = (rng.normal(size=(HALF, 4)) * np.sqrt(VAR)).astype(np.float32)
    comp = (rng.normal(size=(HALF, 4)) * np.sqrt(VAR)).astype(np.float32)
    key = jax.random.key(seed)
    k_l, k_off, k_h, k_u0, k_sh = jax.random.split(key, 5)
    l = jax.random.randint(k_l, (HALF,), 0, HALF)
    m = (l + jax.random.randint(k_off, (HALF,), 1, HALF)) % HALF
    expo = jax.random.exponential(k_h, (HALF,))
    u0 = jax.random.uniform(k_u0, (HALF,))
    us, k = [], k_sh
    for _ in range(max_steps):
        k, kt = jax.random.split(k)
        us.append(np.asarray(jax.random.uniform(kt, (HALF,))))
    us = np.stack(us)
    if case == "shrink_first":
        # the first shrink draw at t = 0, the walker's own point (the
        # interval that stepping out leaves): inside the slice, so every
        # walker is done after one shrink iteration
        lp = _Counted()
        w = TS.slice_begin(t(active), lp(t(active)), t(comp), torch.tensor(mu),
                           t(np.asarray(l)).long(), t(np.asarray(m)).long(), t(np.asarray(expo)),
                           t(np.asarray(u0)))
        more = True
        while more:
            w, more = TS.step_out(lp, w)
        us[0] = (-w.left / (w.right - w.left)).numpy()
    return active, comp, mu, max_steps, l, m, expo, u0, k_sh, us


def _port_half(case, lag):
    active, comp, mu, max_steps, l, m, expo, u0, _, us = _slice_inputs(case)
    lp = _Counted()
    out = TS._slice_half(
        lp, max_steps, t(active), lp(t(active)), t(comp), torch.tensor(mu),
        t(np.asarray(l)).long(), t(np.asarray(m)).long(), t(np.asarray(expo)),
        t(np.asarray(u0)), t(us), flags=TS.LateFlags(CPU, lag),
    )
    calls = lp.rows[1:]  # after the active half's own log-probs
    return out, sum(r == 2 * HALF for r in calls), sum(r == HALF for r in calls)


@pytest.mark.parametrize("case", ["normal", "out_first", "exhausted", "shrink_first"])
@pytest.mark.parametrize("lag", [0, 1, 3, "max_steps"])
def test_late_condition_reads_equal_the_lag0_loop_and_jax(case, lag):
    """With injected draws, every lag gives the lag-0 loop's update bit for
    bit (the extra iterations are masked), and JAX's ``_slice_half`` to f32
    tolerance (its shrink draws are the injected stream except in
    ``shrink_first``).  ``out_first``: stepping out ends at its first
    iteration; ``shrink_first``: the shrink loop; ``exhausted``: walkers
    that use up ``max_steps`` keep their position."""
    active, comp, mu, max_steps, l, m, expo, u0, k_sh, _ = _slice_inputs(case)
    lag = max_steps if lag == "max_steps" else lag
    (x0, lp0, ne0, nc0), out0, in0 = _port_half(case, 0)
    (x, lp, ne, nc), out_calls, in_calls = _port_half(case, lag)
    assert torch.equal(x, x0) and torch.equal(lp, lp0)
    assert int(ne) == int(ne0) and int(nc) == int(nc0)
    # the lag adds up to `lag` masked iterations to each loop, never more
    # than max_steps in all
    assert out_calls == min(out0 + lag, max_steps) and in_calls == min(in0 + lag, max_steps)
    if case == "out_first":
        assert out0 == 1
    if case == "shrink_first":
        assert in0 == 1
        return
    if case == "exhausted":
        assert np.any(np.all(x.numpy() == active, axis=1))
    jx, jlp, jne, jnc = JS._slice_half(
        _lp_jax, max_steps, active, np.asarray(_lp_jax(active)), comp, jnp.float32(mu),
        l, m, expo, u0, k_sh,
    )
    assert int(ne) == int(jne) and int(nc) == int(jnc)
    npt.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-6)
    npt.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("lag,first_false,max_steps,want", [
    (0, 0, 10, 1), (0, 4, 10, 5), (2, 0, 10, 3), (2, 4, 10, 7), (3, 8, 10, 10), (10, 0, 10, 10),
])
def test_late_loop_runs_lag_iterations_past_the_end(lag, first_false, max_steps, want):
    """The condition after iteration i is read once i+1 .. i+lag are
    enqueued: a loop whose condition first fails after iteration
    ``first_false`` runs first_false + 1 + lag iterations, at most
    max_steps."""
    seen = []

    def body(it):
        seen.append(it)
        return torch.tensor(it < first_false)

    assert TS.late_loop(body, max_steps, TS.LateFlags(CPU, lag)) == want
    assert seen == list(range(want))


@pytest.mark.parametrize("lag", [1, 3])
def test_slice_chunk_samples_the_same_chain_at_every_lag(monkeypatch, lag):
    """The shrink loop's uniforms are drawn up front, max_steps rows a
    half-update, so a chunk read ``lag`` iterations late samples the lag-0
    chain bit for bit and leaves the generator where lag 0 leaves it."""
    x0 = t(walkers(8, 2, seed=5, scale=0.5))
    lp = lambda x: -0.5 * (x * x).sum(-1)  # noqa: E731
    runs = []
    for cond_lag in (0, lag):
        monkeypatch.setattr(TS, "CONDITION_LAG", cond_lag)
        g = torch.Generator().manual_seed(0)
        state, chain, lps = TS.slice_chunk(lp, TS.init_slice_state(g, x0, lp), 3, max_steps=7)
        runs.append((chain, lps, state.coords, state.n_expand, state.n_contract, g.get_state()))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# ---------------------------------------------------- the launch ledger


def test_launch_ledger_takes_back_the_capture_and_adds_every_replay():
    launches = {"fused_apply": 1, "fused_log_prob": 5}
    plain = {"fused_apply": 0, "fused_log_prob": 2}
    ledger = OG.LaunchLedger(launches, plain)
    with ledger.capturing():
        launches["fused_log_prob"] += 31  # the Python calls made while capturing
        plain["fused_apply"] += 2
    assert launches == {"fused_apply": 1, "fused_log_prob": 5}
    assert plain == {"fused_apply": 0, "fused_log_prob": 2}
    assert ledger.per_replay == [{"fused_apply": 0, "fused_log_prob": 31},
                                 {"fused_apply": 2, "fused_log_prob": 0}]
    ledger.replayed()
    ledger.replayed(3)
    assert launches == {"fused_apply": 1, "fused_log_prob": 5 + 4 * 31}
    assert plain == {"fused_apply": 4 * 2, "fused_log_prob": 2}


def test_launch_ledger_restores_the_counters_when_a_capture_fails():
    counters = {"fused_log_prob": 2}
    ledger = OG.LaunchLedger(counters)
    with pytest.raises(RuntimeError, match="capture failed"):
        with ledger.capturing():
            counters["fused_log_prob"] += 7
            raise RuntimeError("capture failed")
    assert counters == {"fused_log_prob": 2} and ledger.per_replay == [{"fused_log_prob": 7}]


@pytest.mark.parametrize("enabled", [True, False])
def test_collector_paused_restores_the_collector(enabled):
    """No cyclic collection inside a capture (a dead runner freed there
    destroys its graphs and invalidates the capture); outside, the
    collector is as it was, after an error too."""
    import gc

    was = gc.isenabled()
    (gc.enable if enabled else gc.disable)()
    try:
        with OG.collector_paused():
            assert not gc.isenabled()
        assert gc.isenabled() is enabled
        with pytest.raises(RuntimeError, match="capture failed"):
            with OG.collector_paused():
                raise RuntimeError("capture failed")
        assert gc.isenabled() is enabled
    finally:
        (gc.enable if was else gc.disable)()


def test_graphed_chunks_refuse_the_cpu():
    """The CPU runs the eager chunks; nothing falls back from a graph."""
    state = TS.init_slice_state(torch.Generator().manual_seed(0), torch.zeros(8, 2),
                                lambda x: -0.5 * (x * x).sum(-1))
    with pytest.raises(ValueError, match="CUDA device"):
        TG.graphed_chunks("zeus", lambda x: -0.5 * (x * x).sum(-1), state, 10, a=2.0,
                          n_leapfrog=10, max_depth=5, max_steps=100)


# ------------------------------------------------ double-buffered dispatch

_, LP_T = gauss_log_probs()
X0 = walkers(8, 2, seed=5, scale=0.5)
LOOSE = dict(ntimes=0, tautol=np.inf, meanshift=np.inf, stdshift=np.inf)


def _run(outdir, method, **kw):
    kw = {"check_every": 10, "seed": 4, "device": CPU, "tau_walkers": 8, **kw}
    return TR.run_ensemble(LP_T, X0, str(outdir), method=method, **kw)


def _stored(backend):
    """The chain file's chain, log-probs and acceptances, and the blob."""
    out = {"chain": np.asarray(backend.get_chain()), "log_prob": np.asarray(backend.get_log_prob())}
    if isinstance(backend, TB.EmceeBackend):
        with backend._open("r") as f:
            out["accepted"] = np.asarray(f["mcmc"]["accepted"][:])
    return out, backend.load_state()


def _assert_same(a, b):
    (sa, ba), (sb, bb) = a, b
    assert sa.keys() == sb.keys() and ba.keys() == bb.keys()
    for k in sa:
        npt.assert_array_equal(sa[k], sb[k], err_msg=k)
    for k in ba:
        npt.assert_array_equal(np.asarray(ba[k]), np.asarray(bb[k]), err_msg=k)


@pytest.mark.parametrize("method", ["emcee", "zeus", "hmc", "nuts"])
def test_stop_with_a_chunk_pending_writes_the_serial_run(tmp_path, method):
    """The convergence keys stop the run at its second tau check (20 steps)
    while chunk 3 is already dispatched: the chain file and the state blob
    (its generator state among them) are those of a run whose
    ``max_iterations`` is 20, bit for bit."""
    stopped = _run(tmp_path / "stopped", method, max_iterations=200, **LOOSE)
    serial = _run(tmp_path / "serial", method, max_iterations=20, **LOOSE)
    assert stopped.iteration == serial.iteration == 20
    a, b = _stored(stopped), _stored(serial)
    assert bool(a[1]["_converged"]) and bool(a[1]["_finished"])
    _assert_same(a, b)


@pytest.mark.parametrize("method", ["emcee", "zeus", "hmc", "nuts"])
def test_resume_after_a_cut_equals_the_uninterrupted_run(tmp_path, method):
    """A run cut after chunk 3 and resumed to 50 steps is the uninterrupted
    50-step run, bit for bit: chain, log-probs, acceptances and blob."""
    _run(tmp_path / "cut", method, max_iterations=30, convergence_check=False)
    resumed = _run(tmp_path / "cut", method, max_iterations=50, convergence_check=False)
    whole = _run(tmp_path / "whole", method, max_iterations=50, convergence_check=False)
    assert resumed.iteration == whole.iteration == 50
    _assert_same(_stored(resumed), _stored(whole))


def test_chip_smoke_phase_programs_rehearsal():
    """``chip_smoke.py`` phase 11 at a small size on the CPU: the eager
    chunks of each method and the K=4 ensemble's batched likelihood against
    the per-member loop (the graphs themselves run on a card only)."""
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parent.parent)
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    res = chip_smoke.phase_programs(
        torch.device(CPU), ndim=6, ndata=12, nwalkers=16,
        steps={"emcee": 4, "zeus": 4, "hmc": 2, "nuts": 1},
        traced={"emcee": 1, "zeus": 1, "hmc": 1, "nuts": 1}, k4_steps=2, k4_traced=1)
    assert set(res["methods"]) == {"emcee", "zeus", "hmc", "nuts"}
    assert res["k4"]["max_rel_diff"] <= chip_smoke.K4_RTOL
    assert all(r["eager_s_per_100"] > 0 for r in res["methods"].values())
