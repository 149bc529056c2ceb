"""chip_smoke.py's helpers, on the CPU: the kernel-time reading refuses a
profile whose device-event count differs from the launches, the bounds give
both the f32 CUDA-core and the 3xTF32 tensor-core times, the compiler's
register report is read per kernel (the profiler is replaced by fixed event
counts; the card runs the real one), and the training phase's synthetic
theory, iteration-directory check and learned check."""

import os
import pathlib
import sys

import numpy as np
import pytest
import torch

import linna_tpu_torch
from linna_tpu_torch import nn as TN

REPO = pathlib.Path(linna_tpu_torch.__file__).parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
import chip_smoke as C  # noqa: E402

torch.set_num_threads(1)

KERNEL = "(anonymous namespace)::fused_apply_kernel((anonymous namespace)::ApplyPlan)"


def _profile_gives(monkeypatch, *readings):
    """Each profiled run returns the next of ``readings`` ({name: (count, us)})."""
    it = iter(readings)
    monkeypatch.setattr(C, "_warm", lambda fn: None)
    monkeypatch.setattr(C, "_profiled_events", lambda fn, reps: next(it))


def test_device_ms_times_the_kernels_own_events(monkeypatch):
    _profile_gives(monkeypatch, {KERNEL: (30, 2700.0), "memset": (30, 90.0)})
    ms, method = C.device_ms(lambda: None, "fused_apply_kernel", reps=30)
    assert ms == pytest.approx(0.09)
    assert "30 device events of fused_apply_kernel" in method


@pytest.mark.parametrize("seen", [0, 15, 29, 31])
def test_device_ms_refuses_a_count_that_differs_from_the_launches(monkeypatch, seen):
    _profile_gives(monkeypatch, *[{KERNEL: (seen, 1635.0)}] * 3)
    with pytest.raises(AssertionError, match=f"saw {seen} device events .* not the 30 launched"):
        C.device_ms(lambda: None, "fused_apply_kernel", reps=30)


def test_kernel_ms_takes_the_mean_of_the_events_a_short_profile_recorded(monkeypatch):
    _profile_gives(monkeypatch, *[{KERNEL: (25, 2500.0), "memset": (30, 90.0)}] * 4)
    ms, method = C.kernel_ms(lambda: None, "fused_apply_kernel", reps=30)
    assert ms == pytest.approx(0.1)
    assert "mean of the 25 device events of fused_apply_kernel it recorded of 30" in method
    _profile_gives(monkeypatch, {KERNEL: (30, 2700.0)})
    assert C.kernel_ms(lambda: None, "fused_apply_kernel", reps=30)[0] == pytest.approx(0.09)
    _profile_gives(monkeypatch, *[{"memset": (30, 90.0)}] * 4)
    with pytest.raises(AssertionError, match="saw 0 device events"):
        C.kernel_ms(lambda: None, "fused_apply_kernel", reps=30)


def test_device_ms_takes_a_reading_again_after_a_short_one(monkeypatch):
    _profile_gives(monkeypatch, {KERNEL: (17, 930.0)}, {KERNEL: (60, 5400.0)})
    ms, _ = C.device_ms(lambda: None, "fused_apply_kernel", per_call=2, reps=30)
    assert ms == pytest.approx(0.18)


def test_device_ms_of_a_plain_version_times_every_event(monkeypatch):
    _profile_gives(monkeypatch, {"gemm": (330, 1200.0), "relu": (390, 270.0)})
    ms, method = C.device_ms(lambda: None, reps=30)
    assert ms == pytest.approx(0.049)
    assert "720 device events of the call's kernels" in method


def test_bounds_give_both_operation_rates():
    spec = TN.make_model_spec("chto_v2", 27, 457)
    params = TN.init_model(spec, seed=0, device="cpu")
    flops = 2.0 * TN.count_params(params) * 4096
    apply = C.bound_ms("fused_apply", spec, params, 4096)
    assert apply["f32_cuda_core_ms"] == pytest.approx(flops / 67e12 * 1e3)
    assert apply["tf32x3_tensor_core_ms"] == pytest.approx(3 * flops / 494.7e12 * 1e3)
    assert apply["ms"] == apply["tf32x3_tensor_core_ms"] and apply["by"] == "operations"
    assert apply["tf32x3_tensor_core_ms"] == pytest.approx(0.0625, abs=5e-4)
    assert C.bound_ms("fused_apply", spec, params, 256)["ms"] == pytest.approx(0.0039, abs=5e-5)
    lp = C.bound_ms("fused_log_prob", spec, params, 256)
    assert lp["ms"] == lp["f32_cuda_core_ms"] > lp["tf32x3_tensor_core_ms"]


def test_kernel_resources_reads_each_kernels_registers_and_spills():
    report = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118fused_apply_kernelENS_9ApplyPlanE' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_118fused_apply_kernelENS_9ApplyPlanE",
        "    56 bytes stack frame, 52 bytes spill stores, 52 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers, 1616 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121fused_log_prob_kernelEPKfi' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_121fused_log_prob_kernelEPKfi",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers",
    ])
    assert C.kernel_resources(report) == {
        "fused_apply": {"spill_bytes": 104, "registers": 128},
        "fused_log_prob": {"spill_bytes": 0, "registers": 128},
    }


# ------------------------------------------------- the training phase's helpers


def test_smooth_theory_is_seeded_and_called_like_a_pipeline_theory():
    a, b = C.SmoothTheory(4, 6, seed=5), C.SmoothTheory(4, 6, seed=5)
    x = np.random.default_rng(0).normal(size=(3, 4))
    assert np.array_equal(a.batch(x), b.batch(x)) and a.batch(x).shape == (3, 6)
    assert np.allclose(a([1, x[1]], "/unused"), a.batch(x)[1])
    assert np.all(np.abs(a.batch(x * 100) - 10.0) <= np.abs(a.b).sum(axis=0) + 1e-12)
    assert not np.array_equal(C.SmoothTheory(4, 6, seed=6).batch(x), a.batch(x))


def test_iteration_checks_name_each_missing_artifact(tmp_path):
    d = str(tmp_path / "iter_0")
    assert "transforms.npz" in C.iteration_missing(d, 2)
    for sub in ("", "ens_1"):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
        for f in ("best.ckpt.npz", "last.ckpt.npz", "lr.npy"):
            open(os.path.join(d, sub, f), "w").close()
    for f in ("train_samples_x.txt", "train_samples_y.npy", "val_samples_x.txt",
              "val_samples_y.npy", "transforms.npz", "finish.json"):
        open(os.path.join(d, f), "w").close()
    assert C.iteration_missing(d, 2) == []
    assert C.iteration_missing(d, 3) == [os.path.join("ens_2", f)
                                         for f in ("best.ckpt.npz", "last.ckpt.npz", "lr.npy")]
    assert C.iteration_missing(d, 2, chain=True) == ["zeus_256.h5"]
    assert C.member_dirs(d, 2) == [d, os.path.join(d, "ens_1")]


def test_learned_check():
    assert C.not_learned([0.05, 0.009], [0.9, 0.1]) == []
    assert C.not_learned([0.09, 0.01], [0.9, 0.1]) == [(0, 0.09, 0.9), (1, 0.01, 0.1)]
    assert [m for m, *_ in C.not_learned([float("nan"), float("inf"), 1e-3], [1.0] * 3)] == [0, 1]


def test_initial_and_best_val_losses_on_a_trained_iteration(tmp_path):
    """On the CPU at a small width: the phase's initial loss is the
    untrained members' val metric, and training lowers it."""
    from linna_tpu_torch import orchestrator as O
    from linna_tpu_torch import priors as P
    from linna_tpu_torch import sample_gen as SG

    ndim, ndata, seeds = 4, 6, [1234, 2234]
    theory = C.SmoothTheory(ndim, ndata)
    pack = P.priors_from_list(C.mixed_priors(ndim), "cpu")
    d = str(tmp_path / "iter_0")
    sigma = np.full(ndata, 0.1)
    data, cov = theory.batch(np.zeros((1, ndim)))[0], np.diag(sigma**2)
    SG.generate_training_point(theory, SG.NNSampler(d, P.prior_range(pack)), None, d, 200, 40,
                               data, np.linalg.inv(cov))
    O.train_emulator(d, [d], data, cov, sigma, None, False, "chto_v2",
                     {"num_epochs": 20, "batch_size": 50, "nensemble": 2}, device="cpu")
    spec = TN.make_model_spec("chto_v2", ndim, ndata)
    initial = C.initial_val_losses(d, spec, data, cov, seeds, torch.device("cpu"))
    best = C.best_val_losses(d, 2)
    assert len(initial) == len(best) == 2 and all(np.isfinite(initial))
    assert all(b < i for b, i in zip(best, initial))
    assert C.iteration_missing(d, 2) == []


# ------------------------------------- phases 6 and 7, rehearsed at small size


def test_phase_gradient_rehearsal(tmp_path):
    """Phase 6 on the CPU at 6 -> 40 (the kernel's plain version in place of
    the kernel): the gradient check, then the MAP search with NUTS, HMC and
    emcee through ``run_ensemble``."""
    res, launches = C.phase_gradient(torch.device("cpu"), str(tmp_path), nwalkers=16,
                                     nuts_steps=10, hmc_steps=5, emcee_steps=20, ndim=6, ndata=40)
    none = {"fused_apply": 0, "fused_log_prob": 0, "composition_grad": 0}
    assert launches == {"gradient": none, "emcee": none}  # no kernel on the CPU
    assert res["gradient_check"]["log10 lanes"]["-inf rows"] > 0
    assert res["gradient_check"]["mixed priors"]["abs"] <= 1e-6
    for method, steps in (("nuts", 10), ("hmc", 5), ("emcee", 20)):
        rec = res[method]
        assert rec["steps"] == steps and 0.0 <= rec["mean_acceptance"] <= 1.0
        assert (rec["sampler_s"]["precond"] > 0) == (method != "emcee")
    assert res["nuts"]["mean_acceptance"] > 0


def test_phase_composition_grad_rehearsal(tmp_path):
    """Phase 6b on the CPU at 5 -> 12: the plain version stands in for the
    kernel's calls (one plain call each, held to the composition's float64
    autograd), then NUTS at K = 2 through ``run_ensemble``, which keeps the
    composition here."""
    res = C.phase_composition_grad(torch.device("cpu"), str(tmp_path), rows=(1, 16),
                                   nuts_steps=3, nwalkers=8, ndim=5, ndata=12)
    assert sorted(res["members"]) == [1, 2]
    for rec in res["members"].values():
        assert sorted(rec["by_rows"]) == [1, 16]
        for r in rec["by_rows"].values():
            assert r["counts"]["plain_calls"]["composition_grad"] == 1
            assert not any(r["counts"]["launches"].values())
            assert r["value_gap_over_tolerance"] <= 1.0 and "ms" not in r
    nuts = res["nuts"]
    assert nuts["members"] == 2 and nuts["steps"] == 3 and nuts["precond_s"] > 0
    assert not any(nuts["counts"]["launches"].values())
    assert not any(nuts["counts"]["plain_calls"].values())
    assert nuts["launches_per_traced_sample"] == 0


TINY_THEORY = """
from examples.des_theory import SyntheticSurveyTheory

_T = SyntheticSurveyTheory(3, 12, 8, seed=1)
NDIM, NDATA = 3, 12
data_vector, noise_sigma, fiducial = _T.data_vector, _T.noise_sigma, _T.fiducial
cov_triplet_rows = _T.cov_triplet_rows


def make_theory(params):
    return _T
"""


def test_phase_driver_rehearsal(tmp_path, monkeypatch):
    """Phase 7 on the CPU: des_synthetic.yaml with the phase's cuts, through
    ``python -m linna_tpu_torch.driver ... --device cpu``, on a 3 -> 12
    theory of the same family with one emulator (its own exact posterior
    stands in)."""
    import json

    (tmp_path / "tiny_theory.py").write_text(TINY_THEORY)
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the driver's process, beside the other workers
    exact = tmp_path / "exact.json"
    exact.write_text(json.dumps({"exact_mean": [0.05] * 3, "exact_std": [1.0] * 3}))
    overrides = {
        "theory": "tiny_theory:make_theory", "nwalkers": 8, "ntrainArr": [40, 40],
        "nvalArr": [10, 10], "batch_size": 20, "nensemble": 1,
        "sampled_params": [{"param": f"p{i}", "dist": "flat", "arg1": -1.0, "arg2": 1.0}
                           for i in range(3)],
    }
    res = C.phase_driver(torch.device("cpu"), str(tmp_path / "p7"), epochs=4,
                         theory_mod="tiny_theory", overrides=overrides, exact=str(exact))
    assert set(res["cuts"]) >= {"iterations", "methodArr", "temperatureArr", "num_epochs",
                                "ntimesArr", "ntautolArr", "meanshiftArr", "stdshiftArr",
                                "outdir"}
    rows = res["report"]["iterations"]
    assert [r["method"] for r in rows] == ["zeus", "nuts"]
    assert all(r["compute_dtype"] == "torch.bfloat16" and r["epochs_run"] == 4 for r in rows)
    assert rows[1]["sampler_s"]["precond"] > 0 and rows[1]["steps"] == 200
    bias = res["report"]["bias"]
    assert len(bias["bias_sigma"]) == 3 and np.isfinite(bias["bias_sigma"]).all()
    assert res["store"].endswith("chemcee_256.h5")


def test_phase_premodel_and_bf16_rehearsal(tmp_path):
    """Phase 8 on the CPU at 6 -> 8 (hidden 256): the pre-model pipeline
    (K=2, bf16 training, zeus at T = 1 to its second tau check), NUTS
    through member 0 and its pre-model with the Hessian at the MAP point,
    then bf16 inference on the trained iteration; no path reaches a kernel
    or its plain version."""
    dev = torch.device("cpu")
    rec = C.phase_premodel(dev, str(tmp_path), ndim=6, ndata=8, ntrain=600, nval=60,
                           epochs=100, nensemble=2, nwalkers=16, nuts_steps=4, wrapper_rows=32)
    assert rec["compute_dtype"] == "torch.bfloat16" and rec["epochs_run"] == 100
    assert rec["zeus_steps"] == 200 and rec["npc"] >= 1 and rec["monomials"] == 28
    assert rec["wrapper_check"]["abs"] <= 1e-6 and rec["fit_traced_peak_bytes"] > 0
    assert rec["gradient"]["steps"] == 4 and rec["gradient"]["precond_s"] > 0
    assert rec["gradient"]["hessian_asymmetry"] <= 1e-3
    none = {"fused_apply": 0, "fused_log_prob": 0, "composition_grad": 0}
    assert rec["counts"]["launches"] == none and rec["gradient"]["counts"]["launches"] == none
    bf16 = C.phase_bf16(dev, str(tmp_path / "run" / "iter_0"), nensemble=2, ndim=6, ndata=8,
                        walker_counts=(16, 64), zeus_steps=10, nwalkers=16)
    assert set(bf16["log_prob"]) == {"K=2 @16", "K=2 @64", "member 0 @16", "member 0 @64"}
    assert all(0 < r["rel_err"]["max"] <= C.BF16_RTOL for r in bf16["log_prob"].values())
    assert len(bf16["zeus"]) == 4 and bf16["counts"]["launches"] == none
    assert all(r["calls_per_step"] >= 2 for r in bf16["zeus"].values())


# ------------------------------------------- phase 9, rehearsed at small size


def test_phase_multiprocess_rehearsal(tmp_path, monkeypatch):
    """Phase 9 on the CPU: 9a a one-rank gloo group (nccl on the card)
    against no group, bit for bit; 9b ``python -m linna_tpu_torch.launch``
    as two gloo ranks on des_synthetic.yaml cut to one iteration at K=4 on a
    3 -> 12 theory, rank 1 writing nothing; 9c two data ranks' K=1 training,
    sharded emcee and NUTS against one rank, and the census."""
    cpu = torch.device("cpu")
    (tmp_path / "tiny_theory.py").write_text(TINY_THEORY)
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    a = C.phase_nccl(cpu, str(tmp_path / "9a"), steps=10, ndim=6, ndata=40, nwalkers=16)
    assert a["backend"] == "gloo" and a["emcee_equal_bit_for_bit"] and all(a["checks"].values())
    assert a["collectives"]["all_gather@world"] == 2  # one call, one in fetch
    overrides = {"theory": "tiny_theory:make_theory", "nwalkers": 8, "ntrainArr": [40],
                 "nvalArr": [10], "batch_size": 20,
                 "sampled_params": [{"param": f"p{i}", "dist": "flat", "arg1": -1.0,
                                     "arg2": 1.0} for i in range(3)]}
    b = C.phase_launch(cpu, str(tmp_path / "9b"), epochs=4, theory_mod="tiny_theory",
                       overrides=overrides, timeout=300)
    assert b["writes_rank1"] == 0 and b["writes_rank0"] > 0 and b["steps"] == 200
    assert b["log_prob_check"]["abs"] <= 1e-4
    assert all(c.get("all_gather@world", 0) >= 400 for c in b["collectives"])  # zeus, sharded
    c = C.phase_data_parallel(cpu, str(tmp_path / "9c"), ndim=6, ndata=40, ntrain=400, nval=50,
                              depths=(1, 3), nwalkers=16, steps=20, nuts_steps=3, timeout=300)
    # the forward is row-independent here; the CPU's backward is not
    assert c["row_independent"]["emcee"] and c["chains"]["emcee"]["bit_for_bit"]
    assert all(v["max_abs_chain_diff"] <= 1e-6 for v in c["chains"].values())
    assert c["train"]["first_step_grad_max_diff_over_max"] <= 1e-6
    for e in (1, 3):
        assert c["train"]["two_vs_one"][e]["pred_diff_over_pred_std"]["max"] <= 1e-4
    assert c["train"]["one_vs_one_again"]["pred_diff_over_pred_std"]["max"] == 0.0
    assert all(n == 0 for v in c["chains"].values() for n in v["walkers_apart_by_sample"])
    assert c["train_collectives_rank0"]["all_reduce@data[0,1]"] > 0
    assert c["census"]["sampler"]["emcee"]["per_step"] == {"all_gather@world": 2.0}


# ------------------------------------------ phase 10, rehearsed at small size


def test_phase_rest_rehearsal(tmp_path, monkeypatch):
    """Phase 10 on the CPU at 6 -> 40 (hidden 1000, so the tensor-parallel
    trunk splits 125 into 63 + 62): 10a two gloo ranks' tensor-parallel
    epoch against one rank and a one-rank gloo group's step bit for bit;
    10b speculative dispatch on and off; 10c the gradient helper, the
    Hessian against phase 6's preconditioner and the fused Hessian refused;
    10d one use_fused iteration in fresh processes, warming on and off
    (nothing is built off the card, so the broken-compiler run is the card's
    alone); 10e pod_accept."""
    cpu = torch.device("cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    grad, _ = C.phase_gradient(cpu, str(tmp_path / "p6"), nwalkers=16, nuts_steps=4,
                               hmc_steps=2, emcee_steps=4, ndim=6, ndata=40)
    res = C.phase_rest(
        cpu, str(tmp_path / "p10"), grad.pop("map"),
        rows={"ndim": 6, "ndata": 40, "ntrain": 400, "nval": 50, "batch": 50},
        speculative={"epochs": 12, "nensemble": 2, "traced_epochs": 6,
                     "epochs_per_dispatch": 3, "traced_chunk": 2},
        helpers={"rows": 16, "ndim": 6, "ndata": 40},
        precompile={"ndim": 3, "ndata": 8, "ntrain": 100, "nval": 20, "epochs": 3,
                    "nwalkers": 16},
        pod_accept={"device_arg": "cpu"})
    a = res["10a"]
    assert a["mesh"] == {"data": 1, "model": 2} and a["steps"] == 8
    assert a["losses_max_rel"] <= 1e-5 and a["one_rank_group"]["equal_bit_for_bit"]
    assert a["one_rank_group"]["backend"] == "gloo" and a["one_rank_group"]["groups_made"]
    assert a["census"]["per_step"]["all_gather@model[0,1]"] == 3
    assert a["first_step"]["loss_rel"] <= C.TP_STEP_RTOL
    assert a["first_step"]["grad_max_diff_over_max"] <= C.TP_GRAD_RTOL
    assert a["params_apart"]["max"] <= a["params_apart"]["limit_max"]
    b = res["10b"]
    assert b["on"]["speculated"] > 0 and b["off"]["speculated"] == 0
    assert b["on"]["dropped"] > 0 or b["equal_bit_for_bit"]
    assert set(b["on"]["phase_s"]) >= {"dispatch", "wait_fetch", "supervisor", "save"}
    c = res["10c"]
    assert c["gradient"]["abs"] <= 1e-5 and c["neg_inf_rows_zero_gradient"] >= 8
    assert c["hessian_max_rel_to_precond"] <= C.HESS_RTOL
    assert "forward-mode" in c["fused_hessian_refused"]
    d = res["10d"]
    assert d["warm"]["warm"] == {} and d["cold"]["warm"] == {}  # no thread off the card
    assert d["warm"]["nvcc_s"] == 0.0 and d["warm"]["launches"]["fused_log_prob"] == 0
    e = res["10e"]
    assert e["rc"] == 0 and e["verdict"]["pass"] and e["verdict"]["device"] == "cpu"


# ------------------------------------------ phase 12, rehearsed at small size


def test_phase_train_programs_rehearsal(tmp_path):
    """Phase 12 on the CPU at 4 -> 8 (hidden 256), 400 / 50 rows and 800 /
    100 for 12b, minibatches of 50: every case's program against the eager
    program (both eager here, so bit for bit by construction), the range
    test, the planted hyper, reinit and reload each dropping a speculated
    chunk, and no kernel launch or plain call."""
    res = C.phase_train_programs(torch.device("cpu"), str(tmp_path), ndim=4, ndata=8,
                                 ntrain=400, nval=50, batch=50, flagship_rows=(800, 100),
                                 epochs={"12a": 2, "12b": 2, "12c": 2},
                                 traced={"12a": 1, "12b": 1, "12c": 1})
    for key, members, rows, dtype in (("12a", 4, 400, "torch.float32"),
                                      ("12b", 2, 800, "torch.bfloat16"),
                                      ("12c", 1, 400, "torch.float32")):
        r = res[key]
        assert r["bit_for_bit"] and not r["graphed"] and r["graphs"] == 0
        assert (r["members"], r["rows"], r["compute_dtype"]) == (members, rows, dtype)
        assert r["minibatches_per_epoch"] == rows // 50 and r["replays_per_epoch"] == 0
        assert r["pre_model"] == (key == "12c")
        assert r["graphed_traced"]["device_busy_share"] is None  # no device here
    assert res["12d"]["bit_for_bit"] and res["12d"]["params_put_back"]
    e = res["12e"]
    assert e["bit_for_bit"] and e["speculation"]["graphed"]["dropped"] == 3
    # each dropped chunk's epochs run once more
    assert e["graphs"]["epochs"] == C.PLANTED_EPOCHS + 3 * C.PLANTED_CHUNK
    assert not e["graphs"]["graphed"]
    assert "capture" in e["phase_s"]["graphed"]
    assert not any(res["launches"].values()) and not any(res["plain_calls"].values())


# ------------------------------------------------ phase 13, rehearsed at small size


def test_phase_scripts_rehearsal(tmp_path, monkeypatch):
    """Phase 13 on the CPU: the walkthrough; ``bench_full_torch.main`` on
    des_synthetic.yaml with the phase's cuts (two iterations, one emulator
    with ``use_fused``) on the 3 -> 12 theory of ``tests/_torch_tiny_theory.py``,
    where the kernel's plain version runs on every iteration in its place;
    the NUTS demo on its last iteration; and the exact posterior of the same
    theory against a stand-in stored file."""
    import json

    import yaml

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    priors = [{"param": f"p{i}", "dist": "flat", "arg1": -1.0, "arg2": 1.0} for i in range(3)]
    stored = tmp_path / "exact.json"
    stored.write_text(json.dumps({"exact_mean": [0.05] * 3, "exact_std": [0.5] * 3,
                                  "split_half_mc_err_sigma_max": 0.01, "n_steps": 250}))
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(yaml.safe_dump({"sampled_params": priors}))
    overrides = {"theory": "_torch_tiny_theory:make_theory", "nwalkers": 8,
                 "ntrainArr": [40, 40], "nvalArr": [10, 10], "batch_size": 20,
                 "sampled_params": priors}
    demo = {"m_adapt": 4, "nuts_warmup": 4, "nuts_steps": 8, "tune_rounds": 1,
            "tune_steps": 10, "slice_steps": 20}
    res = C.phase_scripts(torch.device("cpu"), str(tmp_path / "p13"),
                          lsst=("_torch_tiny_theory", "examples/des_synthetic.yaml"), epochs=4,
                          lsst_overrides=overrides, exact_path=str(stored),
                          polish={"polish_rounds": 1, "polish_steps": 20}, demo_steps=demo,
                          exact_mod="_torch_tiny_theory", exact_steps=10,
                          exact_yaml=str(cfg), stored_path=str(stored),
                          checked={(1, 3, 12), (4, 3, 12), (8, 3, 12)})
    assert res["13a"]["chain"][1] == 2
    b = res["13b"]
    assert set(b["cuts"]) >= {"ntrainArr", "methodArr", "temperatureArr", "num_epochs",
                              "ntimesArr", "nensemble", "use_fused", "polish_rounds"}
    its = [(r["iteration"], r["method"]) for r in b["by_iteration"]]
    assert its == [(0, "zeus"), (1, "nuts")]
    assert all(r["plain_calls"]["fused_log_prob"] > 0 for r in b["by_iteration"])
    assert not any(b["counts"]["launches"].values())
    # the MAP search's one row, zeus's half-ensemble and NUTS's whole one
    assert b["shapes"] == [(1, 3, 12), (4, 3, 12), (8, 3, 12)]
    assert C.unchecked_shapes(b["shapes"], {(1, 3, 12)}) == [(4, 3, 12), (8, 3, 12)]
    assert C.unchecked_shapes(b["shapes"], None) == []
    assert b["result"]["ndim"] == 3 and "max_emulator_bias_sigma" in b["result"]
    assert res["13c"]["steps"] == demo and res["13c"]["demo"]["agree_sigma"] >= 0
    d = res["13d"]
    assert d["n_steps"] == 10 and d["against_stored"]["n_steps"]["stored"] == 250
    assert np.isfinite(d["against_stored"]["max_mean_diff_sigma"])


# ------------------------------------------------ phase 14, rehearsed at small size


def test_phase_bench_scripts_rehearsal(tmp_path, monkeypatch):
    """Phase 14 on the CPU: the seven measurement scripts with the phase's
    cuts at small widths (the sampling scripts at 5 -> 8, the training
    scripts at 4 -> 8 on 2,000 rows, the all-options pipeline on the 3 -> 12
    theory of ``tests/_torch_tiny_theory.py``), where ``fused_log_prob``'s
    plain version runs in place of the kernel at each walker count, no other
    script reaches either kernel, and the option artifacts are written."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr("bench_torch_common.tempfile.gettempdir", lambda: str(tmp_path))
    train = {"n_train": 2000, "n_val": 50, "ndim": 4, "ndata": 8}
    small = {
        "bench_torch": {"walkers": 16, "shape": (5, 8), "baseline_evals": 10, "probe_n": 32,
                        "chunks_per_rep": 1},
        "bench_fused_torch": {"walker_counts": (8, 32), "shape": (5, 8), "raw_reps": 2},
        "bench_bf16_torch": {"walker_counts": (8,), "lsst_walkers": (8,), "shape": (5, 8),
                             "lsst": (6, 12), "accuracy_walkers": 16},
        "bench_train_torch": {"epochs": 1, **train},
        "bench_train_profile_torch": {"epochs": 1, **train},
        "bench_dispatch_torch": {"epochs": 10, **train, "batch": 250},
        "bench_allopts_torch": {"theory_mod": "_torch_tiny_theory", "schedule": {
            "ntrain": 80, "nval": 20, "epochs": 5, "nimp": 40, "nbest": 10, "nwalkers": 8,
            "batch_size": 20, "temperatures": [2.0, 1.0]}},
    }
    cuts = C.bench_cuts(small)
    # the phase's cuts stay where the rehearsal does not replace them
    assert cuts["bench_torch"]["reps"] == 2 and cuts["bench_fused_torch"]["reps"] == 1
    assert cuts["bench_allopts_torch"]["schedule"]["n_iter"] == 2
    assert cuts["bench_allopts_torch"]["min_ess"] is None
    res = C.phase_bench_scripts(torch.device("cpu"), str(tmp_path / "p14"), small)
    assert set(res) == set(cuts)
    fused = res["bench_fused_torch"]
    assert [r["walkers"] for r in fused["result"]["rows"]] == [8, 32]
    assert fused["counts"]["plain_calls"]["fused_log_prob"] == sum(
        r["fused_counts"]["plain_calls"] for r in fused["result"]["rows"]) + 4  # + the checks
    assert not any(fused["counts"]["launches"].values())
    assert len(res["bench_torch"]["result"]["rates"]) == 2
    assert res["bench_dispatch_torch"]["result"]["serial"]["epochs_run"] == 10
    allopts = res["bench_allopts_torch"]["result"]
    assert all(allopts["artifacts"].values()) and allopts["chain_finite"]
    assert (tmp_path / "p14" / "allopts" / "iter_1" / "zeus_256.h5").exists()
    assert sorted(os.listdir(tmp_path / "p14")) == sorted(
        ["allopts", "history.json"] + [f"{n}.json" for n in cuts if n != "bench_allopts_torch"])


# ------------------------------------------------ phase 15, rehearsed at small size


def test_phase_acceptance_rehearsal(tmp_path, monkeypatch):
    """Phase 15 on the CPU: the 2-D acceptance run at its tiny budget (the
    other two run so in ``tests/test_torch_acceptance.py``), the notebook's
    code cells with its pipeline cut (40 / 10 points, 5 epochs, each sampler
    to its second convergence check) and ``bench_scaling_torch`` at one
    epoch, 64 walkers and two gloo ranks, the pins not applied: neither
    kernel nor its plain version runs, and the card's checks of the scaling
    result hold for the CPU."""
    import functools
    import json

    sys.path.insert(0, str(REPO / "tests"))
    import _torch_acceptance as A
    from linna_tpu_torch.samplers import run as TR

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr("bench_torch_common.tempfile.gettempdir", lambda: str(tmp_path))
    monkeypatch.setattr(TR, "run_ensemble",
                        functools.partial(TR.run_ensemble, check_every=A.TINY_CHECK_EVERY))
    nb = json.loads((REPO / C.NOTEBOOK).read_text())
    inf2 = "[float('inf')] * 2"
    cuts = {"ntrainArr=[400, 400], nvalArr=[80, 80]": "ntrainArr=[40, 40], nvalArr=[10, 10]",
            "ntimesArr=[8, 15], ntautolArr=[0.2, 0.1]": f"ntimesArr=[0, 0], ntautolArr={inf2}",
            "meanshiftArr=[0.5, 0.5], stdshiftArr=[0.5, 0.5]":
                f"meanshiftArr={inf2}, stdshiftArr={inf2}",
            '"num_epochs": 300': '"num_epochs": 5'}
    for cell in nb["cells"]:
        src = "".join(cell["source"])
        for old, new in cuts.items():
            if old in src:
                src = src.replace(old, new)
                cuts[old] = None
        cell["source"] = src
    assert not any(cuts.values()), cuts
    (tmp_path / "nb.ipynb").write_text(json.dumps(nb))
    name = "posterior_accuracy_2d_gaussian"
    res = C.phase_acceptance(torch.device("cpu"), str(tmp_path / "p15"),
                             budgets={name: A.TINY_BUDGETS[name]}, pins=False,
                             notebook=str(tmp_path / "nb.ipynb"),
                             scaling={"epochs": 1, "max_ranks": 2, "backend": "gloo",
                                      "walkers": 64, "chunk": 5, "reps": 2})
    assert set(res) == {name, "notebook", "bench_scaling"}
    for r in res.values():
        assert not any(r["counts"]["launches"].values())
        assert not any(r["counts"]["plain_calls"].values())
    assert res[name]["chain"][1] == 2 and set(res[name]["pins"]) == {
        "each mean within 0.25 sigma", "each std within 0.35 sigma"}
    assert [r["iteration"] for r in res[name]["record"] if r["phase"] == "mcmc"] == [0, 1, 2]
    lines = res["notebook"]["lines"]
    assert [ln.split(" ")[0] for ln in lines] == ["posterior", "grad"], lines
    scaling = res["bench_scaling"]
    assert [r["k"] for r in scaling["trainer"]] == [2, 4]
    assert [(r["devices"], r["backend"]) for r in scaling["sampler"]] == [(1, None), (2, "gloo")]
    assert scaling["census"]["sampler_hlo"]["world"] == 2
