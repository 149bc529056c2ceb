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
    none = {"fused_apply": 0, "fused_log_prob": 0}
    assert launches == {"gradient": none, "emcee": none}  # no kernel on the CPU
    assert res["gradient_check"]["log10 lanes"]["-inf rows"] > 0
    assert res["gradient_check"]["mixed priors"]["abs"] <= 1e-6
    for method, steps in (("nuts", 10), ("hmc", 5), ("emcee", 20)):
        rec = res[method]
        assert rec["steps"] == steps and 0.0 <= rec["mean_acceptance"] <= 1.0
        assert (rec["sampler_s"]["precond"] > 0) == (method != "emcee")
    assert res["nuts"]["mean_acceptance"] > 0


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
    none = {"fused_apply": 0, "fused_log_prob": 0}
    assert rec["counts"]["launches"] == none and rec["gradient"]["counts"]["launches"] == none
    bf16 = C.phase_bf16(dev, str(tmp_path / "run" / "iter_0"), nensemble=2, ndim=6, ndata=8,
                        walker_counts=(16, 64), zeus_steps=10, nwalkers=16)
    assert set(bf16["log_prob"]) == {"K=2 @16", "K=2 @64", "member 0 @16", "member 0 @64"}
    assert all(0 < r["rel_err"]["max"] <= C.BF16_RTOL for r in bf16["log_prob"].values())
    assert len(bf16["zeus"]) == 4 and bf16["counts"]["launches"] == none
    assert all(r["calls_per_step"] >= 2 for r in bf16["zeus"].values())
