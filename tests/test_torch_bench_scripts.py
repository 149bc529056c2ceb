"""The port's sampling measurement scripts on the CPU: ``bench_torch_common``,
``bench_torch.py``, ``bench_fused_torch.py`` and ``bench_bf16_torch.py``
against the JAX package and its scripts.  ``build_problem`` with the JAX
``_build_problem``'s weights and data carried across gives its log-prob;
one stretch chunk with injected draws takes its steps; each script's
``main`` runs at a small width with ``device="cpu"`` and prints the JAX
script's keys; and nothing lands at the repository root."""

import json
import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import linna_tpu_torch
from linna_tpu.samplers import stretch as JS
from linna_tpu_torch.samplers import stretch as TS

REPO = pathlib.Path(linna_tpu_torch.__file__).parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
import bench_bf16_torch as BB  # noqa: E402
import bench_fused_torch as BF  # noqa: E402
import bench_torch as B  # noqa: E402
import bench_torch_common as BC  # noqa: E402
from __graft_entry__ import _build_problem  # noqa: E402

torch.set_num_threads(1)

SHAPE = (5, 8)  # hidden 256


def _problems(seed=0):
    """JAX's ``_build_problem`` and the port's ``build_problem`` on its
    weights and data."""
    spec, params, transforms, pack, data, inv_cov, lp_j = _build_problem(*SHAPE, seed=seed)
    pb = BC.build_problem(*SHAPE, device="cpu", params=jax.device_get(params),
                          data=np.asarray(data))
    return lp_j, pb, np.asarray(data), inv_cov


@pytest.mark.parametrize("seed", [0, 3])
def test_build_problem_gives_the_jax_log_prob(seed):
    """Same weights and data: the same problem (identity transforms, flat
    priors on [-2, 2], an identity inverse covariance) and log-prob within
    rtol 1e-5 (float32 sums in another order), rows far outside the prior's
    bulk included."""
    lp_j, pb, data, inv_cov = _problems(seed)
    npt.assert_array_equal(pb.data, data)
    npt.assert_array_equal(pb.inv_cov, inv_cov)
    npt.assert_array_equal(pb.pack.arg1.numpy(), -2.0)
    npt.assert_array_equal(pb.pack.arg2.numpy(), 2.0)
    x = np.random.default_rng(seed).normal(size=(33, SHAPE[0])).astype(np.float32) * 2.0
    want = np.asarray(lp_j(jnp.asarray(x)))
    got = pb.log_prob(torch.as_tensor(x)).numpy()
    assert np.isfinite(want).all()
    npt.assert_allclose(got, want, rtol=1e-5)


def test_build_problem_from_seeds_is_the_same_problem_everywhere():
    a, b = BC.build_problem(*SHAPE, seed=2, device="cpu"), BC.build_problem(*SHAPE, seed=2,
                                                                            device="cpu")
    x = BC.walkers(16, SHAPE[0], "cpu")
    assert torch.equal(a.log_prob(x), b.log_prob(x))
    npt.assert_allclose(np.std(BC.build_problem(5, 4000, device="cpu").data), 0.1, rtol=0.05)


def test_stretch_chunk_with_injected_draws_matches_jax():
    """One chunk of the bench's stretch move on the shared problem, the same
    draws in both packages: the same acceptances, the chain and log-probs
    within rtol 1e-5 (the log-prob's float32 sums)."""
    lp_j, pb, _, _ = _problems()
    w, d, nsteps = 16, SHAPE[0], 8
    half = w // 2
    x0 = BC.walkers(w, d, "cpu").numpy() * 0.5
    rng = np.random.default_rng(7)
    partners = rng.integers(0, half, (nsteps, 2, half))
    us = rng.uniform(size=(nsteps, 2, half)).astype(np.float32)
    ln_u = np.log(rng.uniform(size=(nsteps, 2, half))).astype(np.float32)
    lp0 = np.array(lp_j(jnp.asarray(x0)))
    (c_j, l_j, a_j), (ch_j, lps_j) = JS._stretch_scan(
        lp_j, 2.0, d, nsteps,
        (jnp.asarray(x0.reshape(2, half, d)), jnp.asarray(lp0.reshape(2, half)),
         jnp.zeros((2, half), jnp.int32)),
        (jnp.asarray(partners), jnp.asarray(us), jnp.asarray(ln_u)), lambda x: x, None)
    (c_t, l_t, a_t), (ch_t, lps_t) = TS.stretch_steps(
        pb.log_prob, BC.STEP_OPTIONS["a"],
        (torch.as_tensor(x0.reshape(2, half, d)), torch.as_tensor(lp0.reshape(2, half)),
         torch.zeros((2, half), dtype=torch.int32)),
        (torch.as_tensor(partners), torch.as_tensor(us), torch.as_tensor(ln_u)))
    npt.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    assert 0 < int(a_t.sum()) < nsteps * w
    npt.assert_allclose(ch_t.numpy(), np.asarray(ch_j), rtol=1e-5, atol=1e-6)
    npt.assert_allclose(lps_t.numpy(), np.asarray(lps_j), rtol=1e-5, atol=1e-5)


def test_stretch_rate_runs_the_eager_chunk_on_the_cpu():
    pb = BC.build_problem(*SHAPE, device="cpu")
    r = BC.stretch_rate(pb.log_prob, 16, SHAPE[0], "cpu", chunk=10, reps=3, chunks_per_rep=2,
                        warm=1)
    assert r["path"] == "eager" and r["finite"] and len(r["rates"]) == 3
    assert r["best"] == max(r["rates"]) and r["best"] >= r["median"] > 0 and r["iqr"] >= 0


def test_command_line_and_result_path(tmp_path, monkeypatch):
    assert BC.parse_argv(["--device", "cpu", "f32", "ndim=40", "out=x.json"]) == (
        "cpu", {"ndim": "40", "out": "x.json"}, ["f32"])
    assert BC.int_list({"walkers": "128,16384"}, "walkers", ()) == (128, 16384)
    assert BC.int_list({"walkers": ""}, "walkers", (1,)) == ()
    assert BC.int_list({}, "walkers", (1,)) == (1,)
    monkeypatch.setattr(BC.tempfile, "gettempdir", lambda: str(tmp_path))
    d = BC.run_dir("bench")
    assert d == str(tmp_path / "linna_bench_torch")
    assert BC.result_path(d, None, "R.json") == os.path.join(d, "R.json")
    assert BC.result_path(d, "sub/r.json", "R.json") == os.path.join(d, "sub", "r.json")
    outside = tmp_path / "elsewhere.json"
    assert BC.result_path(d, str(outside), "R.json") == str(outside)
    outside.write_text("{}")
    with pytest.raises(FileExistsError, match="never overwrite"):
        BC.result_path(d, str(outside), "R.json")


def _json_lines(out: str) -> list:
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def _listing():
    return sorted(p for p in os.listdir(REPO) if p != "__pycache__")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each script's main at a small width, its printed lines captured, the
    repository root listed before and after."""
    import contextlib
    import io

    tmp = tmp_path_factory.mktemp("bench_scripts")
    before = _listing()
    mp = pytest.MonkeyPatch()
    mp.setattr(BC.tempfile, "gettempdir", lambda: str(tmp))
    out = {}
    try:
        calls = {
            "bench": lambda: B.main("cpu", reps=3, chunks_per_rep=1, walkers=16,
                                    history=str(tmp / "history.json"), shape=SHAPE,
                                    baseline_evals=10, probe_n=32),
            "fused": lambda: BF.main("cpu", (8, 32), reps=1, raw_reps=2, shape=SHAPE),
            "bf16": lambda: BB.main("cpu", (8,), (2,), (8,), reps=1, accuracy_walkers=16,
                                    ensemble_walkers=8, shape=SHAPE, lsst=(6, 12)),
        }
        for name, call in calls.items():
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                res = call()
            out[name] = {"res": res, "lines": buf.getvalue().splitlines()}
    finally:
        mp.undo()
    return {"out": out, "tmp": tmp, "before": before, "after": _listing()}


def test_bench_prints_bench_py_keys(runs):
    r = runs["out"]["bench"]
    assert r["lines"][0] == "device: cpu"
    res = _json_lines("\n".join(r["lines"]))[-1]
    # bench.py's result keys (bench.py:296-316) plus the port's
    assert {"metric", "value", "unit", "vs_baseline", "median", "iqr", "probe_tflops",
            "history", "note"} <= set(res)
    assert res["metric"] == "emulator_loglike_evals_per_sec" and res["unit"] == "evals/s"
    assert res["device"] == "cpu" and res["path"] == "eager" and res["chain_finite"]
    assert res["value"] == max(res["rates"]) > 0 and res["baseline_evals_per_sec"] > 0
    # one entry: this run is its own pin (the verdict's regime is the host's)
    assert res["history"] == [res["value"]] and "100% of pinned" in res["note"]
    assert (runs["tmp"] / "linna_bench_torch" / B.RESULT_FILE).is_file()
    assert len(json.loads((runs["tmp"] / "history.json").read_text())) == 1


def test_bench_classify_separates_host_noise_from_code():
    history = [{"best": 100.0, "probe": 10.0}, {"best": 80.0, "probe": 5.0}]
    noisy = B._classify({"best": 80.0, "median": 70.0, "iqr": 5.0}, 5.0, history)
    assert noisy.startswith("host noisy AND best-of-N down")
    history[-1]["probe"] = 10.0
    slower = B._classify({"best": 80.0, "median": 79.0, "iqr": 1.0}, 10.0, history)
    assert slower.startswith("probe at par but best-of-N down")


def test_bench_history_lives_in_an_ignored_directory():
    ignored = (REPO / ".gitignore").read_text().split()
    rel = os.path.relpath(B.HISTORY_FILE, REPO)
    assert rel.split(os.sep)[0] + "/" in ignored


def test_fused_checks_every_count_and_counts_the_plain_version_on_the_cpu(runs):
    res = runs["out"]["fused"]["res"]
    rows = _json_lines("\n".join(runs["out"]["fused"]["lines"]))
    # bench_fused.py's row keys (bench_fused.py:99-112)
    keys = {"walkers", "xla_chunk_evals_s", "fused_chunk_evals_s", "xla_raw_evals_s",
            "fused_raw_evals_s", "chunk_speedup", "raw_speedup"}
    assert [r["walkers"] for r in rows[:2]] == [8, 32] and all(keys <= set(r) for r in rows[:2])
    assert {"shape", "device", "max_rel_err_vs_xla", "rows"} <= set(rows[-1])
    # every count and its half (a chunk's half-ensemble) checked before it is timed
    assert res["checked_rows"] == [4, 8, 16, 32] and res["max_rel_err_vs_xla"] < BF.RTOL
    # the CPU runs the kernel's plain version in its place, never a launch
    assert all(r["fused_counts"]["plain_calls"] > 0 == r["fused_counts"]["launches"]
               for r in res["rows"])
    assert [s[0] for s in res["shapes_launched"]] == [4, 8, 16, 32]


def test_fused_refuses_a_disagreement():
    lp = BC.build_problem(*SHAPE, device="cpu").log_prob
    with pytest.raises(AssertionError, match="disagree at 8 rows"):
        BF.check(lambda x: lp(x) * 1.01, lp, 8, SHAPE[0], "cpu")


def test_bf16_rows_and_no_kernel(runs):
    res = runs["out"]["bf16"]["res"]
    # bench_bf16.py's keys (bench_bf16.py:67-126)
    assert {"shape", "device", "accuracy", "rows", "regime_rows"} <= set(res)
    assert {"median_abs_dlogp", "p95_abs_dlogp"} <= set(res["accuracy"])
    assert 0 < res["accuracy"]["median_abs_dlogp"] <= res["accuracy"]["p95_abs_dlogp"] < 0.05
    assert [r.get("case") for r in res["regime_rows"]] == ["ensemble_K2", "lsst_6x12"]
    for r in res["rows"] + res["regime_rows"]:
        assert r["speedup"] == round(r["bf16_chunk_evals_s"] / r["f32_chunk_evals_s"], 3)
    assert res["kernels"].startswith("none")


def test_nothing_is_written_at_the_repository_root(runs):
    assert runs["after"] == runs["before"]
    for name in ("bench", "bench_fused", "bench_bf16"):
        assert (runs["tmp"] / f"linna_{name}_torch").is_dir()
