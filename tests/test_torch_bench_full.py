"""``bench_full_torch.py`` on the CPU: the flagship gate's pipeline, run
through the port on a 3 -> 12 theory of the flagship's family with
``des_synthetic.yaml``'s schedule cut to two iterations (zeus, then NUTS) and
a few epochs.  The result has ``bench_full.py``'s keys; its R-hat is the JAX
package's ``gelman_rubin`` of the stored chain; its emulator bias is the
chain's distance to an exact posterior written here; ``--check`` passes at a
large threshold and exits 1 at a tiny one; and nothing lands at the
repository root."""

import json
import os
import pathlib
import sys

import numpy as np
import pytest
import torch
import yaml

import linna_tpu_torch
from linna_tpu.samplers import backends as JB
from linna_tpu.samplers import convergence as JC

REPO = pathlib.Path(linna_tpu_torch.__file__).parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
import bench_full_torch as B  # noqa: E402

torch.set_num_threads(1)

THEORY = "_torch_tiny_theory"
# bench_full.py's result keys (bench_full.py:213-250) with an exact posterior
KEYS = {"metric", "value", "unit", "phases_s", "max_split_rhat", "polish_to_rhat_s",
        "polish_rounds", "max_posterior_err_sigma", "median_posterior_err_sigma",
        "max_emulator_bias_sigma", "median_emulator_bias_sigma", "final_chain_steps",
        "nwalkers", "ndim", "ndata", "config"}
EXACT = {"exact_mean": [0.04, 0.06, 0.05], "exact_std": [0.5, 0.4, 0.6]}
POLISH = dict(polish_rounds=2, polish_steps=100)
INF = float("inf")


def _config(path):
    """des_synthetic.yaml's keys at a test's size: 2 iterations, zeus then
    NUTS, 4 epochs, each sampler stopped at its second tau check (200 steps)."""
    cfg = {
        "theory": f"{THEORY}:make_theory", "data_file": "data.txt",
        "cov_file": "cov_triplet.txt", "nwalkers": 8, "nnmodel": "chto_v2",
        "trainingoption": 1, "num_epochs": 4, "batch_size": 20, "nensemble": 2,
        "methodArr": ["zeus", "nuts"], "ntrainArr": [40, 40], "nvalArr": [10, 10],
        "nkeepArr": [2, 2], "ntimesArr": [0, 0], "ntautolArr": [INF, INF],
        "meanshiftArr": [INF, INF], "stdshiftArr": [INF, INF], "temperatureArr": [2.0, 1.0],
        "seed": 11,
        "sampled_params": [{"param": f"p{i}", "dist": "flat", "arg1": -1.0, "arg2": 1.0}
                           for i in range(3)],
    }
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _listing():
    return sorted(p for p in os.listdir(REPO) if p != "__pycache__")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("bench_full")
    exact = d / "exact.json"
    exact.write_text(json.dumps(EXACT))
    kw = dict(theory_mod=THEORY, config_yaml=_config(d / "tiny.yaml"), device="cpu",
              exact_path=str(exact), outdir=str(d / "run"), indir=str(d / "inputs"), **POLISH)
    before = _listing()
    res = B.main(check=1e9, **kw)
    return {"res": res, "kw": kw, "dir": d, "before": before, "after": _listing()}


def test_result_has_bench_full_keys_and_is_written_in_the_run_directory(run):
    res = run["res"]
    assert set(res) == KEYS
    assert res["metric"] == "_torch_tiny_synthetic_wallclock" and res["unit"] == "s"
    assert (res["ndim"], res["ndata"], res["nwalkers"]) == (3, 12, 8)
    assert {"train_emulator", "mcmc", "generate_training_point"} <= set(res["phases_s"])
    assert res["final_chain_steps"] == 200 + res["polish_rounds"] * POLISH["polish_steps"]
    stored = json.loads((run["dir"] / "run" / B.RESULT_FILE).read_text())
    assert stored == json.loads(json.dumps(res))


def test_rhat_is_the_jax_packages_on_the_stored_chain(run):
    chain = JB.EmceeBackend(str(run["dir"] / "run" / "iter_1" / "chemcee_256.h5")).get_value(
        "chain_transformed")
    want = JC.gelman_rubin(chain[len(chain) // 5:], split=True)
    np.testing.assert_allclose(B.split_rhat(chain), want, rtol=1e-13, atol=0)
    assert run["res"]["max_split_rhat"] == round(float(np.max(want)), 4)
    if run["res"]["polish_rounds"] < POLISH["polish_rounds"]:
        assert np.max(want) - 1.0 <= B.POLISH_TARGET


def test_emulator_bias_against_the_exact_json(run):
    full = JB.EmceeBackend(str(run["dir"] / "run" / "iter_1" / "chemcee_256.h5")).get_value(
        "chain_transformed")
    mean = full[len(full) // 5:].reshape(-1, 3).mean(axis=0)
    bias = np.abs(mean - EXACT["exact_mean"]) / EXACT["exact_std"]
    assert run["res"]["max_emulator_bias_sigma"] == round(float(np.max(bias)), 3)
    assert run["res"]["median_emulator_bias_sigma"] == round(float(np.median(bias)), 3)


def test_check_exits_1_above_the_threshold(run, capsys):
    res = B.main(fresh=False, check=1e9, **run["kw"])
    assert "CHECK PASS" in capsys.readouterr().out
    assert res["final_chain_steps"] >= run["res"]["final_chain_steps"]
    with pytest.raises(SystemExit) as exc:
        B.main(fresh=False, check=1e-9, **run["kw"])
    assert exc.value.code == 1
    assert "CHECK FAIL" in capsys.readouterr().out


def test_nothing_is_written_at_the_repository_root(run):
    assert run["after"] == run["before"]


def test_an_existing_result_outside_the_run_directory_is_refused(tmp_path):
    out = tmp_path / "FLAGSHIP.json"
    out.write_text("{}")
    with pytest.raises(FileExistsError):
        B.main(out=str(out), theory_mod=THEORY, device="cpu", outdir=str(tmp_path / "run"),
               indir=str(tmp_path / "inputs"))
    assert out.read_text() == "{}" and not (tmp_path / "inputs").exists()


def test_command_line_is_bench_full_s_plus_device():
    kw = B.parse_args(["--resume", "--check", "out=r.json", "theory=examples.lsst_theory",
                       "yaml=examples/lsst_synthetic.yaml", "nensemble=1", "use_fused=true",
                       "--device", "cpu", "train_compute_dtype=bfloat16"])
    assert kw == {"fresh": False, "check": B.CHECK_SIGMA, "out": "r.json",
                  "theory_mod": "examples.lsst_theory",
                  "config_yaml": "examples/lsst_synthetic.yaml", "device": "cpu",
                  "overrides": {"nensemble": 1, "use_fused": True,
                                "train_compute_dtype": "bfloat16"}}
    assert B.parse_args(["check=0.15"])["check"] == 0.15
    assert B.parse_args([])["check"] is None and B.parse_args([])["fresh"]
