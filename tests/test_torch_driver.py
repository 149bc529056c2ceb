"""The port's YAML driver (``python -m linna_tpu_torch.driver``): the cases
of tests/test_driver.py pointed at the port with ``--device cpu`` (include
merging, triplet covariance, masks, priors, theory plugins, the theory
cache, the CLI, ``methodArr``, the compression hook), and
``_load_data_cov`` giving the same arrays as the JAX package's."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from linna_tpu import config as JC
from linna_tpu import driver as JD
from linna_tpu_torch import config as C
from linna_tpu_torch import driver as D

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU_ENV = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")


def test_yaml_include_merge(tmp_path):
    (tmp_path / "base.yaml").write_text("a: 1\nb: 2\nnested: {x: 1}\n")
    (tmp_path / "run.yaml").write_text("include: base.yaml\nb: 3\nc: 4\n")
    params = C.yaml_load(str(tmp_path / "run.yaml"))
    assert params == {"a": 1, "b": 3, "c": 4, "nested": {"x": 1}}
    sub = tmp_path / "sub"
    sub.mkdir()
    (sub / "run2.yaml").write_text("include: base.yaml\nd: 5\n")
    params = C.yaml_load(str(sub / "run2.yaml"), parent_dir=str(tmp_path))
    assert params["a"] == 1 and params["d"] == 5
    examples = os.path.join(REPO, "examples")
    for name in ("des_synthetic.yaml", "gaussian_3d.yaml"):
        path = os.path.join(examples, name)
        assert C.yaml_load(path, parent_dir=examples) == JC.yaml_load(path, parent_dir=examples)


def test_read_triplet_cov_symmetrizes_and_clips():
    rows = np.array([[0, 0, 1.0, 0.5], [0, 1, 0.1, 0.0], [1, 1, 2.0, 0.0], [2, 2, 1e11, 0.0]])
    cov = D.read_triplet_cov(rows)
    assert cov.shape == (3, 3)
    assert cov[0, 0] == 1.5 and cov[0, 1] == 0.1 and cov[1, 0] == 0.1 and cov[2, 2] == 0.0
    np.testing.assert_array_equal(cov, JD.read_triplet_cov(rows))


def test_align_mask():
    m = np.array([True, False, True])
    np.testing.assert_array_equal(D.align_mask(m, 2), [True, False])
    np.testing.assert_array_equal(D.align_mask(m, 5), [True, False, True, False, False])


def test_priors_and_init_from_config():
    params = {"sampled_params": [
        {"param": "om", "dist": "gauss", "arg1": 0.3, "arg2": 0.02},
        {"param": "s8", "dist": "flat", "arg1": 0.6, "arg2": 1.0},
        {"param": "w", "dist": "flat", "arg1": -2.0, "arg2": 0.0, "fid": -1.0},
    ]}
    priors, init = D.priors_and_init_from_config(params)
    assert [p["dist"] for p in priors] == ["gauss", "flat", "flat"]
    np.testing.assert_allclose(init, [0.3, 0.8, -1.0])
    jp, ji = JD.priors_and_init_from_config(params)
    assert priors == jp and np.array_equal(init, ji)


def test_resolve_theory():
    with pytest.raises(KeyError):
        D.resolve_theory({})
    with pytest.raises(ValueError):
        D.resolve_theory({"theory": "no_colon_here"})
    with pytest.raises(ModuleNotFoundError):
        D.resolve_theory({"theory": "definitely.not.a.module:f"})
    des = D.resolve_theory({"theory": "examples.des_theory:make_theory"})
    assert des([0, np.zeros(27)], None).shape == (457,)
    np.testing.assert_array_equal(D.resolve_theory({"theory": "identity"})([0, [1.0, 2.0]], None),
                                  [1.0, 2.0])


def test_model_func_caches_and_masks(tmp_path):
    calls = []

    def writer(params, outfile):
        calls.append(1)
        np.savetxt(outfile, np.stack([np.arange(4), np.asarray(params)], 1))

    mf = D.ModelFunc(writer, np.array([True, True, False, True]))
    out1 = mf([0, np.array([1.0, 2.0, 3.0, 4.0])], str(tmp_path))
    np.testing.assert_allclose(out1, [1.0, 2.0, 4.0])
    np.testing.assert_allclose(mf([0, np.full(4, 9.0)], str(tmp_path)), out1)  # cached
    assert len(calls) == 1

    def bad_writer(params, outfile):
        raise RuntimeError("theory exploded")

    out3 = D.ModelFunc(bad_writer, np.array([True, True, False, True]))([1, np.zeros(4)],
                                                                      str(tmp_path))
    np.testing.assert_allclose(out3, np.zeros(3))  # zeros on failure


def _inputs(tmp_path):
    inputs = tmp_path / "inputs"
    inputs.mkdir()
    np.savetxt(inputs / "data.txt", np.stack([np.arange(2), [0.3, -0.2]], 1))
    np.savetxt(inputs / "cov_triplet.txt", np.array([[0, 0, 0.0, 0.3], [1, 1, 0.25, 0.25]]))
    return inputs


def test_driver_cli_end_to_end(tmp_path):
    """The CLI as a user runs it on the CPU: bf16 training, two iterations
    of methods emcee then nuts from ``methodArr``, ``time.npy`` written."""
    inputs = _inputs(tmp_path)
    (tmp_path / "base.yaml").write_text(
        "nwalkers: 8\nnnmodel: chto_v2\ntrainingoption: 1\nnum_epochs: 8\nbatch_size: 16\n"
        "ntrainArr: [40, 40]\nnvalArr: [10, 10]\nnkeepArr: [2, 2]\nntimesArr: [0, 0]\n"
        "ntautolArr: [.inf, .inf]\nmeanshiftArr: [.inf, .inf]\nstdshiftArr: [.inf, .inf]\n"
        "temperatureArr: [2.0, 1.0]\nseed: 7\ntrain_compute_dtype: bfloat16\n"
        "methodArr: [emcee, nuts]\n"
    )
    (tmp_path / "run.yaml").write_text(
        "include: base.yaml\n"
        f"outdir: {tmp_path}/out\ntheory: identity\nbase_dir: {inputs}\n"
        "data_file: data.txt\ncov_file: cov_triplet.txt\n"
        "sampled_params:\n"
        "  - {param: x0, dist: flat, arg1: -2.0, arg2: 2.0}\n"
        "  - {param: x1, dist: flat, arg1: -2.0, arg2: 2.0}\n"
    )
    proc = subprocess.run(
        [sys.executable, "-m", "linna_tpu_torch.driver", "zeus", "None",
         str(tmp_path / "run.yaml"), str(tmp_path), "--device", "cpu"],
        capture_output=True, text=True, timeout=600, env=CPU_ENV, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = tmp_path / "out"
    assert (out / "time.npy").exists()
    assert (out / "iter_0" / "chemcee_256.h5").exists()
    assert (out / "iter_1" / "chemcee_256.h5").exists() and (out / "iter_1" / "precond.npz").exists()
    import json

    trace = json.loads((out / "trace.json").read_text())
    assert {r["compute_dtype"] for r in trace if r["phase"] == "train_emulator"} == {"torch.bfloat16"}
    assert [r["method"] for r in trace if r["phase"] == "mcmc"] == ["emcee", "nuts"]


def test_driver_cli_usage_error():
    proc = subprocess.run([sys.executable, "-m", "linna_tpu_torch.driver"],
                          capture_output=True, text=True, timeout=120, env=CPU_ENV, cwd=REPO)
    assert proc.returncode == 2 and "usage" in proc.stderr


def test_run_from_config_method_arr(tmp_path):
    """methodArr overrides the CLI method per iteration; each iteration's
    chain layout follows its own method."""
    params = {
        "outdir": str(tmp_path / "out"), "base_dir": str(_inputs(tmp_path)),
        "data_file": "data.txt", "cov_file": "cov_triplet.txt", "theory": "identity",
        "nwalkers": 6, "trainingoption": 1, "num_epochs": 10, "batch_size": 16,
        "ntrainArr": [25, 25], "nvalArr": [6, 6], "nkeepArr": [1, 1], "ntimesArr": [2, 2],
        "ntautolArr": [0.5, 0.5], "meanshiftArr": [100, 100], "stdshiftArr": [100, 100],
        "temperatureArr": [2.0, 1.0], "seed": 3, "methodArr": ["emcee", "zeus"],
        "sampled_params": [{"param": f"x{i}", "dist": "flat", "arg1": -2.0, "arg2": 2.0}
                           for i in range(2)],
    }
    chain, _ = D.run_from_config(params, method="zeus", device="cpu")
    out = tmp_path / "out"
    assert (out / "iter_0" / "chemcee_256.h5").exists() and (out / "iter_1" / "zeus_256.h5").exists()
    assert np.all(np.isfinite(chain)) and (out / "time.npy").exists()


@pytest.mark.parametrize("case", ["dense+transform", "triplet+mask", "premasked", "bad length",
                                  "bad transform"])
def test_load_data_cov_matches_jax(tmp_path, case):
    """Both packages' ``_load_data_cov`` on the same files: the same arrays,
    or the same error."""
    rng = np.random.default_rng(0)
    n, m = 6, 3
    a = rng.standard_normal((n, n))
    cov = a @ a.T + n * np.eye(n)
    mask = np.array([1, 1, 0, 1, 0, 1], dtype=float)
    params = {"base_dir": str(tmp_path), "data_file": "data.txt"}
    rows = [[i, j, 0.0, cov[i, j]] for i in range(n) for j in range(i, n)]
    if case == "dense+transform":
        np.savetxt(tmp_path / "cov.txt", cov)
        np.savetxt(tmp_path / "data.txt", rng.standard_normal(n))
        np.savetxt(tmp_path / "t.txt", rng.standard_normal((m, n)))
        params.update(cov_file="cov.txt", cov_format="dense", transform_matrix_file="t.txt")
    elif case == "bad transform":
        np.savetxt(tmp_path / "cov.txt", cov)
        np.savetxt(tmp_path / "data.txt", rng.standard_normal(n))
        np.savetxt(tmp_path / "t.txt", np.ones((2, n + 1)))
        params.update(cov_file="cov.txt", cov_format="dense", transform_matrix_file="t.txt")
    else:
        np.savetxt(tmp_path / "cov.txt", np.asarray(rows))
        np.savetxt(tmp_path / "mask.txt", np.stack([np.arange(n), mask], 1))
        length = {"triplet+mask": n, "premasked": 4, "bad length": 5}[case]
        np.savetxt(tmp_path / "data.txt", np.stack([np.arange(length),
                                                    rng.standard_normal(length)], 1))
        params.update(cov_file="cov.txt", mask_file="mask.txt")
    if case.startswith("bad"):
        with pytest.raises(ValueError) as want:
            JD._load_data_cov(params)
        with pytest.raises(ValueError) as got:
            D._load_data_cov(params)
        assert str(got.value) == str(want.value)
        return
    for got, want in zip(D._load_data_cov(params), JD._load_data_cov(params)):
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)


def test_transform_matrix_end_to_end(tmp_path, monkeypatch):
    """The compression applies to the model side too: the emulator trains
    on compressed vectors (width 2, not 4) and the posterior finds the
    compressed data vector."""
    inputs = tmp_path / "inputs"
    inputs.mkdir()
    np.savetxt(inputs / "data.txt", np.stack([np.arange(4), [0.3, 0.3, -0.2, -0.2]], 1))
    np.savetxt(inputs / "cov.txt", 0.25 * np.eye(4))
    np.savetxt(inputs / "t.txt", np.array([[0.5, 0.5, 0.0, 0.0], [0.0, 0.0, 0.5, 0.5]]))

    def theory4(params):
        return lambda x, outdirs: np.repeat(np.asarray(x[1], dtype=np.float64), 2)

    mod = type(sys)("_t4_torch")
    mod.factory = theory4
    monkeypatch.setitem(sys.modules, "_t4_torch", mod)
    params = {
        "outdir": str(tmp_path / "out"), "base_dir": str(inputs), "data_file": "data.txt",
        "cov_file": "cov.txt", "cov_format": "dense", "transform_matrix_file": "t.txt",
        "theory": "_t4_torch:factory", "nwalkers": 8, "trainingoption": 1, "num_epochs": 100,
        "batch_size": 25, "ntrainArr": [150, 150], "nvalArr": [30, 30], "nkeepArr": [1, 2],
        "ntimesArr": [2, 3], "ntautolArr": [0.5, 0.5], "meanshiftArr": [100, 100],
        "stdshiftArr": [100, 100], "temperatureArr": [2.0, 1.0], "seed": 3,
        "sampled_params": [{"param": f"x{i}", "dist": "flat", "arg1": -2.0, "arg2": 2.0}
                           for i in range(2)],
    }
    chain, _ = D.run_from_config(params, method="zeus", device="cpu")
    assert np.all(np.isfinite(chain))
    assert np.load(tmp_path / "out" / "iter_0" / "train_samples_y.npy").shape[1] == 2
    err = np.abs(chain.mean(axis=0) - np.array([0.3, -0.2]))
    assert np.all(err < 1.0), err
