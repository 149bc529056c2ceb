"""Package rules of the PyTorch port: it imports neither JAX nor the JAX
package, its entry points default to the card and raise without one, and a
kernel that cannot be built raises instead of falling back."""

import ast
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import linna_tpu_torch
from linna_tpu_torch import likelihood as TLK
from linna_tpu_torch import nn as TN
from linna_tpu_torch import orchestrator as TO
from linna_tpu_torch import priors as TP
from linna_tpu_torch import ops as TOPS
from linna_tpu_torch import transforms as TT
from linna_tpu_torch.ops import fused as TF
from linna_tpu_torch.ops import library as TL
from linna_tpu_torch.samplers import backends as TB
from linna_tpu_torch.samplers import run as TR

torch.set_num_threads(1)

PKG = pathlib.Path(linna_tpu_torch.__file__).parent
REPO = PKG.parent


def test_import_leaves_jax_and_the_jax_package_out():
    code = (
        "import sys, linna_tpu_torch, linna_tpu_torch.ops.fused, linna_tpu_torch.samplers.run; "
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'linna_tpu' or m.startswith('linna_tpu.')); print(bad)"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(REPO), timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_sources_never_import_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import jax|from jax)|linna_tpu\.", re.M)
    sources = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "des_report.py"]
    assert len(sources) > 10
    for path in sources:
        assert not pattern.search(path.read_text()), path


def test_the_port_never_imports_sklearn():
    """The card has no scikit-learn: the walker cut is numpy k-means."""
    sources = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in sources:
        assert "sklearn" not in path.read_text(), path
    code = (
        "import sys, numpy as np, linna_tpu_torch.orchestrator as O; "
        "O.get_good_walker_list(np.arange(12.0).reshape(3, 4) * 50); "
        "print('sklearn' in sys.modules)"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(REPO), timeout=120, check=True)
    assert out.stdout.strip() == "False"


USER_SCRIPTS = ["bench_full_torch.py", "bench_exact_posterior_torch.py",
                "examples/walkthrough_torch.py", "examples/nuts_flagship_demo_torch.py",
                "tests/_torch_acceptance.py"]
# the measurement scripts and their shared module
BENCH_SCRIPTS = ["bench_torch_common.py", "bench_torch.py", "bench_fused_torch.py",
                 "bench_bf16_torch.py", "bench_train_torch.py", "bench_train_profile_torch.py",
                 "bench_dispatch_torch.py", "bench_allopts_torch.py", "bench_scaling_torch.py"]


def test_user_scripts_leave_jax_and_the_jax_package_out(tmp_path):
    """The gate, the exact posterior, the walkthrough (script and notebook),
    the NUTS demo and the acceptance tier import the port only; without a
    card their entry points raise."""
    import json

    pattern = re.compile(r"^\s*(import jax|from jax)|linna_tpu\.", re.M)
    for rel in USER_SCRIPTS:
        assert not pattern.search((REPO / rel).read_text()), rel
    cells = json.loads((REPO / "examples" / "walkthrough_torch.ipynb").read_text())["cells"]
    for cell in cells:
        assert not pattern.search("".join(cell["source"])), cell["source"]
    code = (
        "import sys; sys.path[:0] = ['examples', 'tests']; "
        "import bench_full_torch, bench_exact_posterior_torch, walkthrough_torch, "
        "nuts_flagship_demo_torch, _torch_acceptance; "
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'linna_tpu' or m.startswith('linna_tpu.')); print(bad)"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(REPO), timeout=120, check=True)
    assert out.stdout.strip() == "[]"
    if torch.cuda.is_available():
        return
    sys.path.insert(0, str(REPO / "examples"))
    sys.path.insert(0, str(REPO / "tests"))
    import _torch_acceptance as A
    import bench_exact_posterior_torch as E
    import bench_full_torch as B
    import nuts_flagship_demo_torch as D
    import walkthrough_torch as W

    calls = [lambda: B.main(outdir=str(tmp_path / "b"), indir=str(tmp_path / "i")),
             lambda: E.main(outdir=str(tmp_path / "e")),
             lambda: W.main(str(tmp_path / "w")),
             lambda: D.main(str(tmp_path / "d"), str(tmp_path / "i"))]
    calls += [lambda fn=fn, name=name: fn(str(tmp_path / name))
              for name, fn in A.ACCEPTANCE.items()]
    for call in calls:
        with pytest.raises(RuntimeError, match="pass device='cpu'"):
            call()
    assert not os.listdir(tmp_path)


def test_entry_points_without_a_device_raise_off_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    spec = TN.make_model_spec("chto_v2", 3, 4)
    params = TN.init_model(spec, device="cpu")
    ts = TT.TransformSet(
        TT.XTransform(torch.zeros(3), torch.ones(3), torch.zeros(3, dtype=torch.bool)),
        TT.YTransform(torch.zeros(4), torch.ones(4), False),
        TT.YTransformData(torch.ones(4)),
    )
    pack = TP.priors_from_list([{"dist": "flat", "arg1": -1, "arg2": 1}] * 3, "cpu")
    calls = [
        lambda: TN.init_model(spec),
        lambda: TN.params_from_numpy({"w": np.zeros(2)}),
        lambda: TP.priors_from_list([{"dist": "flat", "arg1": 0, "arg2": 1}]),
        lambda: TT.fit_x_transform(np.ones((4, 3))),
        lambda: TLK.make_log_prob(spec, params, ts, pack, np.zeros(4), np.eye(4)),
        lambda: TLK.make_log_prob(spec, params, ts, pack, np.zeros(4), np.eye(4), use_fused=True),
        lambda: TR.run_ensemble(lambda x: x.sum(-1), np.zeros((4, 3)), str(tmp_path)),
        lambda: TR.run_ensemble(lambda x: x.sum(-1), np.zeros((4, 3)), str(tmp_path),
                                method="nuts"),
        lambda: TO.retrieve_model(str(tmp_path), 3, 4),
        lambda: linna_tpu_torch.linear_model.fit_linear_model(np.ones((4, 3)), np.ones((4, 2))),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="pass device='cpu'"):
            call()


@pytest.mark.parametrize("name", [lib.name for lib in TOPS.LIBRARIES])
def test_kernel_build_failure_raises(monkeypatch, name):
    lib = next(lib for lib in TOPS.LIBRARIES if lib.name == name)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(lib, "lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        lib.get()


def _code(path: pathlib.Path) -> ast.Module:
    return ast.parse(path.read_text(), str(path))


def _seam_breaches(tree: ast.Module) -> list:
    """What only ``ops/library.py`` may do: run ``nvcc``, load a library,
    make a lock or declare a C function's types."""
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef)) and n.body
            and isinstance(n.body[0], ast.Expr) and isinstance(n.body[0].value, ast.Constant)}
    out = []
    for n in ast.walk(tree):
        if isinstance(n, ast.Call):
            f = n.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")
            if name in ("Lock", "RLock", "CDLL", "_nvcc", "compile_library"):
                out.append(f"calls {name}")
        elif isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Store) \
                and n.attr in ("argtypes", "restype"):
            out.append(f"assigns {n.attr}")
        elif isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs \
                and "nvcc" in n.value:
            out.append(f"names nvcc: {n.value!r}")
    return out


def _imports(tree: ast.Module) -> list:
    """(module, name) of every import, relative modules with their dots."""
    out = []
    for n in ast.walk(tree):
        if isinstance(n, ast.ImportFrom):
            out += [("." * n.level + (n.module or ""), a.name) for a in n.names]
        elif isinstance(n, ast.Import):
            out += [(a.name, None) for a in n.names]
    return out


@pytest.mark.parametrize("rule", ["seam", "precompile", "train_graphs"])
def test_card_plumbing_goes_through_the_library_seam(rule):
    """The kernel libraries are built, loaded, locked and typed in
    ``ops/library.py`` alone; the warm-up asks the seam and reaches into no
    kernel module; the trainer's graphs sit below the samplers."""
    if rule == "seam":
        seam = PKG / "ops" / "library.py"
        assert _seam_breaches(_code(seam))  # the scan sees what it looks for
        for path in sorted(PKG.rglob("*.py")):
            if path != seam:
                assert not _seam_breaches(_code(path)), path
    elif rule == "precompile":
        tree = _code(PKG / "parallel" / "precompile.py")
        ops = [(m, n) for m, n in _imports(tree) if m.lstrip(".").startswith("ops")]
        assert ops and not any((n or "").startswith("_") for _, n in ops)
        assert not {"adamw", "graph_loops"} & {n for _, n in ops}
        bound = {n for _, n in ops}
        reached = [n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)
                   and isinstance(n.value, ast.Name) and n.value.id in bound
                   and n.attr.startswith("_")]
        assert reached == []
    else:
        imports = _imports(_code(PKG / "train_graphs.py"))
        assert imports and not any("samplers" in m or n == "samplers" for m, n in imports)


def test_fused_binds_the_seams_counters():
    """The benchmark reads the counters from ``ops.fused``: the same objects."""
    for name in ("launches", "plain_calls", "designs", "launch_shapes", "plain_shapes",
                 "reset_counts"):
        assert getattr(TF, name) is getattr(TL, name), name
    assert list(TL.launches) == list(TL.plain_calls) == ["fused_apply", "fused_log_prob", "adamw",
                                                          "composition_grad"]
    assert list(TL.designs) == ["tiled", "cluster"]
    assert TL.COUNTERS == {"launches": TL.launches, "plain_calls": TL.plain_calls,
                           "designs": TL.designs}


def test_unported_samplers_raise(tmp_path):
    """Every sampler of the JAX package is ported: only an unknown name
    raises NotImplementedError, and the moves' walker-count contracts hold."""
    with pytest.raises(NotImplementedError, match="not_a_sampler"):
        TR.run_ensemble(lambda x: x.sum(-1), np.zeros((4, 3)), str(tmp_path),
                        method="not_a_sampler", device="cpu")
    with pytest.raises(NotImplementedError, match="not_a_sampler"):
        TO._chain_filename("not_a_sampler")
    with pytest.raises(ValueError, match="nwalkers >= 4"):
        TR.run_ensemble(lambda x: x.sum(-1), np.zeros((2, 3)), str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="nwalkers must be even"):
        TR.run_ensemble(lambda x: -x.pow(2).sum(-1), np.zeros((5, 3)), str(tmp_path / "odd"),
                        method="emcee", device="cpu")


def test_linear_model_artifact_is_not_ported(tmp_path):
    """The pre-model is ported: ``retrieve_model`` attaches the iteration's
    ``linear_model.npz`` on the device it is asked for, except for a
    linear_bypass model, which never trains with one."""
    from linna_tpu_torch import linear_model as TLM
    from linna_tpu_torch.utils import checkpoint as ckpt

    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (30, 3))
    lm = TLM.fit_linear_model(x, np.stack([x[:, 0] * x[:, 1], x[:, 2], x[:, 0], x[:, 1]], 1),
                              device="cpu")
    TLM.save_linear_model(str(tmp_path / TO.LINEAR_MODEL_FILE), lm)
    TT.save_transforms(str(tmp_path / TO.TRANSFORMS_FILE), TT.TransformSet(
        TT.XTransform(torch.zeros(3), torch.ones(3), torch.zeros(3, dtype=torch.bool)),
        TT.YTransform(torch.zeros(4), torch.ones(4), False), TT.YTransformData(torch.ones(4))))
    for name in ("chto_v2", "chto_v2_linear"):
        spec = TN.make_model_spec(name, 3, 4)
        ckpt.save_checkpoint(str(tmp_path / TO.BEST_CKPT), TN.init_model(spec, device="cpu"))
        got = TO.retrieve_model(str(tmp_path), 3, 4, name, device="cpu").linearmodel
        if spec.linear_bypass:
            assert got is None
        else:
            assert isinstance(got, TLM.LinearModel) and got.coef.device.type == "cpu"
            assert torch.equal(got(torch.as_tensor(x[:4], dtype=torch.float32)),
                               lm(torch.as_tensor(x[:4], dtype=torch.float32)))


def test_npz_store_keeps_the_zeus_layout(tmp_path, monkeypatch):
    """Without h5py the chain goes to the directory <name>.d with the same
    datasets, iteration attribute and sampler_state group; an append writes
    its own rows and leaves the index the same size."""
    monkeypatch.setattr(TB, "_h5", lambda: TB._DirModule)
    assert TB.store_kind() == "dir"
    b = TB.ZeusBackend(str(tmp_path / "zeus_256.h5"))
    assert not b.initialized and b.load_state() is None
    rng = np.random.default_rng(0)
    c1, c2 = rng.normal(size=(3, 4, 2)), rng.normal(size=(2, 4, 2))
    b.append(c1, rng.normal(size=(3, 4)), transform=lambda c: 2 * c)
    index = os.path.join(b.path, "index.npz")
    index_bytes = os.path.getsize(index)
    b.append(c2, rng.normal(size=(2, 4)), transform=lambda c: 2 * c)
    assert os.path.getsize(index) == index_bytes
    assert os.path.getsize(os.path.join(b.path, "samples.bin")) == c1.nbytes + c2.nbytes
    b.save_state({"coords": np.ones((4, 2), np.float32), "_method": np.bytes_("zeus"),
                  "_finished": np.asarray(True)})
    assert b.path.endswith("zeus_256.h5.d") and os.path.isdir(b.path)
    with open(os.path.join(b.path, "samples.bin"), "ab") as f:
        f.write(c2[:1].tobytes())  # the rows of a torn append
    again = TB.ZeusBackend(str(tmp_path / "zeus_256.h5"))
    assert again.initialized and again.iteration == 5 and again.get_chain().shape[0] == 5
    np.testing.assert_array_equal(again.get_chain(), np.concatenate([c1, c2]))
    np.testing.assert_array_equal(again.get_value("chain_transformed"), 2 * np.concatenate([c1, c2]))
    np.testing.assert_array_equal(again.get_last_sample(), c2[-1])
    state = again.load_state()
    assert state["_method"].item() == b"zeus" and bool(state["_finished"])
    assert not TO._chain_incomplete(str(tmp_path / "zeus_256.h5"), "zeus")
    e = TB.EmceeBackend(str(tmp_path / "chemcee_256.h5"))
    e.reset(4, 2)
    e.append(c1, rng.normal(size=(3, 4)), np.ones(4))
    assert e.initialized and e.iteration == 3
    np.testing.assert_array_equal(e.get_chain(flat=True), c1.reshape(-1, 2))


def test_run_ensemble_resumes_exactly_on_the_npz_store(tmp_path, monkeypatch):
    """The card has no h5py: sampling, exact resume and the chain cut work
    the same on the directory store."""
    monkeypatch.setattr(TB, "_h5", lambda: TB._DirModule)
    lp = lambda x: -0.5 * torch.sum(x * x, dim=-1)
    x0 = np.random.default_rng(0).normal(size=(8, 2)) * 0.1
    kw = dict(check_every=50, tautol=1e-12, seed=3, device="cpu")
    TR.run_ensemble(lp, x0, str(tmp_path / "whole"), max_iterations=150, **kw)
    TR.run_ensemble(lp, x0, str(tmp_path / "split"), max_iterations=100, **kw)
    TR.run_ensemble(lp, x0, str(tmp_path / "split"), max_iterations=150, **kw)
    paths = [str(tmp_path / d / TR.ZEUS_FILENAME) for d in ("whole", "split")]
    whole, split = (TB.ZeusBackend(p) for p in paths)
    assert not os.path.exists(paths[0]) and os.path.isdir(whole.path)
    np.testing.assert_array_equal(whole.get_chain(), split.get_chain())
    assert whole.iteration == 150 and bool(split.load_state()["_finished"])
    chain, logp, _ = TO.read_chain_and_cut(paths[1], nk=2, method="zeus", flat=True)
    assert chain.shape[1] == 2 and logp.shape == (chain.shape[0], 1)


def test_bench_scripts_leave_jax_and_the_jax_package_out(tmp_path, monkeypatch):
    """The seven measurement scripts and their shared module import the port
    only (never jax, ``linna_tpu`` or ``__graft_entry__``, which imports
    jax); without a card each script's entry point raises, and writes
    nothing first."""
    pattern = re.compile(r"^\s*(import jax|from jax|(import|from) __graft_entry__)|linna_tpu\.",
                         re.M)
    for rel in BENCH_SCRIPTS:
        assert not pattern.search((REPO / rel).read_text()), rel
    mods = [rel[:-3] for rel in BENCH_SCRIPTS]
    code = (
        f"import sys; import {', '.join(mods)}; "
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'linna_tpu' or m.startswith('linna_tpu.') or m == '__graft_entry__'); "
        "print(bad)"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(REPO), timeout=120, check=True)
    assert out.stdout.strip() == "[]"
    if torch.cuda.is_available():
        return
    import bench_torch_common as BC

    monkeypatch.setattr(BC.tempfile, "gettempdir", lambda: str(tmp_path))
    for name in mods[1:]:
        mod = __import__(name)
        with pytest.raises(RuntimeError, match="pass device='cpu'"):
            mod.main()
    assert not os.listdir(tmp_path)
