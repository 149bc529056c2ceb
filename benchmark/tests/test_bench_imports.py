"""Nothing the benchmark runs loads JAX, the JAX package or a root script of
the repository; top-level names are compared whole."""

import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness as H

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("names, bad", [
    (["linna_tpu_torch", "linna_tpu_torch.nn", "numpy", "benchmark.run"], []),
    (["linna_tpu", "linna_tpu.nn"], ["linna_tpu"]),
    (["jax", "jax.numpy"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["__graft_entry__"], ["__graft_entry__"]),
    (["bench_torch_common", "bench_train_torch"], ["bench_torch_common", "bench_train_torch"]),
    (["chip_smoke"], ["chip_smoke"]),
    (["linna_tpu_torchx", "jaxtyping"], []),
])
def test_whole_names(names, bad):
    assert H.forbidden_modules(names) == bad


def test_a_run_loads_none(tiny):
    """A whole cell run on the CPU at a tiny size, in a fresh interpreter."""
    code = (
        "import sys, json, torch\n"
        "torch.set_num_threads(2)\n"
        "from benchmark import run, harness as H\n"
        f"res = run.execute('des3x2pt.train', 7, 0.5, False, torch.device('cpu'), "
        f"overrides={tiny!r})\n"
        "print(json.dumps(H.forbidden_modules(sys.modules)))\n"
        "print(json.dumps(sorted(n for n in sys.modules if n.startswith('linna'))))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    bad, linna = proc.stdout.strip().splitlines()[-2:]
    assert bad == "[]"
    assert "linna_tpu_torch" in linna and '"linna_tpu"' not in linna


def test_benchmark_alone_fails(tmp_path, tiny):
    """A directory that holds only BENCHMARK.json and the benchmark runs no
    cell: the program is not there."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import torch\nfrom benchmark import run\n"
            f"run.execute('des3x2pt.train', 7, 0.5, False, torch.device('cpu'), overrides={tiny!r})\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0 and "linna_tpu_torch" in proc.stderr
    assert proc.stdout == ""
