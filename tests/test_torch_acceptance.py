"""The JAX package's slow acceptance tier through the port, and the
walkthrough notebook.

Slow tier (``pytest -m slow tests/test_torch_acceptance.py``, on the CPU):
the three accuracy pins of ``tests/_torch_acceptance.py`` at their JAX
tests' budgets and seeds, unchanged, and ``examples/walkthrough_torch.ipynb``
executed through ``nbclient`` as ``tests/test_walkthrough.py`` executes the
JAX notebook.  ``chip_smoke.py`` phase 15 runs the 2-D and 33-dim pins and
the notebook on the card.  The flagship pin misses at ``seed=11`` through
the port; at its budget it flips with the seeds in both packages
(``tests/flagship_pin_trace.py``, PERF.md §6).

Tier 1: the notebook mirrors ``examples/walkthrough.ipynb`` cell for cell
and compiles, and each acceptance function runs at a tiny budget (its
samplers cut to 20 steps) to a finite chain, its pins not applied there.
"""

import functools
import json
import os
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

import linna_tpu_torch
from linna_tpu_torch.samplers import run as TR

REPO = pathlib.Path(linna_tpu_torch.__file__).parent.parent
sys.path.insert(0, str(REPO / "tests"))
import _torch_acceptance as A  # noqa: E402

torch.set_num_threads(1)

NOTEBOOK = REPO / "examples" / "walkthrough_torch.ipynb"
JAX_NOTEBOOK = REPO / "examples" / "walkthrough.ipynb"
MARKERS = ("posterior mean", "grad log p at whitened 0")


def _cells(path):
    with open(path) as f:
        return json.load(f)["cells"]


def _headings(cells):
    return [line.strip() for c in cells if c["cell_type"] == "markdown"
            for line in c["source"] if line.startswith("## ")]


def test_notebook_mirrors_the_jax_notebook():
    """Same 12 cells of the same kinds in the same order and the same
    section headings; no code cell names JAX or the JAX package; every code
    cell compiles; the marker lines, the output directory and device
    variables are there."""
    ours, theirs = _cells(NOTEBOOK), _cells(JAX_NOTEBOOK)
    assert [c["cell_type"] for c in ours] == [c["cell_type"] for c in theirs]
    assert len(ours) == 12
    assert _headings(ours) == _headings(theirs) and len(_headings(ours)) == 5
    assert ours[0]["source"][0].startswith("# ")
    code = ["".join(c["source"]) for c in ours if c["cell_type"] == "code"]
    jax_word = re.compile(r"\bjax\b|\blinna_tpu\b(?!_torch)")
    for i, src in enumerate(code):
        assert not jax_word.search(src), src
        compile(src, f"{NOTEBOOK.name} code cell {i}", "exec")
    joined = "\n".join(code)
    for marker in MARKERS + ("LINNA_WALKTHROUGH_OUTDIR", "LINNA_WALKTHROUGH_DEVICE",
                             "torch.func.jacrev", "make_grad_log_prob", "ml_sampler_core",
                             "retrieve_model_wrapper"):
        assert marker in joined, marker
    assert len({c["id"] for c in ours}) == 12


@pytest.mark.parametrize("name", sorted(A.ACCEPTANCE))
def test_acceptance_function_at_a_tiny_budget(name, tmp_path, monkeypatch):
    monkeypatch.setattr(TR, "run_ensemble",
                        functools.partial(TR.run_ensemble, check_every=A.TINY_CHECK_EVERY))
    res = A.ACCEPTANCE[name](str(tmp_path / "run"), "cpu", **A.TINY_BUDGETS[name])
    chain = res["chain"]
    assert chain.ndim == 2 and len(chain) > 0 and np.isfinite(chain).all()
    assert set(res["pins"]) and all(isinstance(v, bool) for v in res["pins"].values())
    mcmc = [r for r in res["record"] if r["phase"] == "mcmc"]
    assert [r["steps_run"] for r in mcmc] == [2 * A.TINY_CHECK_EVERY] * len(mcmc)
    assert all(r["graph_replays"] == 0 for r in mcmc)  # the CPU samples eagerly


# ------------------------------------------------------------------ slow tier


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(A.ACCEPTANCE))
def test_acceptance_pin(name, tmp_path):
    res = A.ACCEPTANCE[name](str(tmp_path / "out"), "cpu")
    assert not A.missed(res), {k: v for k, v in res.items() if k != "chain"}


@pytest.mark.slow
def test_walkthrough_notebook_executes(tmp_path, monkeypatch):
    import nbformat
    from nbclient import NotebookClient

    nb = nbformat.read(str(NOTEBOOK), as_version=4)
    monkeypatch.setenv("LINNA_WALKTHROUGH_OUTDIR", str(tmp_path / "out"))
    monkeypatch.setenv("LINNA_WALKTHROUGH_DEVICE", "cpu")
    NotebookClient(nb, timeout=1200, kernel_name="python3",
                   resources={"metadata": {"path": str(REPO / "examples")}}).execute()
    joined = "\n".join("".join(o.get("text", "") for o in c.get("outputs", []) if o.get("text"))
                       for c in nb.cells if c.cell_type == "code")
    for marker in MARKERS:
        assert marker in joined, marker
    assert os.path.isfile(tmp_path / "out" / "iter_1" / "zeus_256.h5")
