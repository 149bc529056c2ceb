"""One short run of a cell on the card, as the benchmark's command runs it,
and the training control at the cell's own size (each skips without a
card)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.card
def test_zeus_fused_on_the_card(card):
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "lsst6x2pt.zeus-fused",
         "--seed", "4242424242", "--seconds", "5", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert set(line["metrics"]) == {"walker_steps_per_s", "setup_s"}
    kernels = line["counters"]["window"]
    assert kernels["launches"]["fused_log_prob"] > 0
    assert kernels["plain_calls"]["fused_log_prob"] == 0
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")


@pytest.mark.card
def test_training_control_on_the_card(card, tmp_path):
    """``benchmark.control`` on one seed of ``des3x2pt.train``: the program
    within every limit, the bfloat16 control (float8 products) over one, and
    each fault the reference plays over one."""
    out = tmp_path / "control.json"
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.control", "--workload", "des3x2pt.train",
         "--seeds", "3300000001", "--seconds", "1", "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    row = json.loads(out.read_text())[0]
    limits = json.loads((ROOT / "benchmark" / "cells" / "des3x2pt.train.json").read_text())[
        "limits"]
    assert row["correct"] is True
    over = lambda readings: [k for k, lim in limits.items() if readings[k] > lim]
    assert over(row["control"]), row["control"]
    for fault, readings in row["control"]["faults"].items():
        assert over(readings), (fault, readings)
