"""Finding a cell's pieces by name, running it, and the result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name ``BENCHMARK.json``
gives it:

- a configuration: the ``file`` of its ``configs`` entry;
- a traffic mix: ``benchmark/traffic/<traffic>.json``, whose ``kind`` picks
  the driver in :mod:`benchmark.kinds`;
- a cell's own numbers, ``benchmark/cells/<cell>.json``: the limit of each
  number ``correct`` compares, and the seconds one unit of its window's
  work (an epoch, a step) took on the card, which fixes how many units a
  window of ``--seconds`` holds;
- a per-layer metric: ``benchmark/metrics/<metric>.py``, whose ``read(run)``
  returns the number or None when the run holds nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent  # the checkout
# top-level modules a run may not hold: JAX, the JAX package, and the
# repository's root scripts (names compared whole: linna_tpu_torch is not
# linna_tpu)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "linna_tpu", "__graft_entry__", "chip_smoke"})
FORBIDDEN_PREFIX = "bench_"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(ROOT / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


# the configuration's run settings, which a traffic mix may override
RUN_KEYS = ("nwalkers", "nensemble", "batch_size", "train_compute_dtype", "epochs_per_dispatch")


def traffic(name: str, cfg: dict) -> dict:
    """The traffic mix ``name`` over the configuration's run settings."""
    return {**{k: cfg[k] for k in RUN_KEYS}, **load_json(HERE / "traffic" / f"{name}.json")}


def cell_data(cell_name: str) -> dict:
    return load_json(HERE / "cells" / f"{cell_name}.json")


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _listed(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def end_to_end(bench: dict, cell_name: str) -> list:
    """The end-to-end metrics a cell reports."""
    return [m for m in bench["end_to_end"] if _listed(m, cell_name)]


def per_layer(bench: dict, cell_name: str) -> list:
    """The per-layer metrics a cell reports: those that list it, and those
    with no list whose end-to-end metric the cell reports."""
    reported = {m["name"] for m in end_to_end(bench, cell_name)}
    out = []
    for m in bench["per_layer"]:
        if cell_name in m["workloads"] if "workloads" in m else m["moves"] in reported:
            out.append(m)
    return out


def forbidden_modules(names) -> list:
    """The top-level module names among ``names`` that a run may not hold."""
    tops = {n.split(".")[0] for n in names}
    return sorted(t for t in tops if t in FORBIDDEN or t.startswith(FORBIDDEN_PREFIX))


def checks(readings: dict, lim: dict) -> dict:
    """{name: [value, limit]} of every number compared; a number passes at
    or under its limit."""
    return {k: [readings[k], lim[k]] for k in lim}


def passed(compared: dict) -> bool:
    return all(math.isfinite(v) and v <= limit for v, limit in compared.values())


def metrics_line(bench: dict, cell_name: str, out: dict, trace: bool, setup_s: float) -> dict:
    """The ``metrics`` of the result line: the cell's end-to-end metrics
    with ``--trace 0``, its per-layer metrics (those whose reader found
    something) with ``--trace 1``."""
    if not trace:
        values = dict(out["e2e"], setup_s=setup_s)
        return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                for m in end_to_end(bench, cell_name)}
    line = {}
    for m in per_layer(bench, cell_name):
        value = reader(m["name"])(out["layer"])
        if value is not None:
            line[m["name"]] = {"value": value, "unit": m["unit"]}
    return line


def result_line(out: dict, metrics: dict, device: dict, compared: dict) -> dict:
    line = {"correct": passed(compared), "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device}
    trace = out["layer"].get("trace")
    if trace is not None:
        line["breakdown"] = trace["breakdown"]
    if out.get("counters") is not None:
        line["counters"] = out["counters"]
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    return line


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)
