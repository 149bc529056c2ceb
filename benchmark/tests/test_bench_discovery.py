"""BENCHMARK.json against the contract's form, and every piece found by
its name: configurations, traffic mixes, limits and per-layer readers."""

import json
import re

import pytest

from benchmark import harness as H
from benchmark import reference as R

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


@pytest.fixture(scope="module")
def bench():
    return H.benchmark()


def test_form(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(bench)) < 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51 and bench["paths"] == ["benchmark"]
    for group, keys in KEYS.items():
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names)), group
        for e in bench[group]:
            assert set(e) <= keys and set(e) >= keys - {"workloads"}, e["name"]
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert w["config"] in {c["name"] for c in bench["configs"]}


@pytest.mark.parametrize("kind", ["config", "traffic", "cell", "reader"])
def test_found_by_name(bench, kind):
    for w in bench["workloads"]:
        cfg = H.config(bench, w["config"])
        if kind == "config":
            assert cfg["name"] == w["config"]
            assert cfg["n_weights"] == R.n_weights(cfg["ndim"], cfg["ndata"])
            assert cfg["hidden"] == R.hidden_size(cfg["ndata"])
        elif kind == "traffic":
            assert H.traffic(w["traffic"], cfg)["kind"] in ("train", "sample")
        elif kind == "cell":
            own = H.cell_data(w["name"])
            assert own["unit_seconds"] > 0 and own["limits"]
        else:
            for m in H.per_layer(bench, w["name"]):
                assert callable(H.reader(m["name"]))


def test_metric_selection(bench):
    assert [m["name"] for m in H.end_to_end(bench, "des3x2pt.train")] == ["epoch_ms", "setup_s"]
    assert [m["name"] for m in H.end_to_end(bench, "des3x2pt.nuts")] == [
        "walker_steps_per_s", "setup_s"]
    zeus = {m["name"] for m in H.per_layer(bench, "lsst6x2pt.zeus-fused")}
    assert "fused_log_prob_roofline" in zeus and "train_mfu" not in zeus
    nuts = {m["name"] for m in H.per_layer(bench, "des3x2pt.nuts")}
    assert "fused_log_prob_roofline" not in nuts and "sample_mfu" in nuts
    for w in bench["workloads"]:
        moved = {m["moves"] for m in H.per_layer(bench, w["name"])}
        assert moved <= {m["name"] for m in H.end_to_end(bench, w["name"])}
