"""The busy time as a union of device intervals, and idle gaps named by
the host's events, on synthetic intervals."""

import numpy as np
import pytest

from benchmark import trace as T


def test_union_counts_overlap_once():
    iv = np.array([[20, 30], [0, 10], [5, 15], [25, 26]], np.int64)
    assert T.union(iv).tolist() == [[0, 15], [20, 30]]
    busy, gaps = T.busy_and_gaps(iv, 0, 40)
    assert busy == 25  # not 10 + 10 + 10 + 1 = 31
    assert gaps.tolist() == [[15, 20], [30, 40]]


def test_clipped_to_window():
    iv = np.array([[0, 10], [5, 15], [20, 30]], np.int64)
    busy, gaps = T.busy_and_gaps(iv, 2, 28)
    assert busy == 13 + 8 and gaps.tolist() == [[15, 20]]
    busy, gaps = T.busy_and_gaps(np.zeros((0, 2), np.int64), 0, 7)
    assert busy == 0 and gaps.tolist() == [[0, 7]]


def test_gaps_named_by_host():
    gaps = np.array([[15, 20], [40, 41]], np.int64)
    host = [(0, 100, "trainer.train", True), (14, 22, "cudaStreamSynchronize", False),
            (10, 50, "aten::copy_", False)]
    named = T.name_gaps(gaps, host)
    assert named[0][0] == "trainer.train/cudaStreamSynchronize"
    assert named[0][1] == 5e-9
    assert named[1] == ["trainer.train/aten::copy_", 1e-9]
    assert T.name_gaps(gaps, []) == [["(no host event)", 6e-9]]


def test_short_gaps_summed(monkeypatch):
    monkeypatch.setattr(T, "NAMED_GAPS", 1)
    gaps = np.array([[0, 10], [20, 23], [30, 32]], np.int64)
    named = dict(map(tuple, T.name_gaps(gaps, [])))
    assert named == {"(no host event)": 10e-9, T.SHORT: 5e-9}



def test_kernel_grids(tmp_path):
    """Launches by grid size from an exported trace, which is removed."""
    import json

    events = [{"cat": "kernel", "name": "ns::fused_log_prob_kernel(float)", "dur": 270.0,
               "args": {"grid": [16, 8, 1]}},
              {"cat": "kernel", "name": "ns::fused_log_prob_kernel(float)", "dur": 400.0,
               "args": {"grid": [32, 8, 1]}},
              {"cat": "kernel", "name": "ns::fused_log_prob_kernel(float)", "dur": 270.0,
               "args": {"grid": [16, 8, 1]}},
              {"cat": "cpu_op", "name": "fused_log_prob_wrapper", "dur": 9.0, "args": {}},
              {"cat": "kernel", "name": "gemm", "dur": 5.0, "args": {"grid": [1, 1, 1]}}]

    class Prof:
        def export_chrome_trace(self, path):
            with open(path, "w") as f:
                json.dump({"traceEvents": events}, f)

    path = tmp_path / "trace.json"
    grids = T.kernel_grids(Prof(), ("fused_log_prob",), str(path))
    got = grids["fused_log_prob"]
    assert set(got) == {128, 256} and got[128][0] == 2 and got[256][0] == 1
    assert got[128][1] == pytest.approx(540e-6) and got[256][1] == pytest.approx(400e-6)
    assert not path.exists()
