"""The result line's form and the per-layer readers, on synthetic runs."""

import json

import pytest

from benchmark import harness as H

TRAIN = {"kind": "train", "members": 2, "n_weights": 1_258_500, "rows": 40_000,
         "val_rows": 2_000, "window_s": 10.0, "compute_dtype": "bfloat16", "trace": None,
         "trainer": {"epochs_run": 100, "graphs": {"graphed": True, "replays": 8100,
                                                   "epochs": 100},
                     "phase_seconds": {"auto_lr": 0.0, "capture": 0.3, "dispatch": 2.0,
                                       "wait_fetch": 5.0, "supervisor": 0.5, "save": 1.2,
                                       "plot": 0.0}}}
SAMPLE = {"kind": "sample", "members": 1, "n_weights": 4_049_957, "ndim": 40, "ndata": 1560,
          "gradient": False, "window_s": 10.0, "steps": 1000,
          "launch_blocks": {128: [128, 40, 1560], 256: [256, 40, 1560]},
          "window": {"sampler": {"dispatch": 1.5, "host": 0.5},
                     "graphs": {"steps": 1000, "calls": 20_000, "rows": 2_560_000}},
          "traced_call": {"kernels": {"launches": {"fused_log_prob": 10}}},
          "trace": {"busy_s": 3.0, "window_s": 4.0,
                    "grids": {"fused_log_prob": {128: (6, 6 * 0.27e-3), 256: (4, 4 * 0.40e-3)}}}}


def test_train_readers():
    assert H.reader("trainer.host_ms_per_epoch")(TRAIN) == pytest.approx(40.0)
    assert H.reader("trainer.replays_per_epoch")(TRAIN) == 81.0
    # 100 epochs of 6.14148e11 FLOP in 10 s over 989 TFLOP/s
    assert H.reader("train_mfu")(TRAIN) == pytest.approx(6.14148e11 * 10 / 989e12 * 100)
    assert H.reader("device_idle.train")(TRAIN) is None  # no trace
    assert H.reader("sample_mfu")(TRAIN) is None


def test_sample_readers():
    assert H.reader("sampler.host_ms_per_step")(SAMPLE) == pytest.approx(2.0)
    assert H.reader("sampler.calls_per_step")(SAMPLE) == 20.0
    assert H.reader("sample_mfu")(SAMPLE) == pytest.approx(
        2_560_000 * 12_967_114 / 10.0 / 67e12 * 100)
    assert H.reader("device_idle.sample")(SAMPLE) == pytest.approx(25.0)
    # 6 launches at 128 rows (bound 0.024773 ms) and 4 at 256 (0.049546 ms)
    # over 6 x 0.27 + 4 x 0.40 ms
    assert H.reader("fused_log_prob_roofline")(SAMPLE) == pytest.approx(
        (6 * 0.0247730 + 4 * 0.0495460) / (6 * 0.27 + 4 * 0.40) * 100, rel=1e-4)
    assert H.reader("device_idle.train")(SAMPLE) is None


@pytest.mark.parametrize("change", [
    {"traced_call": {"kernels": {"launches": {"fused_log_prob": 11}}}},  # a launch unseen
    {"launch_blocks": {128: [128, 40, 1560]}},  # a grid no row count launches
    {"traced_call": {"kernels": {"launches": {"fused_log_prob": 0}}}},
    {"trace": None},
])
def test_roofline_reads_nothing(change):
    assert H.reader("fused_log_prob_roofline")({**SAMPLE, **change}) is None


def test_result_line():
    bench = H.benchmark()
    out = {"e2e": {"epoch_ms": 70.0}, "attempted": 100, "failed": 0, "layer": TRAIN,
           "counters": {"window": {}}}
    metrics = H.metrics_line(bench, "des3x2pt.train", out, False, 12.5)
    assert metrics == {"epoch_ms": {"value": 70.0, "unit": "ms"},
                       "setup_s": {"value": 12.5, "unit": "s"}}
    traced = H.metrics_line(bench, "des3x2pt.train", out, True, 12.5)
    assert set(traced) == {"trainer.host_ms_per_epoch", "trainer.replays_per_epoch",
                           "train_mfu"}  # device_idle.train: nothing to read
    compared = H.checks({"loss_gap": 1e-6, "grad_gap": 0.01, "change_gap": 0.005},
                        {"loss_gap": 1e-4, "grad_gap": 0.05, "change_gap": 0.1})
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
              "memory_peak_bytes": 1}
    line = H.result_line(out, metrics, device, compared)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks" and line["correct"] is True
    assert json.loads(json.dumps(line)) == line
    compared["grad_gap"] = [0.06, 0.05]
    assert H.result_line(out, metrics, device, compared)["correct"] is False
    compared["grad_gap"] = [float("inf"), 0.05]
    assert H.passed(compared) is False
