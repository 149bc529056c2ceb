"""``bench_scaling_torch.py`` on the CPU: its problem against the JAX
script's (the same seeded rows; transforms and loss state within f32), and
a cut run over two gloo ranks giving ``bench_scaling.py``'s result keys
with finite rates."""

import json
import pathlib

import jax
import numpy as np
import torch

import linna_tpu_torch

REPO = pathlib.Path(linna_tpu_torch.__file__).parent.parent
import bench_scaling as JS  # noqa: E402
import bench_scaling_torch as S  # noqa: E402

torch.set_num_threads(1)

F32 = dict(rtol=1e-6, atol=1e-6)


def test_problem_matches_the_jax_script():
    spec, tset, loss, *rows = S._problem("cpu")
    jspec, jtset, jloss, *jrows = JS._problem(jax)
    for a, b in zip(rows, jrows):
        np.testing.assert_array_equal(a, b)
    assert tuple(spec) == tuple(jspec)
    for ours, theirs in ((tset.x_transform.mean, jtset.x_transform.mean),
                         (tset.x_transform.std, jtset.x_transform.std),
                         (tset.y_transform.mean, jtset.y_transform.mean),
                         (tset.y_transform.std, jtset.y_transform.std),
                         (tset.y_data.sigma, jtset.y_data.sigma),
                         (loss.data_std, jloss.data_std)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **F32)
    np.testing.assert_allclose(loss.inv_transformed_cov.numpy(),
                               np.asarray(jloss.inv_transformed_cov), rtol=1e-5, atol=1e-5)
    assert loss.ndata == jloss.ndata == S.NDATA


def test_rank_counts():
    assert S.rank_counts("gloo", None) == [1]
    assert S.rank_counts("gloo", 3) == [1, 2]
    assert S.rank_counts("gloo", 8) == [1, 2, 4, 8]


def test_cut_run_over_two_gloo_ranks(tmp_path, monkeypatch):
    """``--device cpu --max-ranks 2`` at one epoch and 64 walkers: the JAX
    script's keys (``device`` for ``platform``, plus ``path``), finite
    seconds and rates, the censuses from the two-rank world, and nothing
    written outside the script's directory."""
    monkeypatch.setattr("bench_torch_common.tempfile.gettempdir", lambda: str(tmp_path))
    scaling_json = (REPO / "SCALING.json").read_bytes()
    r = S.main(device="cpu", max_ranks=2, epochs=1, walkers=64, chunk=5, reps=2)
    jax_keys = set(json.loads(scaling_json))
    assert set(r) == (jax_keys - {"platform"}) | {"device", "path"}
    assert r["device"] == "cpu" and r["n_devices"] == 2
    assert [t["k"] for t in r["trainer"]] == list(S.KS)
    for t in r["trainer"]:
        assert {"k", "mesh_s", "serial_s", "speedup"} <= set(t)
        assert np.isfinite([t["mesh_s"], t["serial_s"], t["speedup"]]).all()
        assert t["mesh_replays_per_epoch"] == t["serial_replays_per_epoch"] == 0
    assert [(s["devices"], s["graphed"]) for s in r["sampler"]] == [(1, False), (2, False)]
    assert all(np.isfinite(s["evals_per_s"]) and s["evals_per_s"] > 0 and s["finite"]
               for s in r["sampler"])
    assert r["hlo"]["k"] == 4 and r["hlo"]["cross_member_collectives"] == 0
    census = r["sampler_hlo"]
    assert census["world"] == 2 and census["walkers"] == S.CENSUS_WALKERS
    assert census["emcee"]["per_step"] == census["zeus"]["per_step"] == {"all_gather@world": 2.0}
    assert census["hmc"]["per_step"] == census["nuts"]["per_step"] == {}
    assert "not HLO" in census["counted"] and "not HLO" in r["hlo"]["counted"]
    out = tmp_path / "linna_bench_scaling_torch"
    assert sorted(p.name for p in out.iterdir()) == [S.RESULT_FILE]
    assert json.loads((out / S.RESULT_FILE).read_text())["n_devices"] == 2
    assert (REPO / "SCALING.json").read_bytes() == scaling_json
