"""``ml_sampler_core`` through the port: a crash mid-sampling resumes its
chain, and the fast posterior pin of tests/test_end_to_end.py:241-278 (two
iterations, 400 training points, nensemble=2) holds with zeus to 0.5 sigma."""

import os

import numpy as np
import pytest
import torch
from scipy.stats import truncnorm

from linna_tpu_torch.samplers import backends as TB
from linna_tpu_torch.samplers import run as TR

from test_torch_pipeline import COV, MEANS, NDIM, run

torch.set_num_threads(1)


def test_mid_sampling_crash_resumes_chain(tmp_path, monkeypatch):
    outdir = str(tmp_path / "out")

    class Killed(Exception):
        pass

    orig = TR.run_ensemble

    def killing(*a, **kw):
        kw["max_iterations"] = kw.get("check_every", 100)
        kw["convergence_check"] = False
        b = orig(*a, **kw)
        # the on-disk state a killed process leaves: no terminal stamp
        blob = b.load_state()
        blob["_finished"] = np.asarray(False)
        b.save_state(blob)
        raise Killed()

    monkeypatch.setattr(TR, "run_ensemble", killing)
    with pytest.raises(Killed):
        run(outdir)
    monkeypatch.undo()
    part = os.path.join(outdir, "iter_0", TR.ZEUS_FILENAME)
    killed_at = TB.ZeusBackend(part).iteration
    assert killed_at > 0
    chain, logp = run(outdir)  # the same command again
    assert TB.ZeusBackend(part).iteration > killed_at, "chain did not resume"
    assert np.all(np.isfinite(chain)) and np.all(np.isfinite(logp))


def test_posterior_sanity_pin_fast(tmp_path):
    chain, _ = run(
        str(tmp_path / "out"),
        ntrainArr=[400, 400], nvalArr=[80, 80], nkeepArr=[2, 5], ntimesArr=[8, 20],
        ntautolArr=[0.3, 0.1], meanshiftArr=[0.6, 0.6], stdshiftArr=[0.6, 0.6],
        temperatureArr=[2.0, 1.0], nwalkers=32,
        params={"trainingoption": 1, "num_epochs": 400, "batch_size": 100, "nensemble": 2},
    )
    for d in range(NDIM):
        s = np.sqrt(COV[d, d])
        a, b = (-2 - MEANS[d]) / s, (2 - MEANS[d]) / s
        want_mean = truncnorm.mean(a, b, loc=MEANS[d], scale=s)
        want_std = truncnorm.std(a, b, loc=MEANS[d], scale=s)
        assert abs(chain[:, d].mean() - want_mean) < 0.5 * want_std, (d, chain[:, d].mean())
        assert abs(chain[:, d].std() / want_std - 1) < 0.5, (d, chain[:, d].std())
