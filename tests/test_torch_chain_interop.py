"""Chain files across the packages, for the samplers of this slice: a chain
the port writes (HDF5 here, where h5py exists) reads and resumes in the JAX
package and the other way round, with ``precond.npz`` reused by both (the
MAP search never re-runs) and the foreign RNG state never restored; and a
directory store, as the card writes it without h5py, read by the port
where h5py exists and, after ``export_hdf5``, by the JAX package."""

import os

import numpy as np
import numpy.testing as npt
import pytest
import torch

from _torch_parity import gauss_log_probs
from linna_tpu.samplers import backends as JB
from linna_tpu.samplers import precondition as JPC
from linna_tpu.samplers import run as JR
from linna_tpu_torch import orchestrator as TO
from linna_tpu_torch.samplers import backends as TB
from linna_tpu_torch.samplers import precondition as TPC
from linna_tpu_torch.samplers import run as TR

torch.set_num_threads(1)

LP_J, LP_T = gauss_log_probs()
X0 = (0.1 * np.random.default_rng(1).standard_normal((8, 2))).astype(np.float32)
KW = dict(ntimes=1, tautol=1e9, meanshift=1e9, stdshift=1e9, nk=1, check_every=10,
          convergence_check=False, seed=4)


def _no_search(*a, **k):
    raise AssertionError("the MAP search re-ran: precond.npz was not reused")


@pytest.mark.parametrize("method", ["emcee", "nuts"])
def test_port_chain_reads_and_resumes_in_jax(tmp_path, method, monkeypatch):
    d = str(tmp_path)
    port = TR.run_ensemble(LP_T, X0, d, method=method, max_iterations=20, device="cpu", **KW)
    first = port.get_chain()
    jax_view = JB.EmceeBackend(os.path.join(d, JR.EMCEE_FILENAME))
    npt.assert_array_equal(jax_view.get_chain(), first)
    npt.assert_array_equal(jax_view.get_log_prob(), port.get_log_prob())
    monkeypatch.setattr(JPC, "calc_hess_mass_mat", _no_search)
    with pytest.warns(UserWarning, match="fields do not match"):
        again = JR.run_ensemble(LP_J, X0, d, method=method, max_iterations=30,
                                shard_walkers=False, **KW)
    assert again.iteration == 30
    npt.assert_array_equal(again.get_chain()[:20], first)
    assert "key" in again.load_state()  # the JAX package's own state now


@pytest.mark.parametrize("method", ["emcee", "nuts"])
def test_jax_chain_reads_and_resumes_in_the_port(tmp_path, method, monkeypatch):
    d = str(tmp_path)
    jax_run = JR.run_ensemble(LP_J, X0, d, method=method, max_iterations=20,
                              shard_walkers=False, **KW)
    first = jax_run.get_chain()
    view = TB.EmceeBackend(os.path.join(d, TR.EMCEE_FILENAME))
    npt.assert_array_equal(view.get_chain(), first)
    monkeypatch.setattr(TPC, "calc_hess_mass_mat", _no_search)
    with pytest.warns(UserWarning, match="fields do not match"):
        again = TR.run_ensemble(LP_T, X0, d, method=method, max_iterations=30, device="cpu", **KW)
    assert again.iteration == 30 and "rng_state" in again.load_state()
    npt.assert_array_equal(again.get_chain()[:20], first)


@pytest.mark.parametrize("method", ["nuts", "zeus"])
def test_directory_store_reads_with_h5py_and_exports_for_jax(tmp_path, method, monkeypatch):
    d = str(tmp_path)
    monkeypatch.setattr(TB, "_h5", lambda: TB._DirModule)
    x0 = np.concatenate([X0, X0 + 0.05])
    TR.run_ensemble(LP_T, x0, d, method=method, max_iterations=20, device="cpu", **KW)
    monkeypatch.undo()
    assert TB.store_kind() == "hdf5"
    name = os.path.join(d, TO._chain_filename(method))
    assert not os.path.exists(name) and os.path.isdir(name + ".d")
    # the port finds the directory store beside the missing file
    store = TO._open_backend(name, method)
    assert store.path == name + ".d" and store.exists() and store.initialized
    assert not TO._chain_incomplete(name, method)
    chain, logp, _ = TO.read_chain_and_cut(name, nk=2, method=method, flat=True)
    assert chain.shape[1] == 2 and np.isfinite(chain).all()
    # export: the JAX package reads every dataset and the state
    TB.export_hdf5(name + ".d", name)
    jcls = JB.EmceeBackend if method == "nuts" else JB.ZeusBackend
    j = jcls(name)
    npt.assert_array_equal(j.get_chain(), store.get_chain())
    npt.assert_array_equal(j.get_log_prob(), store.get_log_prob())
    npt.assert_array_equal(j.get_value("chain_transformed"), store.get_value("chain_transformed"))
    assert j.iteration == 20
    blob_j, blob_t = j.load_state(), store.load_state()
    assert set(blob_j) == set(blob_t)
    for k in blob_t:
        npt.assert_array_equal(blob_j[k], blob_t[k])
    if method == "nuts":
        import h5py

        with h5py.File(name, "r") as f, TB._DirFile(name + ".d") as g:
            npt.assert_array_equal(f["mcmc/accepted"][:], g["mcmc"]["accepted"][:])
    # the exported file now comes first, and resumes in either package
    assert TO._open_backend(name, method).path == name
    monkeypatch.setattr(JPC, "calc_hess_mass_mat", _no_search)
    with pytest.warns(UserWarning, match="fields do not match"):
        again = JR.run_ensemble(LP_J, x0, d, method=method, max_iterations=30,
                                shard_walkers=False, **KW)
    assert again.iteration == 30
