"""The public helpers of the JAX package that the port now carries, held
against the JAX package on the same numpy inputs:

- ``utils/checkpoint.checkpoint_exists`` and ``params_from_raw`` on
  checkpoints written by either package (exact: the same float32 bytes);
- ``priors.priors_to_list``, ``save_priors`` and ``load_priors``: a priors
  JSON written by one package loads in the other, Gaussian and flat mixed
  (exact);
- ``samplers/backends.get_last_log_prob`` on the HDF5 store (written by
  either package) and on the directory store the card uses (exact);
- ``likelihood.make_grad_log_prob`` against JAX's at 6 -> 40, log10 rows
  that are -inf included (zero gradient in both): float32 autograd of the
  same composition in two libraries, within rtol 1e-5 of the largest entry;
- ``make_hessian_log_prob``: the plain composition against JAX's within
  1e-5 of the largest entry; both packages refuse the Hessian of their
  fused kernel with a TypeError (JAX's ``custom_vjp`` refuses forward mode;
  the port's ``autograd.Function`` has no forward-mode rule)."""

import jax
import numpy as np
import numpy.testing as npt
import pytest
import torch

import _torch_parity as TPY
from linna_tpu import likelihood as JLK
from linna_tpu import priors as JP
from linna_tpu.ops import fused as JF
from linna_tpu.samplers import backends as JB
from linna_tpu.utils import checkpoint as JC
from linna_tpu_torch import likelihood as TLK
from linna_tpu_torch import priors as TP
from linna_tpu_torch.ops import fused as TF
from linna_tpu_torch.samplers import backends as TB
from linna_tpu_torch.utils import checkpoint as TC

torch.set_num_threads(1)

PRIORS = [
    {"param": "a", "dist": "gauss", "arg1": 0.3, "arg2": 0.05},
    {"param": "b", "dist": "flat", "arg1": -1.5, "arg2": 2.25},
    {"param": "c", "dist": "gauss", "arg1": -0.1, "arg2": 1.7},
    {"param": "d", "dist": "flat", "arg1": 0.0, "arg2": 1e-3},
]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_exists_and_params_from_raw_across_packages(tmp_path, writer):
    pb = TPY.problem(ndim=4, ndata=6)
    path = str(tmp_path / "best.ckpt.npz")
    assert not JC.checkpoint_exists(path) and not TC.checkpoint_exists(path)
    if writer == "jax":
        JC.save_checkpoint(path, pb.params_j, None, {"epoch": 3})
    else:
        TC.save_checkpoint(path, pb.params_t, None, {"epoch": 3})
    assert JC.checkpoint_exists(path) and TC.checkpoint_exists(path)
    arrays_t, meta_t = TC.read_checkpoint_raw(path)
    arrays_j, meta_j = JC.read_checkpoint_raw(path)
    assert meta_t == meta_j == {"epoch": 3}
    got = TC.params_from_raw(pb.params_t, arrays_t, device="cpu")
    want = JC.params_from_raw(pb.params_j, arrays_j)
    for layer, leaves in jax.device_get(want).items():
        for name, leaf in leaves.items():
            if isinstance(leaf, dict):
                for k, v in leaf.items():
                    npt.assert_array_equal(got[layer][name][k].numpy(), v)
            else:
                npt.assert_array_equal(got[layer][name].numpy(), leaf)
    wrong = {**pb.params_t, "layer1": {"w": torch.zeros(2, 2), "b": torch.zeros(2)}}
    with pytest.raises(ValueError, match="shape"):
        TC.params_from_raw(wrong, arrays_t, device="cpu")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_priors_json_across_packages(tmp_path, writer):
    path = str(tmp_path / "priors.json")
    pack_j, pack_t = JP.priors_from_list(PRIORS), TP.priors_from_list(PRIORS, "cpu")
    assert TP.priors_to_list(pack_t) == JP.priors_to_list(pack_j)
    if writer == "jax":
        JP.save_priors(path, pack_j)
    else:
        TP.save_priors(path, pack_t)
    with open(path) as f:
        text = f.read()
    back_t, back_j = TP.load_priors(path, "cpu"), JP.load_priors(path)
    for got, want in zip(back_t, jax.device_get(back_j)):
        npt.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(back_t, pack_t):
        assert torch.equal(got, want)
    assert [p["dist"] for p in TP.priors_to_list(back_t)] == ["gauss", "flat", "gauss", "flat"]
    assert '"gauss"' in text and '"flat"' in text


def _chain(rng, n=5, w=6, d=3):
    return rng.normal(size=(n, w, d)), rng.normal(size=(n, w))


@pytest.mark.parametrize("layout", ["emcee", "zeus"])
@pytest.mark.parametrize("store", ["hdf5-jax", "hdf5-port", "dir"])
def test_get_last_log_prob(tmp_path, monkeypatch, layout, store):
    rng = np.random.default_rng(4)
    (c1, l1), (c2, l2) = _chain(rng), _chain(rng)
    fname = str(tmp_path / ("chemcee_256.h5" if layout == "emcee" else "zeus_256.h5"))
    if store == "dir":
        monkeypatch.setattr(TB, "_h5", lambda: TB._DirModule)
    pkg = JB if store == "hdf5-jax" else TB
    if layout == "emcee":
        b = pkg.EmceeBackend(fname)
        b.reset(6, 3)
        b.append(c1, l1, np.ones(6))
        b.append(c2, l2, np.ones(6))
    else:
        b = pkg.ZeusBackend(fname)
        b.append(c1, l1)
        b.append(c2, l2)
    port = TB.EmceeBackend(fname) if layout == "emcee" else TB.ZeusBackend(fname)
    npt.assert_array_equal(port.get_last_log_prob(), l2[-1])
    npt.assert_array_equal(port.get_last_sample(), c2[-1])
    if store == "dir":
        assert port.path.endswith(".h5.d")
    elif layout == "emcee":
        npt.assert_array_equal(JB.EmceeBackend(fname).get_last_log_prob(), l2[-1])


def _problem():
    pb = TPY.problem(ndim=6, ndata=40, log10=[2])
    # 16 walkers; the log10 lane puts some rows at -inf
    return pb, TPY.walkers(16, 6, scale=0.5)


def test_grad_log_prob_matches_jax():
    pb, x = _problem()
    lp_j, lp_t = TPY.log_probs(pb)
    want = np.asarray(JLK.make_grad_log_prob(lp_j)(x))
    got = TLK.make_grad_log_prob(lp_t)(torch.as_tensor(x)).numpy()
    rows = ~np.isfinite(lp_t(torch.as_tensor(x)).detach().numpy())
    assert 0 < rows.sum() < len(x)
    assert np.all(np.isfinite(want)) and np.all(np.isfinite(got))
    npt.assert_array_equal(got[rows], 0.0)
    npt.assert_array_equal(want[rows], 0.0)
    npt.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    # the fused route's plain version on the CPU gives the same gradient
    lp_f = TPY.log_probs(pb, use_fused=True)[1]
    got_f = TLK.make_grad_log_prob(lp_f)(torch.as_tensor(x)).numpy()
    npt.assert_allclose(got_f, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_hessian_log_prob_matches_jax_on_the_plain_path():
    pb, x = _problem()
    lp_j, lp_t = TPY.log_probs(pb)
    want = np.asarray(JLK.make_hessian_log_prob(lp_j)(x))
    got = TLK.make_hessian_log_prob(lp_t)(torch.as_tensor(x)).numpy()
    assert got.shape == (16, 6, 6) and np.all(np.isfinite(got))
    npt.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    npt.assert_allclose(got, np.swapaxes(got, 1, 2), rtol=0, atol=1e-5 * np.abs(got).max())


def test_hessian_of_the_fused_kernel_is_refused_by_both_packages():
    pb, x = _problem()
    # JAX: the Pallas kernel (interpret mode on the CPU) is a custom_vjp
    lp_kernel = JF.fused_log_prob(pb.spec, pb.params_j, pb.ts_j, pb.pack_j, pb.data,
                                  pb.inv_cov, interpret=True)
    with pytest.raises(TypeError, match="custom_vjp"):
        JLK.make_hessian_log_prob(lp_kernel)(x)
    assert np.all(np.isfinite(np.asarray(JLK.make_grad_log_prob(lp_kernel)(x))))
    # the port: the fused route, built either way, is refused before it runs
    lp_f = TPY.log_probs(pb, use_fused=True)[1]
    lp_k = TF.fused_log_prob(pb.tspec, pb.params_t, pb.ts_t, pb.pack_t, pb.data, pb.inv_cov,
                             device="cpu")
    for lp in (lp_f, lp_k):
        with pytest.raises(TypeError, match="forward-mode"):
            TLK.make_hessian_log_prob(lp)
    # JAX's make_log_prob(use_fused=True) has no kernel off the TPU: the
    # composition, whose Hessian is the plain one
    lp_jf = JLK.make_log_prob(pb.spec, pb.params_j, pb.ts_j, pb.pack_j, pb.data, pb.inv_cov,
                              use_fused=True)
    npt.assert_array_equal(np.asarray(JLK.make_hessian_log_prob(lp_jf)(x)),
                           np.asarray(JLK.make_hessian_log_prob(TPY.log_probs(pb)[0])(x)))
