"""The port's MAP + Hessian preconditioner against the JAX package's: the
MAP (rtol 1e-3: both run scipy's Nelder-Mead then BFGS from the same start
on f32 log-probs that differ in summation order) and the Hessian's
eigen-decomposition (the same curvature to rtol 2e-3) on smooth targets; the
round trip between the spaces; the wrapped log-prob at the MAP and its unit
curvature; and the kernel route, whose Hessian goes through the plain
composition."""

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from _torch_parity import GAUSS_MEAN, gauss_log_probs, log_probs, problem
from linna_tpu.samplers import precondition as JP
from linna_tpu_torch.samplers import precondition as TP

torch.set_num_threads(1)


def _curvature(pre):
    """The preconditioner's Hessian U diag(s^2) U^T (sign-free)."""
    return pre.basis @ np.diag(pre.scales**2) @ pre.basis.T


@pytest.mark.parametrize("target", ["gaussian", "emulator"])
def test_map_and_hessian_match_jax(target):
    if target == "gaussian":
        lp_j, lp_t = gauss_log_probs()
        x0 = np.zeros(2)
    else:
        pb = problem(ndim=4, ndata=6, seed=5)
        lp_j, lp_t = log_probs(pb)
        x0 = np.full(4, 0.1)
    pj = JP.calc_hess_mass_mat(lp_j, x0)
    pt = TP.calc_hess_mass_mat(lp_t, x0, device="cpu")
    npt.assert_allclose(pt.center, pj.center, rtol=1e-3, atol=1e-3)
    npt.assert_allclose(_curvature(pt), _curvature(pj), rtol=2e-3, atol=2e-3)
    npt.assert_allclose(np.sort(pt.scales), np.sort(pj.scales), rtol=2e-3)
    if target == "gaussian":
        npt.assert_allclose(pt.center, GAUSS_MEAN, atol=1e-2)


def test_round_trip_and_wrapped_log_prob():
    _, lp = gauss_log_probs()
    pre = TP.calc_hess_mass_mat(lp, np.zeros(2), device="cpu")
    x = np.array([[0.3, 0.7], [-1.0, 2.0]])
    npt.assert_allclose(pre.to_original(pre.to_sampling(x)), x, atol=1e-12)
    wrapped = pre.wrap_log_prob(lp, device="cpu")
    lp_map = float(lp(torch.as_tensor(pre.center, dtype=torch.float32)[None])[0])
    npt.assert_allclose(float(wrapped(torch.zeros((1, 2)))[0]), lp_map, atol=1e-4)
    h = torch.func.hessian(lambda y: wrapped(y[None])[0])(torch.zeros(2))
    npt.assert_allclose(h.numpy(), -np.eye(2), atol=0.05)
    x0 = pre.draw_x0(np.random.default_rng(0), 16)
    assert x0.shape == (16, 2) and x0.dtype == np.float32
    npt.assert_array_equal(x0, JP.Preconditioner(pre.center, pre.basis, pre.scales)
                           .draw_x0(np.random.default_rng(0), 16))


def test_kernel_route_takes_the_plain_hessian():
    """A ``use_fused=True`` likelihood carries its plain composition
    (``_plain_pure``), which the Hessian takes; the MAP search calls the
    likelihood itself.  The result is the plain likelihood's to the MAP
    search's own tolerance: the kernel's plain version sums in another
    order, so Nelder-Mead takes another path (atol 1e-3 on the MAP)."""
    pb = problem(ndim=4, ndata=6, seed=6)
    _, lp_plain = log_probs(pb)
    _, lp_fused = log_probs(pb, use_fused=True)
    assert lp_fused._plain_pure is not None and lp_fused._pure is not lp_fused._plain_pure
    x0 = np.full(4, 0.1)
    a = TP.calc_hess_mass_mat(lp_fused, x0, device="cpu")
    b = TP.calc_hess_mass_mat(lp_plain, x0, device="cpu")
    npt.assert_allclose(a.center, b.center, atol=1e-3)
    npt.assert_allclose(_curvature(a), _curvature(b), rtol=1e-2, atol=1e-3)
    wrapped = a.wrap_log_prob(lp_fused)
    y = torch.zeros((3, 4))
    npt.assert_allclose(wrapped(y).numpy(), a.wrap_log_prob(lp_plain)(y).numpy(), rtol=1e-5)
    jw = JP.Preconditioner(a.center, a.basis, a.scales).wrap_log_prob(log_probs(pb)[0])
    npt.assert_allclose(wrapped(y).numpy(), np.asarray(jw(jnp.zeros((3, 4)))), rtol=1e-5)


def test_ensemble_hessian_is_the_members_mean_chi2():
    """A K=2 ensemble's preconditioner is the curvature of the members'
    mean chi^2 (the JAX package's likelihood built with
    ``ensemble_k_std=0``, its Hessian taken by ``jax.hessian``) at the MAP
    of the full ensemble likelihood (mean + std), which JAX's search finds
    too (rtol 2e-3 and 1e-3, as above)."""
    import jax

    from linna_tpu import likelihood as JLK
    from linna_tpu_torch import likelihood as TLK

    pb, other = problem(ndim=4, ndata=6, seed=5), problem(ndim=4, ndata=6, seed=8)
    lp_t = TLK.make_log_prob(pb.tspec, [pb.params_t, other.params_t], pb.ts_t, pb.pack_t,
                             pb.data, pb.inv_cov, device="cpu")
    members_j = [pb.params_j, other.params_j]
    lp_j = JLK.make_log_prob(pb.spec, members_j, pb.ts_j, pb.pack_j, pb.data, pb.inv_cov)
    mean_j = JLK.make_log_prob(pb.spec, members_j, pb.ts_j, pb.pack_j, pb.data, pb.inv_cov,
                               ensemble_k_std=0.0)
    x0 = np.full(4, 0.1)
    pt = TP.calc_hess_mass_mat(lp_t, x0, device="cpu")
    npt.assert_allclose(pt.center, JP.calc_hess_mass_mat(lp_j, x0).center, rtol=1e-3, atol=1e-3)
    hess = -np.asarray(jax.hessian(lambda x: mean_j(x[None])[0])(
        jnp.asarray(pt.center, jnp.float32)), dtype=np.float64)
    assert np.all(np.linalg.eigvalsh(0.5 * (hess + hess.T)) > 0)
    npt.assert_allclose(_curvature(pt), 0.5 * (hess + hess.T), rtol=2e-3, atol=2e-3)
