"""The composition's value-and-gradient kernel on the CPU: its host plan,
its plain version, the route ``make_log_prob`` takes to it and the counter.

The kernel runs on the card only (``tests/test_torch_composition_grad_card.py``);
here the route's device test (``Tensor.is_cuda``) is stood in for, so that a
gradient call on the CPU reaches the plain version,
:meth:`composition.GradRoute.value_and_grad_plain`: autograd of the
composition's chi^2, weighed by the kernel's combining pass."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from linna_tpu_torch import likelihood as LK
from linna_tpu_torch.ops import composition as CG
from linna_tpu_torch.ops import fused as F
from linna_tpu_torch.ops import library as OL
from linna_tpu_torch.samplers import hmc
from linna_tpu_torch.samplers import precondition as PC

from _torch_composition import (composition, likelihood, problem, row_gap, standardized,
                                walkers)

torch.set_num_threads(1)
CPU = torch.device("cpu")
DES = F.kernel_dims(LK.N.make_model_spec("chto_v2", 27, 457))
LSST = F.kernel_dims(LK.N.make_model_spec("chto_v2", 40, 1560))
# The plain version against the composition: values to float32 rounding;
# each row's gradient, over that row's norm, against float64 autograd, where
# PyTorch's own float32 autograd misses by up to 1.3e-5 (the ensemble's std
# weight (chi2_k - mean) / std divides by the members' chi^2 spread, which
# float32 rounds: ypositive at K = 2 here) and the plain version by 2.5e-5.
VALUE_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL = 5e-5
# two float32 computations of the same gradient (the route against the
# composition's autograd): twice that
PAIR_RTOL = 1e-4


@pytest.fixture
def on_card(monkeypatch):
    """The route's device test passes CPU tensors: a gradient call reaches
    the plain version (which dispatches by the device's type)."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    OL.reset_counts()
    yield
    OL.reset_counts()


def _tree(fn, tree):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


# ---------------------------------------------------------------- the plan


@pytest.mark.parametrize("members", [1, 2, 4])
@pytest.mark.parametrize("dims", [DES, LSST], ids=["des", "lsst"])
def test_plan_is_a_function_of_widths_members_and_rows(dims, members):
    plans = {rows: CG.plan(dims, members, rows) for rows in (1, 37, 128, 256, 4096)}
    splits = {rows: [p["split"] for p in pl["products"]] for rows, pl in plans.items()}
    # the k split follows the widths and the members, never the rows
    assert len({tuple(s) for s in splits.values()}) == 1
    assert splits[256] == [F.k_split(k, w, CG.SPLIT_ROW_TILES, m)
                           for k, w, m in CG.products(dims, members)]
    for rows, pl in plans.items():
        assert pl == CG.plan(dims, members, rows)  # pure
        assert len(pl["array"]) == CG.PLAN_LENGTH
        assert pl["row_tiles"] == -(-rows // F.TILE_ROWS)
        assert 1 <= pl["blocks"] <= pl["capacity"] == F.H100[0] * F.H100[1]
        assert pl["blocks"] == min(pl["capacity"], max(p["tiles"] * p["split"]
                                                        for p in pl["products"]))
        offs = [pl["floats"][b] for b in CG.BUFFERS] + [pl["floats"]["part"]]
        widths = CG.buffer_widths(dims)
        for b, (lo, hi) in enumerate(zip(offs, offs[1:])):
            ms = widths[b] if CG.BUFFERS[b] in ("S1", "GS1") else F.round4(widths[b])
            assert lo % 4 == 0 and hi - lo >= rows * members * ms
        for p in pl["products"]:
            nk = -(-p["K"] // F.TILE_K)
            assert p["split"] == 1 or p["split"] <= nk // F.MIN_SPLIT_CHUNKS
            assert p["local"] == (p["split"] > 1 and p["tiles"] >= pl["blocks"])
            assert [a for a, _ in p["ranges"]] == [q * nk // p["split"] for q in range(p["split"])]
        part = max([(pl["blocks"] if p["local"] else p["items"]) * F.TILE_ROWS * F.TILE_COLS
                    for p in pl["products"] if p["split"] > 1], default=0)
        assert pl["floats"]["total"] == pl["floats"]["part"] + part


def test_plan_products_walk_the_layers_and_back():
    i, h, h2, h4, h8, c1, c2, c3, l6, out = DES
    prods = CG.products(DES, 2)
    assert len(prods) == CG.PRODUCTS
    assert prods[0] == (i, (h,), 2) and prods[10] == (out, (out, out), 2)
    assert prods[11] == (out, (out,), 2) and prods[-2] == (c1, (h,), 2)
    # layer 1's gradient: the members side by side, summed in the k loop
    assert prods[-1] == (2 * h, (i,), 1)
    # the DES plan at K = 2: the splits the card runs
    assert [p["split"] for p in CG.plan(DES, 2, 256)["products"]] == [
        1, 3, 1, 6, 1, 4, 1, 2, 4, 4, 2, 4, 4, 8, 2, 1, 3, 1, 1, 1, 31]


def test_operations_count_each_product_once():
    # two for each multiply-add of the 21 products, a row and member
    per_row = CG.operations(DES, 1, 1)
    assert per_row == 2 * sum(k * sum(w) for k, w, _ in CG.products(DES, 1)) == 5_855_792
    assert CG.operations(DES, 2, 256) == 2 * 256 * per_row
    assert CG.operations(LSST, 4, 37) == 4 * 37 * CG.operations(LSST, 1, 1)


@pytest.mark.parametrize("members,dims", [(0, DES), (CG.MAX_MEMBERS + 1, DES),
                                          (2, [27, 1002, 501, 250, 125, 16, 32, 64, 500, 457])],
                         ids=["no members", "too many members", "hidden not a multiple of 4"])
def test_plan_refuses_what_the_kernel_does_not_take(members, dims):
    assert not CG.supports(dims, members)
    with pytest.raises(ValueError):
        CG.plan(dims, members, 256)


# ------------------------------------------------------ the plain version


@pytest.mark.parametrize("k_std", [0.0, 1.0])
@pytest.mark.parametrize("ypositive", [False, True])
@pytest.mark.parametrize("members", [1, 2, 4])
def test_plain_version_is_the_composition_and_its_gradient(members, ypositive, k_std):
    lp, spec = problem(CPU, 5, 12, members, ypositive=ypositive, k_std=k_std,
                       symmetric=False)
    x_in = standardized(lp, walkers(23, 5, CPU))
    want_lp, want_g = likelihood(spec, lp, x_in)
    got_lp, got_g = lp._route.value_and_grad(x_in)
    torch.testing.assert_close(got_lp.double(), want_lp, **VALUE_TOL)
    assert row_gap(got_g, want_g) < GRAD_RTOL


def test_plain_version_takes_a_subgradient_where_the_members_agree():
    lp, spec = problem(CPU, 5, 12, 2)
    env = lp._env
    # both members the same network: std 0, where torch's std backward is NaN
    env["params"] = _tree(lambda v: v[:1].expand_as(v).clone(), env["params"])
    x_in = standardized(lp, walkers(4, 5, CPU))
    got_lp, got_g = lp._route.value_and_grad(x_in)
    assert torch.isfinite(got_g).all()
    # equal members: each weighs half, the std nothing
    single = _tree(lambda v: v[0].reshape(v.shape[-1]) if v.shape[1] == 1 else v[0],
                   env["params"])
    one = LK.make_log_prob(spec, single, env["transforms"], env["priors"], env["data"],
                           env["inv_cov"], temperature=float(env["temperature"]), device=CPU)
    one_lp, one_g = likelihood(spec, one, x_in)
    torch.testing.assert_close(got_lp.double(), one_lp, **VALUE_TOL)
    assert row_gap(got_g, one_g) < GRAD_RTOL


def test_prepare_copies_and_transposes_once_and_refuses_a_later_change():
    lp, spec = problem(CPU, 5, 12, 2)
    env = lp._env
    route = lp._route
    arrays = route.prepare()
    assert route.prepare() is arrays  # nothing changed: not made again
    weights, like, k_std, transposed = route.snapshot[2]
    w = F.flatten_params(env["params"])
    h, d = spec.hidden, spec.in_size
    # copies: a captured graph's pointers never see the env's storage
    assert all(torch.equal(a, b) and a.data_ptr() != b.data_ptr() for a, b in zip(weights, w))
    assert torch.equal(like[10], env["inv_cov"]) and torch.equal(k_std, env["k_std"])
    assert len(transposed) == 14
    assert torch.equal(transposed[0], w[21].transpose(-1, -2))  # layer 8
    assert torch.equal(transposed[3], w[16].transpose(-1, -2))  # rb3's skip
    assert torch.equal(transposed[12], w[0].transpose(-1, -2).reshape(2 * h, d))
    assert torch.equal(transposed[13], env["inv_cov"].T)
    with torch.no_grad():
        env["params"]["layer8"]["w"].mul_(2.0)  # written in place
    with pytest.raises(RuntimeError, match="replaced or written"):
        route.prepare()
    assert torch.equal(route.snapshot[2][3][0], 0.5 * w[21].transpose(-1, -2))
    lp, _ = problem(CPU, 5, 12, 2)
    lp._route.prepare()
    lp._env["temperature"] = lp._env["temperature"].clone()  # replaced
    with pytest.raises(RuntimeError, match="replaced or written"):
        lp._route.prepare()


def test_prepare_checks_the_weights():
    lp, _ = problem(CPU, 5, 12, 2)
    lp._env["params"]["layer8"]["w"] = lp._env["params"]["layer8"]["w"][:, :3]
    with pytest.raises(ValueError):
        lp._route.prepare()


def test_func_transform_probe_sees_torch_func():
    """The route's one private PyTorch call (the functorch interpreter
    stack): False outside a transform, True inside each kind the
    preconditioner and the Hessians use."""
    seen = []

    def f(x):
        seen.append(CG.func_transform_active())
        return (x ** 2).sum()

    assert not CG.func_transform_active()
    x = torch.ones(3)
    torch.func.grad(f)(x)
    torch.func.vmap(f)(x[None])
    torch.func.hessian(f)(x)
    assert seen and all(seen)
    assert not CG.func_transform_active()


# --------------------------------------------------------------- the route


@pytest.mark.parametrize("members", [1, 2])
def test_gradient_calls_take_the_route(on_card, members):
    lp, spec = problem(CPU, 5, 12, members)
    x = walkers(19, 5, CPU)
    want_lp, want_g = hmc.value_and_grad(composition(lp), x)
    assert OL.plain_calls["composition_grad"] == 0
    got_lp, got_g = hmc.value_and_grad(lp, x)
    assert OL.plain_calls["composition_grad"] == 1
    assert OL.launches["composition_grad"] == 0
    torch.testing.assert_close(got_lp, want_lp, **VALUE_TOL)
    assert row_gap(got_g, want_g) < PAIR_RTOL
    # through the preconditioner's linear map too: autograd carries it
    pre = PC.Preconditioner(np.zeros(5), np.linalg.qr(np.random.default_rng(0).normal(
        size=(5, 5)))[0], np.full(5, 2.0))
    wrapped = pre.wrap_log_prob(lp)
    y = walkers(7, 5, CPU, seed=3)
    got = hmc.value_and_grad(wrapped, y)[1]
    want = hmc.value_and_grad(pre.wrap_log_prob(composition(lp), device=CPU), y)[1]
    assert OL.plain_calls["composition_grad"] == 2
    assert row_gap(got, want) < PAIR_RTOL


def _value_only(lp, call, x):
    with torch.no_grad():
        return call(x)


def _grad_mode_off(lp, call, x):
    with torch.no_grad():
        return call(x.clone().requires_grad_(True))


def _input_without_grad(lp, call, x):
    with torch.enable_grad():
        return call(x)


def _env_leaf_requires_grad(lp, call, x):
    lp._env["data"].requires_grad_(True)
    try:
        return hmc.value_and_grad(call, x)[1]
    finally:
        lp._env["data"].requires_grad_(False)


def _func_grad(lp, call, x):
    return torch.func.vmap(torch.func.grad(lambda r: call(r[None])[0]))(x)


KEEP_CALLS = {"value only": _value_only, "grad mode off": _grad_mode_off,
              "input without grad": _input_without_grad,
              "env leaf requires grad": _env_leaf_requires_grad, "torch.func": _func_grad}


@pytest.mark.parametrize("call", list(KEEP_CALLS), ids=list(KEEP_CALLS))
def test_other_calls_keep_the_composition(on_card, call):
    lp, _ = problem(CPU, 5, 12, 2)
    x = walkers(9, 5, CPU)
    got = KEEP_CALLS[call](lp, lp, x)
    want = KEEP_CALLS[call](lp, composition(lp), x)
    assert OL.plain_calls["composition_grad"] == 0 and OL.launches["composition_grad"] == 0
    assert torch.equal(got, want)


def _premodel(x):
    return torch.zeros((*x.shape[:-1], 12))


KEEP_CONFIGS = {"bf16": dict(compute_dtype="bfloat16"), "out_cut": dict(out_cut=11),
                "loglike_fn": dict(members=1, loglike_fn=LK.gaussian_loglike),
                "external_loglike": dict(external_loglike=lambda xp: 0.0 * xp[..., 0]),
                "linearmodel": dict(linearmodel=_premodel)}


@pytest.mark.parametrize("config", list(KEEP_CONFIGS), ids=list(KEEP_CONFIGS))
def test_other_configurations_keep_the_composition(on_card, config):
    kw = dict(KEEP_CONFIGS[config])
    members = kw.pop("members", 2)
    lp, _ = problem(CPU, 5, 12, members, **kw)
    lp_v, g = hmc.value_and_grad(lp, walkers(9, 5, CPU))
    assert torch.isfinite(g).all()
    assert OL.plain_calls["composition_grad"] == 0 and OL.launches["composition_grad"] == 0


@pytest.mark.parametrize("members", [1, 2])
def test_hessians_work_on_the_composition(on_card, members):
    lp, spec = problem(CPU, 5, 12, members)
    x = walkers(3, 5, CPU)
    got = LK.make_hessian_log_prob(lp)(x)
    want = LK.make_hessian_log_prob(composition(lp))(x)
    assert OL.plain_calls["composition_grad"] == 0
    assert torch.equal(got, want)
    # the preconditioner: the MAP search's BFGS gradient takes the route,
    # its Hessian the composition under torch.func
    pre = PC.calc_hess_mass_mat(lp, np.zeros(5), maxiter=20, device=CPU)
    assert OL.plain_calls["composition_grad"] > 0
    assert np.isfinite(pre.scales).all() and pre.basis.shape == (5, 5)


def test_counter_key_exists_and_starts_at_zero():
    assert "composition_grad" in OL.KERNELS
    assert "composition_grad" not in OL.LIKELIHOOD_KERNELS
    out = subprocess.run(
        [sys.executable, "-c", "from linna_tpu_torch.ops import library as L; "
         "print(L.launches['composition_grad'], L.plain_calls['composition_grad'])"],
        capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["0", "0"]
    OL.plain_calls["composition_grad"] += 3
    OL.reset_counts()
    assert OL.plain_calls["composition_grad"] == 0
