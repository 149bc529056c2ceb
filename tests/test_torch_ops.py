"""The port's fused kernels (plain versions on the CPU) against the JAX
package's Pallas kernels in interpret mode and its plain composition.

The CUDA kernels themselves run only on the card (chip_smoke.py holds them
against these plain versions there).  Here the autograd.Function around
each kernel is driven with its launch replaced by the plain version, so its
backward (autograd of the plain composition, recomputed) is checked
against jax.grad."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linna_tpu import likelihood as JLK
from linna_tpu import nn as JN
from linna_tpu.ops import fused_apply as j_fused_apply
from linna_tpu.ops import fused_log_prob as j_fused_log_prob
from linna_tpu_torch import likelihood as TLK
from linna_tpu_torch import nn as TN
from linna_tpu_torch.ops import fused as TF
from linna_tpu_torch.ops import library as OL

from _torch_parity import CPU, problem, t, walkers

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_ops.py's likelihood tolerance


@pytest.mark.parametrize("batch", [1, 37, 129])  # ragged row tiles
def test_fused_apply_plain_matches_pallas_and_reference(batch):
    p = problem()
    x = walkers(batch, 5, seed=7)
    want = np.asarray(j_fused_apply(p.spec, p.params_j, x, interpret=True))
    got = TF.fused_apply(p.tspec, p.params_t, t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    ref = TN.apply_model(p.tspec, p.params_t, t(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_fused_apply_autograd_function_gradients(monkeypatch):
    p = problem(ndim=3, ndata=4)
    monkeypatch.setattr(TF, "_launch_apply", lambda spec, x, w: TF._trunk_plain(x, w))
    x = walkers(8, 3, seed=8)
    weights = [w.clone().requires_grad_(True) for w in TF.flatten_params(p.params_t)]
    xt = t(x).requires_grad_(True)
    out = TF._FusedApply.apply(p.tspec, xt, *weights)
    torch.sum(out**2).backward()

    def loss(params, xx):
        return jnp.sum(JN.apply_model(p.spec, params, xx) ** 2)

    gp, gx = jax.grad(loss, argnums=(0, 1))(p.params_j, x)
    want = [np.asarray(a) for a in TF.flatten_params(gp)]
    for w, g in zip(weights, want):
        np.testing.assert_allclose(w.grad.numpy(), g, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("batch", [1, 8, 37, 129])
def test_fused_log_prob_matches_pallas_and_reference(batch):
    p = problem()
    x = walkers(batch, 5, seed=9)
    lp_t = TF.fused_log_prob(
        p.tspec, p.params_t, p.ts_t, p.pack_t, p.data, p.inv_cov,
        temperature=4.0, device=CPU,
    )
    got = lp_t(t(x)).numpy()
    pallas = np.asarray(
        j_fused_log_prob(
            p.spec, p.params_j, p.ts_j, p.pack_j, p.data, p.inv_cov,
            temperature=4.0, interpret=True,
        )(x)
    )
    ref = np.asarray(
        JLK.make_log_prob(p.spec, p.params_j, p.ts_j, p.pack_j, p.data, p.inv_cov,
                          temperature=4.0)(x)
    )
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)


def test_fused_log_prob_log10_rejects_nonpositive():
    p = problem(log10=[0])
    lp_t = TF.fused_log_prob(
        p.tspec, p.params_t, p.ts_t, p.pack_t, p.data, p.inv_cov, device=CPU
    )
    # param 0 is gauss (mean 0.2, sigma 1.1): whitened -3 -> physical -3.1
    x = np.zeros((4, 5), np.float32)
    x[1, 0] = -3.0
    x[3, 0] = -5.0
    got = lp_t(t(x)).numpy()
    pallas = np.asarray(
        j_fused_log_prob(p.spec, p.params_j, p.ts_j, p.pack_j, p.data, p.inv_cov,
                         interpret=True)(x)
    )
    np.testing.assert_array_equal(got[[1, 3]], [-np.inf, -np.inf])
    np.testing.assert_array_equal(pallas[[1, 3]], [-np.inf, -np.inf])
    np.testing.assert_allclose(got[[0, 2]], pallas[[0, 2]], **TOL)


def test_fused_log_prob_ypositive():
    p = problem(ndim=3, ndata=6, ypositive=True)
    x = walkers(16, 3, seed=11, scale=0.3)
    got = TF.fused_log_prob(
        p.tspec, p.params_t, p.ts_t, p.pack_t, p.data, p.inv_cov, device=CPU
    )(t(x)).numpy()
    want = np.asarray(
        JLK.make_log_prob(p.spec, p.params_j, p.ts_j, p.pack_j, p.data, p.inv_cov)(x)
    )
    pallas = np.asarray(
        j_fused_log_prob(p.spec, p.params_j, p.ts_j, p.pack_j, p.data, p.inv_cov,
                         interpret=True)(x)
    )
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)


def test_fused_rejects_linear_bypass_spec():
    p = problem(ndim=3, ndata=6)
    spec_lin = TN.make_model_spec("chto_v2_linear", 3, 6)
    params_lin = TN.params_from_numpy(
        jax.device_get(JN.init_model(jax.random.key(0), JN.make_model_spec("chto_v2_linear", 3, 6))),
        CPU,
    )
    with pytest.raises(ValueError, match="fused kernels do not implement chto_v2_linear's 1e-3 linear bypass"):
        TF.fused_apply(spec_lin, params_lin, torch.zeros((4, 3)))
    with pytest.raises(ValueError, match="fused_log_prob does not implement chto_v2_linear's 1e-3 linear bypass"):
        TF.fused_log_prob(spec_lin, params_lin, p.ts_t, p.pack_t, p.data, p.inv_cov, device=CPU)
    # make_log_prob does not route such a spec to the fused path
    lp = TLK.make_log_prob(spec_lin, params_lin, p.ts_t, p.pack_t, p.data, p.inv_cov,
                           use_fused=True, device=CPU)
    OL.reset_counts()
    want = TLK.make_log_prob(spec_lin, params_lin, p.ts_t, p.pack_t, p.data, p.inv_cov,
                             device=CPU)(torch.zeros((2, 3)))
    np.testing.assert_allclose(lp(torch.zeros((2, 3))).numpy(), want.numpy(), rtol=1e-6)
    assert OL.plain_calls["fused_log_prob"] == 0


def test_fused_log_prob_exposes_env_decomposition():
    p = problem(ndim=3, ndata=6)
    lp = TF.fused_log_prob(p.tspec, p.params_t, p.ts_t, p.pack_t, p.data, p.inv_cov, device=CPU)
    assert hasattr(lp, "_pure") and hasattr(lp, "_env")
    x = t(walkers(8, 3, seed=12))
    np.testing.assert_allclose(lp._pure(x, lp._env).numpy(), lp(x).numpy(), rtol=1e-6)
    assert set(lp._env) == {"params", "transforms", "priors", "data", "inv_cov",
                            "temperature", "k_std"}


def test_fused_log_prob_autograd_function_gradient(monkeypatch):
    p = problem(ndim=4, ndata=8)
    monkeypatch.setattr(
        TF, "_launch_log_prob",
        lambda spec, x, env, ypositive, args: TF.fused_log_prob_plain(spec, x, env, ypositive),
    )
    lp = TF.fused_log_prob(p.tspec, p.params_t, p.ts_t, p.pack_t, p.data, p.inv_cov, device=CPU)
    x = walkers(6, 4, seed=10)
    xt = t(x).requires_grad_(True)
    env = lp._env
    meta = (p.tspec, False, env, TLK.make_log_prob(
        p.tspec, p.params_t, p.ts_t, p.pack_t, p.data, p.inv_cov, device=CPU)._pure, None)
    out = TF._FusedLogProb.apply(meta, xt, *TF.tree_tensors(env))
    out.sum().backward()
    j_lp = JLK.make_log_prob(p.spec, p.params_j, p.ts_j, p.pack_j, p.data, p.inv_cov)
    g_ref = np.asarray(JLK.make_grad_log_prob(j_lp)(x))
    np.testing.assert_allclose(xt.grad.numpy(), g_ref, rtol=1e-4, atol=1e-5)


# ------------------------------------------------- fused_log_prob's launch plan

# the kernel's widths (fused.kernel_dims) of the DES-Y1 3x2pt and LSST-Y10 6x2pt+N
# emulators; every row count a sampling path launches (the MAP search's one
# row, a ragged 37, zeus's half-ensemble, NUTS's whole one, bench_fused's
# large batches)
PLAN_DIMS = {"des": [27, 1000, 500, 250, 125, 16, 32, 64, 500, 457],
             "lsst": [40, 1000, 500, 250, 125, 16, 32, 64, 500, 1560]}
PLAN_ROWS = (1, 37, 64, 128, 192, 256, 512, 4096, 16384)


@pytest.mark.parametrize("rows", PLAN_ROWS)
@pytest.mark.parametrize("width", sorted(PLAN_DIMS))
def test_log_prob_plan_covers_every_k_chunk_once(width, rows):
    plan = TF.log_prob_plan(PLAN_DIMS[width], rows)
    for p in plan["products"]:
        ranges = p["ranges"]
        assert len(ranges) == p["split"]
        assert ranges[0][0] == 0 and ranges[-1][1] == p["chunks"] == -(-p["K"] // TF.TILE_K)
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        if p["split"] > 1:
            assert all(k1 - k0 >= TF.MIN_SPLIT_CHUNKS for k0, k1 in ranges)


@pytest.mark.parametrize("width", sorted(PLAN_DIMS))
def test_log_prob_split_follows_the_widths_alone(width):
    dims = PLAN_DIMS[width]
    want = TF.log_prob_splits(dims)
    for rows in PLAN_ROWS:
        for sms, per_sm in ((132, 2), (132, 3), (66, 4), (8, 1)):
            plan = TF.log_prob_plan(dims, rows, sms, per_sm)
            assert [p["split"] for p in plan["products"]] == want
            assert [p["ranges"] for p in plan["products"]] == \
                [p["ranges"] for p in TF.log_prob_plan(dims, 1)["products"]]


@pytest.mark.parametrize("width", sorted(PLAN_DIMS))
def test_log_prob_plan_blocks_tell_the_sampler_row_counts_apart(width):
    # the benchmark tells a traced launch's rows by its grid: 128 and 256
    # (zeus's half-ensemble and whole one), and the MAP search's one row
    blocks = {rows: TF.log_prob_plan(PLAN_DIMS[width], rows)["blocks"] for rows in (1, 128, 256)}
    assert len(set(blocks.values())) == 3, blocks
    # and the grid grows with the rows until the card is full
    grids = [TF.log_prob_plan(PLAN_DIMS[width], rows)["blocks"] for rows in PLAN_ROWS]
    assert grids == sorted(grids) and grids[-1] == TF.H100[0] * TF.H100[1]


@pytest.mark.parametrize("rows", PLAN_ROWS)
@pytest.mark.parametrize("width", sorted(PLAN_DIMS))
def test_log_prob_plan_grid_fits_the_card_and_the_scratch(width, rows):
    for sms, per_sm in (TF.H100, (132, 3), (8, 1)):
        plan = TF.log_prob_plan(PLAN_DIMS[width], rows, sms, per_sm)
        assert 1 <= plan["blocks"] <= plan["capacity"] == sms * per_sm
        fl = plan["floats"]
        tile = TF.TILE_ROWS * TF.TILE_COLS
        for p in plan["products"]:
            assert p["tiles"] == plan["row_tiles"] * sum(p["col_tiles"])
            # a local product's tiles alone fill the grid; the others' items
            # (tiles x split) each have a partial tile in the scratch
            assert p["local"] == (p["split"] > 1 and p["tiles"] >= plan["blocks"])
            if p["split"] > 1:
                need = plan["blocks"] if p["local"] else p["tiles"] * p["split"]
                assert fl["part"] + need * tile <= fl["total"]
        order = [fl[k] for k in ("A", "B", "H", "X", "part", "total")]
        assert order == sorted(order) and all(v % 4 == 0 for v in order)
        assert len(plan["array"]) == TF.PLAN_LENGTH
        assert plan["array"][:3] == [plan["row_tiles"], plan["blocks"], plan["deal"]]
        # block b takes work item b * deal mod blocks first: a permutation
        assert sorted(b * plan["deal"] % plan["blocks"] for b in range(plan["blocks"])) == \
            list(range(plan["blocks"]))


@pytest.mark.parametrize("walkers,design", [(0, "tiled"), (8, "tiled"), (16, "cluster"),
                                            (24, "cluster")])
def test_log_prob_design_follows_the_walkers_a_cluster_holds(walkers, design):
    # the cluster design where a cluster holds 16 walkers or more at the
    # widths (the DES width holds 24 on the H100, the LSST width 8)
    assert TF.log_prob_design(walkers) == design
