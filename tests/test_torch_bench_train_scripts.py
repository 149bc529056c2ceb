"""The port's training measurement scripts on the CPU: ``bench_train_torch.py``,
``bench_train_profile_torch.py``, ``bench_dispatch_torch.py`` and
``bench_allopts_torch.py`` against the JAX package and its scripts.  The
seeded training set and its fitted transforms are the JAX scripts' bit for
bit; the profile's ``full``, ``no_opt`` and ``fwd_only`` steps take one
minibatch step from the JAX weights and give ``bench_train_profile.py``'s
loss, summed gradients and AdamW update; each script's ``main`` runs at a
small size with ``device="cpu"`` and prints the JAX script's keys; the
all-options pipeline writes its option artifacts; and nothing lands at the
repository root."""

import contextlib
import io
import json
import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import optax
import pytest
import torch

import linna_tpu_torch
from linna_tpu import losses as JL
from linna_tpu import nn as JN
from linna_tpu import transforms as JT
from linna_tpu.train import _make_optimizer

REPO = pathlib.Path(linna_tpu_torch.__file__).parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
import bench_allopts_torch as BA  # noqa: E402
import bench_dispatch_torch as BD  # noqa: E402
import bench_torch_common as BC  # noqa: E402
import bench_train_profile_torch as BP  # noqa: E402
import bench_train_torch as BT  # noqa: E402

torch.set_num_threads(1)

NDIM, NDATA = 4, 8  # hidden 256
N_TRAIN, N_VAL = 2000, 100  # four minibatches of 500


def test_training_set_and_transforms_are_the_jax_scripts_bit_for_bit():
    """The rows of ``bench_train.py:44-49`` (the same lines in
    ``bench_dispatch.py`` and ``bench_train_profile.py``) and the transforms
    and loss state fitted on them (``bench_train.py:50-54``)."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((NDIM, NDATA)) / np.sqrt(NDIM)
    tx = np.asarray(rng.uniform(-1, 1, (N_TRAIN, NDIM)), np.float32)
    ty = np.asarray(tx @ w, np.float32)
    vx = np.asarray(rng.uniform(-1, 1, (N_VAL, NDIM)), np.float32)
    vy = np.asarray(vx @ w, np.float32)
    got = BC.training_set(NDIM, NDATA, N_TRAIN, N_VAL)
    for a, b in zip(got, (tx, ty, vx, vy)):
        assert a.dtype == np.float32
        npt.assert_array_equal(a, b)
    tset = JT.TransformSet(JT.fit_x_transform(tx, None), JT.fit_y_transform(ty, ypositive=False),
                           JT.YTransformData(jnp.ones(NDATA, jnp.float32)))
    ls = JL.build_loss_state(np.zeros(NDATA), np.eye(NDATA), tset)
    spec, ts_t, ls_t = BC.training_problem(got[0], got[1], "cpu")
    assert spec == BP.make_stack((spec, ts_t, ls_t), "cpu", None).spec
    assert (spec.in_size, spec.out_size, spec.hidden) == (NDIM, NDATA, 256)
    for a, b in ((ts_t.x_transform.mean, tset.x_transform.mean),
                 (ts_t.x_transform.std, tset.x_transform.std),
                 (ts_t.y_transform.mean, tset.y_transform.mean),
                 (ts_t.y_transform.std, tset.y_transform.std),
                 (ts_t.y_data.sigma, tset.y_data.sigma),
                 (ls_t.inv_transformed_cov, ls.inv_transformed_cov),
                 (ls_t.data_std, ls.data_std)):
        npt.assert_array_equal(a.numpy(), np.asarray(b))


def _jax_step(variant):
    """``bench_train_profile.py``'s minibatch step (its ``epochs_program``
    step with ``do_opt``/``do_bwd``, float32) on one member: (params,
    opt_state, rows) -> (loss, summed gradients or None, new params)."""
    def build(spec, tset, loss_state, tx, ty):
        optimizer = _make_optimizer()

        def member_loss(p, bx, by):
            pred = JN.apply_model(spec, p, tset.x_transform(bx))
            return JL.loss_fn(loss_state, tset, pred, by)

        def step(p, s, idx):
            if variant == "fwd_only":
                return member_loss(p, tx[idx], ty[idx]), None, p
            loss, grads = jax.value_and_grad(member_loss)(p, tx[idx], ty[idx])
            gsum = sum(jnp.sum(g) for g in jax.tree.leaves(grads))
            if variant == "no_opt":
                return loss + 0.0 * gsum, gsum, p
            updates, s = optimizer.update(grads, s, p)
            return loss, gsum, optax.apply_updates(p, updates)

        return optimizer, jax.jit(jax.vmap(step, in_axes=(0, 0, None)))

    return build


@pytest.fixture(scope="module")
def one_step():
    """Both packages' problem at NDIM -> NDATA, two members from the JAX
    weights, and one minibatch of rows."""
    tx, ty, vx, vy = BC.training_set(NDIM, NDATA, N_TRAIN, N_VAL)
    tset = JT.TransformSet(JT.fit_x_transform(tx, None), JT.fit_y_transform(ty, ypositive=False),
                           JT.YTransformData(jnp.ones(NDATA, jnp.float32)))
    ls = JL.build_loss_state(np.zeros(NDATA), np.eye(NDATA), tset)
    spec = JN.make_model_spec("chto_v2", NDIM, NDATA)
    params = jax.vmap(lambda k: JN.init_model(k, spec))(jax.random.split(jax.random.key(0), 2))
    idx = np.random.default_rng(5).permutation(N_TRAIN)[:BP.BATCH]
    members = [jax.device_get(jax.tree.map(lambda a: a[m], params)) for m in range(2)]
    return dict(rows=(tx, ty, vx, vy), tset=tset, ls=ls, spec=spec, params=params,
                members=members, idx=idx)


@pytest.mark.parametrize("variant", ["full", "no_opt", "fwd_only"])
def test_profile_step_takes_the_jax_scripts_step(one_step, variant):
    """One step of the variant from the same weights on the same rows, in
    float32: each member's loss within rtol 1e-5, the summed gradient
    within rtol 1e-5 or 1e-5 of the sum of its elements' magnitudes (terms
    of both signs cancel in it), and after AdamW each parameter within
    1e-6 of JAX's (the first step moves each by about lr = 1e-4); float32
    sums in another order."""
    o = one_step
    tx, ty = o["rows"][:2]
    optimizer, jstep = _jax_step(variant)(o["spec"], o["tset"], o["ls"], jnp.asarray(tx),
                                          jnp.asarray(ty))
    opt_state = jax.vmap(optimizer.init)(o["params"])
    loss_j, gsum_j, new_j = jstep(o["params"], opt_state, jnp.asarray(o["idx"]))

    problem = BC.training_problem(tx, ty, "cpu")
    stack = BP.make_stack(problem, "cpu", None, params=o["members"])
    data = stack._prepare(*o["rows"])
    kind = BP.VARIANTS[variant][0]
    idx = torch.as_tensor(o["idx"]).expand(2, -1)
    start = stack.flat.clone()
    if gsum_j is not None:
        loss, leaves = stack._loss(data, idx)
        grad = stack._grad(loss, leaves)
        npt.assert_allclose(grad.sum(dim=1).numpy(), np.asarray(gsum_j), rtol=1e-5,
                            atol=1e-5 * float(grad.abs().sum(dim=1).max()))
    with torch.enable_grad():
        loss_t = BP.step_body(stack, data, kind)(idx)
    npt.assert_allclose(loss_t.numpy(), np.asarray(loss_j), rtol=1e-5)
    want = torch.stack([stack.layout.flatten(jax.device_get(jax.tree.map(lambda a: a[m], new_j)))
                        for m in range(2)])
    if variant == "full":
        assert float((stack.flat - start).abs().max()) > 5e-5  # AdamW moved every member
        npt.assert_allclose(stack.flat.numpy(), want.numpy(), rtol=0, atol=1e-6)
        assert int(stack.opt.count.max()) == 1
    else:
        assert torch.equal(stack.flat, start) and torch.equal(want, start)


def test_profile_variants_hold_their_steps_and_replays():
    """Every variant of the ladder, ``full_unroll2/4`` as steps of 2 and 4
    minibatches, and a refused split."""
    tx, ty, vx, vy = BC.training_set(NDIM, NDATA, N_TRAIN, N_VAL)
    stack = BP.make_stack(BC.training_problem(tx, ty, "cpu"), "cpu", "bfloat16")
    data = stack._prepare(tx, ty, vx, vy)
    perms = BP.draw_perms(2, 2, N_TRAIN, "cpu")
    assert tuple(perms.shape) == (2, 4, 2, BP.BATCH)
    assert sorted(perms[0, :, 1].reshape(-1).tolist()) == list(range(N_TRAIN))
    nb = {name: BP.Variant(stack, data, perms, name, graphed=False).nb // BP.VARIANTS[name][2]
          for name in BP.VARIANTS}
    assert nb == {**{n: 4 for n in BP.VARIANTS}, "full_unroll2": 2, "full_unroll4": 1,
                  "megabatch": 1}
    with pytest.raises(ValueError, match="do not split"):
        BP.Variant(stack, data, BP.draw_perms(1, 2, 1500, "cpu"), "full_unroll2", False)


def _json_lines(out: str) -> list:
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def _listing():
    return sorted(p for p in os.listdir(REPO) if p != "__pycache__")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each script's main at a small size, its printed lines captured, the
    repository root listed before and after."""
    tmp = tmp_path_factory.mktemp("bench_train_scripts")
    before = _listing()
    mp = pytest.MonkeyPatch()
    mp.setattr(BC.tempfile, "gettempdir", lambda: str(tmp))
    mp.syspath_prepend(str(REPO / "tests"))
    small = dict(n_train=N_TRAIN, n_val=N_VAL, ndim=NDIM, ndata=NDATA)
    calls = {
        "train": lambda: BT.main("cpu", epochs=2, **small),
        "profile": lambda: BP.main("bfloat16", device="cpu", epochs=1, **small),
        "dispatch": lambda: BD.main("cpu", epochs=30, **small),
        "allopts": lambda: BA.main(device="cpu", theory_mod="_torch_tiny_theory", schedule={
            "n_iter": 2, "ntrain": 80, "nval": 20, "epochs": 5, "nimp": 40, "nbest": 10,
            "nwalkers": 8, "batch_size": 20, "temperatures": [2.0, 1.0], "ntimes": [0, 0],
            "ntautol": float("inf"), "meanshift": float("inf"), "stdshift": float("inf")},
            min_ess=None),
    }
    out = {}
    try:
        for name, call in calls.items():
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                res = call()
            out[name] = {"res": res, "lines": buf.getvalue().splitlines()}
    finally:
        mp.undo()
    return {"out": out, "tmp": tmp, "before": before, "after": _listing()}


def test_train_prints_bench_train_keys(runs):
    r = runs["out"]["train"]
    assert r["lines"][0] == "device: cpu"
    res = _json_lines("\n".join(r["lines"]))[-1]
    # bench_train.py:96-103, platform -> device
    assert {"device", "shape", "sec_per_epoch", "k2_packing_overhead_vs_k1",
            "bf16_speedup_vs_f32"} <= set(res)
    assert set(res["sec_per_epoch"]) == {c[0] for c in BT.CASES}
    assert all(v > 0 for v in res["sec_per_epoch"].values())
    assert res["k2_packing_overhead_vs_k1"] == round(
        res["sec_per_epoch"]["k2_f32_b500"] / res["sec_per_epoch"]["k1_f32_b500"], 3)
    for case, c in res["cases"].items():
        assert c["epochs_run"] == 2 and not c["graphed"] and c["replays_per_epoch"] == 0
    assert res["cases"]["k2_f32_b2000"]["minibatches_per_epoch"] == 1
    assert res["cases"]["k2_f32_b500"]["minibatches_per_epoch"] == 4


def test_profile_prints_bench_train_profile_keys(runs):
    res = runs["out"]["profile"]["res"]
    assert _json_lines("\n".join(runs["out"]["profile"]["lines"]))[-1] == res
    # bench_train_profile.py:275-283, platform -> device, every variant's ms an epoch
    assert {"metric", "unit", "compute_dtype", "shape", "device"} <= set(res)
    assert res["metric"] == "train_step_profile" and res["compute_dtype"] == "bfloat16"
    assert all(res[v] > 0 for v in BP.VARIANTS)
    assert set(res["replays_per_epoch"]) == set(BP.VARIANTS)


def test_dispatch_prints_bench_dispatch_keys(runs):
    res = runs["out"]["dispatch"]["res"]
    # bench_dispatch.py:52-80, platform -> device
    assert {"metric", "unit", "shape", "device", "speculative", "serial", "speedup"} <= set(res)
    for mode in ("speculative", "serial"):
        assert res[mode]["epochs_run"] == 30 and {"wall_s", "phases"} <= set(res[mode])
    assert res["serial"]["speculation"]["speculated"] == 0
    assert res["speculative"]["speculation"]["speculated"] > 0


def test_allopts_writes_the_option_artifacts(runs):
    res = runs["out"]["allopts"]["res"]
    # bench_allopts.py:158-184
    assert {"metric", "value", "unit", "options", "phases_s", "max_split_rhat",
            "max_posterior_err_sigma", "median_posterior_err_sigma", "importance_ess",
            "importance_nonzero_weights", "mean_abs_dlogp_emulator_vs_true", "artifacts",
            "chain_finite", "config"} <= set(res)
    assert all(res["artifacts"].values()) and res["chain_finite"]
    assert res["importance_ess"] > 0 and res["importance_nonzero_weights"] > 0
    assert {"train_emulator", "mcmc", "importance_sampling"} <= set(res["phases_s"])
    run = runs["tmp"] / "linna_allopts_bench_torch"
    for f in ("iter_0/best_samples_x.txt", "samples_im.npy", "weight_im.npy",
              BA.RESULT_FILE, "iter_1/zeus_256.h5"):
        assert (run / f).exists(), f
    # the y transforms were fitted in log space
    with np.load(run / "iter_0" / "transforms.npz") as z:
        assert bool(z["y_positive"])


def test_nothing_is_written_at_the_repository_root(runs):
    assert runs["after"] == runs["before"]
    for name in ("bench_train", "bench_train_profile", "bench_dispatch"):
        assert (runs["tmp"] / f"linna_{name}_torch").is_dir()
