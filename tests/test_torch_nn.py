"""The port's emulator network and checkpoints against the JAX package."""

import jax
import numpy as np
import pytest
import torch

from linna_tpu import nn as JN
from linna_tpu.utils import checkpoint as JC
from linna_tpu_torch import nn as TN
from linna_tpu_torch.utils import checkpoint as TC

from _torch_parity import CPU, t, walkers

torch.set_num_threads(1)


@pytest.mark.parametrize("model", TN.MODEL_NAMES)
def test_apply_model_matches_jax(model):
    spec = JN.make_model_spec(model, 5, 8)
    params_j = JN.init_model(jax.random.key(3), spec)
    if spec.linear_bypass:  # make the 1e-3 bypass visible in the output
        params_j["linear_bypass"]["w"] = params_j["linear_bypass"]["w"] * 1e4
    params_t = TN.params_from_numpy(jax.device_get(params_j), CPU)
    x = walkers(37, 5, seed=4)
    want = np.asarray(JN.apply_model(spec, params_j, x))
    got = TN.apply_model(TN.make_model_spec(model, 5, 8), params_t, t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("out_size", [1, 8, 31, 457])
def test_model_spec_matches_jax(out_size):
    for model in TN.MODEL_NAMES:
        assert tuple(TN.make_model_spec(model, 27, out_size)) == tuple(
            JN.make_model_spec(model, 27, out_size)
        )
    assert TN.hidden_size_for(out_size) == JN.hidden_size_for(out_size)


@pytest.mark.parametrize("model", TN.MODEL_NAMES)
def test_init_model_layout_and_scheme(model):
    """Same keys and (in, out) shapes as the JAX init; Xavier-uniform bounds,
    biases 1e-2; the same seed gives the same weights."""
    spec = TN.make_model_spec(model, 5, 8)
    p = TN.init_model(spec, seed=1, device=CPU)
    pj = jax.device_get(JN.init_model(jax.random.key(1), JN.make_model_spec(model, 5, 8)))
    flat_t = TC._flatten(p)
    flat_j = TC._flatten(pj)
    assert {k: v.shape for k, v in flat_t.items()} == {k: v.shape for k, v in flat_j.items()}
    for key, w in flat_t.items():
        if key.startswith("linear_bypass"):
            continue
        if key.endswith("/b"):
            np.testing.assert_array_equal(w, np.full(w.shape, 1e-2, np.float32))
        else:
            limit = np.sqrt(6.0 / sum(w.shape))
            assert np.abs(w).max() <= limit and np.abs(w).max() > 0.5 * limit
    assert TN.count_params(p) == sum(v.size for v in flat_j.values())
    again = TC._flatten(TN.init_model(spec, seed=1, device=CPU))
    assert all(np.array_equal(again[k], flat_t[k]) for k in flat_t)


def test_checkpoint_jax_written_loads_in_port(tmp_path):
    spec = JN.make_model_spec("chto_v2", 4, 6)
    params_j = JN.init_model(jax.random.key(5), spec)
    path = str(tmp_path / "best.ckpt.npz")
    JC.save_checkpoint(path, params_j, meta={"epoch": 7})
    template = TN.init_model(TN.make_model_spec("chto_v2", 4, 6), device=CPU)
    params_t, opt, meta = TC.load_checkpoint(path, template, device=CPU)
    assert meta == {"epoch": 7} and opt is None
    x = walkers(9, 4, seed=6)
    np.testing.assert_allclose(
        TN.apply_model(TN.make_model_spec("chto_v2", 4, 6), params_t, t(x)).numpy(),
        np.asarray(JN.apply_model(spec, params_j, x)), rtol=1e-5, atol=1e-5,
    )


def test_checkpoint_port_written_loads_in_jax(tmp_path):
    tspec = TN.make_model_spec("chto_simple", 4, 6)
    params_t = TN.init_model(tspec, seed=2, device=CPU)
    path = str(tmp_path / "best.ckpt.npz")
    TC.save_checkpoint(path, params_t, meta={"seed": 2})
    spec = JN.make_model_spec("chto_simple", 4, 6)
    params_j, _, meta = JC.load_checkpoint(path, JN.init_model(jax.random.key(0), spec))
    assert meta == {"seed": 2}
    x = walkers(9, 4, seed=6)
    np.testing.assert_allclose(
        np.asarray(JN.apply_model(spec, params_j, x)),
        TN.apply_model(tspec, params_t, t(x)).numpy(), rtol=1e-5, atol=1e-5,
    )


def test_checkpoint_template_mismatch_raises(tmp_path):
    path = str(tmp_path / "c.npz")
    TC.save_checkpoint(path, TN.init_model(TN.make_model_spec("chto_v2", 4, 6), device=CPU))
    with pytest.raises(ValueError, match="shape"):
        TC.load_checkpoint(path, TN.init_model(TN.make_model_spec("chto_v2", 5, 6), device=CPU), device=CPU)
    with pytest.raises(KeyError, match="linear_bypass"):
        TC.load_checkpoint(path, TN.init_model(TN.make_model_spec("chto_v2_linear", 4, 6), device=CPU), device=CPU)
