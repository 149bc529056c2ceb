"""The tensor-parallel half of ``parallel/mesh`` against JAX's rules, and
``parallel/dtrain``, ``census.tensor_parallel_census`` and
``pod_accept --structural`` in one process (the two-rank runs are in
``tests/test_torch_parallel_2proc.py``).

- Every leaf's sharding spec, the batch sharding and the grid equal JAX's
  (exact).
- The blocks of a dimension follow GSPMD's padded split (ceil-sized blocks,
  the last ones shorter or empty), and every rank's blocks put together
  give the whole tensor back (exact).
- On one rank with no process group the sharded forward is
  ``nn.apply_model`` up to the row-parallel products' bias added after the
  product (rtol 1e-6), and a step's loss is ``losses.loss_fn`` of that
  forward (rtol 1e-6)."""

import json

import jax
import numpy as np
import numpy.testing as npt
import pytest
import torch

import _torch_mh2_worker as W
from linna_tpu import nn as JN
from linna_tpu import parallel as PX
from linna_tpu_torch import losses as TL
from linna_tpu_torch import nn as TN
from linna_tpu_torch import pod_accept
from linna_tpu_torch.parallel import census as CE
from linna_tpu_torch.parallel import dtrain as DT
from linna_tpu_torch.parallel import mesh as ME
from linna_tpu_torch.train import _walk

torch.set_num_threads(1)


def _jax_specs(tree):
    return {k: _jax_specs(v) if isinstance(v, dict) else tuple(v.spec) for k, v in tree.items()}


def _port_specs(tree):
    return {k: _port_specs(v) if isinstance(v, dict) else tuple(v.spec) for k, v in tree.items()}


@pytest.mark.parametrize("model", ["chto_v2", "chto_simple", "chto_v2_linear"])
def test_param_shardings_match_jax(model):
    jmesh = PX.make_mesh(jax.devices(), n_model=2)
    spec = JN.make_model_spec(model, 4, 8)
    want = _jax_specs(PX.param_shardings(JN.init_model(jax.random.key(0), spec), jmesh))
    mesh = ME.make_mesh(2, world=8, rank=0)
    got = _port_specs(ME.param_shardings(TN.init_model(TN.make_model_spec(model, 4, 8),
                                                       device="cpu"), mesh))
    assert got == want
    assert tuple(ME.replicated(mesh).spec) == tuple(PX.replicated(jmesh).spec)
    for also in (False, True):
        assert (tuple(ME.batch_sharding(mesh, also).spec)
                == tuple(PX.batch_sharding(jmesh, also).spec))


def test_grid_matches_jax():
    jmesh = PX.make_mesh(jax.devices(), n_model=2)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for r in range(8):
        mesh = ME.make_mesh(2, world=8, rank=r)
        assert mesh.shape == dict(jmesh.shape)
        assert tuple(int(i) for i in np.argwhere(ids == r)[0]) == mesh.coords()
    with pytest.raises(ValueError, match="not divisible"):
        ME.make_mesh(3, world=8, rank=0)


@pytest.mark.parametrize("n, parts, want", [(125, 2, [63, 62]), (1000, 2, [500, 500]),
                                            (10, 4, [3, 3, 3, 1]), (3, 4, [1, 1, 1, 0]),
                                            (16, 1, [16])])
def test_blocks_are_gspmds_padded_split(n, parts, want):
    sizes = [len(range(*ME.block(n, parts, i).indices(n))) for i in range(parts)]
    assert sizes == want
    assert [ME.block(n, parts, i).start for i in range(parts)] == list(
        np.minimum(np.cumsum([0] + want[:-1]), n))


def test_shard_params_blocks_put_back_together():
    spec = TN.make_model_spec("chto_v2", 6, 40)
    full = TN.init_model(spec, seed=1, device="cpu")
    blocks = [ME.shard_params(full, ME.make_mesh(2, world=2, rank=r)) for r in range(2)]
    assert tuple(blocks[0]["rb3"]["skip_w"].shape) == (250, 63)
    assert tuple(blocks[1]["rb3"]["skip_w"].shape) == (250, 62)
    assert tuple(blocks[1]["layer6"]["w"].shape) == (62, 500)
    for (path, whole), (_, b0), (_, b1) in zip(_walk(full), _walk(blocks[0]), _walk(blocks[1])):
        sh = ME.param_shardings(full, ME.make_mesh(2, world=2, rank=0))
        for p in path:
            sh = sh[p]
        if sh.spec == ():
            assert torch.equal(b0, whole) and torch.equal(b1, whole), path
        else:
            dim = list(sh.spec).index("model")
            assert torch.equal(torch.cat([b0, b1], dim=dim), whole), path


@pytest.mark.parametrize("model", ["chto_v2", "chto_v2_linear"])
def test_one_rank_step_is_the_whole_model(model):
    d = W.tp_inputs(6, 40)
    spec = TN.make_model_spec(model, 6, 40)
    mesh = ME.make_mesh()
    assert mesh.groups() == (None, None)
    params, state = DT.init_sharded(2, spec, DT.adamw(1e-3), mesh, device="cpu")
    full = TN.init_model(spec, seed=2, device="cpu")
    x = torch.as_tensor(d["tx"][:16], dtype=torch.float32)
    with torch.no_grad():
        npt.assert_allclose(DT.sharded_apply(spec, params, x, mesh).numpy(),
                            TN.apply_model(spec, full, x).numpy(), rtol=1e-6, atol=1e-6)
    tset, ls = _tset(d)
    step = DT.make_sharded_train_step(spec, tset, ls, DT.adamw(1e-3), mesh)
    y = torch.as_tensor(d["ty"][:16], dtype=torch.float32)
    with torch.no_grad():
        want = TL.loss_fn(ls, tset, TN.apply_model(spec, full, tset.x_transform(x)), y)
    _, state, loss = step(params, state, x, y)
    npt.assert_allclose(float(loss), float(want), rtol=1e-6)
    assert int(state.count[0]) == 1
    got = DT.gather_params(spec, params, mesh)
    moved = [np.abs(a - b.numpy()).max() for (_, a), (_, b) in zip(_walk(got), _walk(full))]
    assert 0 < max(moved) <= 1.0001e-3  # one AdamW step moves each weight by at most lr


def _tset(d):
    from linna_tpu_torch import transforms as TT

    tset = TT.TransformSet(
        TT.XTransform(torch.as_tensor(d["x_mean"]), torch.as_tensor(d["x_std"]),
                      torch.zeros(len(d["x_mean"]), dtype=torch.bool)),
        TT.YTransform(torch.as_tensor(d["y_mean"]), torch.as_tensor(d["y_std"]), False),
        TT.YTransformData(torch.as_tensor(d["sigma"])))
    return tset, TL.build_loss_state(d["data"], d["cov"], tset)


def test_one_rank_census_counts_nothing():
    c = CE.tensor_parallel_census(1, device="cpu")
    assert c["mesh"] == {"data": 1, "model": 1} and c["per_step"] == c["per_chunk"] == {}


def test_pod_accept_structural_on_the_cpu(capsys):
    assert pod_accept.main(["--structural", "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["pass"] is True and report["device"] == "cpu"
    st = report["structural"]
    assert st["world"] == 1 and "flagship" not in report
    assert all(v["pass"] and v["per_step_collectives"] == 0 for v in st["sampler"].values())
    assert st["trainer"]["cross_member_collectives"] == 0


def test_pod_accept_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        pod_accept.main(["--structural"])
