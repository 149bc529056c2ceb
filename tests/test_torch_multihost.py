"""The port's multi-process helpers in one process (the counterpart of
tests/test_multihost.py): without a process group every helper is the
identity and makes no collective; a cluster named in part raises; and the
(ens, data) grid and the member and walker blocks match the JAX package's
``make_ensemble_mesh`` / ``member_sharding`` / ``shard_over_walkers`` specs
on the suite's 8 virtual devices."""

import jax
import numpy as np
import numpy.testing as npt
import pytest
import torch

from linna_tpu.parallel import mesh as JM
from linna_tpu_torch.parallel import mesh as ME
from linna_tpu_torch.parallel import multihost as MH

torch.set_num_threads(1)


def test_initialize_is_noop_single_process(monkeypatch):
    for var in (MH.ENV_COORDINATOR, MH.ENV_NUM_PROCESSES, MH.ENV_PROCESS_ID, "RANK",
                "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert MH.initialize() is False
    assert MH.process_count() == 1 and MH.process_index() == 0
    assert MH.backend() is None


@pytest.mark.parametrize("env", [
    {MH.ENV_NUM_PROCESSES: "2", MH.ENV_PROCESS_ID: "0"},
    {MH.ENV_PROCESS_ID: "1"},
    {MH.ENV_COORDINATOR: "localhost:1234", MH.ENV_NUM_PROCESSES: "2"},
    {"RANK": "1", "WORLD_SIZE": "2"},
])
def test_half_configured_cluster_raises(monkeypatch, env):
    for var in (MH.ENV_COORDINATOR, MH.ENV_NUM_PROCESSES, MH.ENV_PROCESS_ID, "RANK",
                "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="set in part"):
        MH.initialize(device="cpu")


def test_nccl_needs_a_card():
    with pytest.raises(ValueError, match="nccl backend needs a CUDA device"):
        MH.initialize("localhost:1", 1, 0, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="backend 'mpi'"):
        MH.initialize("localhost:1", 1, 0, backend="mpi", device="cpu")


def test_is_primary_and_primary_only_single_process():
    calls = []

    @MH.primary_only
    def record(x):
        calls.append(x)
        return x

    assert MH.is_primary()
    assert record(7) == 7 and calls == [7]


def test_helpers_are_the_identity_single_process():
    MH.reset_collective_counts()
    MH.barrier("test")
    val = {"a": np.array([1.0 + 1e-12], np.float64), "b": ("x", 3)}
    assert MH.broadcast_from_primary(lambda: val) is val
    x = np.arange(3.0)
    assert MH.broadcast(x) is x
    assert MH.primary_flag(True) is True and MH.primary_flag(0) is False
    t = torch.arange(4.0)
    assert MH.all_reduce(t) is t and MH.all_gather(t)[0] is t
    got = MH.fetch((t, t.int()))
    npt.assert_array_equal(got[0], t.numpy())
    assert got[1].dtype == np.int32
    assert MH.collective_counts() == {}


def test_fetch_packs_every_type_in_one_copy():
    parts = [torch.arange(6.0).reshape(2, 3), torch.tensor([1, 2], dtype=torch.int32),
             torch.tensor(True), torch.arange(3, dtype=torch.float64)]
    for got, want in zip(MH.to_host(parts), parts):
        npt.assert_array_equal(got, want.numpy())
        assert got.dtype == want.numpy().dtype and got.shape == tuple(want.shape)


@pytest.mark.parametrize("world", [1, 2, 4, 8])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_ensemble_mesh_and_members_match_jax(k, world):
    """The grid's shape and every rank's members equal the JAX mesh's
    shape and the member rows ``member_sharding`` puts on each device."""
    devices = jax.devices()[:world]
    jmesh = JM.make_ensemble_mesh(k, devices)
    mesh = ME.make_ensemble_mesh(k, world)
    assert mesh.shape == dict(jmesh.shape)
    sharding = JM.member_sharding(jmesh, {"w": np.zeros((k, 2))})["w"]
    rows = sharding.devices_indices_map((k, 2))
    for rank, dev in enumerate(jmesh.devices.reshape(-1)):
        assert list(mesh.members(rank)) == list(range(k))[rows[dev][0]], (rank, dev)
        assert mesh.coords(rank) == tuple(int(i) for i in np.argwhere(jmesh.devices == dev)[0])
    assert mesh.row_leaders() == [int(jmesh.devices[e, 0].id) - int(devices[0].id)
                                  for e in range(mesh.ens)]


@pytest.mark.parametrize("n, data", [(16, 2), (17, 2), (10, 4), (3, 4)])
def test_batch_slices_tile_the_minibatch(n, data):
    mesh = ME.EnsembleMesh(1, data)
    idx = np.concatenate([np.arange(n)[mesh.batch_slice(r, n)] for r in range(data)])
    npt.assert_array_equal(idx, np.arange(n))
    sizes = [len(np.arange(n)[mesh.batch_slice(r, n)]) for r in range(data)]
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("world", [1, 2, 4])
def test_walker_blocks_are_jax_shard_over_walkers_specs(world):
    """Rank r holds block r of each half-ensemble, as ``P(None, 'walkers')``
    shards the (2, W/2, D) carry; take and gather invert each other."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    nwalkers, ndim = 16, 3
    devices = jax.devices()[:world]
    spec = NamedSharding(Mesh(np.asarray(devices), ("walkers",)), P(None, "walkers", None))
    carry = np.arange(nwalkers * ndim, dtype=np.float32).reshape(2, nwalkers // 2, ndim)
    index = spec.devices_indices_map(carry.shape)
    x = torch.as_tensor(carry.reshape(nwalkers, ndim))
    for rank, dev in enumerate(devices):
        shard = ME.walker_shard(nwalkers, world, rank)
        npt.assert_array_equal(shard.take(x).numpy(), carry[index[dev]].reshape(-1, ndim))
    shard = ME.walker_shard(nwalkers, world, 0)
    chain = torch.as_tensor(np.stack([carry.reshape(nwalkers, ndim)] * 2))
    if world == 1:
        npt.assert_array_equal(shard.gather([shard.take(chain, dim=1)], 1)[0], chain.numpy())


def test_walker_shard_refuses_an_uneven_half():
    with pytest.raises(ValueError, match="must divide over the 4-rank walker mesh"):
        ME.walker_shard(12, 4, 0)
    assert ME.walker_shard(16, 4, 3).local == 4
