"""Data path of the PyTorch port against the JAX package, exactly.

``ShardedSampler`` indices over a grid of dataset sizes, worlds, ranks,
shuffles, epochs and ``drop_last``; the ``DataLoader``'s batches without
a sampler (shuffled or not) and with one (the ranks' local batches
concatenated in rank order are the JAX loader's global batch); the
seeded datasets item for item; ``DummyModel`` through ``convert``. No
tolerance anywhere but the model's forward (float32, 1e-6).
"""

import itertools

import jax
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu import data as jdata
from distributed_pytorch_tpu import models as jmodels
from distributed_pytorch_tpu_torch import data as tdata
from distributed_pytorch_tpu_torch import from_jax_params, to_jax_params
from distributed_pytorch_tpu_torch.models import DummyModel

SAMPLER_GRID = [
    (n, world, rank, shuffle, epoch, drop_last)
    for n, world in itertools.product((32, 33, 7), (1, 2, 3))
    for rank in range(world)
    for shuffle, epoch, drop_last in itertools.product(
        (False, True), (0, 1), (False, True))]


@pytest.mark.parametrize("n,world,rank,shuffle,epoch,drop_last",
                         SAMPLER_GRID)
def test_sampler_indices_equal_jax(n, world, rank, shuffle, epoch,
                                   drop_last):
    kw = dict(rank=rank, world_size=world, shuffle=shuffle, seed=3,
              drop_last=drop_last)
    js, ts = jdata.ShardedSampler(n, **kw), tdata.ShardedSampler(n, **kw)
    js.set_epoch(epoch)
    ts.set_epoch(epoch)
    np.testing.assert_array_equal(ts.global_indices(), js.global_indices())
    np.testing.assert_array_equal(ts.local_indices(), js.local_indices())
    assert list(ts) == list(js) and len(ts) == len(js)


def _np_batches(loader):
    return [tuple(t.numpy() for t in batch) for batch in loader]


@pytest.mark.parametrize("shuffle", [False, True])
def test_loader_without_sampler_equals_jax(shuffle):
    ds_j = jdata.DummyDataset(33, 4)
    ds_t = tdata.DummyDataset(33, 4)
    jl = jdata.DataLoader(ds_j, batch_size=8, shuffle=shuffle, seed=5)
    tl = tdata.DataLoader(ds_t, batch_size=8, shuffle=shuffle, seed=5)
    for epoch in (0, 0, 1):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        want, got = list(jl), _np_batches(tl)
        assert len(got) == len(want) == len(tl) == len(jl) == 5
        for (gx, gy), (wx, wy) in zip(got, want):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
            assert gx.dtype == wx.dtype and gy.dtype == wy.dtype


@pytest.mark.parametrize("world,shuffle,drop_last", [
    (2, False, False), (2, True, False), (3, True, False), (3, True, True)])
def test_loader_with_sampler_is_a_rank_of_the_jax_global_batch(
        world, shuffle, drop_last):
    """The JAX loader's global batch = the port ranks' local batches
    concatenated in rank order, every step of two epochs."""
    ds_j = jdata.SyntheticLM(29, 6, 50, seed=1)
    ds_t = tdata.SyntheticLM(29, 6, 50, seed=1)
    kw = dict(shuffle=shuffle, seed=2, drop_last=drop_last)
    jl = jdata.DataLoader(ds_j, batch_size=3, drop_last=drop_last,
                          sampler=jdata.ShardedSampler(29, 0, world, **kw))
    tls = [tdata.DataLoader(ds_t, batch_size=3, drop_last=drop_last,
                            sampler=tdata.ShardedSampler(29, r, world, **kw))
           for r in range(world)]
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        for tl in tls:
            tl.set_epoch(epoch)
        want = list(jl)
        per_rank = [_np_batches(tl) for tl in tls]
        assert all(len(b) == len(want) for b in per_rank)
        for t, (wx, wy) in enumerate(want):
            np.testing.assert_array_equal(
                np.concatenate([b[t][0] for b in per_rank]), wx)
            np.testing.assert_array_equal(
                np.concatenate([b[t][1] for b in per_rank]), wy)


@pytest.mark.parametrize("name", ["DummyDataset", "SyntheticLM",
                                  "SyntheticImages"])
def test_datasets_bit_identical(name):
    args = {"DummyDataset": (37, 5), "SyntheticLM": (11, 9, 300),
            "SyntheticImages": (6, (4, 4, 3), 10)}[name]
    js, ts = getattr(jdata, name)(*args, seed=7), \
        getattr(tdata, name)(*args, seed=7)
    assert len(js) == len(ts)
    for i in range(len(js)):
        for a, b in zip(ts[i], js[i]):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, b)


def test_data_sampler_follows_the_group():
    ds = tdata.DummyDataset(10, 2)
    assert tdata.data_sampler(ds, distributed=False, shuffle=True) is None
    s = tdata.data_sampler(ds, distributed=True, shuffle=False)
    assert (s.rank, s.world_size, s.shuffle) == (0, 1, False)
    s = tdata.data_sampler(ds, distributed=True, shuffle=True, rank=1,
                           world_size=2)
    assert (s.rank, s.world_size) == (1, 2) and len(s) == 5


def test_dummy_model_converts_and_matches_jax():
    jm = jmodels.DummyModel(in_dim=1, hidden_dim=32, n_classes=4)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(0)))
    tm = from_jax_params(params, DummyModel(1, 32, 4, device="cpu"))
    x = np.random.default_rng(0).standard_normal((5, 1)).astype(np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(params, x)),
                               atol=1e-6, rtol=0)
    back = to_jax_params(tm)
    for layer in ("lin1", "lin2"):
        for leaf in ("w", "b"):
            np.testing.assert_array_equal(back[layer][leaf],
                                          params[layer][leaf])
