"""paddle_tpu_torch.io against paddle_tpu.io: the samplers' index lists
(``DistributedBatchSampler`` over 1–4 replicas, every rank, epochs 0–2,
with and without ``shuffle`` and ``drop_last``), ``default_collate_fn``
on nested tuples and dicts of arrays and scalars, the datasets' items,
and the DataLoader's batches on each of its routes (the JAX package's
from its route without workers), in order; no ``/dev/shm/ptq_*``
segment left by the shm route, also after a loop that stops early; the
seeded ``torch.Generator`` draws of ``random_split`` and
``RandomSampler`` checked for partition, shape and determinism (they
never match the JAX package's draws).  Values are compared exactly."""
import glob
import os

import numpy as np
import pytest
import torch

import paddle_tpu.io as jio
import paddle_tpu_torch.io as tio


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if hasattr(x, "numpy"):
        return np.asarray(x.numpy())
    return np.asarray(x)


def _same_tree(got, want):
    """``got`` (the port's) holds ``want``'s (the JAX package's) values
    leaf by leaf, numbers exactly."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for k in want:
            _same_tree(got[k], want[k])
    elif isinstance(want, (tuple, list)) and not hasattr(want, "numpy"):
        assert isinstance(got, (tuple, list)) and len(got) == len(want)
        for g, w in zip(got, want):
            _same_tree(g, w)
    else:
        g, w = _np(got), _np(want)
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


class _Squares:
    """A map-style dataset of (x, y, {"i": i}) samples, once for each
    package's Dataset base."""

    def __init__(self, n=37):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return (np.full((3,), i, np.float32), np.asarray([i * i], np.int64),
                {"i": i, "half": i / 2.0})


class TSquares(_Squares, tio.Dataset):
    pass


class JSquares(_Squares, jio.Dataset):
    pass


class _Stream:
    def __init__(self, n=23):
        self.n = n

    def __iter__(self):
        for i in range(self.n):
            yield np.asarray([i, -i], np.int64), float(i)


class TStream(_Stream, tio.IterableDataset):
    pass


class JStream(_Stream, jio.IterableDataset):
    pass


@pytest.mark.parametrize("nr,rank", [(n, r) for n in range(1, 5)
                                     for r in range(n)])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_distributed_batch_sampler_matches_jax(nr, rank, shuffle, drop_last):
    ds = list(range(37))
    for bs in (1, 4):
        t = tio.DistributedBatchSampler(ds, bs, num_replicas=nr, rank=rank,
                                        shuffle=shuffle, drop_last=drop_last)
        j = jio.DistributedBatchSampler(ds, bs, num_replicas=nr, rank=rank,
                                        shuffle=shuffle, drop_last=drop_last)
        for epoch in range(3):
            t.set_epoch(epoch)
            j.set_epoch(epoch)
            assert list(t) == list(j)
            assert len(t) == len(j)


@pytest.mark.parametrize("drop_last", [False, True])
def test_sequence_and_batch_samplers_match_jax(drop_last):
    ds = list(range(11))
    assert list(tio.SequenceSampler(ds)) == list(jio.SequenceSampler(ds))
    for bs in (1, 3, 11, 12):
        t = tio.BatchSampler(ds, batch_size=bs, drop_last=drop_last)
        j = jio.BatchSampler(ds, batch_size=bs, drop_last=drop_last)
        assert list(t) == list(j) and len(t) == len(j)
        t = tio.BatchSampler(sampler=tio.SequenceSampler(ds), batch_size=bs,
                             drop_last=drop_last)
        assert list(t) == list(j)


def test_default_collate_matches_jax():
    rng = np.random.default_rng(0)
    samples = [((rng.standard_normal((2, 3)).astype(np.float32), i,
                 float(i) * 0.5),
                {"a": rng.integers(0, 9, (4,)), "b": (np.int64(i), i + 1)})
               for i in range(5)]
    _same_tree(tio.default_collate_fn(samples),
               jio.default_collate_fn(samples))
    out = tio.default_collate_fn(samples)
    assert isinstance(out[0][0], np.ndarray) and out[0][0].shape == (5, 2, 3)
    # torch CPU samples collate into numpy as well (a worker runs no op)
    t = tio.default_collate_fn([torch.arange(3), torch.arange(3) + 1])
    np.testing.assert_array_equal(t, [[0, 1, 2], [1, 2, 3]])


def test_datasets_match_jax():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((6, 2)).astype(np.float32)
    b = rng.integers(0, 5, (6,))
    pairs = [(tio.TensorDataset([a, b]), jio.TensorDataset([a, b])),
             (tio.TensorDataset([torch.as_tensor(a), torch.as_tensor(b)]),
              jio.TensorDataset([a, b])),
             (tio.ComposeDataset([TSquares(4), tio.TensorDataset([a, b])]),
              jio.ComposeDataset([JSquares(4), jio.TensorDataset([a, b])])),
             (tio.ConcatDataset([TSquares(3), TSquares(5)]),
              jio.ConcatDataset([JSquares(3), JSquares(5)])),
             (tio.Subset(TSquares(9), [8, 1, 5]),
              jio.Subset(JSquares(9), [8, 1, 5]))]
    for t, j in pairs:
        assert len(t) == len(j)
        for i in range(len(j)):
            _same_tree(t[i], j[i])
    _same_tree(list(iter(tio.ChainDataset([TStream(3), TStream(2)]))),
               list(iter(jio.ChainDataset([JStream(3), JStream(2)]))))


def _jax_batches(ds, **kw):
    return list(jio.DataLoader(ds, num_workers=0, **kw))


@pytest.mark.parametrize("route,kw", [
    ("sync", dict(num_workers=0)),
    ("thread", dict(num_workers=2, use_shared_memory=False)),
    ("shm", dict(num_workers=3))])
@pytest.mark.parametrize("batching", ["plain", "drop_last", "sampler"])
def test_dataloader_routes_match_jax(route, kw, batching):
    """Each route's batches are the JAX package's, in the sampler's order
    (the shm route's workers deliver out of order: the loader puts them
    back)."""
    bk = {"plain": dict(batch_size=5),
          "drop_last": dict(batch_size=5, drop_last=True),
          "sampler": {}}[batching]
    if batching == "sampler":
        tk = dict(batch_sampler=tio.DistributedBatchSampler(
            list(range(37)), 4, num_replicas=2, rank=1, shuffle=True))
        jk = dict(batch_sampler=jio.DistributedBatchSampler(
            list(range(37)), 4, num_replicas=2, rank=1, shuffle=True))
    else:
        tk, jk = bk, bk
    loader = tio.DataLoader(TSquares(), device="cpu", **tk, **kw)
    got = list(loader)
    assert loader.last_route == route
    want = _jax_batches(JSquares(), **jk)
    assert len(got) == len(want) == len(loader)
    for g, w in zip(got, want):
        _same_tree(g, w)
        assert isinstance(g[0], torch.Tensor) and g[0].device.type == "cpu"


@pytest.mark.parametrize("kw,route", [(dict(num_workers=0), "sync"),
                                      (dict(num_workers=2), "thread")])
def test_iterable_dataset_routes_match_jax(kw, route):
    for drop_last in (False, True):
        loader = tio.DataLoader(TStream(), batch_size=4, drop_last=drop_last,
                                device="cpu", **kw)
        got = list(loader)
        assert loader.last_route == route
        want = list(jio.DataLoader(JStream(), batch_size=4,
                                   drop_last=drop_last, num_workers=0))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_tree(g, w)


def _segments():
    return set(glob.glob("/dev/shm/ptq_%d_*" % os.getpid()))


def test_shm_route_leaves_no_segment():
    before = _segments()
    loader = tio.DataLoader(TSquares(64), batch_size=4, num_workers=3,
                            device="cpu")
    assert len(list(loader)) == 16
    for i, _ in enumerate(loader):
        if i == 1:
            break                   # the consumer stops early
    it = iter(loader)
    next(it)
    del it
    assert loader.last_route == "shm"
    assert _segments() == before


def test_shm_route_surfaces_a_worker_error():
    class Bad(TSquares):
        def __getitem__(self, i):
            if i == 21:
                raise ValueError("sample 21 is bad")
            return super().__getitem__(i)
    with pytest.raises(RuntimeError, match="sample 21 is bad"):
        list(tio.DataLoader(Bad(), batch_size=4, num_workers=2,
                            device="cpu"))


def test_random_split_and_sampler_are_seeded_partitions():
    ds = list(range(50))
    parts = tio.random_split(ds, [20, 30],
                             generator=torch.Generator().manual_seed(3))
    again = tio.random_split(ds, [20, 30],
                             generator=torch.Generator().manual_seed(3))
    assert [len(p) for p in parts] == [20, 30]
    assert sorted(parts[0].indices + parts[1].indices) == ds
    assert [p.indices for p in parts] == [p.indices for p in again]
    other = tio.random_split(ds, [0.5, 0.5],
                             generator=torch.Generator().manual_seed(4))
    assert [len(p) for p in other] == [25, 25]
    assert other[0].indices != parts[0].indices[:25]
    with pytest.raises(ValueError, match="sum"):
        tio.random_split(ds, [10, 10])
    s = tio.RandomSampler(ds, generator=torch.Generator().manual_seed(5))
    order = list(s)
    assert sorted(order) == ds and order != ds
    assert list(tio.RandomSampler(
        ds, generator=torch.Generator().manual_seed(5))) == order
    r = list(tio.RandomSampler(ds, replacement=True, num_samples=80,
                               generator=torch.Generator().manual_seed(5)))
    assert len(r) == 80 and all(0 <= i < 50 for i in r)
    w = list(tio.WeightedRandomSampler(
        [0.0, 1.0, 0.0, 3.0], 40, generator=torch.Generator().manual_seed(6)))
    assert len(w) == 40 and set(w) <= {1, 3}
    torch.manual_seed(11)
    a = list(tio.RandomSampler(ds))
    torch.manual_seed(11)
    assert list(tio.RandomSampler(ds)) == a


def test_dataloader_without_a_device_runs_on_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tio.DataLoader(TSquares())
