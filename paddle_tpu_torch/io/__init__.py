"""Datasets, samplers and the DataLoader (port of ``paddle_tpu/io``;
reference surface: ``python/paddle/io/`` and ``fluid/dataloader/``).

``DataLoader`` has the JAX package's three routes
(``paddle_tpu/io/__init__.py:274-431``), and ``loader.last_route`` says
which the last iteration took:

* ``"sync"`` — ``num_workers=0``: batches made on the caller's thread;
* ``"thread"`` — a producer thread fills a bounded queue (an
  ``IterableDataset``, ``use_shared_memory=False``, or no native
  library);
* ``"shm"`` — ``num_workers`` worker processes, ``fork``ed, collate
  batches into numpy and push them through the native shared-memory
  queue (:mod:`.shm_queue`); the loader hands them out in the sampler's
  order through a map of early arrivals.

A worker touches neither CUDA nor ``torch.distributed`` (the parent may
hold a card's context and gloo's threads) and runs no torch op (the
thread pool of a forked child's libgomp can hang): samples and batches
are numpy, and the parent makes the tensors and moves them to the
loader's device, the card unless ``device="cpu"`` is passed
(:func:`..core.device.resolve_device`).  The queue's name is removed as
soon as the workers are forked, and the queue is destroyed in a
``finally``: no ``/dev/shm/ptq_*`` segment outlives its iteration, also
when the consumer stops early or a process dies without clean-up.

``DistributedBatchSampler`` shuffles with ``np.random.RandomState(epoch)``
as the JAX package does, so both give the same indices;
``RandomSampler``, ``WeightedRandomSampler`` and ``random_split`` draw
from a ``torch.Generator`` (the caller's, else one seeded from PyTorch's
default generator) and never match the JAX package's draws.
"""
from __future__ import annotations

import itertools
import math
import os
import queue as _queue
import threading
from typing import Optional

import numpy as np
import torch

from ..core.device import resolve_device

__all__ = [
    "Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
    "ChainDataset", "ConcatDataset", "Subset", "random_split", "Sampler",
    "SequenceSampler", "RandomSampler", "WeightedRandomSampler",
    "BatchSampler", "DistributedBatchSampler", "default_collate_fn",
    "DataLoader",
]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


def _numpy(x):
    """A CPU tensor as numpy (a view); anything else as it is."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError("io: a dataset holds host data; got a tensor "
                             "on %s" % x.device)
        return x.numpy()
    return x


class TensorDataset(Dataset):
    """Rows of equally long arrays; torch tensors (on the CPU) are held as
    numpy views, so that a worker process never runs a torch op."""

    def __init__(self, tensors):
        self.tensors = [_numpy(t) for t in tensors]

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets])

    def __len__(self):
        return int(self.cum[-1])

    def __getitem__(self, idx):
        di = int(np.searchsorted(self.cum, idx, side="right"))
        prev = 0 if di == 0 else int(self.cum[di - 1])
        return self.datasets[di][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def _generator(generator: Optional[torch.Generator]) -> torch.Generator:
    """``generator``, or a CPU generator seeded from PyTorch's default one
    (so ``paddle_tpu_torch.seed`` makes the draws repeat)."""
    if generator is not None:
        return generator
    seed = int(torch.empty((), dtype=torch.int64).random_().item())
    return torch.Generator().manual_seed(seed)


def random_split(dataset, lengths, generator=None):
    """``Subset``s of a random permutation of ``dataset``: ``lengths``
    are counts, or fractions that sum to 1 (the last takes the rest)."""
    n = len(dataset)
    if all(isinstance(l, float) for l in lengths):
        counts = [int(math.floor(n * f)) for f in lengths]
        counts[-1] = n - sum(counts[:-1])
        lengths = counts
    if sum(lengths) != n:
        raise ValueError("random_split: lengths %r do not sum to the "
                         "dataset's %d" % (list(lengths), n))
    perm = torch.randperm(n, generator=_generator(generator)).tolist()
    out, off = [], 0
    for l in lengths:
        out.append(Subset(dataset, perm[off:off + l]))
        off += l
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        g = _generator(self.generator)
        if self.replacement:
            return iter(torch.randint(0, n, (self.num_samples,),
                                      generator=g).tolist())
        return iter(torch.randperm(n, generator=g)[:self.num_samples]
                    .tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True,
                 generator=None):
        self.weights = torch.as_tensor(np.asarray(weights, np.float64))
        self.num_samples = num_samples
        self.replacement = replacement
        self.generator = generator

    def __iter__(self):
        return iter(torch.multinomial(
            self.weights, self.num_samples, self.replacement,
            generator=_generator(self.generator)).tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """This rank's disjoint share of the dataset (reference:
    ``python/paddle/io/dataloader/batch_sampler.py``): the index list,
    shuffled by ``RandomState(epoch)`` under ``shuffle``, padded from its
    head to a multiple of ``num_replicas``, then every ``num_replicas``-th
    index from ``rank``.  ``num_replicas`` / ``rank`` default to the
    ``torch.distributed`` world's (1 / 0 outside one)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        import torch.distributed as dist
        world = dist.is_available() and dist.is_initialized()
        if num_replicas is None:
            num_replicas = dist.get_world_size() if world else 1
        if rank is None:
            rank = dist.get_rank() if world else 0
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / num_replicas))
        self.total_size = self.num_samples * num_replicas

    def __iter__(self):
        indices = list(range(len(self.dataset)))
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            rng.shuffle(indices)
        indices += indices[: self.total_size - len(indices)]
        indices = indices[self.local_rank:self.total_size:self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


def default_collate_fn(batch):
    """Stack samples into batched numpy arrays (reference:
    ``fluid/dataloader/collate.py`` ``default_collate_fn``): arrays and
    CPU tensors stacked, scalars into an array, tuples and lists
    transposed, dicts by key; anything else is returned as the list."""
    sample = batch[0]
    if isinstance(sample, (np.ndarray, torch.Tensor)):
        return np.stack([_numpy(s) for s in batch])
    if isinstance(sample, (int, float, np.integer, np.floating)):
        return np.asarray(batch)
    if isinstance(sample, (list, tuple)):
        return tuple(default_collate_fn(list(s)) for s in zip(*batch))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    return batch


def _to_device(tree, device):
    """numpy leaves as tensors on ``device``, tensors moved there."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(tree)).to(device)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree


class DataLoader:
    """reference surface: ``python/paddle/io/DataLoader``
    (``fluid/reader.py:146``); the routes are the module's.  ``device``:
    where batches land (the card unless ``"cpu"``)."""

    #: the ring's bytes on the shm route (the JAX package's)
    SHM_CAPACITY = 128 << 20

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, device=None):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.use_shared_memory = use_shared_memory
        self.worker_init_fn = worker_init_fn
        self.prefetch_factor = max(prefetch_factor, 2)
        self.device = resolve_device(device)
        self.last_route: Optional[str] = None
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

    def _iter_batches(self):
        """Collated host batches, in order, on this thread."""
        if self._iterable_mode:
            it = iter(self.dataset)
            while True:
                batch = list(itertools.islice(it, self.batch_size))
                if not batch:
                    return
                if len(batch) < self.batch_size and self.drop_last:
                    return
                yield self.collate_fn(batch)
        else:
            for idxs in self.batch_sampler:
                yield self.collate_fn([self.dataset[i] for i in idxs])

    def __iter__(self):
        if self.num_workers == 0:
            route, it = "sync", self._iter_batches()
        elif self.use_shared_memory and not self._iterable_mode and \
                _shm_ok():
            route, it = "shm", self._iter_multiprocess()
        else:
            route, it = "thread", self._iter_threaded()
        self.last_route = route
        for batch in it:
            yield _to_device(batch, self.device)

    def _iter_threaded(self):
        q: _queue.Queue = _queue.Queue(maxsize=self.prefetch_factor
                                       * self.num_workers)
        sentinel = object()
        stop = threading.Event()
        failure = []

        def producer():
            try:
                for b in self._iter_batches():
                    while not stop.is_set():
                        try:
                            q.put(b, timeout=0.1)
                            break
                        except _queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # surfaced on the consumer's thread
                failure.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True,
                             name="dataloader-producer")
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
            if failure:
                raise failure[0]
        finally:
            stop.set()

    def _iter_multiprocess(self):
        """Worker processes over the native shared-memory queue; batch
        ``i`` goes to worker ``i % n``, and each worker ends with a
        ``("done", wid)`` record, or ``("error", text)`` when it raised.
        The workers use the queue's handle they inherit, and its name is
        removed once they are forked, so no segment outlives the
        processes whatever ends them; a worker dies with its parent
        (``PR_SET_PDEATHSIG``)."""
        import multiprocessing as mp

        from .shm_queue import QueueClosed, ShmQueue
        out_q = ShmQueue.create(self.SHM_CAPACITY)
        try:
            all_batches = list(self.batch_sampler)
            nw = min(self.num_workers, max(len(all_batches), 1))
            dataset, collate = self.dataset, self.collate_fn
            init_fn, parent = self.worker_init_fn, os.getpid()

            def worker(wid):
                _die_with_parent(parent)
                try:
                    if init_fn is not None:
                        init_fn(wid)
                    for bi in range(wid, len(all_batches), nw):
                        out_q.put((bi, collate([dataset[i]
                                                for i in all_batches[bi]])))
                    out_q.put(("done", wid))
                except QueueClosed:
                    pass        # the consumer stopped early
                except BaseException:
                    import traceback
                    try:
                        out_q.put(("error", "worker %d: %s" % (
                            wid, traceback.format_exc())))
                    except QueueClosed:
                        pass

            ctx = mp.get_context("fork")
            procs = [ctx.Process(target=worker, args=(w,), daemon=True)
                     for w in range(nw)]
            for p in procs:
                p.start()
        finally:
            out_q.unlink()
        return self._ordered(out_q, procs, len(all_batches))

    @staticmethod
    def _ordered(out_q, procs, total):
        pending = {}
        nxt = 0
        done = 0
        try:
            while nxt < total:
                if nxt in pending:
                    payload = pending.pop(nxt)
                else:
                    tag, payload = out_q.get()
                    if tag == "error":
                        raise RuntimeError("DataLoader " + payload)
                    if tag == "done":
                        done += 1
                        if done == len(procs) and nxt < total \
                                and nxt not in pending:
                            raise RuntimeError(
                                "DataLoader: every worker finished with "
                                "batch %d of %d undelivered" % (nxt, total))
                        continue
                    if tag != nxt:
                        pending[tag] = payload
                        continue
                nxt += 1
                yield payload
            dead = [p.exitcode for p in procs
                    if p.exitcode not in (None, 0)]
            if dead:
                raise RuntimeError("DataLoader: worker exit codes %r" % dead)
        finally:
            out_q.close()
            for p in procs:
                p.join(timeout=5)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=5)
            out_q.destroy()


def _die_with_parent(parent_pid):
    """Have the kernel kill this (forked) process when its parent dies."""
    import ctypes
    import signal
    PR_SET_PDEATHSIG = 1
    ctypes.CDLL(None, use_errno=True).prctl(PR_SET_PDEATHSIG,
                                            int(signal.SIGKILL))
    if os.getppid() != parent_pid:      # the parent died before the prctl
        os._exit(1)


def _shm_ok() -> bool:
    from ..core import native
    return native.available()
