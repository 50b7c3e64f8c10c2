"""paddle_tpu_torch.distributed (port of ``paddle_tpu.distributed``).

One process per rank on ``torch.distributed`` (NCCL on cards, gloo on the
CPU) in place of the JAX package's single-controller mesh: the world's
ranks form a grid with named axes (:mod:`.mesh`), collectives run over the
process group of a rank's slice along an axis (:mod:`.collective`),
parameters keep the slice their rank's coordinate names
(:func:`parallelize`), and the Megatron layers run their collectives by
hand (:mod:`.mp_layers`), or, with the overlap switch on, as rings of
permutes overlapped with the partial matmuls (:mod:`.mp_overlap`).
ZeRO (:mod:`.sharding`) slices the optimizer state, the gradients and
the masters over the ``sdp`` axis.  :mod:`.pipeline` runs the 1F1B
schedule with one process a stage over the ``pp`` axis, and :mod:`.fleet`
is the facade that lays the hybrid degrees out and dispatches a model to
its wrapper.  :mod:`.ring_attention` runs ring and Ulysses attention
over the ``sep`` axis (``scaled_dot_product_attention`` routes to the
ring where the mesh has a ``sep`` group), and :mod:`.moe` the
Mixture-of-Experts layer over ``ep`` (:mod:`.utils` re-exports its
``global_scatter`` / ``global_gather``).  Also here: :mod:`.store`, the
TCP key-value store (on the native library's server and client, or the
Python pair), and :mod:`.recompute`, activation recompute.
``distributed.launch`` is the launcher, :mod:`.launch_main` (``python -m
paddle_tpu_torch.distributed.launch_main``: a node's workers with the
``PADDLE_*`` environment, per-rank logs, elastic restarts), and
``fleet.elastic`` its membership manager over the store.

On a ``sep`` mesh the GPT shards its sequences itself (each rank runs
its rows, the ring inside its attention; ``gather_sequence`` joins a
rank's shard of an output), beside ZeRO over ``sdp`` or tensor
parallelism over ``mp``, and ZeRO's ``sdp`` axis runs inside the 1F1B
pipeline.  :mod:`.auto_parallel` is the Engine over all of it
(``ProcessMesh``, ``shard_op``, ``Engine``).
"""
from __future__ import annotations

import os

from . import collective, mesh, mp_layers, mp_overlap, sharding  # noqa
from . import fleet, pipeline, store  # noqa: F401
from . import auto_parallel, moe, ring_attention, utils  # noqa: F401
from .collective import (ReduceOp, all_gather, all_gather_object, all_reduce,
                         all_to_all, all_to_all_single, alltoall, barrier,
                         broadcast, get_group, irecv, isend, new_group, recv,
                         reduce, reduce_scatter, scatter, send, wait)
from .mesh import (CommunicateTopology, HybridCommunicateGroup, get_mesh,
                   init_hybrid_mesh, init_mesh, named_sharding, set_mesh)
from .parallel_base import (DataParallel, ParallelEnv,  # noqa: F401
                            gather_sequence, get_rank, get_world_size,
                            init_parallel_env, is_initialized, parallelize,
                            shard_dataloader, shard_tensor)
from .recompute import recompute, recompute_sequential  # noqa: F401
from .sharding import (group_sharded_parallel,  # noqa: F401
                       save_group_sharded_model)
from .store import StoreReplyLostError, TCPStore  # noqa: F401

__all__ = [
    "ReduceOp", "all_reduce", "all_gather", "reduce_scatter", "broadcast",
    "reduce", "scatter", "alltoall", "all_to_all", "send", "recv", "barrier",
    "new_group", "get_group", "init_parallel_env", "get_rank",
    "get_world_size", "ParallelEnv", "DataParallel", "init_mesh", "get_mesh",
    "parallelize", "shard_tensor", "fleet", "spawn", "launch",
    # the port's own, from before this list was ported
    "store", "TCPStore", "StoreReplyLostError", "recompute",
    "recompute_sequential",
]


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """reference: python/paddle/distributed/spawn.py.  Runs ``func(*args)``
    in ``nprocs`` processes through ``torch.multiprocessing`` (the spawn
    start method), each with ``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM``
    set, plus ``PADDLE_MASTER`` on a free port of 127.0.0.1 unless the
    caller's environment names one — so ``func`` calls
    ``init_parallel_env()``.  ``nprocs`` of -1, 0 or 1 runs it inline.
    With ``join`` the call waits for every process and raises if one
    failed; otherwise it returns the processes."""
    if nprocs in (-1, 0, 1):
        return func(*args)
    import torch.multiprocessing as mp
    from .parallel_base import _free_port
    master = os.getenv("PADDLE_MASTER") or "127.0.0.1:%d" % _free_port()
    ctx = mp.get_context("spawn")
    procs = []
    for rank in range(nprocs):
        env = {"PADDLE_TRAINER_ID": str(rank),
               "PADDLE_TRAINERS_NUM": str(nprocs),
               "PADDLE_MASTER": master}
        p = ctx.Process(target=_spawn_entry, args=(func, args, env),
                        daemon=daemon)
        p.start()
        procs.append(p)
    if not join:
        return procs
    for p in procs:
        p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError("spawn: %d of %d processes failed (exit codes "
                           "%s)" % (len(bad), nprocs, bad))
    return procs


def _spawn_entry(func, args, env):
    os.environ.update(env)
    func(*args)


def __getattr__(name):
    # lazy, as in the JAX package: ``launch`` is the launcher module,
    # imported on access so that ``python -m
    # paddle_tpu_torch.distributed.launch_main`` does not import it twice
    if name == "launch":
        from . import launch_main
        return launch_main
    raise AttributeError(name)
