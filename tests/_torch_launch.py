"""Rank jobs for the port's checkpoint and launcher tests (not a test
module; it imports no JAX, so that the gloo ranks of
``tests/_torch_dist.py``, which unpickle their jobs from here, never load
it)."""
from __future__ import annotations

import os


def job_ckpt_two_ranks(directory):
    """Each rank of a world of two saves its half of a (4, 6) array as a
    sliced leaf: both ``host-<rank>`` files are written and rank 0
    publishes; a restore joins the halves.  Then a save whose rank-1
    shard vanishes before the publish barrier: rank 0 refuses to publish
    it (``CheckpointWriteError``)."""
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.incubate.checkpoint import (CheckpointManager,
                                                      CheckpointWriteError,
                                                      sliced)
    from paddle_tpu_torch.robustness import faultpoints as fp
    rank = dist.get_rank()
    full = torch.arange(24.0).reshape(4, 6)
    mgr = CheckpointManager(directory, async_save=True)
    state = {"w": sliced(full[2 * rank:2 * rank + 2], (4, 6),
                         ((2 * rank, 2 * rank + 2), (0, 6))),
             "step": 1}
    mgr.save(1, state)          # several ranks: synchronous
    dist.barrier()              # rank 0 publishes after the others return
    files = sorted(os.listdir(os.path.join(directory, "ckpt-1")))
    restored = mgr.restore()

    class Vanish(fp.FaultAction):
        def fire(self, ctx, plan):
            os.unlink(ctx["path"])

    plan = fp.FaultPlan()
    if rank == 1:
        plan.inject("checkpoint.shard_file", Vanish())
    err = None
    with fp.chaos(plan):
        try:
            mgr.save(2, state)
        except CheckpointWriteError as e:
            err = str(e)
    dist.barrier()
    steps = mgr.all_steps()
    mgr.close()
    return {"files": files, "w": restored["w"].numpy(),
            "step": restored["step"], "err": err, "steps": steps}
