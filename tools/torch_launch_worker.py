#!/usr/bin/env python3
"""A training worker for the port's launcher: reads its data through
``io.DataLoader`` (worker processes over the shared-memory queue),
trains a seeded GPT with ``jit.TrainStep``, checkpoints, and carries on
from its newest checkpoint when the launcher starts it again.

    python -m paddle_tpu_torch.distributed.launch_main [--elastic] \\
        [--nproc_per_node N --master 127.0.0.1:PORT] \\
        tools/torch_launch_worker.py SPEC.json

``SPEC.json`` (all keys required unless said):

* ``workdir`` — checkpoints go to ``<workdir>/ckpt``, and each run of the
  worker writes ``<workdir>/result-<rank>-<restart>.json``;
* ``device`` — ``"cuda"`` or ``"cpu"``; ``model`` — ``GPTConfig``
  keyword arguments; ``seed`` (weights), ``rows_seed`` (token ids);
  ``batch`` (global rows a step), ``seq``, ``steps``, ``lr``; ``amp``
  (AMP O2 bf16), ``use_pallas_norm``, ``num_workers``, ``stack_layers``
  (optional);
* ``mode`` — ``"elastic"``: one process, ``TrainEpochRange`` over a
  ``CheckpointManager`` (an epoch a step, async saves), resumed through
  its ``ResumableIterator`` cursor; ``crash_at`` (optional) — at the
  ``train.epoch`` faultpoint of that epoch, once (a marker file), the
  worker waits for its queued saves and ends with ``os._exit(137)``;
  ``save_probe`` (optional, K) — after the last epoch, K steps with no
  save in flight, one async save of the same state, then K steps while
  its write is in flight;
  ``"dp"``: ``--nproc_per_node`` ranks over gloo, each taking its rows
  through ``DistributedBatchSampler``, ``TrainStep(local_batch=True)``,
  and with ``save_after`` a synchronous save of every rank after that
  step; ``resume`` restores the newest checkpoint first.

The result file holds the losses by step (``repr`` of the float: bit for
bit), the kernel launches of each step, each step's synced wall ms and
the ms each save call held the loop, the loader's route, the cursor and
step the run resumed at, checkpoint seconds and bytes, wall-clock
marks, host ms a batch through the loader and by hand, the sha256 of
the parameters after the last step, and the ``PADDLE_*`` environment.
"""
from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from paddle_tpu_torch.robustness.faultpoints import (  # noqa: E402
    FaultAction, HardExit)

ENV_KEYS = ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "PADDLE_LOCAL_RANK",
            "PADDLE_RANK_IN_NODE", "PADDLE_CURRENT_ENDPOINT",
            "PADDLE_TRAINER_ENDPOINTS", "PADDLE_RESTART_COUNT",
            "PADDLE_MASTER")


def counters():
    """(kernel name, wrapper module, its launch counter's attribute) of
    every kernel wrapper."""
    from paddle_tpu_torch.kernels import ce_cuda
    from paddle_tpu_torch.kernels import flash_attention_cuda as fac
    from paddle_tpu_torch.kernels import norm_cuda
    return [(name, mod, name + "_launches") for mod, names in (
        (fac, ("flash_fwd_tc", "flash_fwd", "flash_fwd_pipelined",
               "flash_bwd", "flash_bwd_dq", "flash_bwd_dkv")),
        (norm_cuda, ("layer_norm_fwd", "layer_norm_bwd")),
        (ce_cuda, ("ce_lse", "ce_fwd", "ce_bwd"))) for name in names]


def token_rows(spec):
    """The run's token ids, (steps x batch, seq), from ``rows_seed``."""
    import numpy as np
    return np.random.default_rng(spec["rows_seed"]).integers(
        0, spec["model"]["vocab_size"],
        (spec["steps"] * spec["batch"], spec["seq"])).astype(np.int64)


def build_step(spec, torch, world):
    """The seeded model under ``TrainStep`` (AdamW, the label-shift
    criterion) on the spec's device."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.distributed.mesh import PartitionSpec
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLM,
                                             GPTPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.utils import flags
    flags.set_flags({"use_pallas_norm": bool(spec["use_pallas_norm"])})
    model = GPTForCausalLM(GPTConfig(**spec["model"]),
                           generator=torch.Generator().manual_seed(
                               spec["seed"]))
    if spec["amp"]:
        model = amp.decorate(model, level="O2", dtype="bfloat16")
    opt = AdamW(learning_rate=spec["lr"], weight_decay=0.01,
                parameters=model.parameters())
    kw = {}
    if world > 1:
        kw = dict(in_shardings=PartitionSpec("dp", None), local_batch=True)
    return TrainStep(model, GPTPretrainingCriterion(), opt,
                     device=spec["device"],
                     stack_layers=bool(spec.get("stack_layers")), **kw)


def sync(torch, device):
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def main(spec_path):
    spec = json.loads(Path(spec_path).read_text())
    t_start = time.time()
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    restart = int(os.environ.get("PADDLE_RESTART_COUNT", "0"))
    import torch
    torch.set_num_threads(max(1, min(4, os.cpu_count() or 1)))
    from paddle_tpu_torch.incubate.checkpoint import (CheckpointManager,
                                                      ResumableIterator,
                                                      TrainEpochRange,
                                                      step_generators)
    from paddle_tpu_torch.io import (DataLoader, DistributedBatchSampler,
                                     TensorDataset)
    from paddle_tpu_torch.observability import registry
    from paddle_tpu_torch.robustness import faultpoints as fp
    if world > 1:
        from paddle_tpu_torch.distributed import init_parallel_env
        init_parallel_env(backend="gloo", device=spec["device"])
    device = spec["device"]
    rows = token_rows(spec)
    local = spec["batch"] // world
    sampler = DistributedBatchSampler(TensorDataset([rows]), local,
                                      num_replicas=world, rank=rank)
    loader = DataLoader(TensorDataset([rows]), batch_sampler=sampler,
                        num_workers=spec["num_workers"], device=device)
    it = ResumableIterator(loader)
    step = build_step(spec, torch, world)
    ckdir = os.path.join(spec["workdir"], "ckpt")
    out = {"rank": rank, "world": world, "restart": restart,
           "env": {k: os.environ.get(k) for k in ENV_KEYS},
           "t_start": t_start, "losses": {}, "launches": {},
           "loader_ms": [], "by_hand_ms": [], "step_ms": {},
           "save_call_ms": {}}
    write_h = registry.histogram("checkpoint.write_seconds")
    bytes_h = registry.histogram("checkpoint.write_bytes")
    restore_h = registry.histogram("checkpoint.restore_seconds")

    def run_step(e, batch_iter):
        sync(torch, device)
        t0 = time.perf_counter()
        ids = next(batch_iter)[0]
        sync(torch, device)
        out["loader_ms"].append((time.perf_counter() - t0) * 1e3)
        # the same rows made by hand, for the loader's cost beside it
        t0 = time.perf_counter()
        mine = sampler_rows(e)
        torch.as_tensor(rows[mine], device=device)
        sync(torch, device)
        out["by_hand_ms"].append((time.perf_counter() - t0) * 1e3)
        if not torch.equal(ids.cpu(), torch.as_tensor(rows[mine])):
            raise AssertionError("step %d: the loader's rows are not the "
                                 "sampler's" % e)
        for _name, mod, attr in counters():
            setattr(mod, attr, 0)
        t0 = time.perf_counter()
        loss = step(ids, ids)
        sync(torch, device)
        out["step_ms"][str(e)] = (time.perf_counter() - t0) * 1e3
        out["losses"][str(e)] = repr(float(loss))
        out["launches"][str(e)] = {name: getattr(mod, attr)
                                   for name, mod, attr in counters()}
        if "t_first_step" not in out:
            out["t_first_step"] = time.time()

    def sampler_rows(e):
        return list(range(e * spec["batch"] + rank,
                          (e + 1) * spec["batch"], world))

    if spec["mode"] == "elastic":
        epochs = TrainEpochRange(spec["steps"], checkpoint_dir=ckdir,
                                 save_interval=1, max_to_keep=2)
        epochs.register_train_step(step, it)
        epochs.manager.save = _timed(epochs.manager.save,
                                     out["save_call_ms"])
        plan = fp.FaultPlan()
        if spec.get("crash_at") is not None:
            plan.inject("train.epoch", _CrashOnce(
                spec["crash_at"], os.path.join(spec["workdir"],
                                               "crashed.json"),
                epochs.manager, out, loader), every=1)
        batches = None
        with fp.chaos(plan):
            for e in epochs.get():
                if batches is None:
                    out["resumed_at"] = e
                    out["restored_cursor"] = it.state_dict()
                    out["restored_epoch"] = epochs.restored_epoch
                    batches = iter(it)
                run_step(e, batches)
        if batches is not None:
            batches.close()
        epochs.manager.close()
        if spec.get("save_probe"):
            last = torch.as_tensor(rows[sampler_rows(spec["steps"] - 1)],
                                   device=device)
            out["save_probe"] = save_probe(
                torch, step, last, os.path.join(spec["workdir"], "probe"),
                spec["save_probe"], device, write_h)
    else:
        mgr = CheckpointManager(ckdir, max_to_keep=2, async_save=False)
        start = 0
        if spec.get("resume"):
            t0 = time.perf_counter()
            payload = mgr.restore()
            out["restore_wall_s"] = time.perf_counter() - t0
            step.set_state_dict(payload["train_step"])
            for g, st in zip(step_generators(step), payload["generators"]):
                g.set_state(st)
            it.set_state_dict(payload["cursor"])
            start = int(payload["epoch"]) + 1
            out["restored_cursor"] = payload["cursor"]
        out["resumed_at"] = start
        batches = iter(it)
        for e in range(start, spec["steps"]):
            run_step(e, batches)
            if e == spec.get("save_after"):
                t0 = time.perf_counter()
                mgr.save(e, {"epoch": e, "train_step": step.state_dict(),
                             "generators": [g.get_state() for g in
                                            step_generators(step)],
                             "cursor": it.state_dict()})
                out["save_wall_s"] = time.perf_counter() - t0
                d = os.path.join(ckdir, "ckpt-%d" % e)
                out["host_files"] = sorted(
                    n for n in os.listdir(d) if n.endswith(".ckpt")) \
                    if os.path.isdir(d) else []
        batches.close()
        mgr.close()
    out["params_sha256"] = params_digest(torch, step)
    out["route"] = loader.last_route
    out["cursor"] = it.state_dict()
    out["write_seconds"] = {"count": write_h.count, "sum": write_h.sum}
    out["write_bytes"] = {"count": bytes_h.count, "sum": bytes_h.sum}
    out["restore_seconds"] = {"count": restore_h.count,
                              "sum": restore_h.sum}
    out["t_end"] = time.time()
    path = Path(spec["workdir"]) / ("result-%d-%d.json" % (rank, restart))
    path.write_text(json.dumps(out))
    if world > 1:
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


def _timed(fn, into):
    """``fn`` that records the ms of each call under its first argument
    (a checkpoint's step) in ``into``."""
    def call(step_no, *a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(step_no, *a, **kw)
        finally:
            into[str(step_no)] = (time.perf_counter() - t0) * 1e3
    return call


def save_probe(torch, step, ids, directory, k, device, write_h):
    """What an async save adds to a step: ``k`` synced steps on ``ids``
    with no save in flight, one async ``CheckpointManager.save`` of the
    step's state (the call's ms: the fetch to host and the queueing),
    then ``k`` steps while its write runs, each marked by whether the
    write was still in flight when the step ended.  The probe's
    checkpoint is removed."""
    import shutil

    from paddle_tpu_torch.incubate.checkpoint import CheckpointManager

    def timed_step():
        sync(torch, device)
        t0 = time.perf_counter()
        step(ids, ids)
        sync(torch, device)
        return (time.perf_counter() - t0) * 1e3

    idle = [timed_step() for _ in range(k)]
    mgr = CheckpointManager(directory, max_to_keep=1)
    written = write_h.count
    t0 = time.perf_counter()
    mgr.save(0, {"train_step": step.state_dict()})
    call_ms = (time.perf_counter() - t0) * 1e3
    busy, in_flight = [], []
    for _ in range(k):
        busy.append(timed_step())
        in_flight.append(write_h.count == written)
    t0 = time.perf_counter()
    mgr.close()
    drain_ms = (time.perf_counter() - t0) * 1e3
    shutil.rmtree(directory, ignore_errors=True)
    return {"idle_step_ms": idle, "save_call_ms": call_ms,
            "busy_step_ms": busy, "in_flight": in_flight,
            "drain_ms": drain_ms}


def params_digest(torch, step):
    """sha256 of the model's parameters, in order, as f32 bytes: ranks
    that applied the same update agree on it bit for bit."""
    import hashlib
    h = hashlib.sha256()
    for p in step.model.parameters():
        h.update(p.detach().float().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


class _CrashOnce(FaultAction):
    """At ``train.epoch`` of epoch ``at``, once: wait for the queued
    checkpoints, write the run's result so far and the time into
    ``marker``, end the process with no clean-up (``HardExit``)."""

    def __init__(self, at, marker, manager, out, loader):
        self.at, self.marker, self.manager = at, marker, manager
        self.out, self.loader = out, loader

    def fire(self, ctx, plan):
        if ctx["epoch"] != self.at or os.path.exists(self.marker):
            return
        self.manager.wait()
        with open(self.marker, "w") as f:
            json.dump(dict(self.out, epoch=self.at, t_death=time.time(),
                           route=self.loader.last_route), f)
        HardExit(137).fire(ctx, plan)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
