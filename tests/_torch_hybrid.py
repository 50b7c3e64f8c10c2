"""The port's side of the auto-parallel Engine and ZeRO stage 3 tests (not
a test module; it imports no JAX, so that the ranks of a
``_torch_dist.World`` can run its jobs as ``"_torch_hybrid:job_..."``).
Every rank is given the same numpy weights and data."""
from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# the auto-parallel Engine
# ---------------------------------------------------------------------------

def classifier(weights):
    """The Engine tests' 8-16-4 classifier (Linear, ReLU, Linear) with
    ``weights`` by the JAX names ("0.weight", ...)."""
    import torch

    from paddle_tpu_torch.nn.layer.common import Linear
    m = torch.nn.Sequential(Linear(8, 16), torch.nn.ReLU(), Linear(16, 4))
    with torch.no_grad():
        for n, p in m.named_parameters():
            p.copy_(torch.from_numpy(np.array(weights[n])))
    return m


def _mesh_of(mesh):
    """Install ``mesh`` ({"axes": {...}}, or {"ranks": array, "names":
    [...]}: a ProcessMesh) on every rank of the world; ``prepare``'s
    mesh argument for it, or None on a rank outside it."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed.auto_parallel import ProcessMesh
    if "ranks" in mesh:
        pm = ProcessMesh(mesh=np.array(mesh["ranks"]),
                         dim_names=mesh["names"])
        kw = {"process_mesh": pm}
    else:
        D.init_mesh(dict(mesh["axes"]))
        kw = {}
    return kw if D.get_mesh().coord is not None else None


def _np(t):
    return t.detach().float().numpy().copy()


def job_engine_classifier(weights, xs, ys, mesh, epochs=3, batch=16):
    """The classifier through ``Engine(model, cross_entropy, Adam,
    Accuracy())`` on ``mesh``: ``fit`` over a DataLoader of (xs, ys) in
    order, ``evaluate`` and ``predict`` over it, ``cost``.  Beside it the
    port's ``TrainStep`` fed the same global batches (its rows cut by
    ``in_shardings``).  Returns the history, the evaluate result, the
    predictions, the cost's mesh, the trained parameters and the
    step's losses and parameters."""
    import torch

    from paddle_tpu_torch import io
    from paddle_tpu_torch.distributed.auto_parallel import Engine
    from paddle_tpu_torch.distributed.mesh import PartitionSpec as P
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Adam
    kw = _mesh_of(mesh)
    if kw is None:
        return None
    x = torch.from_numpy(np.array(xs))
    y = torch.from_numpy(np.array(ys))
    loader = io.DataLoader(io.TensorDataset([x, y]), batch_size=batch,
                           shuffle=False, drop_last=True, device="cpu")
    model = classifier(weights)
    engine = Engine(model=model, loss=F.cross_entropy,
                    optimizer=Adam(learning_rate=1e-2,
                                   parameters=model.parameters()),
                    metrics=Accuracy())
    engine.prepare(device="cpu", **kw)
    hist = engine.fit(loader, epochs=epochs, batch_size=batch, verbose=0)
    result = engine.evaluate(loader, batch_size=batch)
    preds = [_np(o) for o in engine.predict(loader, batch_size=batch)]
    out = {"history": hist, "evaluate": result, "predict": preds,
           "cost": engine.cost()["mesh"],
           "params": {n: _np(p) for n, p in model.named_parameters()}}
    # the port's own step over the same global batches
    ref = classifier(weights)
    dp = "dp" in engine._mesh.shape
    step = TrainStep(ref, F.cross_entropy,
                     Adam(learning_rate=1e-2, parameters=ref.parameters()),
                     device="cpu", in_shardings=P("dp") if dp else None)
    means = []
    for _ in range(epochs):
        losses = [float(step(bx, by)) for bx, by in loader]
        means.append(sum(losses) / max(len(losses), 1))
    out["step_means"] = means
    out["step_params"] = {n: _np(p) for n, p in ref.named_parameters()}
    return out


def job_engine_gpt(weights, ids, axes, batch=4, zero_stage=None):
    """The tiny GPT through ``Engine(model, GPTPretrainingCriterion(),
    AdamW)`` on ``axes``: one epoch of ``fit`` over a DataLoader of
    ``ids``, ``evaluate``, ``predict`` of the first batch (the logits'
    vocab shards gathered over ``mp``), ``cost``; beside it ``TrainStep``
    over the same batches."""
    import torch

    import _torch_dist
    from paddle_tpu_torch import io
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed.auto_parallel import Engine
    from paddle_tpu_torch.distributed.mesh import PartitionSpec as P
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW
    if _mesh_of({"axes": axes}) is None:
        return None
    x = torch.from_numpy(np.array(ids))
    loader = io.DataLoader(io.TensorDataset([x, x]), batch_size=batch,
                           shuffle=False, drop_last=True, device="cpu")
    model = _torch_dist.tiny_gpt(weights)
    engine = Engine(model, GPTPretrainingCriterion(),
                    AdamW(learning_rate=1e-3, parameters=model.parameters(),
                          epsilon=1e-6))
    engine.prepare(device="cpu", zero_stage=zero_stage)
    hist = engine.fit(loader, epochs=1, verbose=0)
    result = engine.evaluate(loader)
    logits = engine.predict(loader, steps=1)[0]
    if axes.get("mp", 1) > 1:
        parts = C.all_gather([], logits.contiguous(), group="mp")
        logits = torch.cat(parts, -1)
    out = {"history": hist, "evaluate": result, "logits": _np(logits),
           "cost": engine.cost()["mesh"]}
    ref = _torch_dist.tiny_gpt(weights)
    if axes.get("mp", 1) > 1:
        from paddle_tpu_torch import distributed as D
        D.parallelize(ref)
    step = TrainStep(ref, GPTPretrainingCriterion(),
                     AdamW(learning_rate=1e-3, parameters=ref.parameters(),
                           epsilon=1e-6), device="cpu",
                     in_shardings=P("dp") if "dp" in axes else None,
                     zero_stage=zero_stage)
    losses = [float(step(bx, by)) for bx, by in loader]
    out["step_mean"] = sum(losses) / len(losses)
    return out


def job_shard_op(a, b):
    """``shard_op`` over {"dp": 4}: a matmul with its input and output
    rows on ``dp`` — its values and its gradient against the plain
    matmul's — and the specs it refuses (an axis the mesh lacks, a
    dimension the axis does not divide, a spec past the value's rank)."""
    import torch

    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed.auto_parallel import shard_op
    D.init_mesh({"dp": 4})

    def matmul(x, y):
        return x @ y
    f = shard_op(matmul, in_shard_specs=[("dp", None), None],
                 out_shard_specs=[("dp", None)])
    x = torch.from_numpy(np.array(a)).requires_grad_(True)
    y = torch.from_numpy(np.array(b))
    out = f(x, y)
    out.sum().backward()
    xr = torch.from_numpy(np.array(a)).requires_grad_(True)
    (xr @ y).sum().backward()
    errors = {}
    for key, fn in (
            ("unknown_axis", lambda: shard_op(
                matmul, in_shard_specs=[("mp", None)])(x, y)),
            ("indivisible", lambda: shard_op(
                matmul, out_shard_specs=[(None, "dp")])(x, y[:, :3])),
            ("too_long", lambda: shard_op(
                matmul, in_shard_specs=[(None, None, "dp")])(x, y))):
        try:
            fn()
            errors[key] = None
        except ValueError as e:
            errors[key] = str(e)
    return {"out": _np(out), "same": bool(torch.equal(out, xr @ y)),
            "grad_same": bool(torch.equal(x.grad, xr.grad)),
            "errors": errors}


def job_process_mesh(ranks, names):
    """A ProcessMesh over ``ranks`` with ``names``: this rank's coordinate
    and its groups' ranks, or the error it raises."""
    from paddle_tpu_torch.distributed.auto_parallel import ProcessMesh
    try:
        pm = ProcessMesh(mesh=np.array(ranks), dim_names=names)
    except (ValueError, NotImplementedError) as e:
        return "%s: %s" % (type(e).__name__, e)
    m = pm.mesh
    return {"coord": m.coord, "shape": pm.shape, "dim_names": pm.dim_names,
            "groups": {a: m.group(a).ranks for a in names},
            "axis_names": list(m.axis_names)}


def job_process_mesh_errors():
    """ProcessMesh's refusals: ``process_ids``, neither mesh nor shape."""
    from paddle_tpu_torch.distributed.auto_parallel import ProcessMesh
    out = {}
    for key, kw in (("process_ids", {"shape": [2, 2],
                                     "dim_names": ["dp", "mp"],
                                     "process_ids": [0, 1, 2, 3]}),
                    ("nothing", {"dim_names": ["dp"]})):
        try:
            ProcessMesh(**kw)
            out[key] = None
        except (ValueError, NotImplementedError) as e:
            out[key] = "%s: %s" % (type(e).__name__, e)
    return out


# ---------------------------------------------------------------------------
# ZeRO stage 3
# ---------------------------------------------------------------------------

def zero_gpt_train(weights, ids, stage, steps=3, amp=False, stack=False,
                   **cfg):
    """``steps`` AdamW steps of the tiny GPT at ``zero_stage=stage`` on
    {"sdp": 2}, the batch sharded over ``sdp``; ``amp`` decorates it O2
    bf16, ``stack`` is ``TrainStep(stack_layers=True)``.  Returns the
    losses, the full masters from ``state_dict``, the model's parameter
    shapes at rest, the gathered-bytes counters and the model after
    ``sync_to_model``."""
    import torch

    import _torch_dist
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed.mesh import PartitionSpec as P
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW
    D.init_mesh({"sdp": 2})
    m = _torch_dist.tiny_gpt(weights, **cfg)
    if amp:
        from paddle_tpu_torch import amp as A
        m = A.decorate(m, level="O2", dtype="bfloat16")
    step = TrainStep(m, GPTPretrainingCriterion(),
                     AdamW(learning_rate=1e-3, parameters=m.parameters(),
                           epsilon=1e-6), device="cpu", zero_stage=stage,
                     in_shardings=P("sdp"), stack_layers=stack)
    x = torch.from_numpy(np.array(ids))
    losses = [float(step(x, x)) for _ in range(steps)]
    sd = step.state_dict()
    g = step._gather
    out = {"losses": losses,
           "masters": {n: _np(v) for n, v in sd["params"].items()},
           "rest": {n: tuple(p.shape) for n, p in m.named_parameters()},
           "gather": None}
    if g is not None:
        def nbytes(p):
            return p.numel() * p.element_size() * step._zero.nranks
        blocks = {}
        for n, p in g.params.items():
            if ".h." in n:
                i = n.split(".h.")[1].split(".")[0]
                blocks[i] = blocks.get(i, 0) + nbytes(p)
            elif ".h_stack." in n:          # a layer's rows a stacked one
                blocks[0] = blocks.get(0, 0) + nbytes(p) // p.shape[0]
        out["gather"] = {"peak": g.peak_bytes, "live": g.live_bytes,
                         "gathers": g.gathers / steps,
                         "wte": nbytes(g.params["gpt.wte.weight"]),
                         "block": max(blocks.values())}
    step.sync_to_model()
    out["model"] = {n: _np(p) for n, p in m.named_parameters()}
    return out


def job_zero3(weights, ids, steps=3, amp=False, cfg=None):
    """Stages 2 and 3 of :func:`zero_gpt_train` from the same weights."""
    cfg = dict(cfg or {})
    return {stage: zero_gpt_train(weights, ids, stage, steps, amp,
                                  **dict(cfg))
            for stage in (2, 3)}


def job_zero3_stack(weights, ids, steps=2):
    """``TrainStep(stack_layers=True)`` at stages 2 and 3: the stacked
    layout keeps the whole parameters in the model (no gather-on-use)."""
    return {stage: zero_gpt_train(weights, ids, stage, steps, stack=True)
            for stage in (2, 3)}


def tensors(tree):
    """The tensors of a nested state, in a fixed order."""
    import torch
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors(v)]
    return []


def _shard_bytes(path):
    """Bytes of the arrays a rank's checkpoint file holds, and its sliced
    leaves' shard indices, by the leaf's path."""
    import pickle

    from paddle_tpu_torch.incubate import checkpoint as ck
    with open(path, "rb") as f:
        tree = pickle.load(f)
    total, shards = 0, {}

    def walk(t, path):
        nonlocal total
        if isinstance(t, ck._TensorLeaf):
            total += t.array.nbytes
        elif isinstance(t, ck._ShardedLeaf):
            for idx, a in t.shards:
                total += a.nbytes
            shards[path] = [idx for idx, _a in t.shards]
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        elif isinstance(t, np.ndarray):
            total += t.nbytes
    walk(tree, ())
    return total, shards


def job_zero_sliced_save(weights, ids, stage, directory, stack=False):
    """Two steps at ``stage`` on {"sdp": 2}, a checkpoint of the step
    through ``CheckpointManager.save`` (the step in the tree: its ZeRO
    slices as sliced leaves), a third step; then a fresh step restored
    from the checkpoint and its third step.  Returns the bytes of the
    rank's file, the bytes of the whole state (``state_dict()``), the
    sliced leaves' indices, the two third-step losses and whether the
    restored state equals the saved one bit for bit.  ``stack``:
    ``TrainStep(stack_layers=True)``, whose stacked slices are saved
    under the per-layer names."""
    import os

    import torch
    import torch.distributed as dist

    import _torch_dist
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed.mesh import PartitionSpec as P
    from paddle_tpu_torch.incubate.checkpoint import CheckpointManager
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW
    D.init_mesh({"sdp": 2})
    x = torch.from_numpy(np.array(ids))

    def build():
        m = _torch_dist.tiny_gpt(weights)
        return TrainStep(m, GPTPretrainingCriterion(),
                         AdamW(learning_rate=1e-3,
                               parameters=m.parameters(), epsilon=1e-6),
                         device="cpu", zero_stage=stage,
                         in_shardings=P("sdp"), stack_layers=stack)
    step = build()
    for _ in range(2):
        step(x, x)
    mgr = CheckpointManager(directory, async_save=False)
    mgr.save(2, {"train_step": step})
    # rank 0 publishes the checkpoint after the other ranks' save returns
    dist.barrier()
    saved = step.state_dict()
    whole = sum(v.numel() * v.element_size()
                for v in tensors(saved))
    # what the rank's file should hold: its slice of each sliced tensor
    # (the step holds the slices: the file leaves out as many bytes)
    z = step._zero
    cut = sum(v.numel() * v.element_size()
              for n, s in step.opt_state["slots"].items() if z.sliced(n)
              for v in s.values() if v.ndim)
    if stage >= 3:
        cut += sum(t.numel() * t.element_size()
                   for n, t in step.params.items() if z.sliced(n))
    from paddle_tpu_torch.incubate.checkpoint import TrainEpochRange
    epochs = TrainEpochRange(1, checkpoint_dir=os.path.join(
        directory, "epochs-%d" % dist.get_rank()))
    epochs.register_train_step(step)
    registered = epochs._getters["train_step"] == step._sliced_state
    epochs.manager.close()
    rank = dist.get_rank()
    mine, shards = _shard_bytes(os.path.join(directory, "ckpt-2",
                                             "host-%d.ckpt" % rank))
    after = float(step(x, x))
    fresh = build()
    payload = CheckpointManager(directory, async_save=False).restore()
    fresh.set_state_dict(payload["train_step"])
    back = fresh.state_dict()
    same = all(torch.equal(a, b) for a, b in zip(
        tensors(saved), tensors(back)))
    mgr.close()
    return {"file_bytes": mine, "whole_bytes": whole, "shards": shards,
            "expected_bytes": whole - cut, "rank": rank,
            "dims": {n: d for n, d in z.dims.items() if d is not None},
            "losses": (after, float(fresh(x, x))), "same_state": same,
            "registered_sliced": registered}


# ---------------------------------------------------------------------------
# chip_smoke.py's sep_hybrid_gloo on a CPU gloo world of four
# ---------------------------------------------------------------------------

#: sep_hybrid_gloo at a narrow width: 2 layers, 2 heads of 64, 128 rows a
#: rank of a 256-row sequence
HYBRID_S = 256


def hybrid_cfg():
    from paddle_tpu_torch.models.gpt import GPTConfig
    return GPTConfig(vocab_size=512, max_position_embeddings=HYBRID_S,
                     hidden_size=128, num_hidden_layers=2,
                     num_attention_heads=2, intermediate_size=256,
                     hidden_dropout_prob=0.0, attention_dropout_prob=0.0)


def job_sep_hybrid_rank(refs):
    """chip_smoke.py's sep_hybrid_rank on this world (gloo, CPU tensors)
    at :func:`hybrid_cfg`'s narrow width against the one-process runs
    ``refs``, the flash route through its plain versions, counted."""
    import pytest
    import torch

    import chip_smoke
    from _torch_dist import PlainCounters
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(torch.cuda, "synchronize", lambda *a: None)
        spec = {"cfg": hybrid_cfg(), "s": HYBRID_S,
                "steps": chip_smoke.SEP_STEPS, "refs": refs}
        return chip_smoke.sep_hybrid_rank(torch, spec, PlainCounters(mp),
                                          device="cpu")
    finally:
        mp.undo()


def job_zero3_rebuild(weights, ids):
    """A new step on a model at rest as a stage-3 step's slices raises
    ValueError; after that step's ``sync_to_model`` a deep copy of the
    model runs as it without a collective, and a new step takes the
    model, with the old step's hooks gone: its first loss is the old
    step's next one, bit for bit."""
    import torch

    import _torch_dist
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW
    D.init_mesh({"sdp": 2})
    x = torch.from_numpy(np.array(ids))

    def step(m, stage):
        return TrainStep(m, GPTPretrainingCriterion(),
                         AdamW(learning_rate=1e-3, parameters=m.parameters(),
                               epsilon=1e-6), device="cpu", zero_stage=stage)
    m, ref = _torch_dist.tiny_gpt(weights), _torch_dist.tiny_gpt(weights)
    three, ref_step = step(m, 3), step(ref, 3)
    three(x, x)
    ref_step(x, x)
    try:
        step(m, 2)
        refused = None
    except ValueError as e:
        refused = str(e)
    three.sync_to_model()
    # a deep copy of the whole model carries the stage-3 hooks, which
    # leave it alone: its forward gathers nothing
    import copy

    from paddle_tpu_torch.distributed import collective as C
    twin = copy.deepcopy(m)
    C.reset_counts()
    with torch.no_grad():
        copied = bool(torch.equal(twin(x), m(x)))
    copied = copied and not C.issued()
    two = step(m, 2)
    from paddle_tpu_torch.distributed import sharding
    return {"refused": refused, "hooks_left": m in sharding._GATHERS,
            "copied": copied,
            "losses": (float(two(x, x)), float(ref_step(x, x)))}
