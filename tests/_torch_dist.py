"""A gloo world of CPU ranks for the port's multi-rank tests (not a test
module; it imports no JAX, so that the spawned ranks, which unpickle their
entry point from here, never load it).

``World(n)`` starts ``n`` processes that each call
``paddle_tpu_torch.distributed.init_parallel_env(backend="gloo",
device="cpu")`` and then wait for jobs.  ``world.run(name, **kw)`` runs
the function ``name`` of this module, or ``"module:fn"`` of another
JAX-free module here (a job), on every rank with the same
numpy keyword arguments and returns the ranks' results in rank order;
a job that raises on any rank fails the call with the rank's traceback,
and the world is then closed (a rank left inside a collective cannot be
trusted).  A test module starts one world for all its tests
(a module-scoped fixture) and closes it at the end.
"""
from __future__ import annotations

import os
import socket
import sys
import traceback

import numpy as np

_RANK_TIMEOUT_S = 240.0


def _free_port():
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
    finally:
        s.close()


def _rank_main(rank, world, port, conn):
    os.environ.update(PADDLE_TRAINER_ID=str(rank),
                      PADDLE_TRAINERS_NUM=str(world),
                      PADDLE_MASTER="127.0.0.1:%d" % port)
    import datetime

    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d" % port,
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    from paddle_tpu_torch.distributed import init_parallel_env
    init_parallel_env(backend="gloo", device="cpu")
    me = sys.modules[__name__]
    while True:
        msg = conn.recv()
        if msg is None:
            break
        name, kw = msg
        try:
            from paddle_tpu_torch.distributed import mesh as _mesh
            _mesh.set_mesh(None)
            conn.send(("ok", _job(me, name)(**kw)))
        except BaseException:
            conn.send(("error", traceback.format_exc()))
    dist.destroy_process_group()


def _job(me, name):
    """The job ``name``: a function of this module, or ``"module:fn"``, a
    function of another JAX-free module of this directory."""
    mod_name, _, fn = name.rpartition(":")
    if not mod_name:
        return getattr(me, fn)
    import importlib
    return getattr(importlib.import_module(mod_name), fn)


class World:
    def __init__(self, n):
        import torch.multiprocessing as mp
        ctx = mp.get_context("spawn")
        port = _free_port()
        self.n = n
        self._conns, self._procs = [], []
        for rank in range(n):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_rank_main, args=(rank, n, port, child),
                            daemon=True)
            p.start()
            self._conns.append(parent)
            self._procs.append(p)

    def run(self, name, **kw):
        if not self._procs:
            raise RuntimeError("the world is closed")
        for c in self._conns:
            c.send((name, kw))
        out, errors = [], []
        for rank, c in enumerate(self._conns):
            if not c.poll(_RANK_TIMEOUT_S):
                errors.append("rank %d: no result in %.0f s"
                              % (rank, _RANK_TIMEOUT_S))
                out.append(None)
                continue
            try:
                status, value = c.recv()
            except (EOFError, OSError) as e:
                status, value = "error", "the rank died: %r" % (e,)
            if status != "ok":
                errors.append("rank %d:\n%s" % (rank, value))
            out.append(value)
        if errors:
            self.close()
            raise RuntimeError("job %s failed:\n%s" % (name,
                                                       "\n".join(errors)))
        return out

    def close(self):
        for c, p in zip(self._conns, self._procs):
            try:
                if p.is_alive():
                    c.send(None)
            except (BrokenPipeError, OSError):
                pass
        for p in self._procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join(5)
        self._procs, self._conns = [], []


class PlainCounters:
    """chip_smoke's Counters on the CPU, with the flash route forced on:
    the calls of the attention's forward and backward and of the
    LayerNorm wrapper (their plain versions) in place of the kernels'
    launches; eager runs only, so B's count on the card is the
    wrapper's."""

    def __init__(self, monkeypatch):
        from paddle_tpu_torch.kernels import flash_attention as fa
        from paddle_tpu_torch.kernels import flash_attention_cuda as fac
        from paddle_tpu_torch.kernels import norm_cuda
        self.calls = dict.fromkeys(("fwd", "bwd", "ln"), 0)
        for mod, name, key in ((fac, "_forward", "fwd"),
                               (fac, "flash_attention_bwd", "bwd"),
                               (norm_cuda, "layer_norm", "ln")):
            monkeypatch.setattr(mod, name, self._counted(getattr(mod, name),
                                                         key))
        # the card gate's shape conditions, without its device one
        monkeypatch.setattr(fa, "supported",
                            lambda q, k=None: q.dim() == 4
                            and q.shape[1] % 128 == 0
                            and q.shape[3] in (64, 128, 256)
                            and (k is None or k.shape[1] == q.shape[1]))

    def _counted(self, fn, key):
        def run(*a, **kw):
            self.calls[key] += 1
            return fn(*a, **kw)
        return run

    def reset(self):
        self.calls = dict.fromkeys(self.calls, 0)

    def read(self):
        out = dict.fromkeys(("flash_fwd", "flash_fwd_pipelined",
                             "flash_bwd", "layer_norm_bwd", "ce_lse",
                             "ce_fwd", "ce_bwd", "softmax_fwd"), 0)
        out.update(flash_fwd_tc=self.calls["fwd"],
                   flash_bwd_dq=self.calls["bwd"],
                   flash_bwd_dkv=self.calls["bwd"],
                   layer_norm_fwd=self.calls["ln"])
        return out

    def b_on_device(self):
        return self.calls["ln"]


def np_state(tensors):
    return {k: v.detach().float().numpy().copy() for k, v in tensors.items()}


# ---------------------------------------------------------------------------
# jobs: tests/test_torch_collective.py
# ---------------------------------------------------------------------------

def job_collectives(x, lists, objs):
    """Every collective on a 2 x 2 mesh ({"dp": 2, "mp": 2}).  ``x``
    (world, ...) gives rank r its row; ``lists`` (world, n, ...) its
    tensor list.  Returns {case: numpy} and whether each in-place op
    returned its input."""
    import torch

    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import collective as C
    D.init_mesh({"dp": 2, "mp": 2})
    r = D.get_rank()
    out, same = {}, {}

    def mine():
        return torch.from_numpy(np.array(x[r]))

    C.reset_counts()
    for op in ("SUM", "MAX", "MIN", "PROD", "AVG"):
        for axis in ("dp", "mp"):
            t = mine()
            res = D.all_reduce(t, op=getattr(D.ReduceOp, op), group=axis)
            same["all_reduce"] = res is t
            out["all_reduce_%s_%s" % (op, axis)] = t.numpy()
    for axis in ("dp", "mp"):
        out["all_gather_%s" % axis] = D.all_gather(mine(), group=axis).numpy()
        lst = []
        D.all_gather(lst, mine(), group=axis)
        out["all_gather_list_%s" % axis] = np.stack([t.numpy() for t in lst])
        t = mine()
        D.broadcast(t, src=1, group=axis)
        out["broadcast_%s" % axis] = t.numpy()
        for op in ("SUM", "MAX", "MIN"):
            t = mine()
            D.reduce(t, dst=0, op=getattr(D.ReduceOp, op), group=axis)
            out["reduce_%s_%s" % (op, axis)] = t.numpy()
        t = mine()
        out["reduce_scatter_%s" % axis] = D.reduce_scatter(
            t, group=axis).numpy()
        dst = torch.zeros_like(torch.from_numpy(np.array(lists[r][0])))
        res = D.reduce_scatter(dst, [torch.from_numpy(np.array(a))
                                     for a in lists[r][:2]], group=axis)
        same["reduce_scatter"] = res is dst
        out["reduce_scatter_list_%s" % axis] = dst.numpy()
        t = torch.zeros_like(torch.from_numpy(np.array(lists[r][0])))
        D.scatter(t, [torch.from_numpy(np.array(a)) for a in lists[0][:2]],
                  src=0, group=axis)
        out["scatter_%s" % axis] = t.numpy()
        got = []
        D.alltoall([torch.from_numpy(np.array(a)) for a in lists[r][:2]],
                   got, group=axis)
        out["alltoall_%s" % axis] = np.stack([t.numpy() for t in got])
        out["all_to_all_single_%s" % axis] = D.all_to_all_single(
            mine(), group=axis).numpy()
        objs_out = []
        D.all_gather_object(objs_out, objs[r], group=axis)
        out["all_gather_object_%s" % axis] = np.array(objs_out)
    # point to point along mp: group rank 0 sends, group rank 1 receives
    mp_rank = D.get_rank("mp")
    t = mine()
    if mp_rank == 0:
        D.send(t, dst=1, group="mp")
        task = D.irecv(t, src=1, group="mp")
    else:
        D.recv(t, src=0, group="mp")
        task = D.isend(t * 10, dst=0, group="mp")
    task.wait()
    out["p2p"] = t.numpy()
    D.barrier()
    D.wait(t)
    g = D.new_group(axis="dp")
    t = mine()
    D.all_reduce(t, group=g)
    out["new_group_dp"] = t.numpy()
    with C.split_group_axis("mp"):
        t = mine()
        D.all_reduce(t)
        out["default_axis_mp"] = t.numpy()
    out["issued"] = C.issued()
    out["same"] = same
    out["coord"] = (D.get_mesh().coord["dp"], D.get_mesh().coord["mp"])
    return out


# ---------------------------------------------------------------------------
# jobs: tests/test_torch_data_parallel.py
# ---------------------------------------------------------------------------

def job_dp_unused(weights, x):
    """DataParallel over the world: rank r starts from ``weights[r]``
    (rank 0's are broadcast at wrap time); layer ``b`` runs on rank 0
    only and ``c`` on no rank.  Returns the parameters after the wrap and
    the gradients after ``apply_collective_grads`` (None: no grad)."""
    import torch

    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.nn import Linear

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.a, self.b, self.c = Linear(4, 4), Linear(4, 4), Linear(4, 4)

        def forward(self, h, use_b):
            h = self.a(h)
            return self.b(h) if use_b else h

    r = D.get_rank()
    net = Net()
    with torch.no_grad():
        for n, p in net.named_parameters():
            p.copy_(torch.from_numpy(np.array(weights[r][n])))
    dp = D.DataParallel(net)
    params = {n: p.detach().numpy().copy() for n, p in net.named_parameters()}
    dp(torch.from_numpy(np.array(x[r])), use_b=(r == 0)).sum().backward()
    dp.apply_collective_grads()
    grads = {n: (None if p.grad is None else p.grad.numpy().copy())
             for n, p in net.named_parameters()}
    return params, grads


def dp_mlp(weights):
    """The JAX data-parallel test's model: Linear(16, 32), ReLU,
    Linear(32, 4), with ``weights`` by the JAX names."""
    import torch

    from paddle_tpu_torch.nn import Linear
    m = torch.nn.Sequential(Linear(16, 32), torch.nn.ReLU(), Linear(32, 4))
    with torch.no_grad():
        for n, p in m.named_parameters():
            p.copy_(torch.from_numpy(np.array(weights[n])))
    return m


def dp_train(weights, X, Y, steps=3, flat_master=False, dp=True):
    """SGD(0.1) on MSE through ``TrainStep``: with ``dp`` every rank is
    given the global (X, Y) and ``in_shardings=P("dp", None)``.  Returns
    the losses and the final parameters."""
    import torch

    from paddle_tpu_torch.distributed.mesh import PartitionSpec
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import SGD
    m = dp_mlp(weights)
    opt = SGD(learning_rate=0.1, parameters=m.parameters())
    step = TrainStep(m, lambda out, y: ((out - y) ** 2).mean(), opt,
                     device="cpu", flat_master=flat_master,
                     in_shardings=PartitionSpec("dp", None) if dp else None)
    losses = [float(step(torch.from_numpy(X), torch.from_numpy(Y)))
              for _ in range(steps)]
    return losses, {n: p.detach().numpy().copy()
                    for n, p in m.named_parameters()}


def job_dp_train(weights, X, Y, steps=3, flat_master=False):
    return dp_train(weights, X, Y, steps, flat_master)


# ---------------------------------------------------------------------------
# jobs: tests/test_torch_tensor_parallel.py
# ---------------------------------------------------------------------------

def job_mp_layers(weights, x, dy, ids, emb, logits, labels):
    """The four mp layers on a {"dp": 2, "mp": 2} mesh, parallelized from
    the full ``weights``: column (gather_output=False) -> relu -> row
    (input_is_parallel), column with gather_output=True -> row with a full
    input, the vocab-parallel embedding and the parallel CE over the
    rank's vocab shard of ``logits``.  Returns outputs and the gathered
    gradients."""
    import torch

    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import mp_layers as M
    from paddle_tpu_torch.distributed.parallel_base import (shard_slice,
                                                            unshard_state)
    D.init_mesh({"dp": 2, "mp": 2})
    mesh = D.get_mesh()

    class Pair(torch.nn.Module):
        def __init__(self, gather):
            super().__init__()
            self.col = M.ColumnParallelLinear(16, 32, gather_output=gather)
            self.row = M.RowParallelLinear(32, 8,
                                           input_is_parallel=not gather)

        def forward(self, h):
            return self.row(torch.relu(self.col(h)))

    out = {}
    for gather in (False, True):
        m = Pair(gather)
        with torch.no_grad():
            for n, p in m.named_parameters():
                p.copy_(torch.from_numpy(np.array(weights[n])))
        D.parallelize(m)
        xt = torch.from_numpy(np.array(x)).requires_grad_(True)
        y = m(xt)
        (y * torch.from_numpy(np.array(dy))).sum().backward()
        tag = "gather" if gather else "parallel"
        out["y_" + tag] = y.detach().numpy().copy()
        out["dx_" + tag] = xt.grad.numpy().copy()
        grads = {n: p.grad for n, p in m.named_parameters()}
        for n, p in m.named_parameters():
            p.data = grads[n]
        out["grads_" + tag] = np_state(unshard_state(m))
    e = M.VocabParallelEmbedding(64, 16)
    with torch.no_grad():
        e.weight.copy_(torch.from_numpy(np.array(emb)))
    D.parallelize(e)
    y = e(torch.from_numpy(np.array(ids)))
    y.square().sum().backward()
    out["emb"] = y.detach().numpy().copy()
    e.weight.data = e.weight.grad
    out["emb_grad"] = np_state(unshard_state(e))["weight"]
    full = torch.from_numpy(np.array(logits))
    local = shard_slice(full, (None, "mp"), mesh.coord, mesh.shape)
    local = local.clone().requires_grad_(True)
    ce = M.ParallelCrossEntropy()
    D.parallelize(ce)
    loss = ce(local, torch.from_numpy(np.array(labels)))
    loss.sum().backward()
    out["ce"] = loss.detach().numpy().copy()
    out["ce_grad"] = local.grad.numpy().copy()
    return out


def tiny_gpt(weights, **cfg):
    """The port's tiny GPT with ``weights`` (the JAX names, numpy)."""
    from paddle_tpu_torch.convert import load_paddle_tpu_state
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    c = GPTConfig.tiny()
    for k, v in cfg.items():
        setattr(c, k, v)
    m = GPTForCausalLM(c)
    load_paddle_tpu_state(m, weights)
    return m


def gpt_train(weights, ids, steps, mesh_axes=None, clip=None,
              flat_master=False, **cfg):
    """``steps`` AdamW steps (lr 1e-3, eps 1e-6) of the tiny GPT
    (``cfg``: GPTConfig fields) on the global batch ``ids``; with
    ``mesh_axes`` the model is parallelized over them and the batch
    sharded on ``dp``.  Returns the losses, the gathered state after the
    steps and the rank's shards before them."""
    import torch

    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed.mesh import PartitionSpec
    from paddle_tpu_torch.distributed.parallel_base import unshard_state
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    m = tiny_gpt(weights, **cfg)
    shards = None
    if mesh_axes:
        D.init_mesh(mesh_axes)
        D.parallelize(m)
        shards = np_state(dict(m.named_parameters()))
    opt = AdamW(learning_rate=1e-3, parameters=m.parameters(), epsilon=1e-6,
                grad_clip=None if clip is None else ClipGradByGlobalNorm(clip))
    step = TrainStep(m, GPTPretrainingCriterion(), opt, device="cpu",
                     flat_master=flat_master,
                     in_shardings=(PartitionSpec("dp", None) if mesh_axes
                                   else None))
    x = torch.from_numpy(np.array(ids))
    losses = [float(step(x, x)) for _ in range(steps)]
    state = np_state(unshard_state(m)) if mesh_axes else np_state(
        m.state_dict())
    return losses, state, shards


def job_gpt_hybrid(weights, ids, steps=5, clip=None, flat_master=False):
    return gpt_train(weights, ids, steps, {"dp": 2, "mp": 2}, clip,
                     flat_master)


def job_gpt_unshard(weights):
    """parallelize then gather: the state the ranks give back, and the
    rank's local shards."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed.parallel_base import unshard_state
    m = tiny_gpt(weights)
    D.init_mesh({"dp": 2, "mp": 2})
    D.parallelize(m)
    return (np_state(unshard_state(m)), np_state(dict(m.named_parameters())),
            D.get_mesh().coord["mp"])


def job_clip(weights, ids, max_norm):
    """One backward of the tiny GPT at dp2 x mp2 on the global batch, then
    ``clip_grad_norm_``: the norm it returns and the clipped gradients,
    gathered (dp rank 0's rows only: the clip is per rank's grads)."""
    import torch

    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed.parallel_base import unshard_state
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.nn import clip_grad_norm_
    m = tiny_gpt(weights)
    D.init_mesh({"dp": 2, "mp": 2})
    D.parallelize(m)
    x = torch.from_numpy(np.array(ids))
    GPTPretrainingCriterion()(m(x), x).backward()
    total = float(clip_grad_norm_(m.parameters(), max_norm))
    for p in m.parameters():
        p.data = p.grad
    return total, np_state(unshard_state(m))


# ---------------------------------------------------------------------------
# jobs: tests/test_torch_tp_serving.py
# ---------------------------------------------------------------------------

def greedy_drive(eng, prompts, steps):
    """Prefill then greedy decode (the JAX test's ``_greedy_drive``):
    token sequences and per-step logits."""
    seqs, logits = [], []
    for i, p in enumerate(prompts):
        tok, lg = eng.prefill(i, np.array(p), temperature=0.0)
        seqs.append([int(tok)])
        logits.append([lg.float().numpy().copy()])
    n = len(prompts)
    for _ in range(steps):
        nt, lg = eng.decode([s[-1] for s in seqs], [True] * n, [0.0] * n,
                            [0] * n, [1.0] * n)
        for b in range(n):
            seqs[b].append(int(nt[b]))
            logits[b].append(lg[b].float().numpy().copy())
    return seqs, logits


def tp_engine(weights, tp, cfg=None, **kw):
    from paddle_tpu_torch.serving.engine import DecodeEngine
    m = tiny_gpt(weights, **(cfg or {}))
    m.eval()
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("page_size", 16)
    return m, DecodeEngine(m, tp=tp, device="cpu", **kw)


def job_tp_greedy(weights, prompts, steps=6, tp=2):
    _m, eng = tp_engine(weights, tp, seed=3)
    return greedy_drive(eng, prompts, steps)


def sched_drive(eng, prompts, max_new, overlap):
    from paddle_tpu_torch.serving.scheduler import (
        ContinuousBatchingScheduler, Request)
    sched = ContinuousBatchingScheduler(eng, overlap=overlap)
    rids = [sched.submit(Request(prompt=np.array(p), max_new_tokens=max_new,
                                 temperature=0.0)) for p in prompts]
    res = sched.run()
    return [res[r].tokens.tolist() for r in rids]


def job_tp_sched(weights, prompts, max_new, tp=2, overlap=True, **kw):
    _m, eng = tp_engine(weights, tp, seed=0, **kw)
    return sched_drive(eng, prompts, max_new, overlap)


def job_tp_accounting(weights, tp=2):
    from paddle_tpu_torch.observability import registry
    registry.default_registry().enable()
    _m, eng = tp_engine(weights, tp)
    eng.prefill(0, np.arange(5, dtype=np.int32), temperature=0.0)
    eng.prefill(1, np.arange(9, dtype=np.int32), temperature=0.0)
    for _ in range(3):
        eng.decode([1, 2], [True, True], [0.0, 0.0], [0, 0], [1.0, 1.0])
    return (eng.kv_row_bytes(), eng.kv_pool_bytes(),
            eng.kv_bytes_per_token(), tuple(eng.cache.k.shape),
            eng.graph_stats()["uncaptured"], eng.flight_state()["tp"],
            registry.gauge("serving.tp_degree").value)


def job_tp_errors(weights):
    """The JAX engine's validation errors, overlap_comm=True building at
    tp=2, and engine_for's key (tp, and overlap_comm as the engine
    resolves it), at a world of two."""
    import pytest

    from paddle_tpu_torch.distributed import mp_overlap as mpo
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.serving import engine_for
    from paddle_tpu_torch.serving.engine import DecodeEngine
    m = tiny_gpt(weights)
    got = {}
    for kw, exc, pat in ((dict(paged=False, tp=2), ValueError, "paged"),
                         (dict(tp=0), ValueError, "tp must be >= 1"),
                         (dict(tp=4), ValueError, "devices")):
        with pytest.raises(exc, match=pat):
            DecodeEngine(m, num_slots=2, max_len=64, device="cpu", **kw)
        got[str(kw)] = True
    got["overlap"] = DecodeEngine(m, num_slots=2, max_len=64, device="cpu",
                                  tp=2, overlap_comm=True).overlap_comm
    assert got["overlap"]
    odd = GPTForCausalLM(GPTConfig(vocab_size=512, max_position_embeddings=64,
                                   hidden_size=48, num_hidden_layers=1,
                                   num_attention_heads=3,
                                   intermediate_size=96))
    with pytest.raises(ValueError, match="divide"):
        DecodeEngine(odd, num_slots=2, max_len=64, device="cpu", tp=2)
    kw = dict(num_slots=2, max_len=32, page_size=16, device="cpu")
    e1 = engine_for(m, **kw)
    assert engine_for(m, tp=1, **kw) is e1
    e2 = engine_for(m, tp=2, **kw)
    assert e2 is not e1 and e2.tp == 2
    assert engine_for(m, **kw) is e1 and engine_for(m, tp=2, **kw) is e2
    # the overlap switch as the engine resolves it: the environment and
    # an explicit overlap_comm=True share one engine at tp=2
    e3 = engine_for(m, tp=2, overlap_comm=True, **kw)
    assert e3 is not e2 and e3.overlap_comm
    with mpo.overlap_scope(True):
        assert engine_for(m, tp=2, **kw) is e3
    assert engine_for(m, tp=2, overlap_comm=False, **kw) is e2
    return got


def job_tp_refresh(weights, prompt, delta):
    """A tp=2 engine, then a change of the full model's ``wte``:
    refresh_state re-slices it into the engine's copy and drops the
    prefix cache; returns the logits before and after and a fresh
    engine's on the changed weights."""
    import torch
    m, eng = tp_engine(weights, 2, num_slots=1, page_size=8)
    _t, before = eng.prefill(0, np.array(prompt), temperature=0.0)
    eng.free_slot(0)
    unchanged = eng.refresh_state()
    with torch.no_grad():
        m.gpt.wte.weight.add_(torch.from_numpy(np.array(delta)))
    changed = eng.refresh_state()
    task = eng.prefill_begin(0, np.array(prompt), temperature=0.0)
    shared = task.shared_tokens
    while not eng.prefill_step(task):
        pass
    after = task.last_logits.float().numpy().copy()
    from paddle_tpu_torch.serving.engine import DecodeEngine
    fresh = DecodeEngine(m, num_slots=1, max_len=64, page_size=8, tp=2,
                         device="cpu")
    _t, ref = fresh.prefill(0, np.array(prompt), temperature=0.0)
    return (before.float().numpy().copy(), unchanged, changed, shared,
            after, ref.float().numpy().copy())


# ---------------------------------------------------------------------------
# jobs: tests/test_torch_chip_smoke_parity.py
# ---------------------------------------------------------------------------

def job_chip_dist():
    """chip_smoke.py's dist_nccl (over gloo on the CPU: every collective
    at this world's size) and train_dp (a one-rank dp axis of a
    {"dp": 1, "sdp": 2} mesh, so its losses must equal the default step's
    bit for bit, ``hold_train_variant``, whose refusal of a moved loss
    the layout rehearsal checks; its ZeRO stage-2 run slices over the two
    sdp ranks, which hold the same batch) on a narrow 2-layer model at the
    train shape, the flash route through its plain versions."""
    import pytest
    import torch

    import chip_smoke
    from paddle_tpu_torch import amp
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    mp = pytest.MonkeyPatch()
    try:
        dist_line = chip_smoke.dist_nccl(torch, backend="gloo", device="cpu")
        mp.setattr(torch.cuda, "synchronize", lambda *a: None)
        mp.setattr(chip_smoke, "profile_steps",
                   lambda *a, **k: {"step_device_ms": 1.0})
        counters = PlainCounters(mp)
        cfg = GPTConfig(vocab_size=512, max_position_embeddings=1024,
                        hidden_size=128, num_hidden_layers=2,
                        num_attention_heads=2, intermediate_size=256,
                        hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
        base = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(0))
        ids = chip_smoke.train_ids(torch, cfg.vocab_size, "cpu")
        default, _l, _ms = chip_smoke.run_steps(
            torch, chip_smoke.make_step(
                chip_smoke.train_model(torch, base, amp, "cpu"),
                device="cpu"), ids, counters, 3)
        D.init_mesh({"dp": 1, "sdp": 2})
        train_line = {"profile": {"step_device_ms": 1.0}}
        line = chip_smoke.train_dp(torch, base, amp, counters, default,
                                   train_line, device="cpu")
    finally:
        mp.undo()
    return dist_line, line, default


def tp2_spec(default_losses=None):
    """tp2_gloo's spec at a narrow width (2 layers, 2 heads of 64, f32)
    for the CPU rehearsal."""
    import chip_smoke
    from paddle_tpu_torch.models.gpt import GPTConfig
    cfg = GPTConfig(vocab_size=512, max_position_embeddings=1024,
                    hidden_size=128, num_hidden_layers=2,
                    num_attention_heads=2, intermediate_size=256,
                    hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    rng = np.random.default_rng(17)
    return {"cfg": cfg, "seed": 0, "amp": False, "steps": 3,
            "new_tokens": chip_smoke.TP2_NEW_TOKENS,
            "default_losses": default_losses,
            "prompts": [rng.integers(0, 512, 64).tolist()
                        for _ in range(chip_smoke.TP2_PROMPTS)]}


def short_ids(torch, vocab, device="cuda"):
    """chip_smoke.train_ids at 128 tokens a row (the CPU rehearsals'
    batch: (8, 128))."""
    return torch.as_tensor(np.random.default_rng(0).integers(
        0, vocab, (8, 128)), device=device)


def job_zero_rank():
    """chip_smoke.py's zero_rank on this world (gloo, CPU tensors) at
    tp2_spec's narrow width on :func:`short_ids`, two steps a stage, the
    flash route through its plain versions, counted."""
    import pytest
    import torch

    import chip_smoke
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(torch.cuda, "synchronize", lambda *a: None)
        mp.setattr(chip_smoke, "train_ids", short_ids)
        spec = dict(tp2_spec(), steps=2)
        return chip_smoke.zero_rank(torch, spec, PlainCounters(mp),
                                    device="cpu")
    finally:
        mp.undo()


def job_tp2_rank(default_losses):
    """chip_smoke.py's tp2_rank on this world (gloo, CPU tensors), the
    flash route through its plain versions, counted."""
    import pytest
    import torch

    import chip_smoke
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(torch.cuda, "synchronize", lambda *a: None)
        return chip_smoke.tp2_rank(torch, tp2_spec(default_losses),
                                   PlainCounters(mp), device="cpu")
    finally:
        mp.undo()


# ---------------------------------------------------------------------------
# jobs: tests/test_torch_mp_overlap.py (a world of four)
# ---------------------------------------------------------------------------

def _mp_of(n):
    """The ``mp`` group of ``n`` ranks on a world of four: the mesh
    {"mp": 4}, or {"dp": 2, "mp": 2}."""
    from paddle_tpu_torch import distributed as D
    D.init_mesh({"mp": 4} if n == 4 else {"dp": 2, "mp": 2})
    return D.get_mesh().group("mp")


def _piece(a, dim, g, n):
    """Group rank ``g``'s contiguous piece of ``a`` along ``dim``."""
    import torch
    t = torch.from_numpy(np.array(a))
    size = t.shape[dim] // n
    return t.narrow(dim, g * size, size).contiguous()


def _cot(fn, *args):
    """The gradients of sum(sin(fn(*args))) (the JAX test's cotangent)."""
    import torch
    ts = [a.clone().requires_grad_(True) for a in args]
    torch.sin(fn(*ts)).sum().backward()
    return [t.grad.numpy().copy() for t in ts]


def job_mpo_islands(fwd, grad, qkv):
    """Every island at n = 2 and 4 over the rank's shards, at chunks 1 and
    2: the outputs (``fwd``: row x, w, b; column xc, wc; LM head and
    embedding wte, ids), the gradients of sum(sin(.)) (``grad``: x, w,
    wte), the qkv re-deal with and without bias and its dense reference
    (``qkv``: x, w, b, heads, head_dim), the ppermutes a call issued and
    the ``mp.overlap_chunks`` increments."""
    import torch

    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import mp_overlap as mpo
    from paddle_tpu_torch.observability import registry
    registry.default_registry().enable()
    counter = registry.counter("mp.overlap_chunks")
    out = {}
    for n in (2, 4):
        group = _mp_of(n)
        g = group.rank
        for chunks in (1, 2):
            with mpo.overlap_scope(True, chunks):
                C.reset_counts()
                before = counter.value
                row = mpo.row_parallel_matmul(
                    _piece(fwd["x"], 2, g, n), _piece(fwd["w"], 0, g, n),
                    torch.from_numpy(np.array(fwd["b"])))
                res = {"row": row.numpy().copy(),
                       "row_ppermutes": C.issued().get("ppermute", 0),
                       "row_counted": counter.value - before}
                res["col"] = mpo.column_parallel_matmul(
                    torch.from_numpy(np.array(fwd["xc"])),
                    _piece(fwd["wc"], 1, g, n)).numpy().copy()
                res["lm"] = mpo.lm_head_matmul(
                    torch.from_numpy(np.array(fwd["xc"])),
                    _piece(fwd["wte"], 0, g, n)).numpy().copy()
                res["emb"] = mpo.vocab_embed(
                    torch.from_numpy(np.array(fwd["ids"])),
                    _piece(fwd["wte"], 0, g, n)).numpy().copy()
                x = torch.from_numpy(np.array(grad["x"]))
                res["row_grads"] = _cot(
                    lambda a, b: mpo.row_parallel_matmul(a, b),
                    _piece(grad["x"], 1, g, n), _piece(grad["w"], 0, g, n))
                res["col_grads"] = _cot(
                    lambda a, b: mpo.column_parallel_matmul(a, b), x,
                    _piece(grad["w"], 1, g, n))
                res["lm_grads"] = _cot(
                    lambda a, b: mpo.lm_head_matmul(a, b), x,
                    _piece(grad["wte"], 0, g, n))
            out[(n, chunks)] = res
        with mpo.overlap_scope(True):
            xq = torch.from_numpy(np.array(qkv["x"]))
            wq, bq = qkv["w"], qkv["b"]
            nh, hd = qkv["heads"], qkv["head_dim"]
            before = counter.value
            got = mpo.qkv_heads(xq, _piece(wq, 1, g, n), _piece(bq, 0, g, n),
                                nh, hd)
            got0 = mpo.qkv_heads(xq, _piece(wq, 1, g, n), None, nh, hd)
            counted = counter.value - before
            # the dense reference: every rank's contiguous projection as
            # the ranks compute it, then slice-then-reshape to this rank's
            # heads
            dense = torch.cat([xq @ _piece(wq, 1, s, n) for s in range(n)],
                              dim=-1)
            want = []
            for full in (dense + torch.from_numpy(np.array(bq)), dense):
                h = nh * hd
                parts = [full[..., i * h:(i + 1) * h].reshape(
                    tuple(full.shape[:-1]) + (nh, hd)) for i in range(3)]
                want.append([t[:, :, g * nh // n:(g + 1) * nh // n]
                             for t in parts])
            out[("qkv", n)] = {
                "exact": all(torch.equal(a, b) for a, b in zip(got, want[0]))
                and all(torch.equal(a, b) for a, b in zip(got0, want[1])),
                "shapes": [tuple(t.shape) for t in got], "counted": counted}
    return out


def job_mpo_switch(x, w):
    """The switch at a world of four over the {"dp": 2, "mp": 2} mesh's
    mp group: off (no scope, no env) and the per-call argument over an
    enabling scope give None; a contraction that the group does not
    divide into output blocks, None."""
    import torch

    from paddle_tpu_torch.distributed import mp_overlap as mpo
    _mp_of(2)
    xt = torch.from_numpy(np.array(x))
    wt = torch.from_numpy(np.array(w))
    got = {"off": mpo.row_parallel_matmul(xt, wt) is None}
    with mpo.overlap_scope(True):
        got["arg_false"] = mpo.row_parallel_matmul(xt, wt, arg=False) is None
        got["on"] = mpo.row_parallel_matmul(xt, wt) is not None
        got["odd_n"] = mpo.row_parallel_matmul(
            xt, torch.ones(wt.shape[0], 3)) is None
        got["active_n"] = mpo.active()[1]
    return got


def job_mpo_gpt(weights, scan_weights, ids, prompts, steps=3):
    """The tiny GPT at dp2 x mp2, per layer and scan-layers: ``steps``
    train steps with the overlap off and on (losses, and on: the
    ppermutes and ``mp.overlap_chunks`` a step), and the tp=2 engine's
    greedy drive off and on (tokens, logits; on: the counter)."""
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import mp_overlap as mpo
    from paddle_tpu_torch.observability import registry
    registry.default_registry().enable()
    counter = registry.counter("mp.overlap_chunks")
    out = {}
    for scan, w in ((False, weights), (True, scan_weights)):
        for on in (False, True):
            C.reset_counts()
            before = counter.value
            with mpo.overlap_scope(on):
                losses, _state, _shards = gpt_train(
                    w, ids, steps, {"dp": 2, "mp": 2}, scan_layers=scan)
            out[("train", scan, on)] = {
                "losses": losses,
                "ppermute": C.issued().get("ppermute", 0) / steps,
                "chunks": (counter.value - before) / steps}
            before = counter.value
            _m, eng = tp_engine(w, 2, cfg={"scan_layers": scan}, seed=3,
                                overlap_comm=on)
            seqs, logits = greedy_drive(eng, prompts, 6)
            out[("serve", scan, on)] = {
                "seqs": seqs, "logits": logits,
                "overlap_comm": eng.overlap_comm,
                "chunks": counter.value - before}
    return out


# ---------------------------------------------------------------------------
# jobs: tests/test_torch_zero.py (a world of two)
# ---------------------------------------------------------------------------

def zero_mlp(weights):
    """The JAX test's 64-128-64 MLP (Linear, GELU, Linear) with
    ``weights`` by the JAX names ("0.weight", ...)."""
    import torch

    from paddle_tpu_torch.nn.layer.common import Linear
    m = torch.nn.Sequential(Linear(64, 128), torch.nn.GELU(),
                            Linear(128, 64))
    with torch.no_grad():
        for n, p in m.named_parameters():
            p.copy_(torch.from_numpy(np.array(weights[n])))
    return m


def zero_train(weights, x, y, stage, steps=3, mesh_axes=None, in_sdp=False,
               clip=None):
    """``steps`` AdamW (lr 0.01) steps of :func:`zero_mlp` with the mse
    loss at ``zero_stage=stage`` (None: no ZeRO) on ``mesh_axes``; with
    ``in_sdp`` the batch is sharded over ``sdp``.  Returns the losses,
    the step's state_dict (numpy), each rank's slot shapes and the
    collectives issued a step."""
    import torch

    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed.mesh import PartitionSpec
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    if mesh_axes:
        D.init_mesh(mesh_axes)
    m = zero_mlp(weights)
    opt = AdamW(learning_rate=0.01, parameters=m.parameters(),
                grad_clip=None if clip is None else ClipGradByGlobalNorm(clip))
    step = TrainStep(m, lambda o, t: torch.nn.functional.mse_loss(o, t), opt,
                     device="cpu", zero_stage=stage,
                     in_shardings=PartitionSpec("sdp") if in_sdp else None)
    xt, yt = torch.from_numpy(np.array(x)), torch.from_numpy(np.array(y))
    C.reset_counts()
    losses = [float(step(xt, yt)) for _ in range(steps)]
    issued = {k: v / steps for k, v in C.issued().items()}
    sd = step.state_dict()
    state = {"params": np_state(sd["params"]),
             "slots": {n: np_state(s) for n, s in sd["opt_state"]["slots"]
                       .items()}}
    shapes = {n: {k: tuple(v.shape) for k, v in s.items()}
              for n, s in step.opt_state["slots"].items()}
    masters = {n: tuple(v.shape) for n, v in step.params.items()}
    step.sync_to_model()
    model = np_state(m.state_dict())
    return {"losses": losses, "state": state, "slot_shapes": shapes,
            "master_shapes": masters, "issued": issued, "model": model}


def job_zero(weights, x, y, steps=3):
    """Stages 1, 2 and 3 on the {"sdp": 2} mesh against the unsharded
    step (batch replicated, as the JAX parity test), stage 1 and 2 with
    the batch sharded over sdp (the reduce-scatter's case), stage 2 with a
    global-norm clip, and a checkpoint round trip: stage 3's state_dict
    into a fresh stage-1 step."""
    import torch

    from paddle_tpu_torch.distributed import sharding
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    axes = {"sdp": 2}
    out = {"plain": zero_train(weights, x, y, None, steps)}
    for stage in (1, 2, 3):
        out[stage] = zero_train(weights, x, y, stage, steps, axes)
    for stage in (1, 2):
        out[("sdp", stage)] = zero_train(weights, x, y, stage, steps, axes,
                                         in_sdp=True)
    out[("clip", 2)] = zero_train(weights, x, y, 2, steps, axes, clip=0.5)
    out["plain_clip"] = zero_train(weights, x, y, None, steps, clip=0.5)
    # a stage-3 checkpoint into a stage-1 step, then one more step each
    m3, m1 = zero_mlp(weights), zero_mlp(weights)

    def mse(o, t):
        return torch.nn.functional.mse_loss(o, t)
    s3 = TrainStep(m3, mse, AdamW(learning_rate=0.01,
                                  parameters=m3.parameters()),
                   device="cpu", zero_stage=3)
    xt, yt = torch.from_numpy(np.array(x)), torch.from_numpy(np.array(y))
    s3(xt, yt)
    s1 = TrainStep(m1, mse, AdamW(learning_rate=0.01,
                                  parameters=m1.parameters()),
                   device="cpu", zero_stage=1)
    s1.set_state_dict(s3.state_dict())
    out["resume"] = (float(s3(xt, yt)), float(s1(xt, yt)))
    levels = {}
    for level in ("os", "os_g", "p_g_os"):
        m = zero_mlp(weights)
        opt = AdamW(learning_rate=0.01, parameters=m.parameters())
        got = sharding.group_sharded_parallel(m, opt, level=level)
        levels[level] = (got[0] is m, got[1] is opt, m._sharding_level,
                         {n: tuple(getattr(p, "zero_spec", ()) or ())
                          for n, p in m.named_parameters()})
    out["levels"] = levels
    # the placement helpers: slots cut by their picked dim, a stage-3
    # wrapper recording the specs and passing the forward through
    cut = sharding.shard_optimizer_state(
        {"slots": {"w": {"m": torch.ones(128, 64), "v": torch.ones(64, 128)},
                   "b": {"m": torch.ones(64)}}, "step": 3})
    out["opt_cut"] = ({n: {k: tuple(v.shape) for k, v in s.items()}
                       for n, s in cut["slots"].items()}, cut["step"])
    m = zero_mlp(weights)
    cfg = type("C", (), {"sharding_configs": type("S", (), {"stage": 3})})
    wrapped = sharding.ShardingParallel(m, strategy=cfg)
    xt = torch.from_numpy(np.array(x))
    out["wrapper"] = (tuple(m[0].weight.zero_spec),
                      bool(torch.equal(wrapped(xt), m(xt))))
    specs = {}
    for shape in ((128, 64), (64, 128), (64,), (4096,), (3, 4096), (96, 96)):
        specs[shape] = tuple(sharding._stage_spec_for(torch.zeros(shape),
                                                      "sdp"))
    out["specs"] = specs
    return out


def job_zero_errors():
    """The JAX step's refusals at a world of two: ``zero_stage`` on a mesh
    whose ``sdp`` axis has one rank, and ``flat_master=True`` with ZeRO
    (checked first, as in JAX)."""
    import pytest
    import torch

    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    got = []
    for axes, kw, pat in (({"dp": 2}, {}, "sdp"),
                          ({"dp": 2}, {"flat_master": True}, "flat_master"),
                          ({"sdp": 2}, {"flat_master": True},
                           "flat_master")):
        D.init_mesh(axes)
        m = torch.nn.Linear(64, 64)
        with pytest.raises(ValueError, match=pat):
            TrainStep(m, lambda o: o.sum(), AdamW(parameters=m.parameters()),
                      device="cpu", zero_stage=2, **kw)
        got.append(pat)
    return got
