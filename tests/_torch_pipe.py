"""The port's side of the pipeline and fleet tests (not a test module; it
imports no JAX, so that the ranks of a ``_torch_dist.World`` can run its
jobs as ``"_torch_pipe:job_..."``): the tiny tied-embedding model of
tests/test_pipeline_fleet.py in the port's layers, and the jobs."""
from __future__ import annotations

import numpy as np

V, H, S = 64, 32, 8


def _nn():
    import torch

    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F

    class EmbedPipe(torch.nn.Module):
        """Token + position embedding (the first pipeline stage)."""

        def __init__(self):
            super().__init__()
            self.word = nn.Embedding(V, H)
            self.pos = nn.Embedding(S, H)

        @property
        def weight(self):
            return self.word.weight

        @weight.setter
        def weight(self, value):
            self.word.weight = value

        def forward(self, ids):
            p = torch.arange(0, ids.shape[1], dtype=torch.int32,
                             device=ids.device)
            return self.word(ids) + self.pos(p[None])

    class Block(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(H, H)

        def forward(self, x):
            return x + torch.tanh(self.fc(x))

    class Criterion(torch.nn.Module):
        def forward(self, logits, labels):
            return F.cross_entropy(logits.reshape(-1, V).float(),
                                   labels.reshape(-1).long())

    return EmbedPipe, Block, Criterion


def tied_logits(layer, x):
    """The tied LM head: logits = x @ wte^T."""
    return x @ layer.word.weight.t()


def descs(blocks=8):
    from paddle_tpu_torch.distributed.pipeline import (LayerDesc,
                                                       SharedLayerDesc)
    EmbedPipe, Block, _ = _nn()
    return [SharedLayerDesc("embed", EmbedPipe, shared_weight_attr="weight"),
            *[LayerDesc(Block) for _ in range(blocks)],
            SharedLayerDesc("embed", EmbedPipe, forward_func=tied_logits,
                            shared_weight_attr="weight")]


def pipeline_layer(weights, num_stages, blocks=8, dtype=None):
    """The port's PipelineLayer of :func:`descs` with ``weights`` (the
    JAX PipelineLayer's state, numpy, by JAX's names)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.convert import load_paddle_tpu_state
    from paddle_tpu_torch.distributed.pipeline import PipelineLayer
    _, _, Criterion = _nn()
    pl = PipelineLayer(descs(blocks), num_stages=num_stages,
                       loss_fn=Criterion())
    load_paddle_tpu_state(pl, weights)
    if dtype is not None:
        amp.decorate(pl, level="O2", dtype=dtype)
    return pl


def np_params(module):
    return {k: v.detach().float().numpy().copy()
            for k, v in module.named_parameters()}


def sequential_train(weights, data, num_stages, acc=4, lr=0.1):
    """The sequential eager reference of tests/test_pipeline_fleet.py in
    the port: the same layers, SGD, ``acc`` microbatches a step.
    Returns the losses and the trained parameters."""
    import torch

    from paddle_tpu_torch.optimizer import SGD
    ref = pipeline_layer(weights, num_stages)
    opt = SGD(learning_rate=lr, parameters=ref.parameters())
    losses = []
    for x, y in data:
        x, y = torch.from_numpy(np.array(x)), torch.from_numpy(np.array(y))
        mb = x.shape[0] // acc
        total = 0.0
        for i in range(acc):
            h = x[i * mb:(i + 1) * mb]
            for layer in ref.run_function:
                h = layer(h)
            loss = ref.loss_fn(h, y[i * mb:(i + 1) * mb])
            (loss / acc).backward()
            total += float(loss.detach())
        opt.step()
        opt.clear_grad()
        losses.append(total / acc)
    return losses, np_params(ref)


# ---------------------------------------------------------------------------
# jobs: tests/test_torch_pipeline.py
# ---------------------------------------------------------------------------

def _mlp_stage(params, x):
    import torch
    h = torch.tanh(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + x


def _mse(out, label):
    return ((out - label) ** 2).mean()


def job_spmd(params, x, labels, pp):
    """The forward pipeline and the homogeneous 1F1B on the MLP stages
    of tests/test_pipeline_1f1b.py over a ``pp`` axis of ``pp`` ranks
    (``dp`` the rest of the world: each dp slice runs the same
    pipeline).  Returns (stage, outputs, loss, this stage's grads, the
    permutes issued by the 1F1B step)."""
    import torch

    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed.pipeline import (spmd_pipeline,
                                                       spmd_pipeline_1f1b)
    world = D.get_world_size()
    D.init_mesh({"dp": world // pp, "pp": pp})
    s = D.get_mesh().axis_rank("pp")
    mine = {k: torch.from_numpy(np.array(v[s:s + 1])) for k, v in
            params.items()}
    xt = torch.from_numpy(np.array(x))
    lt = torch.from_numpy(np.array(labels))
    m = xt.shape[0]
    outs = spmd_pipeline(_mlp_stage, mine, xt, pp, m)
    C.reset_counts()
    loss, grads = spmd_pipeline_1f1b(_mlp_stage, _mse, mine, xt, lt, pp, m)
    permutes = C.issued().get("ppermute", 0)
    return (s, outs.numpy(), float(loss),
            {k: v.numpy() for k, v in grads.items()}, permutes)


def job_hetero(params, x, labels, pp, loss_scale=None):
    """spmd_pipeline_1f1b_hetero on tests/test_pipeline_fleet.py's
    embed / block / head functions at pp x dp2 (``batch_axes=("dp",)``,
    the microbatch rows sharded over dp), whole embed-grad accumulator
    asked for as the JAX row-sharded one."""
    import torch

    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed.parallel_base import local_rows
    from paddle_tpu_torch.distributed.pipeline import (
        spmd_pipeline_1f1b_hetero)
    D.init_mesh({"dp": 2, "pp": pp})
    mesh = D.get_mesh()
    s = mesh.axis_rank("pp")
    t = {k: {kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()}
         for k, v in params.items()}
    t["blocks"] = {k: v[s:s + 1] for k, v in t["blocks"].items()}
    xt = torch.from_numpy(np.array(x))
    lt = torch.from_numpy(np.array(labels))
    # this rank's rows of every microbatch (dim 1)
    xt = local_rows(xt.transpose(0, 1)).transpose(0, 1)
    lt = local_rows(lt.transpose(0, 1)).transpose(0, 1)

    def embed_fn(ep, xb):
        return xb @ ep["we"]

    def block_fn(bp, h):
        return torch.tanh(h @ bp["w"]) + h

    def head_loss_fn(hp, ep, h, lbl):
        return ((h @ hp["wh"] - lbl) ** 2).mean()

    loss, grads = spmd_pipeline_1f1b_hetero(
        embed_fn, block_fn, head_loss_fn, t, xt, lt, pp, 1, xt.shape[0],
        batch_axes=("dp",), loss_scale=loss_scale,
        embed_grad_shard=("dp", 2))
    return (s, float(loss),
            {k: {kk: vv.numpy() for kk, vv in v.items()}
             for k, v in grads.items()})


def job_fleet(weights, data, pp, dp, acc=4, lr=0.1):
    """tests/test_pipeline_fleet.py's tied-embedding run through the
    port's fleet: ``fleet.init`` at (pp, dp), ``distributed_model``,
    SGD, ``train_batch`` over ``data``.  Returns the losses, every
    rank's ``state_dict()`` and parameters after the steps (the other
    stages' blocks gathered), the step's permutes, its peak in-flight
    microbatches, and the stage."""
    import torch

    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.pipeline import PipelineParallel
    from paddle_tpu_torch.optimizer import SGD
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"pp_degree": pp, "dp_degree": dp}
    strategy.pipeline_configs = {"accumulate_steps": acc}
    fleet.init(is_collective=True, strategy=strategy)
    pl = pipeline_layer(weights, pp)
    model = fleet.distributed_model(pl)
    assert isinstance(model, PipelineParallel)
    opt = SGD(learning_rate=lr, parameters=model.parameters())
    losses = []
    for x, y in data:
        loss = model.train_batch((torch.from_numpy(np.array(x)),
                                  torch.from_numpy(np.array(y))), opt)
        losses.append(float(loss))
    comp = model._compiled
    state = {k: v.float().numpy().copy()
             for k, v in model.state_dict().items()}
    return {"losses": losses, "state": state, "params": np_params(pl),
            "stage": comp._stage, "permutes": comp.last_permutes,
            "peak": comp.last_peak_inflight}


def job_ppermute_partial():
    """``collective.ppermute`` under partial permutations (the 1F1B
    handoffs: a stage that sends or receives nothing) on a ``pp`` axis of
    the whole world: each rank's result for [(0, 1)], the forward and
    the backward chains."""
    import torch

    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import collective as C
    n = D.get_world_size()
    D.init_mesh({"pp": n})
    r = D.get_rank()
    x = torch.full((2, 3), float(r + 1))
    out = {}
    for name, perm in (("first_pair", [(0, 1)]),
                       ("forward", [(i, i + 1) for i in range(n - 1)]),
                       ("backward", [(i + 1, i) for i in range(n - 1)])):
        out[name] = C.ppermute(x, perm, group="pp").numpy().copy()
        out[name + "_async"] = C.ppermute(x, perm, group="pp",
                                          async_op=True).wait().numpy()
    return out


def job_rebuild(weights, data):
    """pp2: ``state_dict()`` current after a step without a manual sync,
    and a changed ``accumulate_steps`` rebuilding the step from the
    trained weights with the same optimizer's state carried over."""
    import torch

    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed.pipeline import PipelineParallel
    from paddle_tpu_torch.optimizer import Adam
    D.init_mesh({"dp": D.get_world_size() // 2, "pp": 2})
    model = PipelineParallel(pipeline_layer(weights, 2))
    model.accumulate_steps = 4
    opt = Adam(parameters=model.parameters(), learning_rate=0.05)
    data = [(torch.from_numpy(np.array(x)), torch.from_numpy(np.array(y)))
            for x, y in data]
    sd0 = {k: v.float().numpy().copy() for k, v in model.state_dict().items()}
    model.train_batch(data[0], opt)
    sd1 = {k: v.float().numpy().copy() for k, v in model.state_dict().items()}
    first = model._compiled
    step_count = first.opt_state["step"]
    model.accumulate_steps = 2
    loss = float(model.train_batch(data[1], opt))
    return {"changed": sorted(k for k in sd0
                              if not np.array_equal(sd0[k], sd1[k])),
            "keys": sorted(sd0), "rebuilt": model._compiled is not first,
            "steps": [step_count, model._compiled.opt_state["step"]],
            "loss": loss}


def job_fleet_amp(weights, data, dtype, pp=2):
    """AMP O2 at pp x dp2, AdamW (lr 5e-3): with ``float16`` a GradScaler
    at 2^40 first (its first step overflows: skipped on every rank, the
    parameters untouched), then at 2^10.  Returns the losses, the step's
    f32 master dtypes, whether the first (overflowing) step left every
    parameter as it was, and the scales."""
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed.pipeline import PipelineParallel
    from paddle_tpu_torch.optimizer import AdamW
    D.init_mesh({"dp": D.get_world_size() // pp, "pp": pp})
    pl = pipeline_layer(weights, pp, dtype=dtype)
    model = PipelineParallel(pl)
    model.accumulate_steps = 4
    opt = AdamW(parameters=model.parameters(), learning_rate=5e-3)
    data = [(torch.from_numpy(np.array(x)), torch.from_numpy(np.array(y)))
            for x, y in data]
    out = {"skipped_first": None, "scales": []}
    scaler = None
    if dtype == "float16":
        scaler = amp.GradScaler(init_loss_scaling=2.0 ** 40,
                                decr_every_n_nan_or_inf=1,
                                incr_every_n_steps=10000)
        before = {k: v.detach().clone() for k, v in pl.named_parameters()}
        model.train_batch(data[0], opt, scaler=scaler)
        out["skipped_first"] = scaler.last_step_skipped and all(
            torch.equal(before[k], v) for k, v in pl.named_parameters())
        out["scales"].append(scaler.get_loss_scaling())
        scaler.set_init_loss_scaling(2.0 ** 10)
    out["losses"] = [float(model.train_batch(d, opt, scaler=scaler))
                     for d in data]
    if scaler is not None:
        out["scales"].append(scaler.get_loss_scaling())
    slots = model._compiled.opt_state["slots"]
    out["masters"] = sorted({str(s["master"].dtype) for k, s in slots.items()
                             if k.startswith("blocks/") and "master" in s})
    out["param_dtypes"] = sorted({str(p.dtype) for p in pl.parameters()})
    return out


def gpt_pipeline(seed, pp, layers=4):
    """chip_smoke.py's GPT pipeline descs at the tiny width."""
    import torch

    import chip_smoke
    from paddle_tpu_torch.distributed.pipeline import PipelineLayer
    from paddle_tpu_torch.models.gpt import (GPTConfig,
                                             GPTPretrainingCriterion)
    cfg = GPTConfig.tiny()
    cfg.num_hidden_layers = layers
    torch.manual_seed(seed)
    return PipelineLayer(chip_smoke.gpt_pipeline_descs(cfg), num_stages=pp,
                         loss_fn=GPTPretrainingCriterion())


def job_pp_mp(ids, steps=3, seed=5):
    """pp2 x mp2: the GPT pipeline with its blocks in the Megatron layout
    (``parallelize`` over mp), AdamW through ``train_batch``.  Returns
    the losses and the full trained state (mp shards gathered)."""
    import torch

    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed.parallel_base import unshard_state
    from paddle_tpu_torch.distributed.pipeline import PipelineParallel
    from paddle_tpu_torch.models.gpt import megatron_layout
    from paddle_tpu_torch.optimizer import AdamW
    D.init_mesh({"pp": 2, "mp": 2})
    pl = gpt_pipeline(seed, 2)
    for name, p in pl.named_parameters():
        spec, parts = megatron_layout(name)
        if spec is not None:
            p.pspec, p.mp_parts = spec, parts
    D.parallelize(pl)
    model = PipelineParallel(pl)
    model.accumulate_steps = 2
    opt = AdamW(parameters=model.parameters(), learning_rate=1e-3,
                epsilon=1e-6)
    x = torch.from_numpy(np.array(ids))
    losses = [float(model.train_batch((x, x), opt)) for _ in range(steps)]
    model.sync_to_layers()
    return losses, {k: v.numpy().copy()
                    for k, v in unshard_state(pl).items()}


def gpt_sequential(ids, steps=3, seed=5, acc=2):
    """:func:`job_pp_mp`'s run on one rank: the same layers in order, the
    same microbatching, AdamW."""
    import torch

    from paddle_tpu_torch.optimizer import AdamW
    pl = gpt_pipeline(seed, 2)
    opt = AdamW(parameters=pl.parameters(), learning_rate=1e-3,
                epsilon=1e-6)
    x = torch.from_numpy(np.array(ids))
    mb = x.shape[0] // acc
    losses = []
    for _ in range(steps):
        total = 0.0
        for i in range(acc):
            xi = x[i * mb:(i + 1) * mb]
            loss = pl.loss_fn(pl(xi), xi)
            (loss / acc).backward()
            total += float(loss.detach())
        opt.step()
        opt.clear_grad()
        losses.append(total / acc)
    return losses, {k: v.detach().numpy().copy()
                    for k, v in pl.state_dict().items()}


def job_contract_errors(weights):
    """The compiled pipeline's contract errors at pp2 (messages of the
    JAX package's), and ZeRO x pipeline refused naming ROADMAP §A5."""
    import torch

    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed.pipeline import (PipelineLayer,
                                                       PipelineParallel)
    from paddle_tpu_torch.optimizer import SGD
    EmbedPipe, Block, Criterion = _nn()
    D.init_mesh({"dp": D.get_world_size() // 2, "pp": 2})
    out = {}

    def attempt(key, model, x, opt):
        try:
            model.train_batch((x, x), opt)
            out[key] = None
        except (ValueError, NotImplementedError) as e:
            out[key] = "%s: %s" % (type(e).__name__, e)

    x8 = torch.zeros((8, S), dtype=torch.int64)
    pl = pipeline_layer(weights, 2)
    model = PipelineParallel(pl)
    model.accumulate_steps = 3
    opt = SGD(learning_rate=0.1, parameters=model.parameters())
    attempt("indivisible_batch", model, x8, opt)
    model.accumulate_steps = 4
    attempt("indivisible_dp", model, torch.zeros((4, S), dtype=torch.int64),
            opt)
    from paddle_tpu_torch.distributed.pipeline import (LayerDesc,
                                                       SharedLayerDesc)
    ragged = PipelineLayer(
        [SharedLayerDesc("embed", EmbedPipe),
         *[LayerDesc(Block) for _ in range(3)],
         SharedLayerDesc("embed", EmbedPipe, forward_func=tied_logits)],
        num_stages=2, loss_fn=Criterion())
    model = PipelineParallel(ragged)
    model.accumulate_steps = 4
    attempt("ragged_blocks", model, x8,
            SGD(learning_rate=0.1, parameters=model.parameters()))

    class Other(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(H))

        def forward(self, x):
            return x + self.w
    mixed = PipelineLayer(
        [SharedLayerDesc("embed", EmbedPipe), LayerDesc(Block),
         LayerDesc(Other),
         SharedLayerDesc("embed", EmbedPipe, forward_func=tied_logits)],
        num_stages=2, loss_fn=Criterion())
    model = PipelineParallel(mixed)
    model.accumulate_steps = 4
    attempt("heterogeneous_blocks", model, x8,
            SGD(learning_rate=0.1, parameters=model.parameters()))
    no_loss = PipelineLayer(descs(), num_stages=2)
    model = PipelineParallel(no_loss)
    model.accumulate_steps = 4
    attempt("no_loss_fn", model, x8,
            SGD(learning_rate=0.1, parameters=model.parameters()))
    D.init_mesh({"pp": 2, "sdp": 2})
    model = PipelineParallel(pipeline_layer(weights, 2))
    model.accumulate_steps = 4
    attempt("zero_x_pipeline", model, x8,
            SGD(learning_rate=0.1, parameters=model.parameters()))
    return out


# ---------------------------------------------------------------------------
# jobs: tests/test_torch_fleet.py
# ---------------------------------------------------------------------------

def job_fleet_init(hybrid):
    """``fleet.init`` over the world with ``hybrid`` degrees: the mesh, the
    topology's degrees and this rank's coordinates, the worker calls."""
    from paddle_tpu_torch.distributed import fleet
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = dict(hybrid)
    fleet.init(is_collective=True, strategy=strategy)
    fleet.barrier_worker()
    hcg = fleet.get_hybrid_communicate_group()
    from paddle_tpu_torch.distributed import mesh as _mesh
    mesh = _mesh.get_mesh()
    return {"mesh": dict(mesh.shape),
            "dp": hcg.get_data_parallel_world_size(),
            "mp": hcg.get_model_parallel_world_size(),
            "pp": hcg.get_pipe_parallel_world_size(),
            "sdp": hcg.get_sharding_parallel_world_size(),
            "mode": hcg.get_parallel_mode(),
            "coord": [hcg.get_data_parallel_rank(), hcg.get_stage_id(),
                      hcg.get_sharding_parallel_rank(),
                      hcg.get_model_parallel_rank()],
            "mesh_coord": dict(mesh.coord),
            "worker_num": fleet.worker_num(),
            "worker_index": fleet.worker_index(),
            "first": fleet.fleet.is_first_worker()}


def job_fleet_dispatch(weights):
    """``distributed_model``'s wrapper for each degree, and what it did
    to the model: TensorParallel slices the Megatron parameters,
    ShardingParallel at stage 3 records ZeRO placements."""
    import torch

    from paddle_tpu_torch.distributed import fleet
    from _torch_dist import tiny_gpt
    out = {}
    for name, hybrid, extra in (
            ("pp", {"pp_degree": 2}, {}),
            ("mp", {"mp_degree": 2}, {}),
            ("sharding", {"sharding_degree": 2}, {"stage": 3}),
            ("dp", {}, {})):
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = hybrid
        if extra:
            strategy.sharding_configs = extra
        fleet.init(is_collective=True, strategy=strategy)
        model = (pipeline_layer(weights["pipe"], 2) if name == "pp"
                 else tiny_gpt(weights["gpt"]))
        wrapped = fleet.distributed_model(model)
        info = {"type": type(wrapped).__name__}
        if name == "mp":
            info["qkv_shape"] = list(
                model.gpt.h[0].attn.qkv_proj.weight.shape)
        if name == "sharding":
            info["zero_specs"] = sum(hasattr(p, "zero_spec")
                                     for p in model.parameters())
        if name == "dp":
            x = torch.zeros((2, 4), dtype=torch.int64)
            info["forward"] = list(wrapped(x).shape)
        out[name] = info
    return out


def job_hybrid_clip(weights, ids, clip):
    """fleet at mp2 (dp filled to 2): ``distributed_optimizer`` over SGD
    (lr 1) with a global-norm clip, one backward and step of the tiny
    GPT.  Returns the gathered parameters after the step and the passed
    through calls' results."""
    import torch

    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.parallel_base import unshard_state
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import SGD
    from _torch_dist import tiny_gpt
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"mp_degree": 2}
    fleet.init(is_collective=True, strategy=strategy)
    m = tiny_gpt(weights)
    model = fleet.distributed_model(m)
    opt = fleet.distributed_optimizer(SGD(
        learning_rate=1.0, parameters=model.parameters(),
        grad_clip=ClipGradByGlobalNorm(clip)))
    x = torch.from_numpy(np.array(ids))
    GPTPretrainingCriterion()(model(x), x).backward()
    opt.step()
    opt.clear_grad()
    return {"state": {k: v.numpy().copy()
                      for k, v in unshard_state(m).items()},
            "lr": opt.get_lr(), "grads_cleared": all(
                p.grad is None for p in m.parameters()),
            "state_dict_keys": sorted(opt.state_dict())}


# ---------------------------------------------------------------------------
# jobs: tests/test_torch_chip_smoke_parity.py (chip_smoke.py's two-rank
# phases of the pipeline and the tp front end, rehearsed)
# ---------------------------------------------------------------------------

def serve_tp2_spec():
    """serve_http_tp2's spec at tp2_spec's narrow width, in f32."""
    import chip_smoke
    from _torch_dist import tp2_spec
    cfg = tp2_spec()["cfg"]
    rng = np.random.default_rng(29)
    return dict(chip_smoke.SERVE_TP2, cfg=cfg, seed=0, amp=False,
                prompts=[rng.integers(0, cfg.vocab_size, 64).tolist()
                         for _ in range(chip_smoke.SERVE_TP2["requests"])],
                cut=rng.integers(0, cfg.vocab_size, 64).tolist(),
                sampled=rng.integers(0, cfg.vocab_size, 64).tolist())


def job_serve_tp2_rank():
    """chip_smoke.py's serve_tp2_rank on this world (gloo, CPU tensors),
    the LayerNorm wrapper's calls counted."""
    import pytest
    import torch

    import chip_smoke
    from _torch_dist import PlainCounters
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(torch.cuda, "synchronize", lambda *a: None)
        return chip_smoke.serve_tp2_rank(torch, serve_tp2_spec(),
                                         PlainCounters(mp), device="cpu")
    finally:
        mp.undo()


def job_pp2_rank():
    """chip_smoke.py's pp2_rank on this world at tp2_spec's narrow width
    on short_ids, the flash route through its plain versions, counted."""
    import pytest
    import torch

    import chip_smoke
    from _torch_dist import PlainCounters, short_ids, tp2_spec
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(torch.cuda, "synchronize", lambda *a: None)
        mp.setattr(chip_smoke, "train_ids", short_ids)
        return chip_smoke.pp2_rank(
            torch, {"cfg": tp2_spec()["cfg"], "seed": 0, "steps": 3},
            PlainCounters(mp), device="cpu")
    finally:
        mp.undo()
