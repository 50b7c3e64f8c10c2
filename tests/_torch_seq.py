"""The port's side of the GPT sequence-sharding tests (not a test module;
it imports no JAX, so that the ranks of a ``_torch_dist.World`` can run
its jobs as ``"_torch_seq:job_..."``).  Every rank is given the global
numpy batch and the JAX model's weights; the GPT takes the rank's rows
of each sequence on a mesh with a ``sep`` axis."""
from __future__ import annotations

import numpy as np


def _in_mesh(axes):
    """Lay ``axes`` over the world's first ranks; whether this rank is in
    the mesh (a world larger than the mesh leaves the rest idle)."""
    from paddle_tpu_torch import distributed as D
    D.init_mesh(dict(axes))
    return D.get_rank() < int(np.prod(list(axes.values())))


def optimizer(name, params):
    """The runs' optimizers, as ``test_torch_seq_sharding._jax_opt``'s."""
    from paddle_tpu_torch.optimizer import SGD, AdamW
    if name == "sgd":
        return SGD(learning_rate=0.5, parameters=params)
    return AdamW(learning_rate=1e-3, parameters=params, epsilon=1e-6)


def seq_train(weights, ids, steps, axes=None, opt="adamw", spec="dp",
              **cfg):
    """``steps`` steps of ``jit.TrainStep`` over the tiny GPT with
    ``weights`` on the global batch ``ids`` (every rank passes it), on
    the mesh ``axes`` when given: ``spec`` "dp" is ``in_shardings=
    P("dp")``, "dp_sep" ``P("dp", "sep")``, None no ``in_shardings``.
    Returns the losses and the gradients the optimizer took at the first
    step, by the step's names (numpy), or None on a rank outside the
    mesh."""
    import torch

    import _torch_dist
    from paddle_tpu_torch.distributed.mesh import PartitionSpec as P
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    if axes is not None and not _in_mesh(axes):
        return None
    m = _torch_dist.tiny_gpt(weights, **cfg)
    o = optimizer(opt, m.parameters())
    first = {}
    real = o.apply_gradients

    def record(params, grads, *a, **kw):
        if not first:
            first.update(_torch_dist.np_state(grads))
        return real(params, grads, *a, **kw)
    o.apply_gradients = record
    shard = {"dp": P("dp"), "dp_sep": P("dp", "sep"), None: None}[spec]
    step = TrainStep(m, GPTPretrainingCriterion(), o, device="cpu",
                     in_shardings=shard)
    x = torch.from_numpy(np.array(ids))
    losses = [float(step(x, x)) for _ in range(steps)]
    return losses, first


def job_seq_train(weights, ids, steps, axes, opt="adamw", spec="dp",
                  cfg=None):
    return seq_train(weights, ids, steps, axes, opt, spec, **(cfg or {}))


def _grads_by_name(m):
    return {n: p.grad.detach().float().numpy().copy()
            for n, p in m.named_parameters() if p.grad is not None}


def job_seq_forward(weights, ids, axes, position_ids=None):
    """A plain forward on the mesh: the rank's logits (its shard), the
    shards joined by ``gather_sequence``, and its loss share."""
    import torch

    import _torch_dist
    from paddle_tpu_torch.distributed import gather_sequence
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    if not _in_mesh(axes):
        return None
    m = _torch_dist.tiny_gpt(weights)
    x = torch.from_numpy(np.array(ids))
    pos = None if position_ids is None else torch.from_numpy(
        np.array(position_ids))
    with torch.no_grad():
        logits = m(x, pos)
        share = GPTPretrainingCriterion()(logits, x)
    return (logits.numpy().copy(), gather_sequence(logits).numpy().copy(),
            float(share))


def job_seq_data_parallel(weights, ids, axes, via="data_parallel"):
    """One eager step's gradients through ``DataParallel`` (``via``
    "data_parallel"), ``fleet.distributed_model`` with the mesh's degrees
    ("fleet") or ``parallelize`` plus ``DataParallel`` ("parallelize"):
    forward on the global batch, the loss share's backward,
    ``apply_collective_grads``.  Returns (the loss summed over 'sep' and
    averaged over 'dp', the grads)."""
    import torch

    import _torch_dist
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.parallel_base import local_rows
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.nn import DataParallel
    m = _torch_dist.tiny_gpt(weights)
    if via == "fleet":
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = {"%s_degree" % a: n
                                   for a, n in axes.items()}
        fleet.init(is_collective=True, strategy=strategy)
        model = fleet.distributed_model(m)
    else:
        if not _in_mesh(axes):
            return None
        if via == "parallelize":
            D.parallelize(m)
        model = DataParallel(m)
    x = torch.from_numpy(np.array(ids))
    x = local_rows(x, "dp") if "dp" in axes else x
    loss = model.scale_loss(GPTPretrainingCriterion()(model(x), x))
    loss.backward()
    model.apply_collective_grads()
    total = C.all_reduce(loss.detach().clone(), group="sep")
    if "dp" in axes:
        total = C.all_reduce(total, op=C.ReduceOp.AVG, group="dp")
    return float(total), _grads_by_name(m)


def job_dp_sep_guard(weights, ids):
    """``DataParallel`` on {"dp": 2, "sep": 2}: the GPT's step raises when
    its loss is a plain mean of the rank's rows, or is the criterion's
    share but never went through ``scale_loss`` (each message); a model
    that does not shard its sequences is averaged over 'dp' alone, so its
    gradient is the one-process gradient of the global batch's mean (the
    pair: DataParallel's, one process's)."""
    import copy

    import torch
    import torch.nn.functional as TF

    import _torch_dist
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed.parallel_base import local_rows
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    out = {}
    _in_mesh({"dp": 2, "sep": 2})
    x = local_rows(torch.from_numpy(np.array(ids)), "dp")

    def attempt(name, loss_of, scale):
        model = nn.DataParallel(_torch_dist.tiny_gpt(weights))
        loss = loss_of(model(x), x)
        if scale:
            loss = model.scale_loss(loss)
        loss.backward()
        try:
            model.apply_collective_grads()
            out[name] = None
        except NotImplementedError as e:
            out[name] = "%s: %s" % (type(e).__name__, e)

    attempt("plain_mean", lambda lg, lb: TF.cross_entropy(
        lg[:, :-1].reshape(-1, lg.shape[-1]), lb[:, 1:lg.shape[1]]
        .reshape(-1)), scale=True)
    attempt("share_unscaled", GPTPretrainingCriterion(), scale=False)
    torch.manual_seed(5)
    lin = nn.Linear(4, 3)
    one = copy.deepcopy(lin)
    rows = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (8, 4)).astype(np.float32))
    model = nn.DataParallel(lin)
    model.scale_loss((model(local_rows(rows, "dp")) ** 2).mean()).backward()
    model.apply_collective_grads()
    (one(rows) ** 2).mean().backward()
    out["dense"] = [(p.grad.numpy().copy(), q.grad.numpy().copy())
                    for p, q in zip(lin.parameters(), one.parameters())]
    return out


def job_seq_refusals(weights, ids):
    """What raises on a 'sep' mesh, each entry point's message (None:
    it builds): an S the ranks do not divide (ValueError), mp x sep
    (parallelize), ZeRO x sep, pp x sep, the serving engine, a GPT block
    run outside the model, ``in_shardings`` naming 'sep' on dimension 0
    or another axis on dimension 1."""
    import torch

    import _torch_dist
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.mesh import PartitionSpec as P
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTBlock, GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.serving import DecodeEngine
    x = torch.from_numpy(np.array(ids))
    out = {}

    def attempt(name, fn):
        try:
            fn()
            out[name] = None
        except (NotImplementedError, ValueError) as e:
            out[name] = "%s: %s" % (type(e).__name__, e)

    def step(m, **kw):
        return TrainStep(m, GPTPretrainingCriterion(),
                         AdamW(learning_rate=1e-3,
                               parameters=m.parameters()),
                         device="cpu", **kw)
    D.init_mesh({"dp": 2, "sep": 2})
    m = _torch_dist.tiny_gpt(weights)
    attempt("odd_s", lambda: m(x[:, :7]))
    attempt("decode_engine", lambda: DecodeEngine(
        _torch_dist.tiny_gpt(weights), num_slots=2, max_len=64,
        device="cpu").prefill(0, x[0]))
    block = GPTBlock(m.config)
    attempt("block", lambda: block(torch.zeros(1, 8, 64)))
    attempt("in_shardings_sep_dim0", lambda: step(
        _torch_dist.tiny_gpt(weights), in_shardings=P("sep")))
    attempt("in_shardings_dim1_dp", lambda: step(
        _torch_dist.tiny_gpt(weights), in_shardings=P(None, "dp")))
    D.init_mesh({"sep": 2, "mp": 2})
    attempt("mp_parallelize", lambda: D.parallelize(
        _torch_dist.tiny_gpt(weights)))
    D.init_mesh({"sdp": 2, "sep": 2})
    attempt("zero", lambda: step(_torch_dist.tiny_gpt(weights),
                                 zero_stage=1))
    D.init_mesh({"pp": 2, "sep": 2})
    attempt("pp", lambda: _pp_sep(x))
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"pp_degree": 2, "sep_degree": 2}
    strategy.pipeline_configs = {"accumulate_steps": 2}
    fleet.init(is_collective=True, strategy=strategy)
    attempt("fleet_pp", lambda: _pp_sep(x, fleet_model=True))
    return out


def _pp_sep(x, fleet_model=False):
    """A two-stage PipelineLayer of GPT blocks through ``train_batch`` on
    the installed mesh."""
    import _torch_pipe
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.pipeline import PipelineParallel
    from paddle_tpu_torch.optimizer import AdamW
    pl = _torch_pipe.gpt_pipeline(0, 2)
    model = fleet.distributed_model(pl) if fleet_model \
        else PipelineParallel(pl)
    model.accumulate_steps = 2
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
    model.train_batch((x, x), opt)


# ---------------------------------------------------------------------------
# chip_smoke.py's sep_train_gloo on a CPU gloo world of two
# ---------------------------------------------------------------------------

#: sep_train_gloo at a narrow width: 2 layers, 2 heads of 64, 128 rows a
#: rank of a 256-row sequence
SEP_S = 256


def sep_cfg():
    from paddle_tpu_torch.models.gpt import GPTConfig
    return GPTConfig(vocab_size=512, max_position_embeddings=SEP_S,
                     hidden_size=128, num_hidden_layers=2,
                     num_attention_heads=2, intermediate_size=256,
                     hidden_dropout_prob=0.0, attention_dropout_prob=0.0)


def sep_spec(ref_grads, ref_losses):
    import chip_smoke
    return {"cfg": sep_cfg(), "s": SEP_S, "steps": chip_smoke.SEP_STEPS,
            "ref_losses": list(ref_losses), "ref_grads": ref_grads,
            "device": "cpu"}


def job_sep_train_rank(ref_grads, ref_losses):
    """chip_smoke.py's sep_train_rank on this world (gloo, CPU tensors) at
    sep_spec's narrow width, the flash route through its plain versions,
    counted."""
    import pytest
    import torch

    import chip_smoke
    from _torch_dist import PlainCounters
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(torch.cuda, "synchronize", lambda *a: None)
        return chip_smoke.sep_train_rank(
            torch, sep_spec(ref_grads, ref_losses), PlainCounters(mp),
            device="cpu")
    finally:
        mp.undo()


# ---------------------------------------------------------------------------
# ZeRO and tensor parallelism over sequence shards
# ---------------------------------------------------------------------------

def job_sep_hybrid(weights, ids, steps, axes, opt="adamw", spec=None,
                   zero_stage=None, cfg=None):
    """:func:`seq_train`'s run with ZeRO (``zero_stage`` over ``sdp``) or
    tensor parallelism (``parallelize`` where the mesh has ``mp``) beside
    ``sep``: ``spec`` "sdp" is ``in_shardings=P("sdp")``, "sdp_sep"
    ``P("sdp", "sep")``, None no ``in_shardings``.  Returns the losses
    and the gradients the optimizer took at the first step, each made
    whole again (ZeRO slices gathered over ``sdp``, tensor-parallel
    shards over ``mp``), or None on a rank outside the mesh."""
    import torch

    import _torch_dist
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed.mesh import PartitionSpec as P
    from paddle_tpu_torch.distributed.parallel_base import unshard_slices
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    if not _in_mesh(axes):
        return None
    m = _torch_dist.tiny_gpt(weights, **(cfg or {}))
    if axes.get("mp", 1) > 1:
        D.parallelize(m)
    o = optimizer(opt, m.parameters())
    first = {}
    real = o.apply_gradients

    def record(params, grads, *a, **kw):
        if not first:
            first.update({n: g.detach().clone() for n, g in grads.items()})
        return real(params, grads, *a, **kw)
    o.apply_gradients = record
    shard = {"sdp": P("sdp"), "sdp_sep": P("sdp", "sep"), None: None}[spec]
    step = TrainStep(m, GPTPretrainingCriterion(), o, device="cpu",
                     in_shardings=shard, zero_stage=zero_stage)
    x = torch.from_numpy(np.array(ids))
    losses = [float(step(x, x)) for _ in range(steps)]
    z = step._zero
    whole = {}
    for n in sorted(first):
        g = first[n]
        if z is not None and z.sliced(n):
            g = z.gather(n, g)
        p = step._model_params[n]
        if getattr(p, "mp_group", None) is not None:
            dim = next(d for d, a in enumerate(tuple(p.pspec))
                       if a is not None)
            parts = C.all_gather([], g.contiguous(), group=p.mp_group)
            g = unshard_slices(parts, dim, int(getattr(p, "mp_parts", 1)))
        whole[n] = g.float().numpy().copy()
    return losses, whole
