"""The port's side of the ring, Ulysses and MoE tests (not a test module;
it imports no JAX, so that the ranks of a ``_torch_dist.World`` can run
its jobs as ``"_torch_sep:job_..."``).  Each job lays the world's four
ranks out as a mesh, takes the rank's shards of the global numpy inputs
and returns its shards of the results as numpy."""
from __future__ import annotations

import numpy as np

# the global inputs of the ring jobs are (B, H, S, D): the batch is sharded
# over ``dp`` and the sequence over ``sep``


def _mesh(axes):
    from paddle_tpu_torch import distributed as D
    D.init_mesh(dict(axes))
    return D.get_mesh()


def _coord(mesh, axis):
    g = mesh.group(axis)
    return (g.rank, g.nranks) if g is not None else (0, 1)


def _shard(a, mesh, dims):
    """The rank's contiguous piece of ``a``: ``dims`` maps an axis name to
    the dimension it shards."""
    import torch
    t = torch.from_numpy(np.array(a))
    for axis, dim in dims.items():
        r, n = _coord(mesh, axis)
        size = t.shape[dim] // n
        t = t.narrow(dim, r * size, size)
    return t.contiguous()


class _Log:
    """The (numel, dtype) of every tensor this rank hands to
    ``all_to_all_single``, in order (the ring's permutes and the
    all-to-alls), so a test can hold the ranks' sequences equal."""

    def __init__(self, mp):
        import torch.distributed as dist
        self.calls = []
        real = dist.all_to_all_single

        def logged(out, x, *a, **kw):
            self.calls.append((int(x.numel()), str(x.dtype)))
            return real(out, x, *a, **kw)
        mp.setattr(dist, "all_to_all_single", logged)


def _grads(out, inputs, dout):
    import torch
    gs = torch.autograd.grad(out, inputs,
                             torch.from_numpy(np.array(dout)).to(out.dtype))
    return [g.float().numpy().copy() for g in gs]


def job_ring(q, k, v, dout, axes, causal, mask=None, fn="ring",
             dtype="float32"):
    """``ring_attention`` (or ``ulysses_attention``) on this rank's shards
    of (B, H, S, D) q/k/v on the mesh ``axes``, in ``dtype``, then its
    gradients for the shard of ``dout``.  Returns (out, dq, dk, dv, the
    all_to_all_single log of the forward and backward, the dtypes the
    ring permuted, out's dtype)."""
    import pytest
    import torch

    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import ring_attention as R
    mesh = _mesh(axes)
    dims = {"dp": 0, "sep": 2}
    qs, ks, vs = (_shard(a, mesh, dims).to(getattr(torch, dtype))
                  .requires_grad_(True) for a in (q, k, v))
    m = None if mask is None else _shard(mask, mesh, {"dp": 0, "sep": 2})
    mp = pytest.MonkeyPatch()
    try:
        log = _Log(mp)
        permuted = []
        real = C.ppermute

        def spy(t, *a, **kw):
            permuted.append(str(t.dtype))
            return real(t, *a, **kw)
        mp.setattr(C, "ppermute", spy)
        if fn == "ring":
            out = R.ring_attention(qs, ks, vs, "sep", causal=causal,
                                   attn_mask=m)
        else:
            out = R.ulysses_attention(qs, ks, vs, "sep", causal=causal)
        grads = _grads(out, (qs, ks, vs), _shard(dout, mesh, dims).numpy())
    finally:
        mp.undo()
    return ([out.detach().float().numpy().copy()] + grads
            + [log.calls, permuted, str(out.dtype)])


def job_ring_errors(q):
    """The ring's refusals on {"sep": 4}: heads that do not divide, a mask
    whose rows are not the local shard; Ulysses' heads that the axis does
    not divide."""
    import torch

    from paddle_tpu_torch.distributed import ring_attention as R
    mesh = _mesh({"sep": 4})
    qs = _shard(q, mesh, {"sep": 2})
    out = {}
    for name, call in (
            ("gqa", lambda: R.ring_attention(
                torch.cat([qs] * 3, 1), torch.cat([qs] * 2, 1),
                torch.cat([qs] * 2, 1), "sep")),
            ("mask_rows", lambda: R.ring_attention(
                qs, qs, qs, "sep",
                attn_mask=torch.zeros(1, 1, qs.shape[2] + 1, 64))),
            ("ulysses_heads", lambda: R.ulysses_attention(
                qs[:, :3], qs[:, :3], qs[:, :3], "sep"))):
        try:
            call()
            out[name] = None
        except (NotImplementedError, ValueError) as e:
            out[name] = "%s: %s" % (type(e).__name__, e)
    return out


def job_sdpa(q, k, v, mask=None, gqa_kv=None):
    """``scaled_dot_product_attention`` on this rank's (B, S_local, H, D)
    shards of {"sep": 4}: the ring route (causal, no mask), the same with
    an additive (B, 1, S_local, S) mask, and multi-query K/V
    (``gqa_kv``); then the gathered opt-out (``sequence_parallel=False``
    over the all-gathered sequence, this rank's rows kept), and the
    raises.  Returns the outputs and the error messages."""
    import torch

    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.nn import functional as F
    mesh = _mesh({"sep": 4})
    dims = {"sep": 1}
    qs, ks, vs = (_shard(a, mesh, dims) for a in (q, k, v))
    out = {"ring": F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True, training=False)}
    if mask is not None:
        out["mask"] = F.scaled_dot_product_attention(
            qs, qs, qs, attn_mask=_shard(mask, mesh, {"sep": 2}),
            is_causal=True, training=False)
    if gqa_kv is not None:
        kv = _shard(gqa_kv, mesh, dims)
        out["mqa"] = F.scaled_dot_product_attention(
            qs, kv, kv, is_causal=True, training=False)
    full = D.all_gather(qs.transpose(0, 1).contiguous(), group="sep")
    full = full.transpose(0, 1).contiguous()
    got = F.scaled_dot_product_attention(
        full, full, full, is_causal=True, training=False,
        sequence_parallel=False)
    r, _n = _coord(mesh, "sep")
    s_loc = qs.shape[1]
    out["gathered"] = got[:, r * s_loc:(r + 1) * s_loc]
    out = {k_: t.float().numpy().copy() for k_, t in out.items()}
    errors = {}
    for name, call in (
            ("dropout", lambda: F.scaled_dot_product_attention(
                qs, qs, qs, dropout_p=0.1, is_causal=True, training=True)),
            ("cross", lambda: F.scaled_dot_product_attention(
                qs, qs[:, :2], qs[:, :2], is_causal=True, training=False)),
            ("rank3", lambda: F.scaled_dot_product_attention(
                qs[0], qs[0], qs[0], training=False)),
            ("heads", lambda: F.scaled_dot_product_attention(
                torch.cat([qs] * 3, 2), torch.cat([qs] * 2, 2),
                torch.cat([qs] * 2, 2), training=False)),
            ("bool_mask", lambda: F.scaled_dot_product_attention(
                qs, qs, qs, training=False,
                attn_mask=torch.ones(qs.shape[0], 1, s_loc, 4 * s_loc,
                                     dtype=torch.bool))),
            ("mask_rows", lambda: F.scaled_dot_product_attention(
                qs, qs, qs, training=False,
                attn_mask=torch.zeros(qs.shape[0], 1, 4 * s_loc,
                                      4 * s_loc)))):
        try:
            call()
            errors[name] = None
        except (NotImplementedError, ValueError) as e:
            errors[name] = "%s: %s" % (type(e).__name__, e)
    return out, errors


def job_sep_refusal():
    """A tiny GPT on the mesh {"dp": 2, "sep": 2} through each entry point
    that runs it: a plain forward, ``TrainStep`` (with the GPT's
    criterion), ``DecodeEngine``'s prefill, ``parallelize`` and
    ``fleet.distributed_model`` (its ``DataParallel``); then on {"dp": 4}
    (no ``sep``).  Each forward's output, its sequence shards joined by
    ``gather_sequence``, and the step's loss are held against the same
    model with no mesh.  Returns {entry point and axes: (the error
    message or None, the largest difference from the one-process run)}."""
    import torch

    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed import mesh as dmesh
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLM,
                                             GPTPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.serving import DecodeEngine
    cfg = GPTConfig(vocab_size=64, max_position_embeddings=32,
                    hidden_size=32, num_hidden_layers=1,
                    num_attention_heads=2, intermediate_size=64,
                    hidden_dropout_prob=0.0, attention_dropout_prob=0.0)

    def gpt():
        return GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(0))
    ids = torch.arange(16).reshape(2, 8) % 64

    def train_step():
        m = gpt()
        step = jit.TrainStep(
            m, GPTPretrainingCriterion(),
            AdamW(learning_rate=1e-3, parameters=m.parameters()),
            device="cpu")
        return step(ids, ids)

    def fleet_model(axes):
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = {"%s_degree" % a: n
                                   for a, n in axes.items()}
        fleet.init(is_collective=True, strategy=strategy)
        return fleet.distributed_model(gpt())(ids)

    calls = (("GPT", lambda: gpt()(ids)),
             ("TrainStep", train_step),
             ("DecodeEngine", lambda: DecodeEngine(
                 gpt(), num_slots=2, max_len=16, device="cpu").prefill(
                     0, ids[0])),
             ("parallelize", lambda: D.parallelize(gpt())(ids)))
    with dmesh.mesh_scope(None):
        ref = {name: call() for name, call in calls
               if name != "DecodeEngine"}
    ref["fleet"] = ref["GPT"]
    out = {}
    for axes in ({"dp": 2, "sep": 2}, {"dp": 4}):
        D.init_mesh(axes)
        for name, call in calls + (("fleet", lambda: fleet_model(axes)),):
            try:
                got = call()
                msg = None
            except NotImplementedError as e:
                got, msg = None, str(e)
            diff = None
            if got is not None and name in ref:
                got = D.gather_sequence(got) if got.dim() else got
                diff = float((got - ref[name]).abs().max())
            out["%s %s" % (name, sorted(axes))] = (msg, diff)
    return out


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe_params(p, mesh, ep_dim=0):
    """The rank's slices of the functional block's params: the expert
    bank's dim ``ep_dim`` over ``ep``, the gate whole."""
    return {k: (_shard(v, mesh, {}) if k == "gate"
                else _shard(v, mesh, {"ep": ep_dim}))
            for k, v in p.items()}


def _ep_recipe(grads, mesh, expert_keys):
    """The JAX recipe's combine of full-scale per-rank grads: replicated
    leaves averaged over ``ep`` (and ``dp``), the expert bank divided by
    ``ep`` (then averaged over ``dp``)."""
    from paddle_tpu_torch.distributed import collective as C
    out = {}
    _r, nep = _coord(mesh, "ep")
    for k, g in grads.items():
        g = g.clone()
        if k in expert_keys:
            g = g / nep
        else:
            C.all_reduce(g, op=C.ReduceOp.AVG, group="ep")
        if mesh.group("dp") is not None:
            C.all_reduce(g, op=C.ReduceOp.AVG, group="dp")
        out[k] = g.numpy().copy()
    return out


def job_moe_apply(params, x, axes):
    """``moe_apply`` (top-1, capacity factor 2) on the mesh ``axes``: the
    bank over ``ep``, x's batch over ``dp``.  Returns the rank's out, the
    aux averaged over dp, the grads of mean(out^2) + 0.01 aux by the JAX
    recipe, and the all-to-alls issued."""
    import torch

    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import moe
    mesh = _mesh(axes)
    p = {k: v.requires_grad_(True)
         for k, v in _moe_params(params, mesh).items()}
    xs = _shard(x, mesh, {"dp": 0})
    C.reset_counts()
    out, aux = moe.moe_apply(p, xs, top_k=1, capacity_factor=2.0)
    loss = torch.mean(out ** 2) + 0.01 * aux
    names = list(p)
    gs = torch.autograd.grad(loss, [p[k] for k in names])
    issued = C.issued()
    aux_m = aux.detach().clone()
    if mesh.group("dp") is not None:
        C.all_reduce(aux_m, op=C.ReduceOp.AVG, group="dp")
    grads = _ep_recipe(dict(zip(names, gs)), mesh,
                       ("w1", "b1", "w2", "b2"))
    return (out.detach().numpy().copy(), float(aux_m), grads,
            issued.get("all_to_all_single", 0))


def moe_layer(state, d_model, d_hidden, n_local, top_k, gate):
    """A port ``MoELayer`` of ``n_local`` ExpertFFNs carrying ``state``
    (the JAX layer's state dict, this rank's experts renumbered from 0,
    ``convert.shard_moe_state``)."""
    import torch

    from paddle_tpu_torch.convert import load_paddle_tpu_state
    from paddle_tpu_torch.distributed.moe import ExpertFFN, MoELayer
    layer = MoELayer(d_model, [ExpertFFN(d_model, d_hidden)
                               for _ in range(n_local)], gate=gate,
                     top_k=top_k, capacity_factor=2.0)
    load_paddle_tpu_state(layer, state)
    return layer.to(torch.float32)


def layer_grads(layer, x, cot):
    """out, aux_loss and the grads of sum(out * cot) + aux_loss."""
    import torch
    xt = torch.from_numpy(np.array(x))
    out = layer(xt)
    loss = (out * torch.from_numpy(np.array(cot))).sum() + layer.aux_loss
    names = [n for n, _ in layer.named_parameters()]
    gs = torch.autograd.grad(loss, [p for _, p in layer.named_parameters()])
    return (out.detach().numpy().copy(), float(layer.aux_loss),
            {n: g.numpy().copy() for n, g in zip(names, gs)})


def job_moe_layer(state, x, cot, d_model, d_hidden, n_experts, top_k,
                  gate):
    """``MoELayer`` on {"ep": 4}, one rank's slice of the experts
    (``convert.shard_moe_state``), every rank the whole batch: out,
    aux_loss, and the grads (the experts' divided by ep, the gate's as
    they are: each rank's is the full one)."""
    from paddle_tpu_torch.convert import shard_moe_state
    mesh = _mesh({"ep": 4})
    r, n = _coord(mesh, "ep")
    layer = moe_layer(shard_moe_state(state, r, n), d_model, d_hidden,
                      n_experts // n, top_k, gate)
    assert layer.num_experts == n_experts
    out, aux, grads = layer_grads(layer, x, cot)
    grads = {k: (g / n if k.startswith("experts.") else g)
             for k, g in grads.items()}
    return out, aux, grads


def job_moe_pp():
    """The parity fixture through ``spmd_pipeline_1f1b_hetero`` on
    {"pp": 2, "ep": 2}, ``moe_apply`` as the block: the loss and the
    rank's grads by the JAX recipe (replicated leaves averaged over ep,
    the expert bank divided by ep), the all-to-alls each stage issued, the
    stage, and the port's ``moe_pp_sequential_loss`` and its grads by the
    same recipe."""
    import torch

    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import moe
    from paddle_tpu_torch.distributed.pipeline import \
        spmd_pipeline_1f1b_hetero
    (params, x, labels, embed_fn, block_fn, head_loss_fn,
     (n_stages, bps, m)) = moe.build_moe_pp_parity_demo()
    mesh = _mesh({"pp": 2, "ep": 2})
    st, _ = _coord(mesh, "pp")
    blocks = {k: _shard(v.numpy(), mesh,
                        {"pp": 0} if k == "gate" else {"pp": 0, "ep": 2})
              for k, v in params["blocks"].items()}
    p = {"embed": params["embed"], "blocks": blocks,
         "head": params["head"]}
    C.reset_counts()
    loss, g = spmd_pipeline_1f1b_hetero(
        embed_fn, block_fn, head_loss_fn, p, x, labels, n_stages, bps, m)
    issued = C.issued()
    _r, nep = _coord(mesh, "ep")

    def ep_mean(t):
        t = t.clone()
        C.all_reduce(t, op=C.ReduceOp.AVG, group="ep")
        return t.numpy().copy()
    out = {"embed": {k: ep_mean(v) for k, v in g["embed"].items()},
           "head": {k: ep_mean(v) for k, v in g["head"].items()},
           "blocks": {k: (ep_mean(v) if k == "gate"
                          else (v / nep).numpy().copy())
                      for k, v in g["blocks"].items()}}
    # the port's sequential reference on the same rank: every stage's
    # blocks, this rank's experts, moe_apply over the same ep group
    sp = {"embed": {k: v.clone().requires_grad_(True)
                    for k, v in params["embed"].items()},
          "head": {k: v.clone().requires_grad_(True)
                   for k, v in params["head"].items()},
          "blocks": {k: (_shard(v.numpy(), mesh, {} if k == "gate"
                                else {"ep": 2}).requires_grad_(True))
                     for k, v in params["blocks"].items()}}
    seq_loss = moe.moe_pp_sequential_loss(sp, x, labels, embed_fn, block_fn,
                                          head_loss_fn, (n_stages, bps, m))
    leaves = [(part, k, t) for part in ("embed", "head", "blocks")
              for k, t in sp[part].items()]
    gs = torch.autograd.grad(seq_loss, [t for _p, _k, t in leaves])
    seq = {"embed": {}, "head": {}, "blocks": {}}
    for (part, k, _t), gr in zip(leaves, gs):
        seq[part][k] = (gr / nep).numpy().copy() \
            if part == "blocks" and k != "gate" else ep_mean(gr)
    return float(loss), out, issued, st, float(seq_loss), seq


def job_exchanges(x, w):
    """The exchanges on {"sep": 4}: ``ppermute`` along the ring (r -> r +
    1) of rank r's (4, 2) rows, and ``all_to_all_autograd`` of them with
    the gradient of sum(y * w[r]) for its input."""
    import torch

    from paddle_tpu_torch.distributed import collective as C
    mesh = _mesh({"sep": 4})
    r, n = _coord(mesh, "sep")
    t = torch.from_numpy(np.array(x[r]))
    y_p = C.ppermute(t, [(i, (i + 1) % n) for i in range(n)], group="sep")
    t = t.clone().requires_grad_(True)
    y = C.all_to_all_autograd(t, group="sep")
    (g,) = torch.autograd.grad((y * torch.from_numpy(np.array(w[r])))
                               .sum(), [t])
    return (y_p.numpy().copy(), (y.detach().numpy().copy(),
                                 g.numpy().copy()))


def job_global_scatter(x):
    """``global_scatter`` then ``global_gather`` of this rank's (8, 3) rows
    on {"ep": 4}: what arrived, and the round trip."""
    import torch

    from paddle_tpu_torch.distributed import utils
    mesh = _mesh({"ep": 4})
    r, _n = _coord(mesh, "ep")
    mine = torch.from_numpy(np.array(x[r]))
    got = utils.global_scatter(mine, None, None)
    back = utils.global_gather(got, None, None)
    return got.numpy().copy(), back.numpy().copy()


# ---------------------------------------------------------------------------
# chip_smoke.py's ring_gloo and moe_gloo on a CPU gloo world of two
# ---------------------------------------------------------------------------

#: ring_gloo at a narrow width: 128 rows a rank, two heads of 64, bf16
RING_SPEC = {"shape": (1, 256, 2, 64), "dtype": "bfloat16", "seed": 11}
#: moe_gloo at a narrow width: 8 experts of 32 -> 64 -> 32, 64 tokens
MOE_SPEC = {"batch": (2, 32), "d_model": 32, "d_hidden": 64, "experts": 8,
            "top_k": 2, "capacity_factor": 1.25, "seed": 13}


def job_ring_rank():
    """chip_smoke.py's ring_rank on this world (gloo, CPU tensors) at
    RING_SPEC, the flash route through its plain versions, counted (the
    profiled step left out: the CPU has no device trace)."""
    import pytest
    import torch

    import _torch_dist
    import chip_smoke
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(torch.cuda, "synchronize", lambda *a: None)
        mp.setattr(chip_smoke, "traced_calls",
                   lambda torch_, fn, n, sums=(): {
                       "step_host_ms": 0.0, "step_device_ms": 0.0,
                       **{p + "_device_ms": 0.0 for p in sums}})
        return chip_smoke.ring_rank(torch, RING_SPEC,
                                    _torch_dist.PlainCounters(mp),
                                    device="cpu")
    finally:
        mp.undo()


def job_moe_rank():
    """chip_smoke.py's moe_rank on this world (gloo, CPU tensors) at
    MOE_SPEC: the "card" runs are the CPU's."""
    import torch

    import _torch_dist  # noqa: F401
    import chip_smoke
    return chip_smoke.moe_rank(torch, MOE_SPEC, None, device="cpu")
