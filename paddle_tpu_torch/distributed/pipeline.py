"""Pipeline parallelism (port of ``paddle_tpu/distributed/pipeline.py``;
reference: fleet/meta_parallel/pipeline_parallel.py:30 PipelineParallel,
1F1B at forward_backward_pipeline:80; parallel_layers/pp_layers.py:132
PipelineLayer, LayerDesc:31, SegmentLayers:63).

The JAX package runs the whole pipeline as one SPMD program under
``shard_map``: the stages' parameters are stacked on a leading dimension
sharded over the ``pp`` mesh axis and each tick's stage handoff is a
``lax.ppermute``.  Here each stage is a process (a rank of the ``pp``
axis of :mod:`.mesh`) that runs its own stage, and each tick's handoff is
:func:`.collective.ppermute` — one uneven ``all_to_all_single`` over the
``pp`` group, not ``send`` / ``recv`` (gloo aborts the process on
``send`` / ``recv`` of CUDA tensors).  Every rank of the group calls the
two permutes of every tick, forward activations and backward cotangents,
whether or not it has a microbatch at that tick (a rank with none sends
zeros), so a step issues ``2 (m + 2 (n - 1))`` permutes over ``n``
stages and ``m`` microbatches, the JAX program's count.

The 1F1B schedules (:func:`spmd_pipeline_1f1b`,
:func:`spmd_pipeline_1f1b_hetero`) take their gradients from
``torch.autograd`` and KEEP each in-flight microbatch's graph from its
forward to its backward (``2 (n - 1 - s) + 1`` graphs at most on stage
``s``, the 1F1B bound), where the JAX program saves only the stage
inputs and re-runs the stage forward inside ``jax.vjp``: the port trades
the activations of those few microbatches for not running each stage
forward twice.  A rank skips the compute of ticks where it has no
microbatch (the JAX program computes them and masks the result).

:class:`PipelineParallel` (the fleet dispatch target) takes the
in-process microbatch loop without a ``pp`` mesh axis, and the 1F1B
schedule over the axis with one (:class:`_CompiledPipelineStep`, named
after the JAX class it ports: the port compiles nothing).
"""
from __future__ import annotations

import warnings
from typing import Callable, List

import torch
from torch import nn

from . import collective as _coll
from . import mesh as _mesh

__all__ = ["LayerDesc", "SharedLayerDesc", "SegmentLayers", "PipelineLayer",
           "PipelineParallel", "PipelinePreconditionError", "spmd_pipeline",
           "spmd_pipeline_1f1b", "spmd_pipeline_1f1b_hetero"]


class LayerDesc:
    """reference parity: pp_layers.py:31 — lazy layer description."""

    def __init__(self, layer_class, *args, **kwargs):
        self.layer_class = layer_class
        self.args = args
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_class(*self.args, **self.kwargs)


class SharedLayerDesc(LayerDesc):
    """reference parity: pp_layers.py:49 — a weight shared across stages
    (embedding / softmax tying).

    All descs with the same ``key`` share ONE parameter object: the first
    occurrence owns it, later occurrences alias it (the attribute
    ``shared_weight_attr`` of the later layer, through the class's
    property setter where it has one), so autograd accumulates both the
    lookup and the head cotangents on the same ``Parameter`` and
    ``named_parameters`` lists it once.  ``forward_func(layer, x)``, when
    given, replaces the later occurrence's forward (the tied logits
    matmul).  Over a ``pp`` axis the shared grads are summed over the
    stages (the reference's shared-embedding allreduce)."""

    def __init__(self, key, layer_class, *args, forward_func=None,
                 shared_weight_attr="weight", **kwargs):
        super().__init__(layer_class, *args, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


def _set_shared(layer, attr, value):
    """``layer.attr = value`` for a tie: a property of the layer's class
    is set through its setter (``nn.Module.__setattr__`` would refuse to
    register a parameter under a property's name)."""
    prop = getattr(type(layer), attr, None)
    if isinstance(prop, property) and prop.fset is not None:
        prop.fset(layer, value)
    else:
        setattr(layer, attr, value)


class _SharedCall(nn.Module):
    """A later occurrence of a SharedLayerDesc: its forward runs
    ``forward_func(shared_layer, x)`` (reference: PipelineLayer's
    shared-layer dispatch in pp_layers.py)."""

    def __init__(self, layer, fn):
        super().__init__()
        self.shared = layer
        self._fn = fn

    def forward(self, x):
        if self._fn is None:
            return self.shared(x)
        return self._fn(self.shared, x)


class SegmentLayers:
    """reference parity: pp_layers.py:63 — the uniform partition of N
    layers into ``num_parts`` segments (the first ``N % num_parts`` one
    longer); any other method raises ``NotImplementedError``."""

    def __init__(self, layers_desc, num_parts, method="uniform"):
        self.descs = layers_desc
        self.num_parts = num_parts
        self.method = method

    def do_segment(self) -> List[int]:
        n = len(self.descs)
        if self.method == "uniform":
            base = n // self.num_parts
            rem = n % self.num_parts
            bounds = [0]
            for i in range(self.num_parts):
                bounds.append(bounds[-1] + base + (1 if i < rem else 0))
            return bounds
        raise NotImplementedError(self.method)


class PipelineLayer(nn.Module):
    """reference parity: pp_layers.py:132.  Builds the WHOLE layer list on
    every rank, as the JAX package does (there every stage lives in one
    program); the 1F1B step trains a rank's own stage and
    :meth:`PipelineParallel.sync_to_layers` gathers the others'."""

    def __init__(self, layers, num_stages=None, topology=None,
                 loss_fn=None, seg_method="uniform", recompute_interval=0):
        super().__init__()
        self.descs = list(layers)
        self.num_stages = num_stages or 1
        self.loss_fn = loss_fn
        self.recompute_interval = recompute_interval
        built = []
        self.shared_groups = {}   # key -> [(layer, desc), ...]
        for d in self.descs:
            layer = d.build_layer() if isinstance(d, LayerDesc) else d
            if isinstance(d, SharedLayerDesc):
                grp = self.shared_groups.setdefault(d.layer_name, [])
                if grp:
                    first_layer, first_desc = grp[0]
                    # tie: later occurrences alias the first's parameter
                    _set_shared(layer, d.shared_weight_attr,
                                getattr(first_layer,
                                        first_desc.shared_weight_attr))
                grp.append((layer, d))
                if grp[1:]:
                    layer = _SharedCall(layer, d.forward_func)
            built.append(layer)
        self.run_function = nn.ModuleList(built)
        self.segment_bounds = SegmentLayers(
            built, self.num_stages, seg_method).do_segment()

    def get_stage_layers(self, stage_id):
        lo, hi = (self.segment_bounds[stage_id],
                  self.segment_bounds[stage_id + 1])
        return self.run_function[lo:hi]

    def forward(self, x):
        for layer in self.run_function:
            x = layer(x)
        return x


# -- trees of tensors (nested dicts, the JAX pytrees of this module) ---------

def _tmap(fn, tree):
    if isinstance(tree, dict):
        return {k: _tmap(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    """The tensors of ``tree`` in sorted key order (the JAX flatten's)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [tree]


def _rebuild(tree, leaves):
    """``tree``'s structure over ``leaves`` (in :func:`_leaves`' order)."""
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        return next(it)
    return walk(tree)


def _group_of(axis):
    """(group, rank on the axis, axis size): the mesh's group of ``axis``,
    or a world of one without it."""
    g = _coll._resolve(axis)
    if g is None:
        return None, 0, 1
    return g, g.rank, g.nranks


# -- the schedules -------------------------------------------------------------

def spmd_pipeline(stage_fn: Callable, stacked_params, x, num_stages: int,
                  num_micro: int, axis: str = "pp"):
    """The forward fill-drain pipeline over ``axis``: ``num_micro +
    num_stages - 1`` ticks; each tick every stage runs its microbatch and
    the activations rotate one stage on (one :func:`.collective.ppermute`
    a tick).

    stage_fn(params_slice, microbatch) -> microbatch_out (same shape).
    stacked_params: this rank's slice of the stacked stage parameters,
        each leaf with a leading dimension of 1 (what a device sees of
        the JAX package's (num_stages, ...) leaves under ``shard_map``).
    x: (num_micro, micro_batch, ...), the whole input on every rank
        (stage 0 reads it).
    Returns the last stage's outputs, (num_micro, ...), on every rank
    (broadcast by a masked all-reduce).  Forward only: the 1F1B
    schedules below give gradients."""
    group, stage, n = _group_of(axis)
    if n != num_stages:
        raise ValueError("spmd_pipeline: the %r axis has %d ranks, "
                         "num_stages=%d" % (axis, n, num_stages))
    params = _tmap(lambda p: p[0], stacked_params)
    fwd_perm = [(i, (i + 1) % n) for i in range(n)]
    with torch.no_grad():
        probe = stage_fn(params, x[0])
        outputs = torch.zeros((num_micro,) + tuple(probe.shape),
                              dtype=probe.dtype, device=probe.device)
        buf = torch.zeros_like(probe)
        for t in range(num_micro + n - 1):
            if 0 <= t - stage < num_micro:
                inp = x[t - stage] if stage == 0 else buf
                out = stage_fn(params, inp)
            else:
                out = torch.zeros_like(probe)
            done = t - (n - 1)
            if stage == n - 1 and done >= 0:
                outputs[done] = out
            buf = _coll.ppermute(out, fwd_perm, group=group)
        if stage != n - 1:
            outputs.zero_()
        _coll.all_reduce(outputs, group=group)
    return outputs


class _Schedule:
    """The 1F1B loop of one rank, shared by the homogeneous and the
    heterogeneous schedules and the fleet step: tick ``t`` runs forward
    microbatch ``f = t - s`` and backward microbatch ``b = t - 2 (n - 1)
    + s`` on stage ``s``, then permutes the activation forward and the
    cotangent backward.

    first_input(f) -> the stage-0 input of microbatch ``f`` (its graph
        may reach ``embed_params``);
    stage_fwd(h) -> the stage's output;
    head_loss(out, f) -> the last stage's (scaled) loss of microbatch
        ``f`` (its graph may reach ``head_params`` and ``embed_params``:
        a tied head);
    h_like: a tensor of the activation's shape and dtype (the buffers of
        ticks a rank has nothing to send).
    ``run()`` returns the summed loss (last stage, else 0) and the f32
    gradient sums of the three parameter lists; ``peak`` is the most
    microbatches held at once, ``permutes`` the permutes issued."""

    def __init__(self, group, stage, n, m, first_input, stage_fwd,
                 head_loss, h_like, stage_params, embed_params=(),
                 head_params=(), loss_in_f32=False):
        self.group, self.stage, self.n, self.m = group, stage, n, m
        self.first_input = first_input
        self.stage_fwd = stage_fwd
        self.head_loss = head_loss
        self.h_like = h_like
        self.stage_params = list(stage_params)
        self.embed_params = list(embed_params)
        self.head_params = list(head_params)
        self.loss_in_f32 = loss_in_f32
        self.peak = 0
        self.permutes = 0

    def _zeros(self):
        h = self.h_like
        return torch.zeros(h.shape, dtype=h.dtype, device=h.device)

    @staticmethod
    def _acc(params):
        return [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in params]

    @staticmethod
    def _add(accs, grads):
        for a, g in zip(accs, grads):
            if g is not None:
                a.add_(g.float())

    def run(self):
        n, m, s = self.n, self.m, self.stage
        last = s == n - 1
        fwd_perm = [(i, i + 1) for i in range(n - 1)]
        bwd_perm = [(i + 1, i) for i in range(n - 1)]
        g_stage = self._acc(self.stage_params)
        g_embed = self._acc(self.embed_params)
        g_head = self._acc(self.head_params)
        loss_acc = torch.zeros((), dtype=torch.float32,
                               device=self.h_like.device)
        fwd_buf = bwd_buf = None
        inflight = {}
        ct_seed = None
        nh, ne, ns = (len(self.head_params), len(self.embed_params),
                      len(self.stage_params))
        for t in range(m + 2 * (n - 1)):
            # ---- forward -------------------------------------------------
            f = t - s
            send_f = None
            if 0 <= f < m:
                with torch.enable_grad():
                    if s == 0:
                        x_in = self.first_input(f)
                    else:
                        x_in = fwd_buf.detach().requires_grad_(True)
                    out = self.stage_fwd(x_in)
                inflight[f] = (x_in, out)
                self.peak = max(self.peak, len(inflight))
                if last:
                    # the loss and the backward seed of f (b == f here)
                    with torch.enable_grad():
                        o = out.detach()
                        o = (o.float() if self.loss_in_f32 else o
                             ).requires_grad_(True)
                        loss = self.head_loss(o, f)
                        grads = torch.autograd.grad(
                            loss, self.head_params + self.embed_params + [o],
                            allow_unused=True)
                    self._add(g_head, grads[:nh])
                    self._add(g_embed, grads[nh:nh + ne])
                    ct_seed = (grads[-1] if grads[-1] is not None
                               else torch.zeros_like(o)).to(out.dtype)
                    loss_acc += loss.detach().float()
                send_f = out.detach().to(self.h_like.dtype)
            # ---- backward ------------------------------------------------
            b = t - 2 * (n - 1) + s
            send_b = None
            if 0 <= b < m:
                x_b, out_b = inflight.pop(b)
                ct = ct_seed if last else bwd_buf.to(out_b.dtype)
                wrt = list(self.stage_params)
                if s == 0:
                    # stage 0 continues the chain into the embedding
                    wrt += self.embed_params
                need_dx = s > 0
                if need_dx:
                    wrt.append(x_b)
                grads = torch.autograd.grad(out_b, wrt, grad_outputs=ct,
                                            allow_unused=True)
                self._add(g_stage, grads[:ns])
                if s == 0:
                    self._add(g_embed, grads[ns:ns + ne])
                if need_dx:
                    send_b = (grads[-1] if grads[-1] is not None
                              else torch.zeros_like(x_b))
            # ---- rotate --------------------------------------------------
            fwd_buf = _coll.ppermute(
                send_f if send_f is not None else self._zeros(), fwd_perm,
                group=self.group)
            bwd_buf = _coll.ppermute(
                send_b.detach() if send_b is not None else self._zeros(),
                bwd_perm, group=self.group)
            self.permutes += 2
        return loss_acc, g_stage, g_embed, g_head


def _loss_over_stages(loss_acc, stage, n, m, group):
    """The last stage's summed loss on every rank, over ``m``."""
    loss = loss_acc if stage == n - 1 else torch.zeros_like(loss_acc)
    _coll.all_reduce(loss, group=group)
    return loss / m


def spmd_pipeline_1f1b(stage_fn: Callable, loss_fn: Callable, stacked_params,
                       x, labels, num_stages: int, num_micro: int,
                       axis: str = "pp"):
    """1F1B pipeline-parallel training step over ``axis``, homogeneous
    stages.  Returns (mean loss, this stage's grads averaged over the
    microbatches, each with a leading dimension of 1).

        tick t, stage s:  fwd microbatch  f = t - s
                          bwd microbatch  b = t - 2(num_stages-1) + s

    stage_fn(params_slice, microbatch) -> microbatch_out (same shape);
    loss_fn(last_stage_out, label_microbatch) -> scalar (mean), given
    the output in f32 as in the JAX schedule.  ``stacked_params`` as in
    :func:`spmd_pipeline`; x / labels: (num_micro, micro_batch, ...),
    read by stage 0 / stage n-1."""
    group, stage, n = _group_of(axis)
    if n != num_stages:
        raise ValueError("spmd_pipeline_1f1b: the %r axis has %d ranks, "
                         "num_stages=%d" % (axis, n, num_stages))
    m = num_micro
    params = _tmap(lambda p: p[0].detach().requires_grad_(True),
                   stacked_params)
    leaves = _leaves(params)
    with torch.no_grad():
        h_like = stage_fn(params, x[0])
    sched = _Schedule(
        group, stage, n, m, first_input=lambda f: x[f],
        stage_fwd=lambda h: stage_fn(params, h),
        head_loss=lambda o, f: loss_fn(o, labels[f]), h_like=h_like,
        stage_params=leaves, loss_in_f32=True)
    loss_acc, g, _, _ = sched.run()
    loss = _loss_over_stages(loss_acc, stage, n, m, group)
    grads = _rebuild(params, [(a / m)[None] for a in g])
    return loss, grads


def spmd_pipeline_1f1b_hetero(embed_fn: Callable, block_fn: Callable,
                              head_loss_fn: Callable, params, x, labels,
                              num_stages: int, blocks_per_stage: int,
                              num_micro: int, axis: str = "pp",
                              batch_axes: tuple = (), loss_scale=None,
                              embed_grad_shard=None):
    """1F1B for HETEROGENEOUS stages (embedding / blocks / head), the
    shape of a language model.

    * ``params["embed"]`` — whole on every stage; stage 0 runs it.  Its
      grads take the stage-0 lookup cotangent and the last stage's
      tied-head cotangent, summed over ``axis`` by one all-reduce (the
      reference's shared-weight allreduce).
    * ``params["blocks"]`` — this rank's slice, leaves of shape (1,
      blocks_per_stage, ...); the stage runs its blocks in order.
    * ``params["head"]`` — whole; ``head_loss_fn`` runs it on the last
      stage.  For tied embeddings the head tree is empty and
      ``head_loss_fn`` reads the weight from the embed tree.

    Signatures:
        embed_fn(embed_params, raw_microbatch) -> h
        block_fn(one_block_params, h) -> h
        head_loss_fn(head_params, embed_params, h, label_mb) -> scalar,
            given h in f32 as in the JAX schedule
    ``batch_axes``: data-parallel axes the microbatch rows are sharded
    over: the loss and every grad are averaged over them.
    ``loss_scale`` (fp16 GradScaler) multiplies the loss inside the
    backward, so every cotangent is scaled before a half-precision cast
    can underflow it; the returned loss is unscaled, the grads stay
    scaled.  ``embed_grad_shard`` (``(axis, size)``, an axis of
    ``batch_axes``) is the JAX package's row-sharded embedding-grad
    accumulator, a memory layout with the same sums: the port keeps the
    whole accumulator and one all-reduce (the sharded layout is queued,
    ROADMAP.md §A5).

    Returns (mean_loss, grads) with grads matching the params structure
    (blocks grads with the leading stage dimension of 1)."""
    group, stage, n = _group_of(axis)
    if n != num_stages:
        raise ValueError("spmd_pipeline_1f1b_hetero: the %r axis has %d "
                         "ranks, num_stages=%d" % (axis, n, num_stages))
    if embed_grad_shard is not None and embed_grad_shard[0] \
            not in batch_axes:
        raise ValueError(
            "embed_grad_shard axis %r must be one of the batch_axes %r "
            "(its per-tick psum_scatter IS the data-axis grad reduction)"
            % (embed_grad_shard[0], batch_axes))
    m, bps = num_micro, blocks_per_stage

    def leaf(p):
        return p.detach().requires_grad_(True)
    ep = _tmap(leaf, params["embed"])
    hp = _tmap(leaf, params["head"])
    bp = _tmap(lambda p: leaf(p[0]), params["blocks"])

    def stage_fwd(h):
        for i in range(bps):
            h = block_fn(_tmap(lambda v: v[i], bp), h)
        return h

    scale = 1.0 if loss_scale is None else loss_scale
    with torch.no_grad():
        h_like = embed_fn(ep, x[0])
    sched = _Schedule(
        group, stage, n, m, first_input=lambda f: embed_fn(ep, x[f]),
        stage_fwd=stage_fwd,
        head_loss=lambda o, f: head_loss_fn(hp, ep, o, labels[f]) * scale,
        h_like=h_like, stage_params=_leaves(bp),
        embed_params=_leaves(ep), head_params=_leaves(hp),
        loss_in_f32=True)
    loss_acc, g_b, g_e, g_h = sched.run()
    loss = _loss_over_stages(loss_acc, stage, n, m, group)
    if loss_scale is not None:
        loss = loss / loss_scale
    for g in g_e + g_h:
        _coll.all_reduce(g, group=group)
    g_e = [g / m for g in g_e]
    g_h = [g / m for g in g_h]
    g_b = [g / m for g in g_b]
    for a in batch_axes:
        loss, g_b, g_e, g_h = _average_over(a, loss, g_b, g_e, g_h)
    return loss, {"embed": _rebuild(ep, g_e),
                  "blocks": _rebuild(bp, [g[None] for g in g_b]),
                  "head": _rebuild(hp, g_h)}


def _average_over(axis, loss, *lists):
    """The loss and every grad of ``lists`` averaged over ``axis`` (the
    fleet's data-parallel semantics)."""
    group, _r, na = _group_of(axis)
    out = [loss]
    _coll.all_reduce(loss, group=group)
    out[0] = loss / na
    for grads in lists:
        for g in grads:
            _coll.all_reduce(g, group=group)
        out.append([g / na for g in grads])
    return tuple(out)


#: warn when the hetero schedule would replicate more f32 embedding grad
#: accumulator than this per pipeline stage
_EMBED_REPLICATION_WARN_BYTES = 512 * 1024 * 1024


def _grads_finite(grads):
    """ONE finite check over every gradient (reference
    check_finite_and_unscale_op.cc): a running max of |g| over the
    leaves, which inf and nan poison and which a large but finite
    gradient set cannot overflow (a sum could).  Returns a bool tensor."""
    total = None
    for g in grads:
        if g is None or g.numel() == 0:
            continue
        m = g.detach().abs().max().float()
        total = m if total is None else torch.maximum(total, m)
    if total is None:
        return torch.tensor(True)
    return torch.isfinite(total)


class _CompiledPipelineStep:
    """The fleet PipelineLayer API onto the 1F1B schedule, one rank's part.

    Contract (checked loudly, with the JAX package's messages): the layer
    list is [input/embedding layer, N structurally identical blocks, head
    layer] with N divisible by the ``pp`` axis size.  Ties declared
    through SharedLayerDesc are found by parameter identity: the head's
    tied parameter is the embedding's, held once (in the embed part), its
    grads summed over ``pp``.  Rank ``s`` of ``pp`` trains blocks ``s *
    N / pp`` to ``(s + 1) * N / pp - 1`` and the embedding and head,
    which every stage holds and updates alike (their grads are summed
    over ``pp`` first).  Microbatch rows are sharded over ``dp``.  The
    step updates the layers' parameters in place; :meth:`sync_to_layers`
    gathers the other stages' blocks."""

    def __init__(self, pipeline_layer: "PipelineLayer", optimizer,
                 num_stages: int, num_micro: int,
                 use_scaler: bool = False, zero_stage: int = 1):
        layers = list(pipeline_layer.run_function)
        if len(layers) < num_stages + 2:
            raise ValueError(
                "compiled pipeline needs [input layer, blocks..., head] "
                "with at least one block per stage; got %d layers for "
                "pp=%d" % (len(layers), num_stages))
        self._embed_layer = layers[0]
        self._head_layer = layers[-1]
        blocks = layers[1:-1]
        if len(blocks) % num_stages:
            raise ValueError(
                "compiled pipeline: %d blocks not divisible by pp=%d"
                % (len(blocks), num_stages))
        keys0 = sorted(blocks[0].state_dict())
        for b in blocks[1:]:
            if sorted(b.state_dict()) != keys0:
                raise ValueError(
                    "compiled pipeline: blocks are not structurally "
                    "identical (param trees differ) — heterogeneous blocks "
                    "cannot be stacked over the 'pp' axis")
        self._blocks = blocks
        self._block_keys = keys0
        if pipeline_layer.loss_fn is None:
            raise ValueError(
                "the compiled pipeline needs PipelineLayer(loss_fn=...) — "
                "the 1F1B schedule computes loss and cotangents on the last "
                "stage inside the compiled program")
        self._loss_layer = pipeline_layer.loss_fn
        self._optimizer = optimizer
        self._num_stages = num_stages
        self._num_micro = num_micro
        self._use_scaler = use_scaler
        self._zero_stage = zero_stage
        self._mesh = _mesh.ensure_mesh()
        self._dp = self._mesh.shape.get("dp", 1)
        self._sdp = self._mesh.shape.get("sdp", 1)
        if self._sdp > 1:
            raise NotImplementedError(
                "ZeRO x pipeline (sharding stage %d over an 'sdp' axis of "
                "%d ranks with pp=%d) is not ported yet (ROADMAP.md §A5)"
                % (zero_stage, self._sdp, num_stages))
        self._group, self._stage, n = _group_of("pp")
        if n != num_stages:
            raise ValueError("compiled pipeline: the 'pp' axis has %d "
                             "ranks, pp=%d" % (n, num_stages))
        bps = len(blocks) // num_stages
        self._bps = bps
        self._my_blocks = blocks[self._stage * bps:(self._stage + 1) * bps]

        embed_sd = self._embed_layer.state_dict(keep_vars=True)
        head_sd = self._head_layer.state_dict(keep_vars=True)
        # tied params: any head entry whose Parameter IS an embed entry
        embed_by_id = {id(t): k for k, t in embed_sd.items()}
        self._tied = {hk: embed_by_id[id(t)] for hk, t in head_sd.items()
                      if id(t) in embed_by_id}
        embed_p = dict(self._embed_layer.named_parameters())
        embed_bytes = sum(p.numel() * 4 for p in embed_p.values())
        if embed_bytes > _EMBED_REPLICATION_WARN_BYTES:
            warnings.warn(
                "compiled pipeline: the embedding tree is %.1f GB (f32 "
                "grad accumulator) and is REPLICATED per pipeline stage "
                "by the hetero 1F1B schedule; at this vocab size consider "
                "tensor-parallel (VocabParallelEmbedding) or a sharded "
                "embedding before pp" % (embed_bytes / 2 ** 30))
        tied_ids = {id(t) for t in embed_sd.values()}
        head_p = {k: p for k, p in self._head_layer.named_parameters()
                  if id(p) not in tied_ids}
        # name -> Parameter: "embed/<k>", "blocks/<j>/<k>" (j: the block's
        # index within this stage), "head/<k>"
        self.params = {}
        self.params.update({"embed/" + k: p for k, p in embed_p.items()})
        for j, b in enumerate(self._my_blocks):
            self.params.update({"blocks/%d/%s" % (j, k): p
                                for k, p in b.named_parameters()})
        self.params.update({"head/" + k: p for k, p in head_p.items()})
        self._names = {"embed": ["embed/" + k for k in embed_p],
                       "blocks": [k for k in self.params
                                  if k.startswith("blocks/")],
                       "head": ["head/" + k for k in head_p]}
        # the global-norm clip's groups: a block's squares are summed over
        # the stages (and over mp for a tensor-parallel shard)
        self._clip_groups = {}
        for name, p in self.params.items():
            grps = tuple(g for g in (
                getattr(p, "mp_group", None),
                self._group if name.startswith("blocks/") else None)
                if g is not None)
            if grps:
                self._clip_groups[name] = grps if len(grps) > 1 else grps[0]
        self.opt_state = optimizer.init_state(
            {k: p.detach() for k, p in self.params.items()})
        self.last_peak_inflight = 0
        self.last_permutes = 0

    # -- one step ----------------------------------------------------------

    def _stage_fwd(self, h):
        for b in self._my_blocks:
            h = b(h)
        return h

    def _head_loss(self, h, lbl, scale):
        loss = self._loss_layer(self._head_layer(h), lbl)
        return loss * scale if scale is not None else loss

    def step(self, x, y, scale=None):
        """One training step on the global batch (x, y) (every rank
        passes the same batch); returns (mean loss, finite)."""
        m = self._num_micro
        batch = x.shape[0]
        mb = batch // m
        data_par = self._dp * self._sdp
        if data_par > 1 and mb % data_par:
            raise ValueError(
                "microbatch size %d not divisible by the data-parallel "
                "extent dp*sdp=%d — the compiled pipeline shards "
                "microbatch rows over ('dp', 'sdp')" % (mb, data_par))
        xs = x.reshape((m, mb) + tuple(x.shape[1:]))
        ys = y.reshape((m, mb) + tuple(y.shape[1:]))
        if self._dp > 1:
            # this rank's rows of every microbatch
            rows = mb // self._dp
            r = self._mesh.axis_rank("dp")
            xs = xs[:, r * rows:(r + 1) * rows]
            ys = ys[:, r * rows:(r + 1) * rows]
        n, s = self._num_stages, self._stage
        embed = self._embed_layer
        with torch.no_grad():
            h_like = embed(xs[0])
        names = self._names
        p = self.params
        sched = _Schedule(
            self._group, s, n, m, first_input=lambda f: embed(xs[f]),
            stage_fwd=self._stage_fwd,
            head_loss=lambda o, f: self._head_loss(o, ys[f], scale),
            h_like=h_like,
            stage_params=[p[k] for k in names["blocks"]],
            embed_params=[p[k] for k in names["embed"]],
            head_params=[p[k] for k in names["head"]])
        loss_acc, g_b, g_e, g_h = sched.run()
        self.last_peak_inflight = sched.peak
        self.last_permutes = sched.permutes
        loss = _loss_over_stages(loss_acc, s, n, m, self._group)
        if scale is not None:
            loss = loss / scale
        for g in g_e + g_h:
            _coll.all_reduce(g, group=self._group)
        g_b, g_e, g_h = ([g / m for g in lst] for lst in (g_b, g_e, g_h))
        if self._dp > 1:
            loss, g_b, g_e, g_h = _average_over("dp", loss, g_b, g_e, g_h)
        # f32 grads, as the JAX step's accumulators are
        grads = dict(zip(names["blocks"] + names["embed"] + names["head"],
                         g_b + g_e + g_h))
        finite = True
        if self._use_scaler:
            # unscale, then one finite check over every rank's grads: all
            # ranks skip the same step
            inv = 1.0 / float(scale)
            grads = {k: g * inv for k, g in grads.items()}
            bad = (~_grads_finite(list(grads.values()))).float().reshape(1)
            bad = bad.to(h_like.device)
            for axis in ("pp", "dp"):
                _coll.all_reduce(bad, op=_coll.ReduceOp.MAX, group=axis)
            finite = not bool(bad.item())
        if finite:
            new_p, self.opt_state = self._optimizer.apply_gradients(
                {k: t.detach() for k, t in p.items()}, grads,
                self.opt_state, self._optimizer.get_lr(),
                mp_groups=self._clip_groups or None)
            with torch.no_grad():
                for k, t in new_p.items():
                    p[k].copy_(t)
        return loss.detach(), finite

    def adopt_opt_state(self, opt_state):
        """Carry a prior step's optimizer state (same optimizer, same
        parameter names) into this one."""
        self.opt_state = opt_state

    @torch.no_grad()
    def sync_to_layers(self):
        """Every rank's layers take the trained blocks of every stage
        (all-gathered over ``pp``); the embedding and head are current on
        every rank already.  A collective: every rank calls it."""
        n = self._num_stages
        if n == 1:
            return
        for j, b in enumerate(self._my_blocks):
            mine = b.state_dict()
            peers = [self._blocks[s * self._bps + j].state_dict()
                     for s in range(n)]
            for k in self._block_keys:
                parts = _coll.all_gather([], mine[k].contiguous(),
                                         group=self._group)
                for s in range(n):
                    if s != self._stage:
                        peers[s][k].copy_(parts[s])


class PipelineParallel(nn.Module):
    """Model wrapper for pp mode (the fleet dispatch target, reference
    pipeline_parallel.py:30).  ``train_batch(data, optimizer,
    lr_scheduler, scaler)`` runs the 1F1B schedule over the mesh's
    ``pp`` axis when it has more than one rank, else the in-process
    microbatch loop."""

    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        self.accumulate_steps = 1
        self.sharding_stage = 1
        if strategy is not None:
            self.accumulate_steps = strategy.pipeline_configs.accumulate_steps
            self.sharding_stage = strategy.sharding_configs.stage
        self._compiled = None     # lazy _CompiledPipelineStep

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def _pp_mesh_axis(self):
        """The 'pp' mesh axis size, if a mesh with one is active."""
        mesh = _mesh.get_mesh()
        if mesh is not None and "pp" in mesh.axis_names:
            return mesh.shape["pp"]
        return 1

    def sync_to_layers(self):
        """Write the trained stages into every rank's layers (a collective
        over ``pp``)."""
        if self._compiled is not None:
            self._compiled.sync_to_layers()

    def state_dict(self, *args, **kwargs):
        """Always current, as the reference's: the other stages' trained
        blocks are gathered first (a collective: every rank of ``pp``
        calls it)."""
        self.sync_to_layers()
        return super().state_dict(*args, **kwargs)

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """One pipeline training step: split the batch into
        ``accumulate_steps`` microbatches, run each through the stages,
        accumulate grads, then ONE optimizer step (the observable
        contract of the reference's 1F1B train_batch)."""
        x, y = data
        acc = max(int(self.accumulate_steps), 1)
        batch = x.shape[0]
        if batch % acc:
            raise ValueError(
                "train_batch: batch size %d not divisible by "
                "accumulate_steps %d" % (batch, acc))
        if self._pp_mesh_axis() > 1:
            live_scaler = (scaler is not None
                           and getattr(scaler, "_enable", True))
            old = None
            if self._compiled is not None and (
                    self._compiled._optimizer is not optimizer
                    or self._compiled._num_micro != acc
                    or self._compiled._use_scaler != live_scaler
                    or self._compiled._zero_stage != self.sharding_stage):
                # rebuild on change (the reference's re-wrap semantics),
                # from the trained weights
                self._compiled.sync_to_layers()
                old = self._compiled
                self._compiled = None
            if self._compiled is None:
                self._compiled = _CompiledPipelineStep(
                    self._layers, optimizer, self._pp_mesh_axis(), acc,
                    use_scaler=live_scaler,
                    zero_stage=self.sharding_stage)
                if old is not None and old._optimizer is optimizer:
                    # the SAME optimizer: its state (moments, step count)
                    # carries across the rebuild
                    self._compiled.adopt_opt_state(old.opt_state)
            if live_scaler:
                loss, finite = self._compiled.step(
                    x, y, scale=scaler.get_loss_scaling())
                scaler._found_inf = not finite
                scaler._last_skipped = not finite
                scaler._update()
            else:
                loss, _ = self._compiled.step(x, y)
            if lr_scheduler is not None:
                lr_scheduler.step()
            return loss
        mb = batch // acc
        total = None
        for i in range(acc):
            xi = x[i * mb:(i + 1) * mb]
            yi = y[i * mb:(i + 1) * mb]
            # forward through the stage chunks in order (the in-process
            # analogue of recv_forward -> stage -> send_forward)
            h = xi
            for s in range(self._layers.num_stages):
                for layer in self._layers.get_stage_layers(s):
                    h = layer(h)
            if self._layers.loss_fn is not None:
                loss = self._layers.loss_fn(h, yi)
            else:
                loss = h.mean()
            scaled = loss / acc
            if scaler is not None:
                scaled = scaler.scale(scaled)
            scaled.backward()  # grads ACCUMULATE across microbatches
            total = loss.detach() if total is None else total + loss.detach()
        if scaler is not None:
            scaler.step(optimizer)
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return total / acc


class PipelinePreconditionError(RuntimeError):
    """This ENVIRONMENT cannot build the canonical pipeline program (too
    few ranks for the mesh), as distinct from a fault in the code that
    builds it."""
