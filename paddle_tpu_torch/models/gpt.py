"""GPT-2 (port of ``paddle_tpu/models/gpt.py``) for training and serving,
in either layer layout: per layer (``gpt.h.{i}``) or, with
``GPTConfig(scan_layers=True)``, the L blocks as twelve stacked (L, ...)
parameters (``gpt.h_stack``, :class:`GPTScanBlocks`).

Pre-LN transformer with a tied LM head (``logits = x @ wte^T``).  Module
and parameter names are the JAX package's (``gpt.h.{i}.attn.qkv_proj.weight``
of shape (H, 3H), ``gpt.h_stack.qkv_w`` of shape (L, H, 3H), ...), so its
state dict loads by name through :mod:`paddle_tpu_torch.convert`, and
:func:`scan_state_to_per_layer` / :func:`per_layer_state_to_scan` map a
state between the layouts.  Attention goes through
``F.scaled_dot_product_attention`` (the CUDA flash kernels on a card,
forward and backward) or, with a serving cache view, through the view's
append-and-attend.  ``use_recompute`` runs each block under
:func:`paddle_tpu_torch.distributed.recompute` while training.
:class:`GPTPretrainingCriterion` is the training loss.

**Megatron layout.**  The parameters carry the JAX package's ``pspec``
annotations (:data:`MEGATRON`: ``qkv_proj`` and ``fc1`` column-sharded on
``mp``, ``out_proj`` and ``fc2`` row-sharded, ``wte`` vocab-sharded) and
``mp_parts`` (3 on the fused q/k/v projection).  After
:func:`paddle_tpu_torch.distributed.parallelize` over a mesh whose
``mp`` axis has more than one rank, a rank holds the q, k and v columns
of its own ``heads / mp`` heads, and the per-layer blocks run the
Megatron collectives (:mod:`..distributed.mp_layers`): the input of each
column-parallel matmul passes :func:`copy_to_mp`, the output of each
row-parallel one :func:`reduce_from_mp` before its (replicated) bias, the
token lookup is vocab-parallel, and the tied LM head returns the rank's
vocab shard of the logits, tagged so that the loss takes the
vocab-parallel softmax-CE.  The stacked layout runs the same
collectives at ``mp > 1``: ``parallelize`` deals its (L, ...) parameters
on the dims of their per-layer counterparts, q/k/v by heads in every
layer's slice.

**Overlap islands.**  With the ``mp_overlap`` switch on
(``overlap_comm``; :mod:`..distributed.mp_overlap`), the sites of the
JAX package's islands run them over the model's ``mp`` group: the
``out_proj`` and ``fc2`` row matmuls as the reduce-scatter / all-gather
ring (per layer and in the stacked block) and the tied LM head as the
rotate-weights ring, whose full logits the loss then takes by the plain
softmax-CE, as in JAX.  (The vocab-parallel lookup is JAX's
``vocab_embed`` island with the switch on or off.)  Under a serving
cache the fused q/k/v projection is the JAX ``qkv_heads`` island's
place; the rank's projection here is dealt by heads already, so it is
the local matmul, counted as an island (ROADMAP.md §C).  Off, or on a
model without an ``mp`` group, every site is the monolithic one.
"""
from __future__ import annotations

import dataclasses
import math
import re

import numpy as np
import torch
from torch import nn

from ..distributed import mp_overlap as _mpo
from ..distributed.mesh import PartitionSpec as P
from ..distributed.mp_layers import (copy_to_mp, mark_vocab_parallel,
                                     reduce_from_mp, vocab_parallel_embedding)
from ..nn import functional as F
from ..nn.layer.common import Dropout, Embedding, Linear, upscale_dropout
from ..nn.layer.norm import LayerNorm

#: name suffix -> (pspec, mp_parts): the JAX package's Megatron
#: annotations (gpt.py's qkv/fc1 column-, out/fc2 row-, wte vocab-sharded),
#: with the fused q/k/v columns dealt in three parts (the module docstring)
MEGATRON = {
    "attn.qkv_proj.weight": (P(None, "mp"), 3),
    "attn.qkv_proj.bias": (P("mp"), 3),
    "attn.out_proj.weight": (P("mp", None), 1),
    "mlp.fc1.weight": (P(None, "mp"), 1),
    "mlp.fc1.bias": (P("mp"), 1),
    "mlp.fc2.weight": (P("mp", None), 1),
    "gpt.wte.weight": (P("mp", None), 1),
    "lm_head.weight": (P(None, "mp"), 1),
    "h_stack.qkv_w": (P(None, None, "mp"), 3),
    "h_stack.qkv_b": (P(None, "mp"), 3),
    "h_stack.out_w": (P(None, "mp", None), 1),
    "h_stack.fc1_w": (P(None, None, "mp"), 1),
    "h_stack.fc1_b": (P(None, "mp"), 1),
    "h_stack.fc2_w": (P(None, "mp", None), 1),
}


def megatron_layout(name):
    """(pspec, mp_parts) of the parameter ``name``; (None, 1) for a
    replicated one."""
    for suffix, layout in MEGATRON.items():
        if name == suffix or name.endswith("." + suffix):
            return layout
    return None, 1


def _mp(module):
    return getattr(module, "_mp_group", None)


def _column(x, lin, group):
    """A column-parallel ``Linear``: its input through ``copy_to_mp``."""
    return lin(copy_to_mp(x, group))


def _row_raw(x, w, b, group, k_dim):
    """A row-parallel ``x @ w + b`` over the rank's rows ``w`` of a
    contraction dim of global size ``k_dim``: the overlapped ring where
    the switch is on, else the partial products summed over ``group``,
    then the replicated bias."""
    if group is None:
        return x @ w + b
    if _mpo.row_viable(k_dim, group=group):
        return _mpo.row_parallel_matmul(x, w, b, group=group)
    return reduce_from_mp(x @ w, group) + b


def _row(x, lin, group, k_dim):
    """A row-parallel ``Linear`` (:func:`_row_raw`)."""
    if group is None:
        return lin(x)
    return _row_raw(x, lin.weight, lin.bias, group, k_dim)


def _note_qkv_island(num_heads, head_dim, group, cache):
    """Under a serving cache, the JAX model runs the ``qkv_heads`` island
    at the fused projection; the port's rank holds the q, k and v columns
    of its own heads already, so its island is the local projection:
    counted as JAX counts it."""
    if cache is not None and group is not None \
            and _mpo.qkv_viable(num_heads, head_dim, group=group):
        _mpo._note_chunks(1)


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304          # 50257 padded to a multiple of 128
    max_position_embeddings: int = 1024
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    hidden_dropout_prob: float = 0.1
    attention_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    layer_norm_epsilon: float = 1e-5
    tie_word_embeddings: bool = True
    # activation recompute per block while training: the block's
    # activations are made again in the backward instead of kept
    use_recompute: bool = False
    # the L blocks as stacked (L, ...) parameters (GPTScanBlocks); the
    # optimizer then sees twelve large tensors instead of 12 L small ones
    scan_layers: bool = False
    # the JAX package's lax.scan unroll factor and how its stacked grads
    # accumulate ("scan" or "stack_vjp"); in eager PyTorch both modes are
    # one loop over unbind views whose backward is one stack a parameter,
    # and the unroll factor has nothing to unroll (ROADMAP.md §C)
    scan_unroll: int = 1
    scan_mode: str = "scan"

    @classmethod
    def gpt2_small(cls):
        return cls(hidden_size=768, num_hidden_layers=12,
                   num_attention_heads=12, intermediate_size=3072)

    @classmethod
    def gpt2_medium(cls):  # the 345M configuration
        return cls(hidden_size=1024, num_hidden_layers=24,
                   num_attention_heads=16, intermediate_size=4096)

    @classmethod
    def tiny(cls):  # for tests
        return cls(vocab_size=512, max_position_embeddings=128,
                   hidden_size=64, num_hidden_layers=2,
                   num_attention_heads=4, intermediate_size=128,
                   hidden_dropout_prob=0.0, attention_dropout_prob=0.0)


class GPTAttention(nn.Module):
    def __init__(self, config: GPTConfig):
        super().__init__()
        c = config
        self.num_heads = c.num_attention_heads
        self.head_dim = c.hidden_size // c.num_attention_heads
        self.hidden_size = c.hidden_size
        self.qkv_proj = Linear(c.hidden_size, 3 * c.hidden_size)
        self.out_proj = Linear(c.hidden_size, c.hidden_size)
        self.attn_dropout_p = c.attention_dropout_prob
        self.resid_dropout = Dropout(c.hidden_dropout_prob)
        # draws the attention-probability dropout masks (None: PyTorch's
        # default generator); jit.TrainStep sets its own
        self.generator = None

    def forward(self, x, cache=None):
        b, s, _ = x.shape
        g = _mp(self)
        _note_qkv_island(self.num_heads, self.head_dim, g, cache)
        qkv = _column(x, self.qkv_proj, g)
        # this rank's width: all heads, or its heads / mp under mp
        hd = self.head_dim
        h = qkv.shape[-1] // 3
        nh = h // hd
        # q/k/v as last-dim slices of the fused projection: views with
        # dense (heads, head_dim) inner dims, which the flash kernel reads
        # in place
        q = qkv[:, :, :h].reshape(b, s, nh, hd)
        k = qkv[:, :, h:2 * h].reshape(b, s, nh, hd)
        v = qkv[:, :, 2 * h:].reshape(b, s, nh, hd)
        if cache is not None:
            out = cache.attend(q, k, v)
        else:
            out = F.scaled_dot_product_attention(
                q, k, v, dropout_p=self.attn_dropout_p, is_causal=True,
                training=self.training, generator=self.generator)
        out = out.reshape(b, s, h)
        return self.resid_dropout(_row(out, self.out_proj, g,
                                       self.hidden_size))


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig):
        super().__init__()
        c = config
        self.fc1 = Linear(c.hidden_size, c.intermediate_size)
        self.fc2 = Linear(c.intermediate_size, c.hidden_size)
        self.dropout = Dropout(c.hidden_dropout_prob)
        self.intermediate_size = c.intermediate_size

    def forward(self, x):
        g = _mp(self)
        return self.dropout(_row(F.gelu(_column(x, self.fc1, g),
                                        approximate=True), self.fc2, g,
                                 self.intermediate_size))


class GPTBlock(nn.Module):
    def __init__(self, config: GPTConfig):
        super().__init__()
        self.ln1 = LayerNorm(config.hidden_size, config.layer_norm_epsilon)
        self.attn = GPTAttention(config)
        self.ln2 = LayerNorm(config.hidden_size, config.layer_norm_epsilon)
        self.mlp = GPTMLP(config)

    def forward(self, x, cache=None):
        x = x + self.attn(self.ln1(x), cache)
        return x + self.mlp(self.ln2(x))


#: stacked-parameter field -> per-layer submodule path (the state maps)
_SCAN_FIELD_MAP = {
    "ln1_w": "ln1.weight", "ln1_b": "ln1.bias",
    "qkv_w": "attn.qkv_proj.weight", "qkv_b": "attn.qkv_proj.bias",
    "out_w": "attn.out_proj.weight", "out_b": "attn.out_proj.bias",
    "ln2_w": "ln2.weight", "ln2_b": "ln2.bias",
    "fc1_w": "mlp.fc1.weight", "fc1_b": "mlp.fc1.bias",
    "fc2_w": "mlp.fc2.weight", "fc2_b": "mlp.fc2.bias",
}


def _scan_block_apply(x, p, cfg, training, generator=None, cache=None,
                      group=None):
    """One block over the per-layer tensors ``p`` (views of the stacked
    parameters).  The same functionals in the same order as
    :class:`GPTBlock` (``h @ w + b`` as ``Linear``, ``F.layer_norm``,
    ``F.gelu(approximate=True)``, ``F.scaled_dot_product_attention`` or
    the cache view's ``attend``, dropout masks drawn from ``generator`` in
    the per-layer block's order, and under an ``mp`` ``group`` the same
    collectives and islands), so both layouts give the same bits."""
    h_sz = cfg.hidden_size
    nh = cfg.num_attention_heads
    hd = h_sz // nh
    b, s = x.shape[0], x.shape[1]
    p_drop = cfg.hidden_dropout_prob
    h = F.layer_norm(x, [h_sz], p["ln1_w"], p["ln1_b"],
                     cfg.layer_norm_epsilon)
    _note_qkv_island(nh, hd, group, cache)
    qkv = copy_to_mp(h, group) @ p["qkv_w"] + p["qkv_b"]
    # this rank's width: all heads, or its heads / mp under mp
    hl = qkv.shape[-1] // 3
    nhl = hl // hd
    q = qkv[:, :, :hl].reshape(b, s, nhl, hd)
    k = qkv[:, :, hl:2 * hl].reshape(b, s, nhl, hd)
    v = qkv[:, :, 2 * hl:].reshape(b, s, nhl, hd)
    if cache is not None:
        out = cache.attend(q, k, v)
    else:
        out = F.scaled_dot_product_attention(
            q, k, v, dropout_p=cfg.attention_dropout_prob, is_causal=True,
            training=training, generator=generator)
    out = out.reshape(b, s, hl)
    x = x + upscale_dropout(_row_raw(out, p["out_w"], p["out_b"], group,
                                     h_sz), p_drop, training, generator)
    h2 = F.layer_norm(x, [h_sz], p["ln2_w"], p["ln2_b"],
                      cfg.layer_norm_epsilon)
    m = F.gelu(copy_to_mp(h2, group) @ p["fc1_w"] + p["fc1_b"],
               approximate=True)
    return x + upscale_dropout(_row_raw(m, p["fc2_w"], p["fc2_b"], group,
                                        cfg.intermediate_size), p_drop,
                               training, generator)


class GPTScanBlocks(nn.Module):
    """The L transformer blocks as twelve stacked (L, ...) parameters
    (port of the JAX package's ``GPTScanBlocks``), named as there
    (``qkv_w`` (L, H, 3H), ``ln1_w`` (L, H), ...).

    The forward slices every stacked parameter once with
    ``torch.unbind`` and runs the layers in a loop: the backward of the
    slices is one ``torch.stack`` a parameter, the exact cotangent of
    disjoint slices and the JAX ``stack_vjp`` contract (indexing
    ``stacked[i]`` per layer would make autograd write a full-size zero
    tensor per layer and parameter).  With a serving cache view each
    layer attends through the view, whose layer cursor advances per
    ``attend``; in a captured step the slices are views at fixed
    addresses, so an in-place update is read live."""

    #: amp.decorate(level="O2") keeps these f32 (the LayerNorm parameters,
    #: which a LayerNorm module would keep by its type)
    _amp_keep_fp32_params = ("ln1_w", "ln1_b", "ln2_w", "ln2_b")

    def __init__(self, config: GPTConfig):
        super().__init__()
        c = config
        self.config = c
        L, H, Iz = c.num_hidden_layers, c.hidden_size, c.intermediate_size
        std = c.initializer_range
        out_std = std / math.sqrt(2 * L)

        def normal(shape, sd):
            return nn.Parameter(torch.empty(shape).normal_(0.0, sd))
        self.ln1_w = nn.Parameter(torch.ones(L, H))
        self.ln1_b = nn.Parameter(torch.zeros(L, H))
        self.qkv_w = normal((L, H, 3 * H), std)
        self.qkv_b = nn.Parameter(torch.zeros(L, 3 * H))
        self.out_w = normal((L, H, H), out_std)
        self.out_b = nn.Parameter(torch.zeros(L, H))
        self.ln2_w = nn.Parameter(torch.ones(L, H))
        self.ln2_b = nn.Parameter(torch.zeros(L, H))
        self.fc1_w = normal((L, H, Iz), std)
        self.fc1_b = nn.Parameter(torch.zeros(L, Iz))
        self.fc2_w = normal((L, Iz, H), out_std)
        self.fc2_b = nn.Parameter(torch.zeros(L, H))
        # draws the dropout masks (None: PyTorch's default generator);
        # jit.TrainStep sets its own
        self.generator = None

    def _block(self, x, p, cache=None):
        return _scan_block_apply(x, p, self.config, self.training,
                                 self.generator, cache, _mp(self))

    def forward(self, x, cache=None):
        c = self.config
        per = {n: torch.unbind(getattr(self, n), 0) for n in _SCAN_FIELD_MAP}
        rc = c.use_recompute and self.training and cache is None
        if rc:
            from ..distributed.recompute import recompute
        for i in range(c.num_hidden_layers):
            p = {n: per[n][i] for n in per}
            x = recompute(self._block, x, p) if rc else self._block(x, p,
                                                                    cache)
        return x


def _stack(values):
    if isinstance(values[0], torch.Tensor):
        return torch.stack(values)
    return np.stack([np.asarray(v) for v in values])


def scan_state_to_per_layer(state):
    """A scan-layers model's state (``gpt.h_stack.qkv_w``: (L, H, 3H))
    under per-layer names (``gpt.h.{i}.attn.qkv_proj.weight``), as
    tensors or numpy arrays; other entries pass through."""
    out = {}
    for k, v in state.items():
        if ".h_stack." in k:
            prefix, field = k.rsplit(".h_stack.", 1)
            sub = _SCAN_FIELD_MAP[field]
            for i in range(int(v.shape[0])):
                out["%s.h.%d.%s" % (prefix, i, sub)] = v[i]
        else:
            out[k] = v
    return out


def per_layer_state_to_scan(state):
    """Inverse of :func:`scan_state_to_per_layer`: the per-layer entries
    stacked into the scan model's (L, ...) ones; other entries pass
    through."""
    pat = re.compile(r"^(.*)\.h\.(\d+)\.(.+)$")
    rev = {v: k for k, v in _SCAN_FIELD_MAP.items()}
    out, groups = {}, {}
    for k, v in state.items():
        m = pat.match(k)
        if m and m.group(3) in rev:
            key = (m.group(1), rev[m.group(3)])
            groups.setdefault(key, {})[int(m.group(2))] = v
        else:
            out[k] = v
    for (prefix, field), per in groups.items():
        idxs = sorted(per)
        if idxs != list(range(len(idxs))):
            raise ValueError("per-layer state has gaps for %s.h.*.%s: %r"
                             % (prefix, _SCAN_FIELD_MAP[field], idxs))
        out["%s.h_stack.%s" % (prefix, field)] = _stack(
            [per[i] for i in idxs])
    return out


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig):
        super().__init__()
        self.config = config
        c = config
        self.wte = Embedding(c.vocab_size, c.hidden_size)
        self.wpe = Embedding(c.max_position_embeddings, c.hidden_size)
        self.drop = Dropout(c.hidden_dropout_prob)
        if c.scan_layers:
            self.h_stack = GPTScanBlocks(c)
        else:
            self.h = nn.ModuleList([GPTBlock(c)
                                    for _ in range(c.num_hidden_layers)])
        self.ln_f = LayerNorm(c.hidden_size, c.layer_norm_epsilon)

    def forward(self, input_ids, position_ids=None, cache=None):
        from ..serving.cache import (DecodeView, PagedDecodeView,
                                     PagedKVCache, SlottedKVCache,
                                     is_cache_view)
        b, s = input_ids.shape
        view, finalize = None, False
        if cache is not None:
            # a bare cache means batched decode; the caller gets the
            # advanced cache back
            if isinstance(cache, SlottedKVCache):
                cache, finalize = DecodeView(cache), True
            elif isinstance(cache, PagedKVCache):
                cache, finalize = PagedDecodeView(cache), True
            if not is_cache_view(cache):
                raise TypeError("cache must be a SlottedKVCache, a "
                                "PagedKVCache or a serving cache view; got "
                                "%r" % (type(cache).__name__,))
            view = cache
        if position_ids is None:
            if view is not None:
                position_ids = view.position_ids(b, s)
            else:
                position_ids = torch.arange(
                    s, dtype=torch.int32, device=input_ids.device)[None, :]
        g = _mp(self)
        # under mp, the masked local gather and one all-reduce: the JAX
        # package's vocab_embed island, here with the switch on or off
        tok = (self.wte(input_ids) if g is None else
               vocab_parallel_embedding(input_ids, self.wte.weight, g))
        x = self.drop(tok + self.wpe(position_ids))
        if self.config.scan_layers:
            x = self.h_stack(x, view)
        else:
            rc = self.config.use_recompute and self.training and view is None
            if rc:
                from ..distributed.recompute import recompute
            for block in self.h:
                x = recompute(block, x) if rc else block(x, view)
        x = self.ln_f(x)
        if view is None:
            return x
        return x, (view.finalize() if finalize else view)


class GPTForCausalLM(nn.Module):
    """LM head with tied embeddings.  ``generator`` seeds the parameters
    (the JAX package's initializers: normal(0, initializer_range) for the
    projections and embeddings, scaled by 1/sqrt(2 L) for the output
    projections, stacked or per layer; LayerNorm weights 1, biases 0)."""

    def __init__(self, config: GPTConfig, generator=None):
        super().__init__()
        self.config = config
        self.gpt = GPTModel(config)
        if not config.tie_word_embeddings:
            self.lm_head = Linear(config.hidden_size, config.vocab_size,
                                  bias_attr=False)
        self._init_weights(generator)
        self._tag_layout()

    def _tag_layout(self):
        """Set each parameter's ``pspec`` and ``mp_parts`` from
        :data:`MEGATRON` (``parallelize`` calls it again: a parameter's
        deep copy drops its attributes)."""
        for name, p in self.named_parameters():
            spec, parts = megatron_layout(name)
            if spec is not None:
                p.pspec, p.mp_parts = spec, parts

    def _check_parallel(self):
        """Called by ``parallelize``: what the tensor-parallel forward
        does not run raises here, before any step."""
        g = _mp(self)
        if g is None:
            return
        c = self.config
        if c.num_attention_heads % g.nranks:
            raise ValueError("mp=%d must divide num_attention_heads=%d"
                             % (g.nranks, c.num_attention_heads))

    @torch.no_grad()
    def _init_weights(self, generator):
        c = self.config
        std = c.initializer_range
        out_std = std / math.sqrt(2 * c.num_hidden_layers)
        for name, p in self.named_parameters():
            if name.endswith(("out_proj.weight", "fc2.weight",
                              "h_stack.out_w", "h_stack.fc2_w")):
                p.normal_(0.0, out_std, generator=generator)
            elif name.endswith(("qkv_proj.weight", "fc1.weight",
                                "h_stack.qkv_w", "h_stack.fc1_w",
                                "wte.weight", "wpe.weight",
                                "lm_head.weight")):
                p.normal_(0.0, std, generator=generator)

    def forward(self, input_ids, position_ids=None, cache=None):
        if cache is not None:
            x, cache = self.gpt(input_ids, position_ids, cache)
        else:
            x = self.gpt(input_ids, position_ids)
        g = _mp(self)
        if self.config.tie_word_embeddings and g is not None \
                and _mpo.lm_viable(self.config.vocab_size, group=g):
            # the rotate-weights ring: full logits on every rank, for the
            # plain CE
            logits = _mpo.lm_head_matmul(x, self.gpt.wte.weight, group=g)
        else:
            if self.config.tie_word_embeddings:
                logits = copy_to_mp(x, g) @ self.gpt.wte.weight.t()
            else:
                logits = _column(x, self.lm_head, g)
            # under mp: the rank's vocab shard, for the vocab-parallel CE
            logits = mark_vocab_parallel(logits, g)
        if cache is not None:
            return logits, cache
        return logits

    def _local_heads(self):
        """The heads this rank computes: all, or heads / mp under mp."""
        g = _mp(self)
        return self.config.num_attention_heads // (1 if g is None
                                                   else g.nranks)

    def gen_cache(self, batch_size, dtype=None, max_len=None, device=None,
                  kv_dtype=None):
        """A preallocated slotted KV cache (``serving.cache.SlottedKVCache``)
        with ``batch_size`` slots, on the model's device and in its
        embedding dtype unless given; ``kv_dtype`` ("int8", "fp8")
        quantizes it."""
        from ..core.dtype import convert_dtype
        from ..serving.cache import SlottedKVCache
        c = self.config
        w = self.gpt.wte.weight
        return SlottedKVCache.create(
            batch_size, c.num_hidden_layers,
            max_len or c.max_position_embeddings, self._local_heads(),
            c.hidden_size // c.num_attention_heads,
            w.dtype if dtype is None else convert_dtype(dtype),
            w.device if device is None else device, kv_dtype=kv_dtype)

    def gen_paged_cache(self, batch_size, dtype=None, max_len=None,
                        page_size=64, device=None, kv_dtype=None):
        """A preallocated paged KV cache (``serving.cache.PagedKVCache``)
        with a DENSE identity page table — slot ``i`` owns its own page
        run, so model-level use needs no allocator (the serving engine
        builds the pooled, shared layout through ``serving.pages``).
        ``model(x, cache=paged)`` decodes through the page-gather
        attention; capacity matches :meth:`gen_cache`; ``kv_dtype``
        quantizes it."""
        from ..core.dtype import convert_dtype
        from ..serving.cache import PagedKVCache
        c = self.config
        w = self.gpt.wte.weight
        max_len = int(max_len or c.max_position_embeddings)
        return PagedKVCache.create_dense(
            batch_size, c.num_hidden_layers, max_len, self._local_heads(),
            c.hidden_size // c.num_attention_heads,
            min(int(page_size), max_len),
            w.dtype if dtype is None else convert_dtype(dtype),
            w.device if device is None else device, kv_dtype=kv_dtype)


class GPTPretrainingCriterion(nn.Module):
    """Shifted causal-LM loss (port of ``paddle_tpu.models.gpt.
    GPTPretrainingCriterion``).  The shift goes through the labels, not
    the logits: the labels move left by one with ``-100`` (ignored) at
    the last position, so no (B, S-1, V) copy of the logits is made; the
    mean over all B*S positions is then divided by (S-1)/S, which makes
    it the mean over the S-1 real ones.  With ``loss_mask`` the mask
    shifts alike and the loss is the masked mean."""

    def forward(self, logits, labels, loss_mask=None):
        b, s = labels.shape[0], labels.shape[1]
        targets = torch.cat(
            [labels[:, 1:], torch.full((b, 1), -100, dtype=labels.dtype,
                                       device=labels.device)], dim=1)
        loss = F.cross_entropy(logits, targets, reduction="none",
                               ignore_index=-100)
        if loss_mask is not None:
            mask = torch.cat([loss_mask[:, 1:],
                              torch.zeros((b, 1), dtype=loss_mask.dtype,
                                          device=loss_mask.device)], dim=1)
            return (loss * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        return loss.mean() / (float(s - 1) / float(s))
