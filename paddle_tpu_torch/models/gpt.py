"""GPT-2 (port of ``paddle_tpu/models/gpt.py``), per-layer layout,
inference only.

Pre-LN transformer with a tied LM head (``logits = x @ wte^T``).  Module
and parameter names are the JAX package's (``gpt.h.{i}.attn.qkv_proj.weight``
of shape (H, 3H), ...), so its state dict loads by name through
:mod:`paddle_tpu_torch.convert`.  Attention goes through
``F.scaled_dot_product_attention`` (the CUDA flash forward on a card) or,
with a serving cache view, through the view's append-and-attend.

Not ported yet (ROADMAP.md): the loss criterion, activation recompute,
the scan-layers layout, the Megatron pspec annotations and the
tensor-parallel overlap islands.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..nn import functional as F
from ..nn.layer.common import Dropout, Embedding, Linear
from ..nn.layer.norm import LayerNorm


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

    def forward(self, x, cache=None):
        b, s, _ = x.shape
        h, nh, hd = self.hidden_size, self.num_heads, self.head_dim
        qkv = self.qkv_proj(x)
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
                training=self.training)
        out = out.reshape(b, s, h)
        return self.resid_dropout(self.out_proj(out))


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig):
        super().__init__()
        c = config
        self.fc1 = Linear(c.hidden_size, c.intermediate_size)
        self.fc2 = Linear(c.intermediate_size, c.hidden_size)
        self.dropout = Dropout(c.hidden_dropout_prob)

    def forward(self, x):
        return self.dropout(self.fc2(F.gelu(self.fc1(x), approximate=True)))


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


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig):
        super().__init__()
        self.config = config
        c = config
        self.wte = Embedding(c.vocab_size, c.hidden_size)
        self.wpe = Embedding(c.max_position_embeddings, c.hidden_size)
        self.drop = Dropout(c.hidden_dropout_prob)
        self.h = nn.ModuleList([GPTBlock(c)
                                for _ in range(c.num_hidden_layers)])
        self.ln_f = LayerNorm(c.hidden_size, c.layer_norm_epsilon)

    def forward(self, input_ids, position_ids=None, cache=None):
        from ..serving.cache import (DecodeView, SlottedKVCache,
                                     is_cache_view)
        b, s = input_ids.shape
        view, finalize = None, False
        if cache is not None:
            if isinstance(cache, SlottedKVCache):
                # a bare cache means batched decode; the caller gets the
                # advanced cache back
                cache, finalize = DecodeView(cache), True
            if not is_cache_view(cache):
                raise TypeError("cache must be a SlottedKVCache or a "
                                "serving cache view; got %r"
                                % (type(cache).__name__,))
            view = cache
        if position_ids is None:
            if view is not None:
                position_ids = view.position_ids(b, s)
            else:
                position_ids = torch.arange(
                    s, dtype=torch.int32, device=input_ids.device)[None, :]
        x = self.drop(self.wte(input_ids) + self.wpe(position_ids))
        for block in self.h:
            x = block(x, view)
        x = self.ln_f(x)
        if view is None:
            return x
        return x, (view.finalize() if finalize else view)


class GPTForCausalLM(nn.Module):
    """LM head with tied embeddings.  ``generator`` seeds the parameters
    (the JAX package's initializers: normal(0, initializer_range) for the
    projections and embeddings, scaled by 1/sqrt(2 L) for the output
    projections; LayerNorm weights 1, biases 0)."""

    def __init__(self, config: GPTConfig, generator=None):
        super().__init__()
        self.config = config
        self.gpt = GPTModel(config)
        if not config.tie_word_embeddings:
            self.lm_head = Linear(config.hidden_size, config.vocab_size,
                                  bias_attr=False)
        self._init_weights(generator)

    @torch.no_grad()
    def _init_weights(self, generator):
        c = self.config
        std = c.initializer_range
        out_std = std / math.sqrt(2 * c.num_hidden_layers)
        for name, p in self.named_parameters():
            if name.endswith(("out_proj.weight", "fc2.weight")):
                p.normal_(0.0, out_std, generator=generator)
            elif name.endswith(("qkv_proj.weight", "fc1.weight",
                                "wte.weight", "wpe.weight",
                                "lm_head.weight")):
                p.normal_(0.0, std, generator=generator)

    def forward(self, input_ids, position_ids=None, cache=None):
        if cache is not None:
            x, cache = self.gpt(input_ids, position_ids, cache)
        else:
            x = self.gpt(input_ids, position_ids)
        if self.config.tie_word_embeddings:
            logits = x @ self.gpt.wte.weight.t()
        else:
            logits = self.lm_head(x)
        if cache is not None:
            return logits, cache
        return logits

    def gen_cache(self, batch_size, dtype=None, max_len=None, device=None):
        """A preallocated slotted KV cache (``serving.cache.SlottedKVCache``)
        with ``batch_size`` slots, on the model's device and in its
        embedding dtype unless given."""
        from ..core.dtype import convert_dtype
        from ..serving.cache import SlottedKVCache
        c = self.config
        w = self.gpt.wte.weight
        return SlottedKVCache.create(
            batch_size, c.num_hidden_layers,
            max_len or c.max_position_embeddings, c.num_attention_heads,
            c.hidden_size // c.num_attention_heads,
            w.dtype if dtype is None else convert_dtype(dtype),
            w.device if device is None else device)
