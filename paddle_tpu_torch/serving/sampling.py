"""Sampling for the batched decode step (port of
``paddle_tpu/serving/sampling.py``: ``apply_temperature``,
``apply_top_k``, ``apply_top_p``, ``sample``) — greedy / temperature /
top-k / top-p, vectorised over slots with per-slot parameters.

* Greedy is the FIRST max index (``torch.argmax``, as ``lax.top_k(.., 1)``
  in the JAX package), returned int32.
* top-p keeps a token while the probability mass strictly before it is
  < p (the EXCLUSIVE cumulative mass) and always keeps column 0, so
  ``p == 0`` still emits the top token.
* The Gumbel-max draw takes its noise from an explicit
  ``torch.Generator`` (the engine owns one per instance), never from the
  global stream.  It gives other numbers than the JAX key for the same
  seed: compare sampled output by distribution, greedy output exactly.
"""
from __future__ import annotations

import torch

__all__ = ["sample", "apply_temperature", "apply_top_k", "apply_top_p",
           "filter_logits", "TOP_K_MAX"]

#: static cap for per-slot top-k (requests are clamped host-side)
TOP_K_MAX = 64

_NEG = -1e30


def apply_temperature(logits, temperature):
    """logits: (slots, vocab) — divide by per-slot temperature (f32).
    Zero or negative temperature means greedy; :func:`sample` takes the
    argmax for those slots, so this division only needs to be finite."""
    t = temperature.float().clamp(min=1e-6)
    return logits.float() / t[:, None]


def apply_top_k(logits, top_k, k_max=TOP_K_MAX):
    """Keep logits >= each slot's k-th largest; ``top_k <= 0`` disables."""
    k_max = min(int(k_max), int(logits.shape[-1]))
    vals = torch.topk(logits, k_max, dim=-1).values       # sorted desc
    kth_idx = (top_k.long() - 1).clamp(0, k_max - 1)
    kth = torch.gather(vals, -1, kth_idx[:, None])
    keep = (logits >= kth) | (top_k <= 0)[:, None]
    return logits.masked_fill(~keep, _NEG)


def apply_top_p(logits, top_p):
    """Per-slot nucleus filtering on the softmax of ``logits``; ties at the
    threshold probability are all kept; ``top_p >= 1`` disables."""
    probs = torch.softmax(logits.float(), dim=-1)
    sorted_p = torch.sort(probs, dim=-1, descending=True).values
    mass_before = torch.cumsum(sorted_p, dim=-1) - sorted_p   # exclusive
    keep_sorted = mass_before < top_p.float()[:, None]
    keep_sorted[:, 0] = True
    thresh = torch.where(keep_sorted, sorted_p,
                         torch.full_like(sorted_p, float("inf"))
                         ).min(dim=-1).values
    keep = (probs >= thresh[:, None]) | (top_p >= 1.0)[:, None]
    return logits.masked_fill(~keep, _NEG)


def filter_logits(logits, temperature, top_k, top_p, k_max=TOP_K_MAX):
    """Temperature scaling, then top-k, then top-p."""
    scaled = apply_temperature(logits, temperature)
    return apply_top_p(apply_top_k(scaled, top_k, k_max), top_p)


def sample(logits, generator, temperature, top_k, top_p, k_max=TOP_K_MAX):
    """One sampled (or greedy) token per slot.

    logits: (slots, vocab); generator: a ``torch.Generator`` on the
    logits' device; temperature/top_p: (slots,) float; top_k: (slots,)
    int (<= 0 disables).  Returns (slots,) int32 token ids."""
    greedy_tok = torch.argmax(logits, dim=-1)
    filtered = filter_logits(logits, temperature, top_k, top_p, k_max)
    u = torch.rand(filtered.shape, generator=generator,
                   device=filtered.device, dtype=torch.float32)
    g = -torch.log(-torch.log(u))          # Gumbel(0, 1); u = 0 gives -inf
    sampled_tok = torch.argmax(filtered + g, dim=-1)
    greedy = temperature <= 0.0
    return torch.where(greedy, greedy_tok, sampled_tok).to(torch.int32)
