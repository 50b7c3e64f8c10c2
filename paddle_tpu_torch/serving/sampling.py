"""Sampling for the batched decode step (port of
``paddle_tpu/serving/sampling.py``: ``apply_temperature``,
``apply_top_k``, ``apply_top_p``, ``filter_logits``, ``sample``,
``spec_accept``) — greedy / temperature /
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

__all__ = ["sample", "spec_accept", "apply_temperature", "apply_top_k",
           "apply_top_p", "filter_logits", "TOP_K_MAX"]

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


def spec_accept(logits, tokens, generator, temperature, top_k, top_p,
                k_max=TOP_K_MAX, max_accept=None):
    """Accept or resample for the batched speculative verify step (port
    of ``paddle_tpu.serving.sampling.spec_accept``).

    logits: (slots, k+1, vocab) — position ``j`` was scored after the
    model read ``tokens[:, :j+1]``; tokens: (slots, k+1) =
    ``[last committed token, draft_1..draft_k]``; temperature/top_p:
    (slots,) float; top_k: (slots,) int; max_accept: optional (slots,)
    int cap on accepted drafts (the engine passes ``max_len - 1 -
    lengths``, so acceptance never reaches past the cache's room).

    Returns ``(emitted, counts)``: emitted (slots, k+1) int32 whose row
    holds the accepted drafts and then ONE sampled or corrected token
    (zeros beyond); counts (slots,) int32 = accepted + 1, the usable
    tokens of the row and the slot's length advance.

    Greedy slots accept ``d_j`` iff it is the raw logits' argmax at
    ``j`` (the first maximum), so their tokens are those of sequential
    greedy decode.  Sampling slots accept with probability
    ``p_filtered(d_j)``; a rejection draws again from the filtered
    distribution with ``d_j`` masked out.  A stop forced by the cap is
    not a rejection and masks nothing.  The generator gives two draws
    in this order on every call, whatever the accept count: uniforms
    (slots, k), then Gumbel noise (slots, vocab)."""
    S, K1, V = logits.shape
    k = K1 - 1
    dev = logits.device
    greedy_tok = torch.argmax(logits, dim=-1)                   # (S, K1)

    def rep(a):
        return a[:, None].expand(S, K1).reshape(S * K1)
    filtered = filter_logits(logits.reshape(S * K1, V), rep(temperature),
                             rep(top_k), rep(top_p), k_max
                             ).reshape(S, K1, V)                # f32
    tokens = tokens.long()
    draft = tokens[:, 1:]                                       # (S, k)
    greedy = temperature <= 0.0
    u = torch.rand((S, k), generator=generator, device=dev,
                   dtype=torch.float32)
    if k:
        probs = torch.softmax(filtered[:, :k, :], dim=-1)
        p_draft = torch.gather(probs, -1, draft[..., None])[..., 0]
        accept = torch.where(greedy[:, None], draft == greedy_tok[:, :k],
                             u < p_draft)
        # accepted prefix length: position j survives iff all of 0..j do
        a0 = torch.cumprod(accept.long(), dim=1).sum(dim=1)
    else:
        a0 = torch.zeros((S,), dtype=torch.long, device=dev)
    a = a0
    if max_accept is not None:
        a = torch.minimum(a, max_accept.long().clamp(min=0))
    # the next token comes from position a's distribution; the rejected
    # draft is masked out only where a real rejection stopped the run
    f_a = torch.gather(filtered, 1,
                       a[:, None, None].expand(S, 1, V))[:, 0, :]
    d_rej = torch.gather(tokens, 1, torch.clamp(a + 1, max=k)[:, None])[:, 0]
    vocab = torch.arange(V, device=dev)
    rejected_here = (a == a0) & (a0 < k)
    mask_rej = rejected_here[:, None] & (vocab[None, :] == d_rej[:, None])
    f_resid = f_a.masked_fill(mask_rej, _NEG)
    noise = torch.rand(f_resid.shape, generator=generator, device=dev,
                       dtype=torch.float32)
    sampled_next = torch.argmax(f_resid - torch.log(-torch.log(noise)),
                                dim=-1)
    greedy_next = torch.gather(greedy_tok, 1, a[:, None])[:, 0]
    next_tok = torch.where(greedy, greedy_next, sampled_next)
    cols = torch.arange(K1, device=dev)[None, :]
    draft_pad = torch.cat([draft, torch.zeros((S, 1), dtype=torch.long,
                                              device=dev)], dim=1)
    emitted = torch.where(cols == a[:, None], next_tok[:, None], draft_pad)
    emitted = torch.where(cols <= a[:, None], emitted,
                          torch.zeros_like(emitted))
    return emitted.to(torch.int32), (a + 1).to(torch.int32)
