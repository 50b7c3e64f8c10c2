"""Decode attention — length-masked attention over the slotted cache
and over one layer's page pool (port of
``paddle_tpu/kernels/decode_attention.py``: ``decode_attention`` with its
default ``masked`` variant, and ``paged_decode_attention`` with its
``paged_gather`` and ``paged_chunked`` variants).

The JAX functions are plain ``jnp`` (no Pallas kernel), so the port is
plain PyTorch.  Query offset ``j`` of a slot with pre-append length ``n``
attends keys ``t <= n + j``.  As in the JAX version, both products read
the input dtype with f32 accumulation (the operands are widened to f32,
which is exact), the softmax statistics are f32, and ``p`` is cast back
to the input dtype before the second product.

The paged variants are the ``decode_attn_paged`` autotune family, as in
the JAX package: candidate [0] is the one-shot gather, then the chunked
variant at each ``pages_per_block`` that divides ``max_pages``.  Not
ported yet (ROADMAP.md §A3): the slotted ``chunked`` variant and its
``decode_attn`` family, and the int8/fp8 ``_q8`` variants.
"""
from __future__ import annotations

import math

import torch

_NEG_INF = -1e30


def _scale(scale, d):
    return 1.0 / math.sqrt(float(d)) if scale is None else float(scale)


def _masked(q, k, v, pos, scale):
    """One-shot masked softmax attention (f32 statistics)."""
    s, t = q.shape[1], k.shape[1]
    # (B, s, H, D) x (B, T, H, D) -> (B, H, s, T), f32 accumulation
    logits = torch.einsum("bqhd,bthd->bhqt", q.float(), k.float())
    logits = logits * _scale(scale, q.shape[-1])
    t_ids = torch.arange(t, dtype=torch.int32, device=q.device)
    q_pos = pos[:, None] + torch.arange(s, dtype=torch.int32,
                                        device=q.device)[None, :]
    valid = t_ids[None, None, None, :] <= q_pos[:, None, :, None]
    logits = logits.masked_fill(~valid, _NEG_INF)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhqt,bthd->bqhd", p.float(), v.float())
    return out.to(q.dtype)


def decode_attention(q, k, v, lengths, scale=None):
    """Length-masked attention for the slotted decode step.

    q: (slots, s, heads, d); k/v: (slots, max_len, heads, d); lengths:
    (slots,) int32 — each slot's PRE-append valid length (the new rows
    were already written at [lengths, lengths + s))."""
    return _masked(q, k, v, lengths, scale)


def _online_step(carry, q, k_blk, v_blk, t_ids, q_pos, sc):
    """One flash-recurrence step over a key block: f32 statistics carry
    ``(m, l, acc)``; ``t_ids: (block,)`` are the block's global key
    positions, masked against ``q_pos: (b, s)``."""
    m, l, acc = carry
    logits = torch.einsum("bqhd,bthd->bhqt", q.float(), k_blk.float()) * sc
    valid = t_ids[None, None, None, :] <= q_pos[:, None, :, None]
    logits = logits.masked_fill(~valid, _NEG_INF)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    # rows with no valid key yet keep m_new at -1e30; their exp(0) terms
    # are zeroed by ``valid``
    p = torch.exp(logits - m_new[..., None]).masked_fill(~valid, 0.0)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhqt,bthd->bhqd", p.to(q.dtype).float(),
                      v_blk.float())
    return m_new, l_new, acc * corr[..., None] + pv


def _online_init(b, h, s, d, device):
    return (torch.full((b, h, s), _NEG_INF, device=device),
            torch.zeros((b, h, s), device=device),
            torch.zeros((b, h, s, d), device=device))


def _online_finish(carry, q_dtype):
    _m, l, acc = carry
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.transpose(1, 2).to(q_dtype)      # (B,H,s,D) -> (B,s,H,D)


def _gather_pages(kp, table):
    """kp: (pages, P, h, d); table: (B, n) int64 -> (B, n*P, h, d).
    Unmapped entries hold 0: page 0's rows are gathered and discarded by
    the length mask downstream."""
    b, n = table.shape
    return kp[table].reshape(b, n * kp.shape[1], kp.shape[2], kp.shape[3])


def _paged_gather(q, kp, vp, table, pos, scale):
    """One-shot: gather every mapped page, then the masked softmax."""
    return _masked(q, _gather_pages(kp, table), _gather_pages(vp, table),
                   pos, scale)


def _paged_chunked(q, kp, vp, table, pos, scale, pages_per_block):
    """Online softmax over blocks of ``pages_per_block`` pages a slot:
    each step gathers one block and folds it into the flash recurrence,
    so the gathered working set is one block, not ``max_pages * P``
    rows."""
    b, s, h, d = q.shape
    P = int(kp.shape[1])
    m = int(pages_per_block)
    block = m * P
    sc = _scale(scale, d)
    q_pos = pos[:, None] + torch.arange(s, dtype=torch.int32,
                                        device=q.device)[None, :]
    carry = _online_init(b, h, s, d, q.device)
    for c in range(int(table.shape[1]) // m):
        ids = table[:, c * m:(c + 1) * m]
        t_ids = c * block + torch.arange(block, dtype=torch.int32,
                                         device=q.device)
        carry = _online_step(carry, q, _gather_pages(kp, ids),
                             _gather_pages(vp, ids), t_ids, q_pos, sc)
    return _online_finish(carry, q.dtype)


def supported_pages_per_block(max_pages):
    return [m for m in (1, 2, 4, 8) if max_pages % m == 0 and m < max_pages]


def paged_autotune_key(slots, pages, page_size, max_pages, h, d, qlen,
                       dtype, device=None):
    """The ``decode_attn_paged`` key of the JAX package (unquantized, one
    device); ``platform`` follows the device ("gpu" for a card)."""
    from . import autotune as at
    return {"slots": int(slots), "pages": int(pages),
            "page_size": int(page_size), "max_pages": int(max_pages),
            "h": int(h), "d": int(d), "qlen": int(qlen),
            "dtype": str(dtype).replace("torch.", ""),
            "platform": at.platform(device)}


def _paged_candidates(key):
    out = [{"variant": "paged_gather", "config": {}}]
    for m in supported_pages_per_block(key["max_pages"]):
        out.append({"variant": "paged_chunked",
                    "config": {"pages_per_block": m}})
    return out


_RUNNER_OPERANDS = {}


def _paged_runner(cand, key):
    """One candidate on synthetic operands of the key's shapes: a pool of
    ``pages`` pages, each slot mapping ``max_pages`` of them, lengths
    spread over the cache."""
    from . import autotune as at
    ks = at.key_str(key)
    ops = _RUNNER_OPERANDS.get(ks)
    if ops is None:
        dev = torch.device("cuda" if key["platform"] == "gpu" else "cpu")
        dtype = getattr(torch, key["dtype"])
        g = torch.Generator().manual_seed(0)
        b, n, P = key["slots"], key["max_pages"], key["page_size"]
        h, d = key["h"], key["d"]

        def draw(*shape):
            return torch.randn(shape, generator=g).to(dev, dtype)
        table = torch.randperm(max(key["pages"], b * n), generator=g)[
            :b * n].remainder(key["pages"]).reshape(b, n).to(dev)
        lengths = torch.linspace(0, n * P - key["qlen"], b).to(
            dev, torch.int32)
        ops = (draw(b, key["qlen"], h, d), draw(key["pages"], P, h, d),
               draw(key["pages"], P, h, d), table, lengths)
        _RUNNER_OPERANDS[ks] = ops
    m = int(cand["config"].get("pages_per_block", 0)) \
        if cand["variant"] == "paged_chunked" else 0

    def run():
        paged_decode_attention(*ops, pages_per_block=m)
        if ops[0].device.type == "cuda":
            torch.cuda.synchronize(ops[0].device)
    return run


def _paged_cleanup(key):
    from . import autotune as at
    _RUNNER_OPERANDS.pop(at.key_str(key), None)


def resolve_pages_per_block(q, k_pages, page_table):
    """The ``decode_attn_paged`` pick for these operands: 0 for the
    one-shot gather, else the chunked variant's pages a block.  A cached
    or pinned config that does not divide ``max_pages`` falls back to
    the gather, as in the JAX package; it never faults."""
    from . import autotune as at
    key = paged_autotune_key(q.shape[0], k_pages.shape[0], k_pages.shape[1],
                             page_table.shape[1], q.shape[2], q.shape[3],
                             q.shape[1], q.dtype, q.device)
    cand = at.resolve("decode_attn_paged", key)
    if cand.get("variant") != "paged_chunked":
        return 0
    m = int(cand.get("config", {}).get("pages_per_block", 0))
    return m if m > 0 and page_table.shape[1] % m == 0 else 0


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths,
                           scale=None, pages_per_block=None):
    """Length-masked attention over one layer's page pool.

    q: (slots, s, heads, d); k_pages/v_pages: (pages, page_size, heads,
    d); page_table: (slots, max_pages) int64; lengths: (slots,) int32 —
    each slot's PRE-append valid length (the new rows were already
    scattered into the mapped pages, so query offset j attends keys
    t <= lengths + j; unmapped entries gather page 0 and are masked).
    ``pages_per_block``: 0 for the one-shot gather, a divisor of
    max_pages for the chunked variant, None to ask the autotuner
    (:func:`resolve_pages_per_block`; the serving views ask once a
    step)."""
    if pages_per_block is None:
        pages_per_block = resolve_pages_per_block(q, k_pages, page_table)
    if pages_per_block:
        m = int(pages_per_block)
        if page_table.shape[1] % m:
            raise ValueError("pages_per_block %d does not divide max_pages "
                             "%d" % (m, page_table.shape[1]))
        return _paged_chunked(q, k_pages, v_pages, page_table, lengths,
                              scale, m)
    return _paged_gather(q, k_pages, v_pages, page_table, lengths, scale)


def _register_families():
    from . import autotune as at
    at.register_family("decode_attn_paged", _paged_candidates,
                       _paged_runner, cleanup=_paged_cleanup)


_register_families()
