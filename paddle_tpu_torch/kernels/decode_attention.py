"""Decode attention — length-masked attention over the slotted cache
and over one layer's page pool (port of
``paddle_tpu/kernels/decode_attention.py``: ``decode_attention`` with
its ``masked`` and ``chunked`` variants, ``paged_decode_attention`` with
its ``paged_gather`` and ``paged_chunked`` variants, and the quantized
``_q8`` variant of each over int8 or fp8 (e4m3) codes plus per-(row,
head) f32 scales).

The JAX functions are plain ``jnp`` (no Pallas kernel), so the port is
plain PyTorch.  Query offset ``j`` of a slot with pre-append length ``n``
attends keys ``t <= n + j``.  As in the JAX version, both products read
the input dtype with f32 accumulation (the operands are widened to f32,
which is exact), the softmax statistics are f32, and ``p`` is cast back
to the input dtype before the second product.  The q8 variants
dequantize in f32 (codes times scales) and cast once to the compute
dtype.

Each layout is an autotune family, as in the JAX package: ``decode_attn``
(slotted; candidate [0] the one-shot masked softmax, then the chunked
variant at each ``block_t`` that divides ``max_len``) and
``decode_attn_paged`` (candidate [0] the one-shot gather, then the
chunked variant at each ``pages_per_block`` that divides ``max_pages``).
A quantized key carries ``kv_dtype`` and selects the q8 candidates.

The quantization grid is defined here once (:func:`quantize_kv`): the
serving cache writes through it and the autotune runners make their
operands through it.  An fp8 pool is indexed through its bytes
(:func:`raw_bytes`): index reads and writes on ``uint8`` run on every
device, and the codes are read as ``float8_e4m3fn`` only for the cast.
"""
from __future__ import annotations

import math

import torch

__all__ = ["decode_attention", "paged_decode_attention", "autotune_key",
           "paged_autotune_key", "supported_block_ts",
           "supported_pages_per_block", "quantize_kv", "dequantize_kv",
           "raw_bytes", "resolve_block_t", "resolve_pages_per_block"]

_NEG_INF = -1e30

# -- quantized KV grids -----------------------------------------------------

_Q_MAX = 127.0          # int8 symmetric grid
_FP8_MAX = 448.0        # float8_e4m3fn finite max (no inf; past it NaN)

#: kv_dtype key values that select the quantized (codes + scales) paths
_QUANT_KV_DTYPES = ("int8", "float8_e4m3fn")


def _dtype_str(dtype):
    return str(dtype).replace("torch.", "")


def _as_dtype(dtype):
    """A torch dtype from a torch dtype or its name ("int8", ...)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    dt = getattr(torch, str(dtype).strip(), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError("unknown dtype %r" % (dtype,))
    return dt


def _grid_for(code_dtype):
    """(code dtype, grid maximum) of a quantized pool."""
    dt = _as_dtype(code_dtype)
    if dt == torch.int8:
        return dt, _Q_MAX
    if dt == torch.float8_e4m3fn:
        return dt, _FP8_MAX
    raise ValueError("unsupported KV code dtype %r (int8 or "
                     "float8_e4m3fn)" % (code_dtype,))


def raw_bytes(t):
    """``t`` as a tensor that index reads and writes accept on every
    device: a float8 tensor as a ``uint8`` view of its bytes, any other
    tensor as it is."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def quantize_kv(x, code_dtype=torch.int8):
    """Quantize ``x: (..., heads, head_dim)`` to codes and per-(...,
    head) f32 scales, as the JAX package does: the scale is the row's
    amax, floored at 1e-30, over the grid maximum (127 for int8, 448 for
    e4m3).  int8 rounds half to even, then clips; fp8 clips BEFORE the
    cast (e4m3 has no inf, and torch's cast saturates where the JAX
    package's gives NaN, so the clip keeps the two equal) and the cast
    rounds to nearest even."""
    dt, qmax = _grid_for(code_dtype)
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    # divide by a tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, one ulp off the JAX package's scale.
    # The divisor is filled on the device: a tensor made from a Python
    # number would be a host-to-device copy that waits for the stream
    # (and cannot run inside a captured step)
    scale = amax.clamp(min=1e-30) / torch.full_like(amax, qmax)
    scaled = xf / scale[..., None]
    if dt == torch.int8:
        q = torch.round(scaled).clamp(-qmax, qmax)
    else:
        q = scaled.clamp(-qmax, qmax)
    return q.to(dt), scale


def dequantize_kv(codes, scales, dtype):
    """Inverse of :func:`quantize_kv` in the compute dtype: the product
    runs in f32 (both code types widen to f32 exactly) and is cast once."""
    return (codes.float() * scales[..., None]).to(dtype)


# -- shared math --------------------------------------------------------------

def _scale(scale, d):
    return 1.0 / math.sqrt(float(d)) if scale is None else float(scale)


def _q_pos(q, pos):
    s = q.shape[1]
    return pos[:, None] + torch.arange(s, dtype=torch.int32,
                                       device=q.device)[None, :]


def _masked(q, k, v, pos, scale):
    """One-shot masked softmax attention (f32 statistics)."""
    t = k.shape[1]
    # (B, s, H, D) x (B, T, H, D) -> (B, H, s, T), f32 accumulation
    logits = torch.einsum("bqhd,bthd->bhqt", q.float(), k.float())
    logits = logits * _scale(scale, q.shape[-1])
    t_ids = torch.arange(t, dtype=torch.int32, device=q.device)
    valid = t_ids[None, None, None, :] <= _q_pos(q, pos)[:, None, :, None]
    logits = logits.masked_fill(~valid, _NEG_INF)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhqt,bthd->bqhd", p.float(), v.float())
    return out.to(q.dtype)


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


def _online(q, pos, scale, n_blocks, block, kv_block):
    """The flash recurrence over ``n_blocks`` key blocks of ``block``
    rows; ``kv_block(c)`` gives block ``c``'s (K, V) in the compute
    dtype."""
    b, s, h, d = q.shape
    sc = _scale(scale, d)
    q_pos = _q_pos(q, pos)
    carry = _online_init(b, h, s, d, q.device)
    for c in range(n_blocks):
        t_ids = c * block + torch.arange(block, dtype=torch.int32,
                                         device=q.device)
        k_blk, v_blk = kv_block(c)
        carry = _online_step(carry, q, k_blk, v_blk, t_ids, q_pos, sc)
    return _online_finish(carry, q.dtype)


# ---------------------------------------------------------------------------
# slotted variants (the decode_attn family)
# ---------------------------------------------------------------------------

def _chunked(q, k, v, pos, scale, block_t):
    """Online softmax over key chunks of ``block_t`` rows (the flash
    recurrence along time)."""
    return _online(q, pos, scale, k.shape[1] // block_t, block_t,
                   lambda c: (k[:, c * block_t:(c + 1) * block_t],
                              v[:, c * block_t:(c + 1) * block_t]))


def _masked_q8(q, k8, ks, v8, vs, pos, scale):
    """One-shot over the quantized slotted cache: dequantize the rows,
    then the masked softmax."""
    return _masked(q, dequantize_kv(k8, ks, q.dtype),
                   dequantize_kv(v8, vs, q.dtype), pos, scale)


def _chunked_q8(q, k8, ks, v8, vs, pos, scale, block_t):
    """Online softmax over quantized key chunks: each step dequantizes
    one block."""
    def kv_block(c):
        t = slice(c * block_t, (c + 1) * block_t)
        return (dequantize_kv(k8[:, t], ks[:, t], q.dtype),
                dequantize_kv(v8[:, t], vs[:, t], q.dtype))
    return _online(q, pos, scale, k8.shape[1] // block_t, block_t, kv_block)


def supported_block_ts(t):
    return [bt for bt in (128, 256, 512) if t % bt == 0 and bt < t]


def autotune_key(slots, t, h, d, qlen, dtype, device=None, kv_dtype=None,
                 tp=1):
    """The ``decode_attn`` key of the JAX package; ``platform`` follows
    the device ("gpu" for a card).  Only quantized keys carry
    ``kv_dtype``, so unquantized keys stay as they were.  ``h`` is the
    model's head count; at ``tp`` > 1 the key holds one rank's ``h / tp``
    and ``tp`` (:func:`_apply_tp`)."""
    from . import autotune as at
    key = {"slots": int(slots), "t": int(t), "h": int(h), "d": int(d),
           "qlen": int(qlen), "dtype": _dtype_str(dtype),
           "platform": at.platform(device)}
    if kv_dtype is not None:
        key["kv_dtype"] = _dtype_str(_as_dtype(kv_dtype))
    return _apply_tp(key, tp)


def _apply_tp(key, tp):
    """The JAX package's ``_apply_tp``: a tensor-parallel key prices ONE
    rank's program, ``h / tp`` heads, and keeps ``tp`` so that a sharded
    winner never serves (or overwrites) the unsharded shape; tp=1 keys
    stay as they were."""
    tp = int(tp)
    if tp > 1:
        if key["h"] % tp:
            raise ValueError("heads %d not divisible by tp %d"
                             % (key["h"], tp))
        key["h"] //= tp
        key["tp"] = tp
    return key


def _is_q8(key):
    return key.get("kv_dtype") in _QUANT_KV_DTYPES


def _candidates(key):
    q8 = "_q8" if _is_q8(key) else ""
    out = [{"variant": "masked" + q8, "config": {}}]
    for bt in supported_block_ts(key["t"]):
        out.append({"variant": "chunked" + q8, "config": {"block_t": bt}})
    return out


def resolve_block_t(q, k, kv_dtype=None, tp=1):
    """The ``decode_attn`` pick for these operands: 0 for the one-shot
    masked softmax, else the chunked variant's ``block_t``.  A cached or
    pinned config that does not divide ``max_len`` falls back to the
    one-shot variant, as in the JAX package; it never faults.  ``q``
    holds one rank's heads at ``tp`` > 1."""
    from . import autotune as at
    key = autotune_key(q.shape[0], k.shape[1], q.shape[2] * int(tp),
                       q.shape[3], q.shape[1], q.dtype, q.device, kv_dtype,
                       tp=tp)
    cand = at.resolve("decode_attn", key)
    if not cand.get("variant", "").startswith("chunked"):
        return 0
    bt = int(cand.get("config", {}).get("block_t", 0))
    return bt if bt > 0 and k.shape[1] % bt == 0 else 0


def decode_attention(q, k, v, lengths, scale=None, k_scales=None,
                     v_scales=None, block_t=None, tp=1):
    """Length-masked attention for the slotted decode step.

    q: (slots, s, heads, d); k/v: (slots, max_len, heads, d); lengths:
    (slots,) int32 — each slot's PRE-append valid length (the new rows
    were already written at [lengths, lengths + s)).  For the quantized
    cache, k/v are the codes and ``k_scales/v_scales: (slots, max_len,
    heads)`` f32 select the q8 variants.  ``block_t``: 0 for the one-shot
    variant, a divisor of max_len for the chunked one, None to ask the
    autotuner (:func:`resolve_block_t`; the serving view asks once a
    step).  ``tp``: the tensor-parallel degree, for the key (q, k and v
    hold one rank's heads)."""
    if block_t is None:
        block_t = resolve_block_t(
            q, k, None if k_scales is None else k.dtype, tp)
    if block_t and k.shape[1] % int(block_t):
        raise ValueError("block_t %d does not divide max_len %d"
                         % (block_t, k.shape[1]))
    if k_scales is not None:
        if block_t:
            return _chunked_q8(q, k, k_scales, v, v_scales, lengths, scale,
                               int(block_t))
        return _masked_q8(q, k, k_scales, v, v_scales, lengths, scale)
    if block_t:
        return _chunked(q, k, v, lengths, scale, int(block_t))
    return _masked(q, k, v, lengths, scale)


# ---------------------------------------------------------------------------
# paged variants (the decode_attn_paged family)
# ---------------------------------------------------------------------------

def _gather_pages(kp, table):
    """kp: (pages, P, h, d); table: (B, n) int64 -> (B, n*P, h, d).
    Unmapped entries hold 0: page 0's rows are gathered and discarded by
    the length mask downstream."""
    b, n = table.shape
    out = raw_bytes(kp)[table].view(kp.dtype)
    return out.reshape(b, n * kp.shape[1], kp.shape[2], kp.shape[3])


def _gather_scale_pages(sp, table):
    """sp: (pages, P, h) f32 scale pool; table: (B, n) -> (B, n*P, h):
    the scale rows beside :func:`_gather_pages`' codes."""
    b, n = table.shape
    return sp[table].reshape(b, n * sp.shape[1], sp.shape[2])


def _paged_gather(q, kp, vp, table, pos, scale):
    """One-shot: gather every mapped page, then the masked softmax."""
    return _masked(q, _gather_pages(kp, table), _gather_pages(vp, table),
                   pos, scale)


def _paged_chunked(q, kp, vp, table, pos, scale, pages_per_block):
    """Online softmax over blocks of ``pages_per_block`` pages a slot:
    each step gathers one block and folds it into the flash recurrence,
    so the gathered working set is one block, not ``max_pages * P``
    rows."""
    m = int(pages_per_block)

    def kv_block(c):
        ids = table[:, c * m:(c + 1) * m]
        return _gather_pages(kp, ids), _gather_pages(vp, ids)
    return _online(q, pos, scale, int(table.shape[1]) // m,
                   m * int(kp.shape[1]), kv_block)


def _paged_gather_q8(q, kp, ks, vp, vs, table, pos, scale):
    """One-shot over the quantized pool: gather every mapped page's codes
    and scale rows, dequantize, then the masked softmax."""
    return _masked(q,
                   dequantize_kv(_gather_pages(kp, table),
                                 _gather_scale_pages(ks, table), q.dtype),
                   dequantize_kv(_gather_pages(vp, table),
                                 _gather_scale_pages(vs, table), q.dtype),
                   pos, scale)


def _paged_chunked_q8(q, kp, ks, vp, vs, table, pos, scale,
                      pages_per_block):
    """Online softmax over quantized page blocks: each step gathers and
    dequantizes ``pages_per_block`` pages a slot."""
    m = int(pages_per_block)

    def kv_block(c):
        ids = table[:, c * m:(c + 1) * m]
        return (dequantize_kv(_gather_pages(kp, ids),
                              _gather_scale_pages(ks, ids), q.dtype),
                dequantize_kv(_gather_pages(vp, ids),
                              _gather_scale_pages(vs, ids), q.dtype))
    return _online(q, pos, scale, int(table.shape[1]) // m,
                   m * int(kp.shape[1]), kv_block)


def supported_pages_per_block(max_pages):
    return [m for m in (1, 2, 4, 8) if max_pages % m == 0 and m < max_pages]


def paged_autotune_key(slots, pages, page_size, max_pages, h, d, qlen,
                       dtype, device=None, kv_dtype=None, tp=1):
    """The ``decode_attn_paged`` key of the JAX package; ``platform``
    follows the device ("gpu" for a card).  Only quantized keys carry
    ``kv_dtype``; ``h`` and ``tp`` as in :func:`autotune_key`."""
    from . import autotune as at
    key = {"slots": int(slots), "pages": int(pages),
           "page_size": int(page_size), "max_pages": int(max_pages),
           "h": int(h), "d": int(d), "qlen": int(qlen),
           "dtype": _dtype_str(dtype), "platform": at.platform(device)}
    if kv_dtype is not None:
        key["kv_dtype"] = _dtype_str(_as_dtype(kv_dtype))
    return _apply_tp(key, tp)


def _paged_candidates(key):
    q8 = "_q8" if _is_q8(key) else ""
    out = [{"variant": "paged_gather" + q8, "config": {}}]
    for m in supported_pages_per_block(key["max_pages"]):
        out.append({"variant": "paged_chunked" + q8,
                    "config": {"pages_per_block": m}})
    return out


def resolve_pages_per_block(q, k_pages, page_table, kv_dtype=None, tp=1):
    """The ``decode_attn_paged`` pick for these operands: 0 for the
    one-shot gather, else the chunked variant's pages a block.  A cached
    or pinned config that does not divide ``max_pages`` falls back to
    the gather, as in the JAX package; it never faults."""
    from . import autotune as at
    key = paged_autotune_key(q.shape[0], k_pages.shape[0], k_pages.shape[1],
                             page_table.shape[1], q.shape[2] * int(tp),
                             q.shape[3], q.shape[1], q.dtype, q.device,
                             kv_dtype, tp=tp)
    cand = at.resolve("decode_attn_paged", key)
    if not cand.get("variant", "").startswith("paged_chunked"):
        return 0
    m = int(cand.get("config", {}).get("pages_per_block", 0))
    return m if m > 0 and page_table.shape[1] % m == 0 else 0


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths,
                           scale=None, pages_per_block=None, k_scales=None,
                           v_scales=None, tp=1):
    """Length-masked attention over one layer's page pool.

    q: (slots, s, heads, d); k_pages/v_pages: (pages, page_size, heads,
    d); page_table: (slots, max_pages) int64; lengths: (slots,) int32 —
    each slot's PRE-append valid length (the new rows were already
    scattered into the mapped pages, so query offset j attends keys
    t <= lengths + j; unmapped entries gather page 0 and are masked).
    For the quantized pool, k_pages/v_pages are the codes and
    ``k_scales/v_scales: (pages, page_size, heads)`` f32 select the q8
    variants.  ``pages_per_block``: 0 for the one-shot gather, a divisor
    of max_pages for the chunked variant, None to ask the autotuner
    (:func:`resolve_pages_per_block`; the serving views ask once a
    step).  ``tp``: the tensor-parallel degree, for the key."""
    if pages_per_block is None:
        pages_per_block = resolve_pages_per_block(
            q, k_pages, page_table,
            None if k_scales is None else k_pages.dtype, tp)
    m = int(pages_per_block)
    if m and page_table.shape[1] % m:
        raise ValueError("pages_per_block %d does not divide max_pages %d"
                         % (m, page_table.shape[1]))
    if k_scales is not None:
        if m:
            return _paged_chunked_q8(q, k_pages, k_scales, v_pages,
                                     v_scales, page_table, lengths, scale, m)
        return _paged_gather_q8(q, k_pages, k_scales, v_pages, v_scales,
                                page_table, lengths, scale)
    if m:
        return _paged_chunked(q, k_pages, v_pages, page_table, lengths,
                              scale, m)
    return _paged_gather(q, k_pages, v_pages, page_table, lengths, scale)


# ---------------------------------------------------------------------------
# autotune runners: synthetic operands of a key's shapes
# ---------------------------------------------------------------------------

_RUNNER_OPERANDS = {}


def _synth(key, shape_q, shape_kv):
    """(generator, device, (q, k, v, k_scales, v_scales)) drawn from a
    seeded generator on the key's device; a quantized key's K/V go
    through :func:`quantize_kv`, the grid the serving cache writes with.
    The generator is returned for the caller's further draws."""
    dev = torch.device("cuda" if key["platform"] == "gpu" else "cpu")
    dtype = _as_dtype(key["dtype"])
    g = torch.Generator().manual_seed(0)

    def draw(*shape):
        return torch.randn(shape, generator=g).to(dev, dtype)
    q, k, v = draw(*shape_q), draw(*shape_kv), draw(*shape_kv)
    ks = vs = None
    if _is_q8(key):
        (k, ks), (v, vs) = (quantize_kv(k, key["kv_dtype"]),
                            quantize_kv(v, key["kv_dtype"]))
    return g, dev, (q, k, v, ks, vs)


def _sync(t):
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def _runner(cand, key):
    """One ``decode_attn`` candidate on synthetic operands: slots at
    staggered fill depths."""
    from . import autotune as at
    ks_ = at.key_str(key)
    ops = _RUNNER_OPERANDS.get(ks_)
    if ops is None:
        b, t, s = key["slots"], key["t"], key["qlen"]
        _g, dev, ops = _synth(key, (b, s, key["h"], key["d"]),
                              (b, t, key["h"], key["d"]))
        ops = _RUNNER_OPERANDS[ks_] = ops + (
            torch.linspace(0, t - s, b).to(dev, torch.int32),)
    q, k, v, ks, vs, pos = ops
    bt = int(cand["config"].get("block_t", 0)) \
        if cand["variant"].startswith("chunked") else 0

    def run():
        decode_attention(q, k, v, pos, k_scales=ks, v_scales=vs,
                         block_t=bt)
        _sync(q)
    return run


def _paged_runner(cand, key):
    """One ``decode_attn_paged`` candidate on synthetic operands of the
    key's shapes: a pool of ``pages`` pages, each slot mapping
    ``max_pages`` of them, lengths spread over the cache."""
    from . import autotune as at
    ks_ = at.key_str(key)
    ops = _RUNNER_OPERANDS.get(ks_)
    if ops is None:
        b, n, P = key["slots"], key["max_pages"], key["page_size"]
        g, dev, ops = _synth(key, (b, key["qlen"], key["h"], key["d"]),
                             (key["pages"], P, key["h"], key["d"]))
        table = torch.randperm(max(key["pages"], b * n), generator=g)[
            :b * n].remainder(key["pages"]).reshape(b, n).to(dev)
        lengths = torch.linspace(0, n * P - key["qlen"], b).to(
            dev, torch.int32)
        ops = _RUNNER_OPERANDS[ks_] = ops + (table, lengths)
    q, kp, vp, ks, vs, table, lengths = ops
    m = int(cand["config"].get("pages_per_block", 0)) \
        if cand["variant"].startswith("paged_chunked") else 0

    def run():
        paged_decode_attention(q, kp, vp, table, lengths,
                               pages_per_block=m, k_scales=ks, v_scales=vs)
        _sync(q)
    return run


def _cleanup(key):
    from . import autotune as at
    _RUNNER_OPERANDS.pop(at.key_str(key), None)


def _register_families():
    from . import autotune as at
    at.register_family("decode_attn", _candidates, _runner,
                       cleanup=_cleanup)
    at.register_family("decode_attn_paged", _paged_candidates,
                       _paged_runner, cleanup=_cleanup)


_register_families()
