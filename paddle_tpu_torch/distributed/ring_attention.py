"""Ring and Ulysses attention over the ``sep`` mesh axis (port of
``paddle_tpu/distributed/ring_attention.py``).

Each rank of the axis's group holds a contiguous shard of the sequence:
rank ``r`` the global rows ``[r * S_local, (r + 1) * S_local)``.

* :func:`ring_attention` keeps its Q shard and passes the K/V shards
  around the ring (:func:`..collective.ppermute`, K and V stacked into
  one call, in their own dtype), folding each block's normalized output
  and base-e row logsumexp into running ones by the two-level f32
  combine.  Under ``causal`` a strictly-future shard is skipped (no
  kernel launch) and only the rank's own shard takes the causal mask.
  The inner block is :func:`_flash_inner`, the flash forward with its lse
  output and its out unrounded in f32
  (``kernels/flash_attention_cuda.flash_attention_bshd_with_lse``), where
  :func:`_flash_inner_ok` holds (a card tensor the flash kernels take, no
  additive mask, no grouped-query heads), else the plain blockwise inner
  :func:`_blockwise_attn` (an online softmax over key chunks; the JAX
  package's fallback and parity reference).  ``PADDLE_TPU_RING_INNER=jnp``
  forces the blockwise inner, as in the JAX package.
* The ring's backward is written by hand (a ``torch.autograd.Function``),
  not autograd through the forward's steps: under ``causal`` rank 0 uses
  only its own shard, and autograd would never run the backward of its
  later permutes while the other ranks wait in theirs.  The backward
  saves q, the rank's own K/V and the final out and lse, and passes (K,
  V) and the f32 (dK, dV) accumulators around the ring for ``n`` steps,
  every rank issuing the same permutes at the same steps, skipped step or
  not; after the ``n``-th rotation the accumulators are home.  A block's
  share is the flash backward (``flash_attention_bwd``) with the GLOBAL
  out (the one returned, in q's dtype) and lse, dS = P (dP - delta) with
  P from the global lse, which is what JAX's autodiff through the combine
  computes; the split pair adds each block's shares unrounded into the
  rank's f32 dq (``dq_acc``) and into the travelling f32 dK/dV
  (``dkv_acc``), so each gradient is rounded once, as one flash call
  rounds it, and so is the forward's combined out.  The blockwise route
  runs a plain block backward of the same formula (mask and GQA too).
* :func:`ulysses_attention` (DeepSpeed-Ulysses) trades the sequence shard
  for a head shard with one tiled all-to-all (q, k and v stacked), runs
  ordinary attention over the whole sequence, and trades back; both
  exchanges are differentiable (:func:`..collective.all_to_all_autograd`).

Where ``axis_name`` resolves to no process group (no world, or a mesh
without the axis) the group is one rank and holds the whole sequence.
"""
from __future__ import annotations

import os
import warnings

import torch

from . import collective as _coll

__all__ = ["ring_attention", "ulysses_attention", "DEFAULT_CHUNK"]

_NEG_INF = -1e30

#: key-chunk width of the blockwise inner loop
DEFAULT_CHUNK = 512

#: below this chunk width the inner loop degenerates into many tiny steps
_CHUNK_FLOOR = 128


def _chunk_for(s_blk: int, chunk: int) -> int:
    """Largest divisor of the K/V block length not exceeding ``chunk``."""
    c = min(chunk, s_blk)
    while s_blk % c:
        c -= 1
    if c < min(_CHUNK_FLOOR, s_blk):
        warnings.warn(
            "ring attention inner chunk degraded to %d for shard length "
            "%d (no divisor <= %d above %d) — pad the sequence shard to a "
            "multiple of a power of two to avoid a ~%dx slower inner loop"
            % (c, s_blk, chunk, _CHUNK_FLOOR, max(1, _CHUNK_FLOOR // c)))
    return c


def _fold_gqa(q, mask_blk, hk):
    """Grouped-query attention: the ``g = h / hk`` query heads that share
    one K/V head folded into the row axis ((b, hk, g * sq, d), rows
    g-major), and the mask with them.  Returns (q, mask, g)."""
    b, h, sq, d = q.shape
    if h % hk:
        raise ValueError(
            "q heads (%d) must be a multiple of k/v heads (%d)" % (h, hk))
    g = h // hk
    if g == 1:
        return q, mask_blk, 1
    q = q.reshape(b, hk, g * sq, d)
    if mask_blk is not None:
        if mask_blk.dim() == 4 and mask_blk.shape[1] == h:
            # a per-q-head mask follows the head fold exactly
            mask_blk = mask_blk.reshape(b, hk, g * sq, mask_blk.shape[-1])
        else:
            # a head-broadcast mask repeats its row axis g times
            reps = [1] * mask_blk.dim()
            reps[-2] = g
            mask_blk = mask_blk.repeat(*reps)
    return q, mask_blk, g


def _causal_hidden(rows, c, c0, q_off, k_off, sq, device):
    """(rows, c) bool: the keys of the chunk at ``c0`` that a (folded) q
    row may not see, from global positions (row = g * sq + position)."""
    q_pos = q_off + torch.arange(rows, device=device) % sq
    k_pos = k_off + c0 + torch.arange(c, device=device)
    return k_pos[None, :] > q_pos[:, None]


def _chunk_logits(qf, ks, scale, mask_blk, c0, hidden):
    """Scaled f32 logits of the (folded) q rows against one key chunk
    starting at ``c0``, with the chunk's columns of the additive mask and,
    on the diagonal shard, -1e30 where ``hidden``."""
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, ks.float()) * scale
    if mask_blk is not None:
        logits = logits + mask_blk[..., c0:c0 + ks.shape[2]].float()
    if hidden is not None:
        logits = logits.masked_fill(hidden, _NEG_INF)
    return logits


def _blockwise_attn(q, k_blk, v_blk, scale, q_off, k_off, diag, mask_blk,
                    chunk, axis_name=None):
    """Blockwise (chunked, online-softmax) attention of the local Q shard
    against ONE K/V shard.

    q: (B, H, Sq, D); k_blk / v_blk: (B, HK, Sk, D) in their own dtype
    (products in f32; p rounded to v's dtype before the p.v product, as
    the JAX inner's ``p.astype(vs.dtype)``).  ``q_off`` / ``k_off``: the
    shards' global offsets, for the causal mask when ``diag``.
    ``mask_blk``: optional ADDITIVE mask broadcastable to (B, H, Sq, Sk).
    Returns (out (B, H, Sq, D) f32 normalized within the block, lse
    (B, H, Sq) f32 base-e).  ``axis_name`` is the JAX signature's and
    unused."""
    b, h, sq, d = q.shape
    hk, sk = k_blk.shape[1], k_blk.shape[2]
    qf, mask_blk, g = _fold_gqa(q.float(), mask_blk, hk)
    rows = g * sq
    c = _chunk_for(sk, chunk)
    m = torch.full((b, hk, rows), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hk, rows), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hk, rows, d), dtype=torch.float32, device=q.device)
    for c0 in range(0, sk, c):
        ks, vs = k_blk[:, :, c0:c0 + c], v_blk[:, :, c0:c0 + c]
        hidden = (_causal_hidden(rows, c, c0, q_off, k_off, sq, q.device)
                  if diag else None)
        logits = _chunk_logits(qf, ks, float(scale), mask_blk, c0, hidden)
        new_m = torch.maximum(m, logits.amax(-1))
        corr = torch.exp(m - new_m)
        p = torch.exp(logits - new_m[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(vs.dtype).float(), vs.float())
        m = new_m
    l_safe = l.clamp_min(1e-30)
    out = acc / l_safe[..., None]
    lse = m + torch.log(l_safe)
    return out.reshape(b, h, sq, d), lse.reshape(b, h, sq)


def _blockwise_bwd(q, k_blk, v_blk, out, lse, dout, scale, q_off, k_off,
                   diag, mask_blk, chunk):
    """The plain block backward of :func:`_blockwise_attn`'s share of the
    whole attention, from the GLOBAL out and lse: P = exp(logits -
    lse), dV = P^T dO, dS = P (dO V^T - delta), dQ = scale dS K, dK =
    scale dS^T Q, over key chunks.  Shapes as :func:`_blockwise_attn`;
    returns (dq (B, H, Sq, D), dk, dv (B, HK, Sk, D)) in f32."""
    b, h, sq, d = q.shape
    hk, sk = k_blk.shape[1], k_blk.shape[2]
    qf, mask_blk, g = _fold_gqa(q.float(), mask_blk, hk)
    rows = g * sq
    gf = dout.float().reshape(b, hk, rows, d)
    lse_f = lse.reshape(b, hk, rows)
    delta = (gf * out.float().reshape(b, hk, rows, d)).sum(-1)
    c = _chunk_for(sk, chunk)
    dq = torch.zeros((b, hk, rows, d), dtype=torch.float32, device=q.device)
    dk = torch.empty((b, hk, sk, d), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    for c0 in range(0, sk, c):
        ks, vs = k_blk[:, :, c0:c0 + c], v_blk[:, :, c0:c0 + c]
        hidden = (_causal_hidden(rows, c, c0, q_off, k_off, sq, q.device)
                  if diag else None)
        logits = _chunk_logits(qf, ks, float(scale), mask_blk, c0, hidden)
        p = torch.exp(logits - lse_f[..., None])
        dv[:, :, c0:c0 + c] = torch.einsum(
            "bhqk,bhqd->bhkd", p.to(v_blk.dtype).float(), gf)
        dp = torch.einsum("bhqd,bhkd->bhqk", gf, vs.float())
        ds = p * (dp - delta[..., None])
        if hidden is not None:
            # the causal fill takes no gradient (JAX's ``jnp.where``): in a
            # row whose visible keys are all masked away, P is uniform over
            # the filled keys too, which feed dV but not dQ / dK
            ds = ds.masked_fill(hidden, 0.0)
        dq += torch.einsum("bhqk,bhkd->bhqd", ds, ks.float()) * float(scale)
        dk[:, :, c0:c0 + c] = torch.einsum("bhqk,bhqd->bhkd", ds,
                                           qf) * float(scale)
    return dq.reshape(b, h, sq, d), dk, dv


def _fac():
    from ..kernels import flash_attention_cuda
    return flash_attention_cuda


def _flash_inner_ok(q, k, attn_mask) -> bool:
    """Whether the flash kernels serve as the inner (the JAX package's
    ``_pallas_inner_ok``, its "TPU backend" read as "a card tensor the
    flash kernels take", ``kernels.flash_attention.supported``): no
    additive mask (the kernel has no mask operand), no grouped-query
    heads, one float dtype the kernels take, D in (64, 128, 256) and S a
    multiple of 128.  q, k: (B, H, S, D).  ``PADDLE_TPU_RING_INNER=jnp``
    forces the blockwise inner."""
    if os.getenv("PADDLE_TPU_RING_INNER", "").lower() == "jnp":
        return False
    if attn_mask is not None or q.shape[1] != k.shape[1]:
        return False
    if q.dtype not in (torch.float32, torch.bfloat16, torch.float16) \
            or k.dtype != q.dtype:
        return False
    from ..kernels import flash_attention as fa
    return fa.supported(q.transpose(1, 2), k.transpose(1, 2))


def _dense(t):
    """``t`` (B, S, H, D) with dense (H, D) inner dimensions, as the
    flash kernels take them: a copy with row-major strides where they are
    not (``contiguous()`` would keep the stride of a size-1 head axis)."""
    if t.stride(3) == 1 and t.stride(2) == t.shape[3]:
        return t
    return t.new_empty(t.shape).copy_(t)


def _flash_inner(q, k_blk, v_blk, causal, scale_py):
    """The flash forward as the ring inner: (B, H, S, D) shards in, (out
    f32, lse base-e (B, H, S) f32) out, the contract of
    :func:`_blockwise_attn`.  The kernel writes out unrounded in f32, so
    the ring rounds its combined out once.  Differentiable in both
    outputs (the lse cotangent folds in as delta - dlse)."""
    out, lse = _fac().flash_attention_bshd_with_lse(
        _dense(q.transpose(1, 2)), _dense(k_blk.transpose(1, 2)),
        _dense(v_blk.transpose(1, 2)), causal=causal, scale=scale_py,
        out_f32=True)
    return out.transpose(1, 2), lse.transpose(1, 2)


def _bhsd(t):
    return t.transpose(1, 2)


class _RingAttention(torch.autograd.Function):
    """The ring over (B, S, H, D) shards; see the module docstring."""

    @staticmethod
    def forward(ctx, q, k, v, mask, group, causal, scale, chunk, flash):
        out, lse = _ring_forward(q, k, v, mask, group, causal, scale,
                                 chunk, flash)
        out = out.to(q.dtype)
        # the backward's delta = rowsum(dO * O) takes the output returned,
        # as the flash kernels' own backward does
        ctx.save_for_backward(q, k, v, out, lse, mask)
        ctx.cfg = (group, causal, scale, chunk, flash)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, mask = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, out, lse, mask,
                                    dout.to(q.dtype), *ctx.cfg)
        return dq, dk, dv, None, None, None, None, None, None


def _ring_pos(group):
    return (group.nranks, group.rank) if group is not None else (1, 0)


def _skipped(causal, src, my):
    # under causal, a strictly-future shard contributes nothing
    return causal and src > my


def _ring_forward(q, k, v, mask, group, causal, scale, chunk, flash):
    """(out f32 (B, S, H, D), lse f32 (B, S, H)) of this rank's Q shard
    over the whole ring."""
    n, my = _ring_pos(group)
    b, s, h, d = q.shape
    out = torch.zeros((b, s, h, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, s, h), _NEG_INF, dtype=torch.float32,
                     device=q.device)
    kv = torch.stack((k, v))
    perm = [(i, (i + 1) % n) for i in range(n)]
    for i in range(n):
        src = (my - i) % n
        if not _skipped(causal, src, my):
            diag = causal and src == my
            if flash:
                ob, lb = _flash_inner(_bhsd(q), _bhsd(kv[0]), _bhsd(kv[1]),
                                      diag, scale)
            else:
                mb = None if mask is None else \
                    mask[..., src * s:(src + 1) * s]
                ob, lb = _blockwise_attn(_bhsd(q), _bhsd(kv[0]),
                                         _bhsd(kv[1]), scale, my * s,
                                         src * s, diag, mb, chunk)
            ob, lb = _bhsd(ob), lb.transpose(1, 2)
            # the two-level combine of normalized block results
            new = torch.logaddexp(lse, lb)
            out = (out * torch.exp(lse - new)[..., None]
                   + ob * torch.exp(lb - new)[..., None])
            lse = new
        if group is not None and i < n - 1:
            # the K/V of the shard ``src - 1`` arrive for the next step
            kv = _coll.ppermute(kv, perm, group=group)
    return out, lse


def _ring_backward(q, k, v, out, lse, mask, dout, group, causal, scale,
                   chunk, flash):
    """(dq, dk, dv) of this rank's shards: (K, V) and the f32 (dK, dV)
    accumulators go round the ring together, one permute each a step
    (K/V for the first ``n - 1`` steps, the accumulators for all ``n``),
    in that order on every rank."""
    n, my = _ring_pos(group)
    b, s, h, d = q.shape
    perm = [(i, (i + 1) % n) for i in range(n)]
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    kv = torch.stack((k, v))
    dkv = torch.zeros((2,) + tuple(k.shape), dtype=torch.float32,
                      device=k.device)
    for i in range(n):
        src = (my - i) % n
        if not _skipped(causal, src, my):
            diag = causal and src == my
            if flash:
                # the kernels add their shares into the f32 dq and dK/dV
                # unrounded
                _fac().flash_attention_bwd(q, kv[0], kv[1], out, lse, dout,
                                           diag, scale, dq_acc=dq,
                                           dkv_acc=dkv)
            else:
                mb = None if mask is None else \
                    mask[..., src * s:(src + 1) * s]
                dq_b, dk_b, dv_b = (_bhsd(t) for t in _blockwise_bwd(
                    _bhsd(q), _bhsd(kv[0]), _bhsd(kv[1]), _bhsd(out),
                    lse.transpose(1, 2), _bhsd(dout), scale, my * s,
                    src * s, diag, mb, chunk))
                dq += dq_b
                dkv[0] += dk_b
                dkv[1] += dv_b
        if group is not None:
            if i < n - 1:
                kv = _coll.ppermute(kv, perm, group=group)
            dkv = _coll.ppermute(dkv, perm, group=group)
    return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype)


def ring_attention(q, k, v, axis_name: str, causal: bool = True,
                   scale=None, attn_mask=None, chunk: int = DEFAULT_CHUNK):
    """Blockwise ring attention over the ``axis_name`` group of the global
    mesh.

    q, k, v: (B, H, S_local, D), this rank's contiguous sequence shard
    (equal length on every rank; rank r's tokens are the global rows
    [r * S_local, (r + 1) * S_local)).  k/v may have fewer heads than q
    (grouped-query attention, the grouped K/V rotating).  ``attn_mask``:
    optional ADDITIVE mask broadcastable to (B, H, S_local, S_global),
    the local q rows against the FULL key axis; each ring step slices
    the columns of the shard it holds (the mask takes no gradient).
    ``scale`` None is the exact ``1 / sqrt(D)``.  Returns (B, H, S_local,
    D) in q's dtype, differentiable in q, k and v."""
    b, h, s_loc, d = q.shape
    if h % k.shape[1]:
        raise NotImplementedError(
            "ring_attention: q heads (%d) must be a multiple of k/v heads "
            "(%d) for grouped-query attention under the 'sep' ring"
            % (h, k.shape[1]))
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if attn_mask is not None and attn_mask.shape[-2] != s_loc:
        raise ValueError(
            "ring_attention: attn_mask rows (%d) must cover the LOCAL q "
            "shard (%d); its columns cover the global key axis"
            % (attn_mask.shape[-2], s_loc))
    group = _coll.bound_group(axis_name)
    flash = _flash_inner_ok(q, k, attn_mask)
    qs, ks, vs = _bhsd(q), _bhsd(k), _bhsd(v)
    if flash:
        qs, ks, vs = _dense(qs), _dense(ks), _dense(vs)
    out = _RingAttention.apply(qs, ks, vs, attn_mask, group, bool(causal),
                               float(scale), int(chunk), flash)
    return _bhsd(out)


class _Blockwise(torch.autograd.Function):
    """:func:`_blockwise_attn` over one whole sequence with the block
    backward (memory O(S * chunk) both ways); returns out in q's dtype."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, chunk):
        out, lse = _blockwise_attn(q, k, v, scale, 0, 0, causal, None,
                                   chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (causal, scale, chunk)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale, chunk = ctx.cfg
        dq, dk, dv = _blockwise_bwd(q, k, v, out, lse, dout, scale, 0, 0,
                                    causal, None, chunk)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def _full_attention(causal, scale):
    """The default inner of :func:`ulysses_attention` over (B, H/n, S, D):
    the flash kernels where :func:`_flash_inner_ok` holds, else the
    blockwise inner over the whole sequence (never the (S, S) logits)."""
    def attn(q_, k_, v_):
        s = scale if scale is not None else 1.0 / (q_.shape[-1] ** 0.5)
        if _flash_inner_ok(q_, k_, None):
            from ..kernels import flash_attention as fa
            out = fa.flash_attention_bshd(
                _dense(_bhsd(q_)), _dense(_bhsd(k_)), _dense(_bhsd(v_)),
                causal=causal, scale=float(s))
            return _bhsd(out)
        return _Blockwise.apply(q_, k_, v_, bool(causal), float(s),
                                DEFAULT_CHUNK)
    return attn


def ulysses_attention(q, k, v, axis_name: str, causal: bool = True,
                      scale=None, attn_fn=None):
    """DeepSpeed-Ulysses: a tiled all-to-all trades the sequence shard for
    a head shard, attention runs over the whole sequence, and the inverse
    all-to-all trades back.  q/k/v: (B, H, S_local, D) with H divisible by
    the group's size; inside, each rank sees (B, H/n, S_global, D) and
    ``attn_fn(q, k, v)`` (default: the flash kernels, else the blockwise
    inner) computes its heads.  q, k and v move in one exchange when they
    share shape and dtype."""
    group = _coll.bound_group(axis_name)
    n = group.nranks if group is not None else 1

    def exchange(x):
        return x if group is None else _coll.all_to_all_autograd(x, group)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape[1] % n:
            raise ValueError("ulysses_attention: %s has %d heads, not a "
                             "multiple of the %r axis's %d ranks"
                             % (name, t.shape[1], axis_name, n))

    def seq_to_head(x):            # (t, b, h, s_loc, d) -> (t, b, h/n, S, d)
        t, b, h, s_loc, d = x.shape
        x = x.reshape(t, b, n, h // n, s_loc, d).permute(2, 0, 1, 3, 4, 5)
        x = exchange(x)           # dim 0: the source rank = the seq chunk
        x = x.permute(1, 2, 3, 0, 4, 5)           # (t, b, h/n, n, s_loc, d)
        return x.reshape(t, b, h // n, n * s_loc, d)

    def head_to_seq(x):            # (b, h/n, S, d) -> (b, h, s_loc, d)
        b, hn, s_full, d = x.shape
        s_loc = s_full // n
        x = x.reshape(b, hn, n, s_loc, d).permute(2, 0, 1, 3, 4)
        x = exchange(x)           # dim 0: the source rank = the heads
        return x.permute(1, 0, 2, 3, 4).reshape(b, n * hn, s_loc, d)

    if q.shape == k.shape == v.shape and q.dtype == k.dtype == v.dtype:
        q2, k2, v2 = seq_to_head(torch.stack((q, k, v))).unbind(0)
    else:
        q2, k2, v2 = (seq_to_head(t[None])[0] for t in (q, k, v))
    if attn_fn is None:
        attn_fn = _full_attention(causal, scale)
    return head_to_seq(attn_fn(q2, k2, v2))
