"""Flash attention: the CUDA kernels ``csrc/flash_fwd_tc.cu`` (forward on
the tensor cores, bf16 and fp16), ``csrc/flash_fwd.cu`` (forward, kernel
A, f32, on the tensor cores as 3 x TF32 products), kernel A' (forward
with pipelined K/V tiles: for bf16 and fp16
``csrc/flash_fwd_pipelined_tc.cu``, TMA-fed and warp-specialised on the
tensor cores; for f32 ``csrc/flash_fwd_pipelined.cu``, kernel A's 3 x
TF32 body behind a deeper ``cp.async`` ring),
``csrc/flash_bwd.cu`` (backward entry points and the f32 kernels: C1
merged, C2 dQ, C3 dK/dV, on the tensor cores as 3 x TF32 products) and
``csrc/flash_bwd_tc.cu`` (C1, C2 and C3 on the tensor cores for bf16 and
fp16), their plain PyTorch
versions, the autograd Functions that join
them, and their autotune families (port of
``paddle_tpu/kernels/flash_attention_pallas.py``: ``_fwd_kernel`` /
``_fwd_kernel_streamed`` / ``_fwd_kernel_pipelined`` and ``_bwd_kernel`` /
``_bwd_dq_kernel`` / ``_bwd_dkv_kernel`` through
``flash_attention_bshd_native`` / ``flash_attention_bshd_with_lse``, their
``custom_vjp``s and the autotune wiring of ``_resolve_specs``).

Tensors are (B, S, H, D), the model's native layout: no transposes.  The
kernels take float32, bfloat16 and float16, S a multiple of 64, S_q ==
S_k, a start-aligned causal mask and D in {64, 128, 256}.  q/k/v (and the
backward's dO) need dense (H, D) inner dimensions; their sequence and
batch strides are free, so the model's q/k/v slices of the fused
projection go in without a copy.  A dO whose (H, D) dimensions are not
dense is made contiguous first.  Every forward streams K/V tiles at any
S, so each is also the counterpart of the TPU's long-sequence
``_fwd_kernel_streamed``.

Every call resolves its kernels' variant and tile shape through
:mod:`.autotune` (families ``flash_fwd``, ``flash_bwd``, ``flash_bwd_dq``,
``flash_bwd_dkv``); with tuning off, no pin and no cache entry that is
candidate [0].  The forward's ``"base"`` variant depends on the dtype:
bf16 and fp16 take the tensor-core forward at one of its (block_q,
block_k) instantiations (candidate [0]: 128 x 128 at D 64, 128 x 64 at
D 128, 64 x 64 at D 256); f32 takes kernel A with its tiles by head
dim (64 x 64, at D 256 64 x 32).  The ``pipelined`` variant selects A'
at one of its instantiations; it is reached by a pin or a tuned pick,
which the autotuner makes only for q/k/v rows that start on 16 bytes.  The backward
route is :func:`..flash_attention._card_bwd_route`'s: bf16 and fp16 take
the split pair C2 + C3 at every length, f32 the JAX package's choice
between C1 and the pair.  The backward's tiles depend on the dtype:
bf16 and fp16 take the tensor-core tiles, 64 or 128 at D 64 and 64 at D
128 and 256; f32 64 or 32 rows (32 at D 256; at D 64 C1 and C3 default
to 32, C2 to 64).  The 16-bit kernels and the f32 backward read 16-byte
rows (A' through tensor maps, which want 16-byte bases and strides): an
input whose rows are not 16-byte aligned is copied to an aligned one
first, as kernel A does.  f32 A' raises on such rows.
``iotafree`` and ``parq`` are accepted and change nothing here: the
first is a bit-identical rewrite of the TPU's mask arithmetic, the
second a TPU lse block layout.  ``bf16chain`` changes the numerics
and has no kernel yet: it raises.  A resolved candidate that the kernels
cannot take (a stale cache entry, a pin, a tile or variant not
instantiated for the dtype) falls back to candidate [0], as in the JAX
package.

A CUDA tensor launches the kernels (or raises); only a CPU tensor takes
the plain versions :func:`_flash_tc_reference` (the tensor-core
forward's and kernel A''s) / :func:`_flash_reference` /
:func:`_flash_bwd_reference`.  The forward saves what the JAX
``custom_vjp`` saves, (q, k, v, out, lse), and only when autograd will
use it.  ``flash_fwd_tc_launches``, ``flash_fwd_launches``,
``flash_fwd_pipelined_launches``, ``flash_bwd_launches``,
``flash_bwd_dq_launches`` and ``flash_bwd_dkv_launches`` count kernel
launches.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import _build
from . import autotune as _at
from .flash_attention import _card_bwd_route

#: kernel launches since import (or since a caller reset them)
flash_fwd_tc_launches = 0
flash_fwd_launches = 0
flash_fwd_pipelined_launches = 0
flash_bwd_launches = 0
flash_bwd_dq_launches = 0
flash_bwd_dkv_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_DTYPE_BY_NAME = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                  "float16": torch.float16}
#: the 16-bit types, which the tensor-core kernels take
_TC_DTYPES = (torch.bfloat16, torch.float16)
_HEAD_DIMS = (64, 128, 256)
_BLOCK = 64
_LOG2E = 1.4426950408889634

#: kernel A's (block_q, block_k) by head dim (``csrc/flash_fwd.cu``: its
#: two-stage ring of 64-row f32 K/V tiles does not fit a block at D 256),
#: and the instantiations of A'
_F32_FWD_BLOCKS = {64: (64, 64), 128: (64, 64), 256: (64, 32)}
_PIPELINED_BLOCKS = ((64, 32), (64, 64), (128, 64), (128, 128))
#: the tensor-core forward's (block_q, block_k) instantiations by head
#: dim, the default first (csrc/flash_fwd_tc.cu, dispatch_tiles)
_TC_FWD_BLOCKS = {64: ((128, 128), (128, 64), (64, 64)),
                  128: ((128, 64), (64, 64)),
                  256: ((64, 64), (128, 64))}

#: variant features understood by the forward / backward (the JAX sets)
_FWD_FEATURES = frozenset({"bf16chain", "iotafree", "parq", "pipelined"})
_BWD_FEATURES = frozenset({"bf16chain", "iotafree"})


def _flash_reference(q, k, v, causal, scale, out_f32=False):
    """Plain f32 softmax attention over (B, S, H, D): returns (out in q's
    dtype, or in f32 with ``out_f32``, base-e row logsumexp (B, S, H)
    f32).  The causal mask is start-aligned (key t is visible to query s
    iff t <= s)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * float(scale)
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        vis = torch.ones((sq, sk), dtype=torch.bool,
                         device=q.device).tril()
        logits = logits.masked_fill(~vis, -1e30)
    lse = torch.logsumexp(logits, dim=-1)                  # (B, H, S)
    p = torch.exp(logits - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    return (out if out_f32 else out.to(q.dtype)), \
        lse.transpose(1, 2).contiguous()


def _flash_tc_reference(q, k, v, causal, scale, block_q, block_k,
                        out_f32=False):
    """Plain version of the tensor-core forward and of kernel A': the
    forward kernels' tile walk over the K/V tiles of ``block_k`` rows,
    with the online softmax in f32 (base 2, the scale times log2(e)
    applied to q.k in f32), each q tile of ``block_q`` rows stopping after
    its causal band and every visited tile masked; p is rounded to v's
    dtype before the p.v product, as the TPU's ``_online_step`` rounds it
    (``p.astype(v.dtype)``), and l summed from the unrounded p.  Returns
    (out in q's dtype, or in f32 with ``out_f32``, base-e row logsumexp
    (B, S, H) f32)."""
    b, s, h, d = q.shape
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))  # (B,H,S,D)
    scale2 = float(scale) * _LOG2E
    m = torch.full((b, h, s), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
    rows = torch.arange(s, device=q.device)
    for c0 in range(0, k.shape[1], block_k):
        # the q tiles whose band reaches this K tile: tile qt visits it iff
        # c0 < (qt + 1) * block_q
        r0 = (c0 // block_q) * block_q if causal else 0
        logits = torch.einsum("bhqd,bhkd->bhqk", qf[:, :, r0:],
                              kf[:, :, c0:c0 + block_k]) * scale2
        if causal:
            cols = torch.arange(c0, c0 + block_k, device=q.device)
            vis = cols[None, :] <= rows[r0:, None]
            logits = logits.masked_fill(~vis, -1e30)
        m_old = m[:, :, r0:]
        m_new = torch.maximum(m_old, logits.amax(-1))
        p = torch.exp2(logits - m_new[..., None])
        corr = torch.exp2(m_old - m_new)
        l[:, :, r0:] = l[:, :, r0:] * corr + p.sum(-1)
        p = p.to(v.dtype).float()
        acc[:, :, r0:] = acc[:, :, r0:] * corr[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p, vf[:, :, c0:c0 + block_k])
        m[:, :, r0:] = m_new
    l_safe = l.clamp_min(1e-30)
    out = acc / l_safe[..., None]
    out = (out if out_f32 else out.to(q.dtype)).transpose(1, 2)
    lse2 = m + torch.log(l_safe) * _LOG2E          # base 2, as the kernels
    return out.contiguous(), (lse2 / _LOG2E).transpose(1, 2).contiguous()


def _flash_bwd_reference(q, k, v, out, lse, dout, causal, scale, dlse=None,
                         f32=False):
    """Plain f32 backward of :func:`_flash_reference`, P recomputed from the
    saved base-e lse (B, S, H) as the TPU's ``_bwd_head_math`` and the
    kernels form it, in base 2: exp2(scale log2(e) q.k - lse log2(e)), the
    scale applied to q.k in f32.  P and dS are rounded to the inputs'
    dtype before the products that take them: returns (dq, dk, dv) in
    q/k/v's dtypes (in f32, unrounded, with ``f32``).  ``dlse`` is
    the lse output's cotangent, folded in as ``delta - dlse``."""
    qf, kf, vf, of, gf = (t.float() for t in (q, k, v, out, dout))
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * (float(scale)
                                                       * _LOG2E)
    p = torch.exp2(logits - (lse.float() * _LOG2E).transpose(1, 2)[..., None])
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        vis = torch.ones((sq, sk), dtype=torch.bool,
                         device=q.device).tril()
        p = p.masked_fill(~vis, 0.0)
    delta = (gf * of).sum(-1)                              # (B, S, H)
    if dlse is not None:
        delta = delta - dlse.float()
    # P is rounded to dO's dtype before dV and dS to q's before dK and dQ,
    # where the TPU kernels round them for their MXU products
    # (_bwd_head_math); in f32 both roundings are exact
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dout.dtype).float(), gf)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = (p * (dp - delta.transpose(1, 2)[..., None])).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * float(scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * float(scale)
    if f32:
        return dq, dk, dv
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError("flash attention: %s must be a 4-D (B, S, H, D)"
                             " tensor" % name)
        if t.dtype not in _DTYPES:
            raise TypeError("flash attention: %s dtype %s not supported "
                            "(float32, bfloat16 or float16)"
                            % (name, t.dtype))
        if not _dense_head(t):
            raise ValueError("flash attention: %s needs dense (H, D) inner "
                             "dimensions, got strides %s"
                             % (name, tuple(t.stride())))
    if not (q.shape == k.shape == v.shape):
        raise ValueError("flash attention: q/k/v shapes differ: %s %s %s"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash attention: q/k/v dtypes differ")
    if not (q.device == k.device == v.device):
        raise ValueError("flash attention: q/k/v on different devices")
    _b, s, _h, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError("flash attention: head_dim %d not in %s"
                         % (d, _HEAD_DIMS))
    if s % _BLOCK:
        raise ValueError("flash attention: sequence length %d is not a "
                         "multiple of %d" % (s, _BLOCK))


def _dense_head(t):
    return t.stride(3) == 1 and t.stride(2) == t.shape[3]


def _aligned(*ts):
    """Whether every (batch, position) row of each tensor starts on 16
    bytes, the unit of the async copies of A' and the tensor-core
    kernels: base pointer and the batch and sequence strides (the dense
    head's own offsets are multiples of 128 bytes)."""
    for t in ts:
        esz = t.element_size()
        if t.data_ptr() % 16 or (t.stride(0) * esz) % 16 or \
                (t.stride(1) * esz) % 16:
            return False
    return True


# ---------------------------------------------------------------------------
# variants and candidate checks (flash_attention_pallas.py:110-135, 1139-1189)
# ---------------------------------------------------------------------------

def variant_features(variant, allowed=_FWD_FEATURES):
    """'iotafree+pipelined' -> frozenset, validated against ``allowed``
    ('base' or '' is the empty set)."""
    if not variant or variant == "base":
        return frozenset()
    feats = frozenset(variant.split("+"))
    bad = feats - allowed
    if bad:
        raise ValueError("unknown flash variant feature(s) %s in %r "
                         "(allowed: %s)" % (sorted(bad), variant,
                                            sorted(allowed)))
    return feats


def canon_variant(feats) -> str:
    return "+".join(sorted(feats)) if feats else "base"


def bwd_variant_of(variant: str) -> str:
    """Strip forward-only features (parq/pipelined) for the backward."""
    return canon_variant(variant_features(variant) & _BWD_FEATURES)


def _refuse_bf16chain(feats):
    if "bf16chain" in feats:
        raise NotImplementedError(
            "flash variant 'bf16chain' (the bf16 softmax chain) changes the "
            "numerics and has no CUDA kernel yet (ROADMAP §C); pin or cache "
            "another variant")


#: 16-bit C1 / C2 / C3 on the tensor cores: square tiles by head dim, the
#: default first (128-row tiles at D 128 would need 256 accumulator
#: registers a thread in C3; at D 256 two 64-row tiles' operands alone
#: exceed shared memory)
_TC_BLOCKS = {64: (64, 128), 128: (64,), 256: (64,)}


#: f32 C1 / C2 / C3 (``csrc/flash_bwd.cu``) tile rows by family and head
#: dim, the default first: 64 and 32 up to D 128, 32 alone at D 256, where
#: 64-row f32 tiles do not fit (``paddle_flash_bwd_smem``); at D 64 C1 and
#: C3 run faster on 32 rows, C2 on 64 (PERF.md §6)
_F32_BLOCKS = {"flash_bwd": {64: (32, 64), 128: (64, 32), 256: (32,)},
               "flash_bwd_dq": {64: (64, 32), 128: (64, 32), 256: (32,)},
               "flash_bwd_dkv": {64: (32, 64), 128: (64, 32), 256: (32,)}}


def _bwd_blocks(d, dtype=torch.float32, family="flash_bwd"):
    """Tile rows of ``family``'s kernel (C1, C2 or C3) instantiated at
    head dim ``d`` and ``dtype``, the default first: the tensor-core tiles
    of ``csrc/flash_bwd_tc.cu`` for bf16 and fp16, which the three
    families share; for f32 ``_F32_BLOCKS``."""
    if dtype in _TC_DTYPES:
        return _TC_BLOCKS[d]
    return _F32_BLOCKS[family][d]


def split_tc_smem_bytes(d, block):
    """Dynamic shared memory of one tensor-core C2 or C3 launch
    (``tc_smem_bytes`` of ``csrc/flash_bwd_tc.cu``): 1024 bytes to align
    the tiles to the 128-byte swizzle's 1024-byte period, six bf16
    ``block`` x ``d`` tiles (two resident, two stages of two streamed),
    four f32 rows of ``block`` (lse and delta) and, at D 256, two f32
    ``block`` x ``block`` score tiles that the warpgroups exchange."""
    xchg = 2 * block * block * 4 if d == 256 else 0
    return 1024 + 6 * block * d * 2 + 4 * block * 4 + xchg


def merged_tc_smem_bytes(d, block):
    """Dynamic shared memory of one tensor-core C1 launch
    (``merged_tc_smem_bytes`` of ``csrc/flash_bwd_tc.cu``): at D 64 C3's
    and the 16-bit ``block`` x ``block`` dS^T tile that dQ reads; at D 128
    and 256, where two warpgroups share the tile, the layout of C3 at D
    256: six tiles, four row vectors and the two f32 score tiles of the
    exchange, whose unused half holds the dS^T tile."""
    if d == 64:
        return split_tc_smem_bytes(d, block) + block * block * 2
    return 1024 + 6 * block * d * 2 + 4 * block * 4 + 2 * block * block * 4


def fwd_tc_smem_bytes(d, block_q, block_k):
    """Dynamic shared memory of one tensor-core forward launch
    (``fwd_tc_smem_bytes`` of ``csrc/flash_fwd_tc.cu``): 1024 bytes to
    align the tiles to the 128-byte swizzle's 1024-byte period, the
    16-bit ``block_q`` x ``d`` q tile and two stages of the ``block_k`` x
    ``d`` K and V tiles."""
    return 1024 + block_q * d * 2 + 4 * block_k * d * 2


def _valid_blocks(bq, bk, s, sk, causal):
    if not (isinstance(bq, int) and isinstance(bk, int)):
        return False
    if bq < 16 or bk < 16 or s % bq or sk % bk:
        return False
    if causal and (bk > bq or bq % bk):
        return False
    return True


def pipelined_smem_bytes(d, block_q, block_k, dtype):
    """Dynamic shared memory of one A' launch.  16-bit
    (``pipelined_tc_smem_bytes`` of ``csrc/flash_fwd_pipelined_tc.cu``,
    which the card tests hold this to): 1024 bytes to align the tiles to
    the swizzle's 1024-byte period, the q tile, the ring's slots of the K
    and V tiles and 256 bytes of barriers; the ring has as many slots as
    fit the H100's 232448 bytes a block, at most 4 and at least 2 (a tile
    that does not fit two is refused).  f32 (``pipelined_smem`` of
    ``csrc/flash_fwd_pipelined.cu``): the q tile and three stages of K and
    V where they fit, else two, f32 rows padded by 16 bytes."""
    if dtype in _TC_DTYPES:
        fixed = 1024 + block_q * d * 2 + 256
        slot = 4 * block_k * d
        return fixed + max(2, min(4, (232448 - fixed) // slot)) * slot
    row = (d + 4) * 4
    stages = 3 if (block_q + 6 * block_k) * row <= 232448 else 2
    return (block_q + 2 * stages * block_k) * row


def _fwd_specs(s, sk, d, dtype, causal):
    """Every forward (variant, block_q, block_k) instantiated for ``dtype``
    at head dim ``d`` that divides these lengths, candidate [0] first:
    bf16 and fp16 the tensor-core forward's tiles (its default first),
    f32 kernel A at its tiles; then A' at each of its tiles."""
    if dtype in _TC_DTYPES:
        specs = [("base",) + bs for bs in _TC_FWD_BLOCKS[d]]
    else:
        specs = [("base",) + _F32_FWD_BLOCKS[d]]
    specs += [("pipelined",) + bs for bs in _PIPELINED_BLOCKS]
    return [sp for sp in specs if _valid_blocks(sp[1], sp[2], s, sk, causal)]


def _fwd_smem_need(variant, d, bq, bk, dtype):
    """Dynamic shared memory of the forward (variant, bq, bk) at ``dtype``:
    A''s or the tensor-core forward's; None for kernel A, whose tiles
    fit a block at every head dim (at most 199,680 bytes, at D 256)."""
    if variant == "pipelined":
        return pipelined_smem_bytes(d, bq, bk, dtype)
    if dtype in _TC_DTYPES:
        return fwd_tc_smem_bytes(d, bq, bk)
    return None


def _sane_fwd_spec(cand, s, sk, d, dtype, causal, aligned, smem_limit):
    """(variant, block_q, block_k) that the forward kernels take for a
    resolved/pinned flash_fwd candidate; anything they cannot take
    (unknown features, a variant or tile not instantiated for the dtype
    or not dividing S, unaligned rows for A', more shared memory than a
    block may use) falls back to candidate [0].  ``hg`` has no meaning
    here and is ignored."""
    default = _fwd_specs(s, sk, d, dtype, causal)[0]
    try:
        feats = variant_features(cand.get("variant", "base"), _FWD_FEATURES)
    except ValueError:
        return default
    _refuse_bf16chain(feats)
    cfg = cand.get("config", {})
    bq, bk = cfg.get("block_q"), cfg.get("block_k")
    kind = "pipelined" if "pipelined" in feats else "base"
    if (kind, bq, bk) not in _fwd_specs(s, sk, d, dtype, causal):
        return default
    if kind == "pipelined" and not aligned:
        return default
    need = _fwd_smem_need(kind, d, bq, bk, dtype)
    if smem_limit is not None and need is not None and need > smem_limit:
        return default
    return (canon_variant(feats), bq, bk)


def _sane_bwd_blocks(cand, s, d, causal, dtype=torch.float32,
                     family="flash_bwd"):
    """(variant, tile rows) that ``family``'s kernel (C1, C2 or C3) takes
    at ``dtype`` for a resolved/pinned backward candidate (square tiles:
    block_q == block_k); anything else, such as a 32-row tile pinned or
    cached for a bf16 split family, falls back to candidate [0].  The
    merged and split families share it: the JAX merged check's head group
    has no meaning here."""
    blocks = _bwd_blocks(d, dtype, family)
    default = ("base", blocks[0])
    try:
        feats = variant_features(cand.get("variant", "base"), _BWD_FEATURES)
    except ValueError:
        return default
    _refuse_bf16chain(feats)
    cfg = cand.get("config", {})
    bq, bk = cfg.get("block_q"), cfg.get("block_k")
    if bq != bk or bq not in blocks or \
            not _valid_blocks(bq, bk, s, s, causal):
        return default
    return (canon_variant(feats), bq)


def autotune_key(b, s, sk, h, d, dtype, causal, device=None):
    """The autotune key of one call; ``platform`` follows the tensors'
    device ("gpu" for a card)."""
    return {"b": int(b), "s": int(s), "sk": int(sk), "h": int(h),
            "d": int(d), "dtype": str(dtype).replace("torch.", ""),
            "causal": bool(causal), "platform": _at.platform(device)}


def _resolve_fwd(q, k, v, causal):
    b, s, h, d = q.shape
    key = autotune_key(b, s, k.shape[1], h, d, q.dtype, causal, q.device)
    return _sane_fwd_spec(_at.resolve("flash_fwd", key), s, k.shape[1], d,
                          q.dtype, causal, _aligned(q, k, v),
                          _at.smem_limit(q.device))


def _resolve_bwd(q, causal, family):
    """Tile rows of the backward kernel of ``family``."""
    b, s, h, d = q.shape
    key = autotune_key(b, s, s, h, d, q.dtype, causal, q.device)
    return _sane_bwd_blocks(_at.resolve(family, key), s, d, causal,
                            q.dtype, family)[1]


# ---------------------------------------------------------------------------
# launches
# ---------------------------------------------------------------------------

def _outputs(q, want_lse, out_f32=False):
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), device=q.device,
                      dtype=torch.float32 if out_f32 else q.dtype)
    lse = (torch.empty((b, s, h), dtype=torch.float32, device=q.device)
           if want_lse else None)
    return out, lse


def _launch_tc(q, k, v, causal, scale, want_lse, block_q, block_k,
               out_f32=False):
    """The tensor-core forward at one of its (block_q, block_k)
    instantiations, out in q's dtype or (``out_f32``) unrounded f32; q/k/v
    rows that are not 16-byte aligned are copied to aligned ones first."""
    global flash_fwd_tc_launches
    b, s, h, d = q.shape
    if q.dtype not in _TC_DTYPES:
        raise TypeError("flash_fwd_tc: dtype %s; the tensor-core forward "
                        "takes bfloat16 and float16" % q.dtype)
    if (block_q, block_k) not in _TC_FWD_BLOCKS[d] or s % block_q \
            or s % block_k:
        raise ValueError("flash_fwd_tc: blocks (%r, %r) at D=%d, S=%d; "
                         "instantiated: %s, S a multiple of both"
                         % (block_q, block_k, d, s, _TC_FWD_BLOCKS[d]))
    q, k, v = (t if _aligned(t) else
               t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    out, lse = _outputs(q, want_lse, out_f32)
    lib = _build.library()
    entry = lib.paddle_flash_fwd_tc_f32out if out_f32 else \
        lib.paddle_flash_fwd_tc
    err = entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, s, h, d,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), int(bool(causal)), float(scale),
        _DTYPES[q.dtype], block_q, block_k, _build.current_stream(q.device))
    _build.check(err, "flash_fwd_tc launch")
    flash_fwd_tc_launches += 1
    return out, lse


def _launch(q, k, v, causal, scale, want_lse):
    """Kernel A (float32); q/k/v rows that are not 16-byte aligned are
    copied to aligned ones first."""
    global flash_fwd_launches
    b, s, h, d = q.shape
    if q.dtype != torch.float32:
        raise TypeError("flash_fwd: dtype %s; kernel A takes float32 "
                        "(bfloat16 and float16 take the tensor-core "
                        "forward)" % q.dtype)
    q, k, v = (t if _aligned(t) else
               t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    out, lse = _outputs(q, want_lse)
    err = _build.library().paddle_flash_fwd_bshd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, s, h, d,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), int(bool(causal)), float(scale),
        _DTYPES[q.dtype], _build.current_stream(q.device))
    _build.check(err, "flash_fwd launch")
    flash_fwd_launches += 1
    return out, lse


def _launch_pipelined(q, k, v, causal, scale, want_lse, block_q, block_k,
                      out_f32=False):
    """Kernel A' at one of its (block_q, block_k) instantiations: the
    tensor-core kernel for bf16 and fp16 (q/k/v rows that are not 16-byte
    aligned are copied to aligned ones first; out in their dtype or,
    ``out_f32``, unrounded f32), the 3 x TF32 kernel for f32 (which raises
    on such rows)."""
    global flash_fwd_pipelined_launches
    b, s, h, d = q.shape
    if (block_q, block_k) not in _PIPELINED_BLOCKS or s % block_q:
        raise ValueError("flash_fwd_pipelined: blocks (%r, %r) at S=%d; "
                         "instantiated: %s, S a multiple of block_q"
                         % (block_q, block_k, s, _PIPELINED_BLOCKS))
    tc = q.dtype in _TC_DTYPES
    if tc:
        q, k, v = (t if _aligned(t) else
                   t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
    elif not _aligned(q, k, v):
        raise ValueError("flash_fwd_pipelined: q/k/v rows must start on 16 "
                         "bytes (pointers and batch / sequence strides), "
                         "the unit of the kernel's async copies")
    out_f32 = out_f32 and tc
    out, lse = _outputs(q, want_lse, out_f32)
    lib = _build.library()
    entry = (lib.paddle_flash_fwd_pipelined if not tc
             else lib.paddle_flash_fwd_pipelined_tc_f32out if out_f32
             else lib.paddle_flash_fwd_pipelined_tc)
    err = entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, s, h, d,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), int(bool(causal)), float(scale),
        _DTYPES[q.dtype], block_q, block_k, _build.current_stream(q.device))
    _build.check(err, "flash_fwd_pipelined launch")
    flash_fwd_pipelined_launches += 1
    return out, lse


def _run_fwd(q, k, v, causal, scale, want_lse, spec, out_f32=False):
    """(out, lse or None) of the forward ``spec`` = (variant, block_q,
    block_k): A' for ``pipelined``, else the tensor-core forward (bf16,
    fp16) or kernel A (f32) on a card; their plain versions on the CPU.
    ``out_f32``: out in f32, unrounded (in f32 every forward's out is)."""
    variant, bq, bk = spec
    pipelined = "pipelined" in variant_features(variant)
    tc = not pipelined and q.dtype in _TC_DTYPES
    if q.device.type == "cpu":
        kw = {"out_f32": True} if out_f32 else {}
        if pipelined or tc:
            out, lse = _flash_tc_reference(q, k, v, causal, scale, bq, bk,
                                           **kw)
        else:
            out, lse = _flash_reference(q, k, v, causal, scale, **kw)
        return out, (lse if want_lse else None)
    if q.device.type != "cuda":
        raise ValueError("flash attention: unsupported device %s" % q.device)
    if pipelined:
        return _launch_pipelined(q, k, v, causal, scale, want_lse, bq, bk,
                                 out_f32)
    if tc:
        return _launch_tc(q, k, v, causal, scale, want_lse, bq, bk, out_f32)
    return _launch(q, k, v, causal, scale, want_lse)


def _forward(q, k, v, causal, scale, want_lse, out_f32=False):
    """(out, lse or None) through the forward that the autotuner resolves
    for this call."""
    return _run_fwd(q, k, v, causal, scale, want_lse,
                    _resolve_fwd(q, k, v, causal), out_f32)


def flash_attention_bwd(q, k, v, out, lse, dout, causal, scale, dlse=None,
                        route=None, dq_acc=None, dkv_acc=None):
    """Gradients (dq, dk, dv) of :func:`flash_attention_bshd_with_lse`'s
    (out, lse) for the cotangents ``dout`` and ``dlse`` (None: zero).
    ``lse`` is the forward's base-e (B, S, H) f32 row logsumexp.

    ``dq_acc``, a dense f32 tensor of q's shape, takes dq added into it
    unrounded, and is returned in dq's place: for a caller that sums dq
    over several K/V blocks (ring attention) and rounds it once.  In bf16
    and fp16 C2 adds into it itself (and C1's workspace is it); in f32 the
    kernel's dq is added; on the CPU the plain version's f32 dq.
    ``dkv_acc``, a dense f32 (2, B, S, H, D) tensor, does the same for dk
    (``dkv_acc[0]``) and dv (``dkv_acc[1]``), which come back as those
    views: C3 adds into it in bf16 and fp16, C1's or the f32 kernels'
    results are added, on the CPU the plain version's f32 dk and dv.

    On a card: ``route=None`` takes
    :func:`..flash_attention._card_bwd_route`'s route: ``"split"`` (C2
    then C3 on the tensor cores) for bf16 and fp16 at every length, and
    for f32 the route the JAX package takes at this shape
    (:func:`..flash_attention._bwd_route`), ``"merged"`` launching C1.
    Each kernel takes the tile rows its autotune family resolves.  A
    given ``route`` pins it (for the kernel checks); it is not a user
    setting."""
    _check(q, k, v)
    b, s, h, d = q.shape
    given = [("out", out, (b, s, h, d)), ("dout", dout, (b, s, h, d)),
             ("lse", lse, (b, s, h))]
    if dlse is not None:
        given.append(("dlse", dlse, (b, s, h)))
    for name, t, shape in given:
        if tuple(t.shape) != shape or t.device != q.device:
            raise ValueError("flash attention backward: %s must be %s on "
                             "%s, got %s on %s" % (name, shape, q.device,
                                                   tuple(t.shape), t.device))
    for name, acc, shape in (("dq_acc", dq_acc, (b, s, h, d)),
                             ("dkv_acc", dkv_acc, (2, b, s, h, d))):
        if acc is not None and (
                tuple(acc.shape) != shape or acc.device != q.device
                or acc.dtype != torch.float32 or not acc.is_contiguous()):
            raise ValueError("flash attention backward: %s must be a "
                             "contiguous float32 %s tensor on %s"
                             % (name, shape, q.device))
    if route is None:
        route = _card_bwd_route(s, h, d, q.dtype)
    if route not in ("merged", "split"):
        raise ValueError("flash attention backward: route %r is not "
                         "'merged' or 'split'" % (route,))
    blocks = ([_resolve_bwd(q, causal, "flash_bwd")] if route == "merged"
              else [_resolve_bwd(q, causal, "flash_bwd_dq"),
                    _resolve_bwd(q, causal, "flash_bwd_dkv")])
    if q.device.type == "cpu":
        dq, dk, dv = _flash_bwd_reference(q, k, v, out, lse, dout, causal,
                                          scale, dlse, f32=True)
        return (_accumulate(dq_acc, dq, q.dtype),) + _add_dkv(dkv_acc, dk,
                                                              dv, k.dtype)
    if q.device.type != "cuda":
        raise ValueError("flash attention: unsupported device %s" % q.device)
    if dout.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError("flash attention backward: dout must be %s and lse "
                        "float32" % q.dtype)
    if not _dense_head(dout):
        dout = dout.contiguous()
    # delta = rowsum(dO * O) in f32, outside the kernels as in the JAX
    # package (_flash_bwd); the lse cotangent folds in as delta - dlse
    delta = (dout.float() * out.float()).sum(-1)
    if dlse is not None:
        delta = delta - dlse.float()
    args = (q, k, v, dout, lse.contiguous(), delta, causal, scale)
    if route == "merged":
        dq, dk, dv = _launch_bwd_merged(*args, block=blocks[0],
                                        dq_acc=dq_acc)
        return (dq,) + _add_dkv(dkv_acc, dk, dv, k.dtype)
    tc = q.dtype in _TC_DTYPES
    if dq_acc is not None and not tc:
        dq = dq_acc.add_(_launch_bwd_dq(*args, block=blocks[0]))
    else:
        dq = _launch_bwd_dq(*args, block=blocks[0], dq_acc=dq_acc)
    if dkv_acc is not None and tc:
        return (dq,) + _launch_bwd_dkv(*args, block=blocks[1],
                                       dkv_acc=dkv_acc)
    return (dq,) + _add_dkv(dkv_acc, *_launch_bwd_dkv(*args,
                                                      block=blocks[1]),
                            k.dtype)


def _accumulate(acc, g, dtype):
    """``g`` added into ``acc`` and returned, or ``g`` in ``dtype`` where
    there is no accumulator."""
    return g.to(dtype) if acc is None else acc.add_(g)


def _add_dkv(dkv_acc, dk, dv, dtype):
    """(dk, dv) added into ``dkv_acc``'s two views, or in ``dtype``."""
    if dkv_acc is None:
        return dk.to(dtype), dv.to(dtype)
    return dkv_acc[0].add_(dk), dkv_acc[1].add_(dv)


def _bwd_args(q, k, v, dout, lse, delta, causal, scale, block, family):
    """The C entry points' (inputs, shape-and-strides tail) arguments for
    ``family``'s kernel, and the tensors they point into, which the caller
    holds until the launch is queued; ``block`` None is the kernel's
    default tile rows at this head dim and dtype.  Raises on a tile the
    kernel does not take; every kernel gets q/k/v/dout rows 16-byte
    aligned, the unit of its async copies (an unaligned input is copied
    first)."""
    b, s, h, d = q.shape
    blocks = _bwd_blocks(d, q.dtype, family)
    if block is None:
        block = blocks[0]
    if block not in blocks or s % block:
        raise ValueError("%s: tile %r at D=%d %s, S=%d; instantiated: %s, "
                         "S a multiple of it" % (family, block, d, q.dtype,
                                                 s, blocks))
    q, k, v, dout = (t if _aligned(t) else
                     t.clone(memory_format=torch.contiguous_format)
                     for t in (q, k, v, dout))
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
              lse.data_ptr(), delta.data_ptr())
    tail = (b, s, h, d, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), dout.stride(0), dout.stride(1),
            int(bool(causal)), float(scale), _DTYPES[q.dtype], int(block),
            _build.current_stream(q.device))
    return common, tail, (q, k, v, dout)


def _launch_bwd_merged(q, k, v, dout, lse, delta, causal, scale, block=None,
                       dq_acc=None):
    """C1: (dq, dk, dv); dq summed, scale folded in, by atomics in an f32
    workspace, which is dq itself in f32 and is cast in bf16 and fp16; a
    given ``dq_acc`` is the workspace (not zeroed) and is returned as
    it is."""
    global flash_bwd_launches
    common, tail, _held = _bwd_args(q, k, v, dout, lse, delta, causal, scale,
                                    block, "flash_bwd")
    given = dq_acc is not None
    if not given:
        dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    _build.check(_build.library().paddle_flash_bwd(
        *common, dq_acc.data_ptr(), dk.data_ptr(), dv.data_ptr(), *tail),
        "flash_bwd launch")
    flash_bwd_launches += 1
    return (dq_acc if given else dq_acc.to(q.dtype)), dk, dv


def _launch_bwd_dq(q, k, v, dout, lse, delta, causal, scale, block=None,
                   dq_acc=None):
    """C2: dq; with ``dq_acc`` (bf16 and fp16) the kernel adds dq into that
    f32 tensor in place of writing it, and returns it."""
    global flash_bwd_dq_launches
    common, tail, _held = _bwd_args(q, k, v, dout, lse, delta, causal, scale,
                                    block, "flash_bwd_dq")
    if dq_acc is not None:
        _build.check(_build.library().paddle_flash_bwd_dq_acc(
            *common, dq_acc.data_ptr(), *tail), "flash_bwd_dq launch")
        flash_bwd_dq_launches += 1
        return dq_acc
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _build.check(_build.library().paddle_flash_bwd_dq(
        *common, dq.data_ptr(), *tail), "flash_bwd_dq launch")
    flash_bwd_dq_launches += 1
    return dq


def _launch_bwd_dkv(q, k, v, dout, lse, delta, causal, scale, block=None,
                    dkv_acc=None):
    """C3: (dk, dv); with ``dkv_acc`` (bf16 and fp16) the kernel adds them
    into that f32 (2, B, S, H, D) tensor in place of writing them, and
    returns its two views."""
    global flash_bwd_dkv_launches
    common, tail, _held = _bwd_args(q, k, v, dout, lse, delta, causal, scale,
                                    block, "flash_bwd_dkv")
    if dkv_acc is not None:
        _build.check(_build.library().paddle_flash_bwd_dkv_acc(
            *common, dkv_acc[0].data_ptr(), dkv_acc[1].data_ptr(), *tail),
            "flash_bwd_dkv launch")
        flash_bwd_dkv_launches += 1
        return dkv_acc[0], dkv_acc[1]
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    _build.check(_build.library().paddle_flash_bwd_dkv(
        *common, dk.data_ptr(), dv.data_ptr(), *tail), "flash_bwd_dkv launch")
    flash_bwd_dkv_launches += 1
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """out = attention(q, k, v); saves (q, k, v, out, lse) as the JAX
    ``_flash_vjp_fwd`` does and differentiates through
    :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = _forward(q, k, v, causal, scale, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


class _FlashAttentionWithLse(torch.autograd.Function):
    """(out, lse) = attention(q, k, v) with the base-e row logsumexp; the
    lse cotangent folds into the backward as ``delta - dlse``
    (``_flash_lse_vjp_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, out_f32):
        out, lse = _forward(q, k, v, causal, scale, True, out_f32)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        # an f32 out's cotangent enters the kernels in q's dtype
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.to(q.dtype), ctx.causal,
                                         ctx.scale, dlse=dlse)
        return dq, dk, dv, None, None, None


def _needs_grad(*ts):
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def flash_attention_bshd_with_lse(q, k, v, causal=False, scale=None,
                                  out_f32=False):
    """(out, lse): out (B, S, H, D) in q's dtype, or in f32 unrounded with
    ``out_f32`` (ring attention's blocks, combined before one rounding),
    lse the base-e row logsumexp (B, S, H) f32; differentiable in both."""
    _check(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if _needs_grad(q, k, v):
        return _FlashAttentionWithLse.apply(q, k, v, causal, scale,
                                            bool(out_f32))
    return _forward(q, k, v, causal, scale, True, bool(out_f32))


def flash_attention_bshd(q, k, v, causal=False, scale=None):
    """q, k, v: (B, S, H, D) -> (B, S, H, D); differentiable."""
    _check(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if _needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, scale)
    return _forward(q, k, v, causal, scale, False)[0]


# ---------------------------------------------------------------------------
# autotune families: candidates, runners, shared-memory hooks
# (flash_attention_pallas.py:1238-1467)
# ---------------------------------------------------------------------------

def _fwd_candidates(key):
    """Each forward instantiated for the key's dtype and head dim that
    divides its lengths (:func:`_fwd_specs`): bf16 and fp16 [0] the
    tensor-core forward at its default tiles, then its other tiles, then
    A' at each of its instantiations; f32 [0] kernel A (its tiles at the
    key's head dim), then A'."""
    return [{"variant": v, "config": {"block_q": bq, "block_k": bk}}
            for v, bq, bk in _fwd_specs(key["s"], key["sk"], key["d"],
                                        _DTYPE_BY_NAME[key["dtype"]],
                                        key["causal"])]


def _bwd_candidates(key, family="flash_bwd"):
    """[0] the default tile rows of ``family``'s kernel at the key's head
    dim and dtype, then the other instantiations: f32 ``_F32_BLOCKS``;
    bf16 and fp16 the tensor-core tiles (64 then 128 at D 64, 64 at D 128
    and 256)."""
    blocks = _bwd_blocks(key["d"], _DTYPE_BY_NAME[key["dtype"]], family)
    return [{"variant": "base", "config": {"block_q": bm, "block_k": bm}}
            for bm in blocks]


def _fwd_smem(cand, key):
    """The shared memory of A' or of the tensor-core forward for the
    tune() gate; None (no gate) for kernel A, whose tiles fit a
    block at every head dim (as do the backward's, which register no
    hook)."""
    cfg = cand["config"]
    kind = ("pipelined" if "pipelined" in variant_features(cand["variant"])
            else "base")
    return _fwd_smem_need(kind, key["d"], cfg["block_q"], cfg["block_k"],
                          _DTYPE_BY_NAME[key["dtype"]])


#: per-key synthetic operands shared by the runners (the backward runners
#: also reuse the default forward's (out, lse) residuals)
_RUNNER_DATA: dict = {}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _runner_data(key):
    ks = _at.key_str(key)
    hit = _RUNNER_DATA.get(ks)
    if hit is not None:
        return hit
    b, s, sk, h, d = (key[n] for n in ("b", "s", "sk", "h", "d"))
    dtype = _DTYPE_BY_NAME[key["dtype"]]
    device = torch.device("cuda" if key["platform"] == "gpu" else "cpu")
    rng = np.random.RandomState(0)

    def draw(n):
        return torch.from_numpy(rng.standard_normal((b, n, h, d))
                                .astype(np.float32)).to(device, dtype)
    q, k, v, do = draw(s), draw(sk), draw(sk), draw(s)
    scale = 1.0 / math.sqrt(d)
    out, lse = _run_fwd(q, k, v, key["causal"], scale, True,
                        _fwd_specs(s, sk, d, dtype, key["causal"])[0])
    delta = (do.float() * out.float()).sum(-1)
    _sync(device)
    data = {"q": q, "k": k, "v": v, "do": do, "out": out, "lse": lse,
            "delta": delta, "scale": scale}
    _RUNNER_DATA[ks] = data
    return data


def _fwd_runner(cand, key):
    data = _runner_data(key)
    cfg = cand["config"]
    spec = (cand["variant"], cfg["block_q"], cfg["block_k"])
    q, k, v = data["q"], data["k"], data["v"]

    def run():
        _run_fwd(q, k, v, key["causal"], data["scale"], True, spec)
        _sync(q.device)
    return run


def _bwd_runner(launch):
    def make(cand, key):
        data = _runner_data(key)
        q, block = data["q"], cand["config"]["block_q"]
        args = (q, data["k"], data["v"], data["do"], data["lse"],
                data["delta"], key["causal"], data["scale"])

        def run():
            if q.device.type == "cpu":
                _flash_bwd_reference(*args[:3], data["out"], data["lse"],
                                     data["do"], *args[6:])
            else:
                launch(*args, block=block)
            _sync(q.device)
        return run
    return make


def _runner_cleanup(key):
    _RUNNER_DATA.pop(_at.key_str(key), None)


def _register_families():
    _at.register_family("flash_fwd", _fwd_candidates, _fwd_runner,
                        cleanup=_runner_cleanup, smem_bytes=_fwd_smem)
    for name, launch in (("flash_bwd", _launch_bwd_merged),
                         ("flash_bwd_dq", _launch_bwd_dq),
                         ("flash_bwd_dkv", _launch_bwd_dkv)):
        _at.register_family(
            name, functools.partial(_bwd_candidates, family=name),
            _bwd_runner(launch), cleanup=_runner_cleanup)


_register_families()
