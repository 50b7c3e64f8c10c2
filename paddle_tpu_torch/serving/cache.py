"""The KV cache layouts and their views (port of
``paddle_tpu/serving/cache.py``: ``SlottedKVCache``, ``DecodeView``,
``PrefillView``, ``PagedKVCache``, ``paged_scatter``,
``PagedDecodeView``, ``PagedPrefillChunkView``, each unquantized or
quantized).

Slotted, per-slot contiguous:

    k, v    : (num_slots, layers, max_len, heads, head_dim)
    lengths : (num_slots,) int32            # valid prefix per slot

Paged, a fixed pool of fixed-size pages plus a per-slot page table
(vLLM's PagedAttention layout; :mod:`.pages` owns the host-side
allocator):

    k, v       : (num_pages + 1, layers, page_size, heads, head_dim)
    page_table : (num_slots, max_pages) int64   # page ids per slot
    lengths    : (num_slots,) int32

**The sink page.**  The JAX scatter routes a write it must drop (chunk
padding, an inactive decode lane, a row past the declared ``max_len``)
to page id ``num_pages``, one past the pool, and XLA drops the
out-of-range write.  PyTorch's index writes raise out of range instead,
so the port's pool holds one page more: page ``num_pages`` is the sink.
It is never mapped and never read; every dropped write lands there.

**Quantized pools** (``kv_dtype="int8"`` or ``"fp8"``, float8 e4m3, at
``create``): ``k``/``v`` hold 1-byte codes and the scale pools hold one
f32 scale per (row, head), in the pool's page or slot structure (the
paged ones with the sink page too):

    k_scale, v_scale : (num_pages + 1, layers, page_size, heads)  (paged)
    k_scale, v_scale : (num_slots, layers, max_len, heads)        (slotted)

Appends quantize (``kernels.decode_attention.quantize_kv``) and the q8
attention variants dequantize what they read.  ``PrefillView`` writes
quantized rows but attends the exact K/V (nothing precedes its block);
``PagedPrefillChunkView`` attends its own quantized rows, the values
every later step reads, as in the JAX package.  An fp8 pool is indexed
through its bytes (``raw_bytes``).  A decode view given ``quant_err`` (a
one-element f32 tensor) folds the max abs dequantization error of every
row it quantizes into it, in place, as the JAX views' carried
``quant_err`` scalar does (the ``serving.kv_quant_error`` gauge).

**Updates in place.**  The JAX package donates the cache buffers to each
compiled step and XLA aliases them input to output.  PyTorch runs
eagerly, so the views write new K/V rows straight into ``k``/``v`` and
advance ``lengths`` in place; a view's ``finalize()`` returns the same
cache object.

Attention over the cache is masked to each slot's valid prefix: the query
at block offset ``j`` of a slot with pre-append length ``n`` sits at
global position ``n + j`` and attends keys ``t <= n + j``.

Views adapt a cache to the model's per-layer walk: each attention layer
calls :meth:`_CacheView.attend` in order and the view hands out layer
indices from a cursor.

* :class:`DecodeView` — batched: batch == num_slots, every slot computes.
* :class:`PrefillView` — one right-padded sequence into one slot; plain
  causal attention over the bucket (nothing precedes it), through the
  CUDA flash-attention forward when the shapes allow.
* :class:`PagedDecodeView` — batched over the page pool.
* :class:`PagedPrefillChunkView` — one fixed-size chunk of one slot's
  prompt, attending the slot's mapped past (shared prefix pages
  included) and its own causal band through the paged attention.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from ..kernels.decode_attention import dequantize_kv, quantize_kv, raw_bytes

__all__ = ["SlottedKVCache", "DecodeView", "PrefillView", "PagedKVCache",
           "PagedDecodeView", "PagedPrefillChunkView", "paged_scatter",
           "is_cache_view", "quantize_kv", "dequantize_kv"]


def _as_kv_dtypes(kv_dtype):
    """(code dtype, scale dtype), or (None, None) for an unquantized
    pool.  Takes ``"int8"``, ``"float8_e4m3fn"``, the ``"fp8"``
    shorthand, or the torch dtypes; anything else raises ValueError."""
    if kv_dtype is None:
        return None, None
    dt = kv_dtype
    if not isinstance(dt, torch.dtype):
        try:
            name = (kv_dtype.strip().lower() if isinstance(kv_dtype, str)
                    else np.dtype(kv_dtype).name)
        except TypeError:
            name = None
        if name == "fp8":
            name = "float8_e4m3fn"
        dt = getattr(torch, name, None) if name else None
    if dt not in (torch.int8, torch.float8_e4m3fn):
        raise ValueError("kv_dtype %r unsupported (int8 or fp8/"
                         "float8_e4m3fn)" % (kv_dtype,))
    return dt, torch.float32


def _pools(shape, dtype, kv_dtype, device):
    """(k, v, k_scale, v_scale) zeroed: the scale pools are None for an
    unquantized pool."""
    code_dt, scale_dt = _as_kv_dtypes(kv_dtype)
    pool_dt = dtype if code_dt is None else code_dt
    k, v = (torch.zeros(shape, dtype=pool_dt, device=device)
            for _ in range(2))
    if scale_dt is None:
        return k, v, None, None
    return (k, v) + tuple(torch.zeros(shape[:-1], dtype=scale_dt,
                                      device=device) for _ in range(2))


class SlottedKVCache:
    """The preallocated cache state (plain tensors, updated in place).
    ``k_scale``/``v_scale`` are the per-(row, head) f32 scale pools of a
    quantized cache (None for an unquantized one)."""

    def __init__(self, k, v, lengths, k_scale=None, v_scale=None):
        self.k = k
        self.v = v
        self.lengths = lengths
        self.k_scale = k_scale
        self.v_scale = v_scale

    @classmethod
    def create(cls, num_slots, num_layers, max_len, num_heads, head_dim,
               dtype=torch.float32, device=None, kv_dtype=None):
        """Zeroed buffers on ``device``; ``None`` is the first card
        (``core.device.resolve_device``), so a caller wanting the CPU
        says ``device="cpu"``."""
        device = resolve_device(device)
        shape = (int(num_slots), int(num_layers), int(max_len),
                 int(num_heads), int(head_dim))
        k, v, ks, vs = _pools(shape, dtype, kv_dtype, device)
        return cls(k, v, torch.zeros((int(num_slots),), dtype=torch.int32,
                                     device=device), k_scale=ks, v_scale=vs)

    @property
    def quantized(self):
        return self.k_scale is not None

    def __repr__(self):
        return ("SlottedKVCache(slots=%d, layers=%d, max_len=%d, heads=%d, "
                "head_dim=%d, dtype=%s)" % (tuple(self.k.shape)
                                            + (self.k.dtype,)))


class PagedKVCache:
    """Block-structured cache state: a fixed pool of fixed-size KV pages
    plus a per-slot page table (plain tensors, updated in place).
    Unmapped page-table entries hold 0 — they gather page 0's rows,
    which the length mask discards.  The pool holds ``num_pages`` pages
    and the sink page after them (module docstring)."""

    def __init__(self, k, v, page_table, lengths, declared_max_len=None,
                 k_scale=None, v_scale=None):
        self.k = k
        self.v = v
        self.page_table = page_table
        self.lengths = lengths
        self.k_scale = k_scale
        self.v_scale = v_scale
        # the DECLARED length budget, when tighter than the table's
        # capacity (max_len % page_size != 0 leaves dead rows in the tail
        # page)
        self.declared_max_len = (None if declared_max_len is None
                                 else int(declared_max_len))

    @classmethod
    def create(cls, num_pages, num_layers, page_size, num_heads, head_dim,
               num_slots, max_pages, dtype=torch.float32, device=None,
               kv_dtype=None):
        """Zeroed buffers on ``device`` (None: the first card); the scale
        pools, when quantized, hold the sink page too."""
        device = resolve_device(device)
        shape = (int(num_pages) + 1, int(num_layers), int(page_size),
                 int(num_heads), int(head_dim))
        k, v, ks, vs = _pools(shape, dtype, kv_dtype, device)
        return cls(k, v, torch.zeros((int(num_slots), int(max_pages)),
                                     dtype=torch.int64, device=device),
                   torch.zeros((int(num_slots),), dtype=torch.int32,
                               device=device), k_scale=ks, v_scale=vs)

    @classmethod
    def create_dense(cls, num_slots, num_layers, max_len, num_heads,
                     head_dim, page_size, dtype=torch.float32, device=None,
                     kv_dtype=None):
        """A pool with exactly one page set per slot, identity-mapped
        (slot ``i`` owns pages ``[i*max_pages, (i+1)*max_pages)``) — the
        allocator-free layout for model-level use (``gen_paged_cache``):
        capacity matches the slotted cache, only the memory is paged."""
        max_pages = -(-int(max_len) // int(page_size))
        cache = cls.create(int(num_slots) * max_pages, num_layers,
                           page_size, num_heads, head_dim, num_slots,
                           max_pages, dtype, device, kv_dtype)
        table = torch.arange(int(num_slots) * max_pages, dtype=torch.int64,
                             device=cache.k.device).reshape(
                                 int(num_slots), max_pages)
        return cls(cache.k, cache.v, table, cache.lengths,
                   declared_max_len=int(max_len), k_scale=cache.k_scale,
                   v_scale=cache.v_scale)

    @property
    def quantized(self):
        return self.k_scale is not None

    @property
    def num_pages(self):
        """Pages the allocator may hand out (the sink page excluded)."""
        return int(self.k.shape[0]) - 1

    @property
    def page_size(self):
        return int(self.k.shape[2])

    @property
    def max_pages(self):
        return int(self.page_table.shape[1])

    @property
    def max_len(self):
        cap = self.max_pages * self.page_size
        return cap if self.declared_max_len is None \
            else min(self.declared_max_len, cap)

    def __repr__(self):
        return ("PagedKVCache(pages=%d, layers=%d, page_size=%d, heads=%d, "
                "head_dim=%d, slots=%d, max_pages=%d, dtype=%s)"
                % ((self.num_pages,) + tuple(self.k.shape[1:])
                   + tuple(self.page_table.shape) + (self.k.dtype,)))


def paged_scatter(kc, vc, layer, table, pos, valid, k_new, v_new, ksc=None,
                  vsc=None, ks_new=None, vs_new=None):
    """Scatter ``k_new/v_new: (B, s, heads, head_dim)`` into page rows of
    ``layer``, in place.  For a quantized pool, ``k_new/v_new`` are the
    codes and ``ks_new/vs_new: (B, s, heads)`` the scale rows, written
    into the scale pools ``ksc/vsc`` through the same indices (the sink
    page included).

    ``table: (B, max_pages)`` maps each lane's pages; ``pos: (B, s)`` are
    global token positions; entries with ``valid`` False (inactive decode
    lanes, chunk padding, rows past ``max_len``) — or positions past the
    table — go to the sink page (module docstring), where the JAX
    scatter drops them.  Distinct valid lanes never collide: the
    allocator copy-on-writes any shared page before a write can target
    it."""
    page_id, row = _scatter_index(table, pos, valid, int(kc.shape[2]),
                                  int(kc.shape[0]) - 1)
    _write_rows(((kc, k_new), (vc, v_new), (ksc, ks_new), (vsc, vs_new)),
                layer, page_id, row)


def _scatter_index(table, pos, valid, page_size, sink):
    """(page id, row in the page) of each write of :func:`paged_scatter`:
    the same for every layer, so the views form it once a step."""
    max_pages = int(table.shape[1])
    page_idx = pos.long() // page_size
    page_id = torch.gather(table, 1, page_idx.clamp(0, max_pages - 1))
    page_id = torch.where(valid & (page_idx < max_pages), page_id, sink)
    return page_id, pos.long() % page_size


def _write_rows(pairs, layer, page_id, row):
    """Index-write each (pool, new rows) pair; a None pool is skipped."""
    for pool, new in pairs:
        if pool is not None:
            raw_bytes(pool)[page_id, layer, row] = raw_bytes(
                new.to(pool.dtype))


def is_cache_view(obj) -> bool:
    return isinstance(obj, _CacheView)


class _CacheView:
    """Carrier of the cache through the model's per-layer walk."""

    def __init__(self, cache: SlottedKVCache, quant_err=None):
        self.cache = cache
        self.k = cache.k
        self.v = cache.v
        self.k_scale = cache.k_scale
        self.v_scale = cache.v_scale
        self.lengths = cache.lengths
        self._layer = 0
        # the opt-in error accumulator, for a quantized cache only
        self.quant_err = quant_err if self.quantized else None

    @property
    def quantized(self):
        return self.k_scale is not None

    def _new_rows(self, k_new, v_new):
        """This layer's (pool, new rows) pairs: K and V, and for a
        quantized cache the codes and the scale rows (the pool's dtype
        picks the grid)."""
        if not self.quantized:
            return ((self.k, k_new), (self.v, v_new))
        kq, ks = quantize_kv(k_new, self.k.dtype)
        vq, vs = quantize_kv(v_new, self.v.dtype)
        if self.quant_err is not None:
            for x, q, sc in ((k_new, kq, ks), (v_new, vq, vs)):
                err = (dequantize_kv(q, sc, torch.float32)
                       - x.float()).abs().amax()
                torch.maximum(self.quant_err, err, out=self.quant_err)
        return ((self.k, kq), (self.v, vq), (self.k_scale, ks),
                (self.v_scale, vs))

    def _scales(self, layer):
        """The q8 attention's scale keywords for ``layer`` (none for an
        unquantized cache)."""
        if not self.quantized:
            return {}
        return {"k_scales": self.k_scale[:, layer],
                "v_scales": self.v_scale[:, layer]}

    def _alloc_layer(self) -> int:
        i = self._layer
        if i >= int(self.k.shape[1]):
            raise ValueError(
                "cache view exhausted: model has more attention layers "
                "than the cache's layer axis (%d)" % (self.k.shape[1],))
        self._layer = i + 1
        return i

    def attend(self, q, k_new, v_new, scale=None):
        """Append this layer's new K/V rows and attend; q/k/v are
        (batch, s, heads, head_dim)."""
        return self._append_attend(self._alloc_layer(), q, k_new, v_new,
                                   scale)


class DecodeView(_CacheView):
    """Batched decode: q/k/v arrive as (num_slots, s, heads, head_dim);
    each slot's ``s`` new tokens are written at rows
    ``[lengths[b], lengths[b] + s)`` and attention is masked to
    ``t <= lengths[b] + j``.  ``active`` gates which slots advance their
    length at :meth:`finalize`: inactive slots still compute and write,
    past their frozen valid prefix, and a later prefill into the slot
    overwrites those rows.  Rows at or past ``max_len`` are dropped, as
    XLA's scatter drops them in the JAX package."""

    def __init__(self, cache: SlottedKVCache, active=None, quant_err=None):
        super().__init__(cache, quant_err=quant_err)
        self.active = active
        self._steps = 0
        self._rows = None
        self._block_t = None

    def position_ids(self, batch, seq_len):
        if batch != int(self.k.shape[0]):
            raise ValueError(
                "batched decode needs batch == num_slots (%d), got %d — "
                "use PrefillView for single sequences"
                % (self.k.shape[0], batch))
        return (self.lengths[:, None]
                + torch.arange(seq_len, dtype=torch.int32,
                               device=self.lengths.device)[None, :])

    def _write_rows(self, s):
        """(slot index, clamped row, source token, write mask) of this
        step's appends, shared by every layer.

        An append at or past ``max_len`` is dropped, as the JAX scatter
        drops it: it targets the last row and carries what that row ends
        up holding (the append that lands there, else the row's old
        value).  So every write to a repeated row carries the same value,
        and the index write stays deterministic on a card."""
        if self._rows is None or self._rows[1].shape[1] != s:
            dev = self.lengths.device
            last = int(self.k.shape[2]) - 1
            j = torch.arange(s, device=dev)[None, :]
            t_idx = self.lengths[:, None].long() + j
            keep = t_idx <= last
            j_last = last - self.lengths[:, None].long()
            lands = (j_last >= 0) & (j_last < s)
            src = torch.where(keep, j, j_last.clamp(0, s - 1))
            rows = t_idx.clamp(max=last)
            b_idx = torch.arange(int(self.k.shape[0]), device=dev)[:, None]
            self._rows = (b_idx.expand_as(rows), rows, src, keep | lands)
        return self._rows

    def _append_attend(self, layer, q, k_new, v_new, scale):
        from ..kernels.decode_attention import (decode_attention,
                                                resolve_block_t)
        s = int(q.shape[1])
        self._steps = s
        b_idx, rows, src, write = self._write_rows(s)
        for pool, new in self._new_rows(k_new, v_new):
            dst = raw_bytes(pool[:, layer])
            keep = write.reshape(write.shape + (1,) * (dst.dim() - 2))
            dst[b_idx, rows] = torch.where(
                keep, raw_bytes(new.to(pool.dtype))[b_idx, src],
                dst[b_idx, rows])
        if self._block_t is None:
            self._block_t = resolve_block_t(
                q, self.k[:, layer], self.k.dtype if self.quantized else None)
        return decode_attention(q, self.k[:, layer], self.v[:, layer],
                                self.lengths, scale=scale,
                                block_t=self._block_t, **self._scales(layer))

    def finalize(self) -> SlottedKVCache:
        adv = torch.full_like(self.lengths, self._steps)
        if self.active is not None:
            adv = adv * self.active.to(adv.dtype)
        self.lengths.add_(adv)
        return self.cache


class PrefillView(_CacheView):
    """Bucketed single-sequence prefill into one slot: input is
    ``(1, bucket)`` right-padded tokens with ``true_len`` real ones.
    Writes rows ``[0, bucket)`` of ``slot`` and attends causally — pad
    rows compute values that stay masked (``lengths[slot] = true_len``)
    and that later decode appends overwrite."""

    def __init__(self, cache: SlottedKVCache, slot, true_len):
        super().__init__(cache)
        self.slot = int(slot)
        self.true_len = int(true_len)

    def position_ids(self, batch, seq_len):
        if batch != 1:
            raise ValueError("PrefillView is single-sequence (got batch=%d)"
                             % batch)
        return torch.arange(seq_len, dtype=torch.int32,
                            device=self.lengths.device)[None, :]

    def _append_attend(self, layer, q, k_new, v_new, scale):
        from ..kernels import flash_attention as fa
        from ..nn.functional.attention import sdpa_reference_raw
        s = int(k_new.shape[1])
        for pool, new in self._new_rows(k_new, v_new):
            raw_bytes(pool)[self.slot, layer, :s] = raw_bytes(new[0])
        # fresh slot: nothing precedes the block — plain causal attention
        # over the bucket's exact K/V, through the CUDA flash kernel when
        # it applies
        if fa.supported(q, k_new):
            return fa.flash_attention_bshd(q, k_new, v_new, causal=True,
                                           scale=scale)
        return sdpa_reference_raw(q, k_new, v_new, None, 0.0, True, scale)

    def finalize(self) -> SlottedKVCache:
        self.lengths[self.slot] = self.true_len
        return self.cache


class _PagedView(_CacheView):
    """A view over the page pool: each layer appends through the sink-
    page scatter and attends through the paged attention.  The write
    indices, the attention's pre-append lengths and its variant are the
    same for every layer, so they are formed once, at the first layer."""

    def __init__(self, cache: PagedKVCache, quant_err=None):
        super().__init__(cache, quant_err=quant_err)
        self.page_table = cache.page_table
        self._step = None

    def _table(self):
        raise NotImplementedError

    def _writes(self, s):
        """(positions, valid mask, pre-append lengths) of ``s`` appends."""
        raise NotImplementedError

    def _append_attend(self, layer, q, k_new, v_new, scale):
        from ..kernels.decode_attention import (paged_decode_attention,
                                                resolve_pages_per_block)
        table = self._table()
        if self._step is None or self._step[0].shape[1] != q.shape[1]:
            pos, valid, lengths = self._writes(int(q.shape[1]))
            self._step = _scatter_index(
                table, pos, valid, int(self.k.shape[2]),
                int(self.k.shape[0]) - 1) + (
                lengths, resolve_pages_per_block(
                    q, self.k[:, layer], table,
                    self.k.dtype if self.quantized else None))
        page_id, row, lengths, blocks = self._step
        _write_rows(self._new_rows(k_new, v_new), layer, page_id, row)
        return paged_decode_attention(q, self.k[:, layer], self.v[:, layer],
                                      table, lengths, scale=scale,
                                      pages_per_block=blocks,
                                      **self._scales(layer))


class PagedDecodeView(_PagedView):
    """Batched decode over the paged pool: q/k/v arrive as
    ``(num_slots, s, heads, head_dim)``; each slot's new tokens scatter
    into its mapped pages at rows ``lengths[b] + j`` and attention
    gathers only the slot's page-table row.  Unlike the slotted view,
    writes from INACTIVE lanes are dropped (routed to the sink page): a
    retired slot's stale table row may point at pages the allocator has
    handed to another slot, so its lane must never write.  Appends at or
    past ``max_len`` drop too, and lengths stop advancing there."""

    def __init__(self, cache: PagedKVCache, active=None, max_len=None,
                 quant_err=None):
        super().__init__(cache, quant_err=quant_err)
        self.active = active
        self.max_len = (int(max_len) if max_len is not None
                        else int(cache.max_len))
        self._steps = 0

    def position_ids(self, batch, seq_len):
        if batch != int(self.page_table.shape[0]):
            raise ValueError(
                "batched paged decode needs batch == num_slots (%d), got "
                "%d — use PagedPrefillChunkView for single sequences"
                % (self.page_table.shape[0], batch))
        return (self.lengths[:, None]
                + torch.arange(seq_len, dtype=torch.int32,
                               device=self.lengths.device)[None, :])

    def _table(self):
        return self.page_table

    def _writes(self, s):
        self._steps = s
        pos = self.position_ids(int(self.lengths.shape[0]), s)
        valid = pos < self.max_len
        if self.active is not None:
            valid = valid & self.active[:, None]
        return pos, valid, self.lengths

    def finalize(self, advance=None) -> PagedKVCache:
        """``advance`` (per-slot, optional) replaces the uniform advance
        of ``s`` rows a slot: the speculative verify passes the accepted
        count + 1, so a rejected draft moves no length (its rows stay
        written past the length, and the next step overwrites them)."""
        adv = (torch.full_like(self.lengths, self._steps) if advance is None
               else advance.to(self.lengths.dtype))
        if self.active is not None:
            adv = adv * self.active.to(adv.dtype)
        torch.minimum(self.lengths + adv,
                      torch.full_like(self.lengths, self.max_len),
                      out=self.lengths)
        return self.cache


class PagedPrefillChunkView(_PagedView):
    """One fixed-size prefill chunk of one slot's prompt: input is
    ``(1, chunk)`` right-padded tokens, ``n_valid`` of them real, at
    global positions ``n_before + j``.  Writes land in the slot's mapped
    pages (the engine maps them on the host before the chunk runs);
    padding writes go to the sink page.  Attention gathers the slot's
    page-table row and masks ``t <= n_before + j`` — the full mapped
    past (shared prefix pages included) plus the chunk's own causal
    band, so a chunk after a prefix-cache hit attends to pages it never
    computed.

    ``slot``, ``n_before`` and ``n_valid`` are Python ints, or 0-d int32
    tensors on the pool's device: the operands of the captured chunk
    (``DecodeEngine._chunk_step``), which a replay reads from static
    buffers, as the JAX ``prefill_chunk_fn`` takes them as operands.  The
    two forms run the same arithmetic on the same values, so their
    logits and writes are bit for bit the same (the int form is the
    reference ``tests/test_torch_prefill_chunk.py`` holds the operand form
    against)."""

    def __init__(self, cache: PagedKVCache, slot, n_before, n_valid):
        super().__init__(cache)
        self._operands = isinstance(slot, torch.Tensor)
        if self._operands:
            self.slot, self.n_before, self.n_valid = slot, n_before, n_valid
        else:
            self.slot = int(slot)
            self.n_before = int(n_before)
            self.n_valid = int(n_valid)

    def position_ids(self, batch, seq_len):
        if batch != 1:
            raise ValueError(
                "PagedPrefillChunkView is single-sequence (got batch=%d)"
                % batch)
        return self.n_before + torch.arange(
            seq_len, dtype=torch.int32, device=self.lengths.device)[None, :]

    def _table(self):
        if self._operands:
            return self.page_table.index_select(0, self.slot.view(1))
        return self.page_table[self.slot:self.slot + 1]

    def _writes(self, c):
        pos = self.position_ids(1, c)
        valid = torch.arange(c, device=pos.device)[None, :] < self.n_valid
        if self._operands:
            return pos, valid, self.n_before.view(1)
        return pos, valid, torch.full((1,), self.n_before, dtype=torch.int32,
                                      device=pos.device)

    def finalize(self) -> PagedKVCache:
        if self._operands:
            self.lengths.index_copy_(
                0, self.slot.view(1).long(),
                (self.n_before + self.n_valid).view(1).to(
                    self.lengths.dtype))
        else:
            self.lengths[self.slot] = self.n_before + self.n_valid
        return self.cache
