"""The slotted KV cache and its views (port of ``paddle_tpu/serving/cache.py``:
``SlottedKVCache``, ``DecodeView``, ``PrefillView``; unquantized only).

    k, v    : (num_slots, layers, max_len, heads, head_dim)
    lengths : (num_slots,) int32            # valid prefix per slot

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
"""
from __future__ import annotations

import torch

__all__ = ["SlottedKVCache", "DecodeView", "PrefillView", "is_cache_view"]


class SlottedKVCache:
    """The preallocated cache state (plain tensors, updated in place)."""

    def __init__(self, k, v, lengths):
        self.k = k
        self.v = v
        self.lengths = lengths

    @classmethod
    def create(cls, num_slots, num_layers, max_len, num_heads, head_dim,
               dtype=torch.float32, device="cpu"):
        shape = (int(num_slots), int(num_layers), int(max_len),
                 int(num_heads), int(head_dim))
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros((int(num_slots),), dtype=torch.int32,
                               device=device))

    def __repr__(self):
        return ("SlottedKVCache(slots=%d, layers=%d, max_len=%d, heads=%d, "
                "head_dim=%d, dtype=%s)" % (tuple(self.k.shape)
                                            + (self.k.dtype,)))


def is_cache_view(obj) -> bool:
    return isinstance(obj, _CacheView)


class _CacheView:
    """Carrier of the cache through the model's per-layer walk."""

    def __init__(self, cache: SlottedKVCache):
        self.cache = cache
        self.k = cache.k
        self.v = cache.v
        self.lengths = cache.lengths
        self._layer = 0

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

    def __init__(self, cache: SlottedKVCache, active=None):
        super().__init__(cache)
        self.active = active
        self._steps = 0
        self._rows = None

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
        from ..kernels.decode_attention import decode_attention
        s = int(q.shape[1])
        self._steps = s
        b_idx, rows, src, write = self._write_rows(s)
        kl, vl = self.k[:, layer], self.v[:, layer]
        write4 = write[..., None, None]
        kl[b_idx, rows] = torch.where(write4, k_new[b_idx, src].to(kl.dtype),
                                      kl[b_idx, rows])
        vl[b_idx, rows] = torch.where(write4, v_new[b_idx, src].to(vl.dtype),
                                      vl[b_idx, rows])
        return decode_attention(q, kl, vl, self.lengths, scale=scale)

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
        self.k[self.slot, layer, :s] = k_new[0]
        self.v[self.slot, layer, :s] = v_new[0]
        # fresh slot: nothing precedes the block — plain causal attention
        # over the bucket, through the CUDA flash kernel when it applies
        if fa.supported(q, k_new):
            return fa.flash_attention_bshd(q, k_new, v_new, causal=True,
                                           scale=scale)
        return sdpa_reference_raw(q, k_new, v_new, None, 0.0, True, scale)

    def finalize(self) -> SlottedKVCache:
        self.lengths[self.slot] = self.true_len
        return self.cache
