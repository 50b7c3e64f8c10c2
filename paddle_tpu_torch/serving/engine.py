"""The decode engine (port of ``paddle_tpu/serving/engine.py``): a KV cache
preallocated once, prompt admission, and a batched decode step over
every slot.  Two cache layouts, ``paged=True`` the default as in the JAX
package:

* **Paged** — a fixed pool of fixed-size KV pages plus a per-slot page
  table (:class:`~.cache.PagedKVCache` and the host-side
  :class:`~.pages.PageAllocator`).

  - ``prefill_begin`` / ``prefill_step`` admit a prompt one fixed-size
    chunk per call (:class:`~.cache.PagedPrefillChunkView`), so the
    scheduler can interleave a long admission with live decode steps.
    Only the final chunk samples (the first generated token), and only
    it draws from the sampling generator: the chunk count depends on
    the prefix cache, and ``generate(seed=s)`` must give the same
    tokens whether or not a prompt hits it.
  - **Prefix sharing**: prompt pages are content-hashed; an admission
    maps the leading hits to the existing refcounted pages instead of
    recomputing them, capped at ``n - 1`` tokens so that the final
    token always runs through a chunk and yields the first-token
    logits (a fully cached prompt admits in one 1-token chunk).
  - **Copy-on-write**: a write into a shared page first copies it to a
    fresh private page (``_cow_page``).
  - ``decode_submit`` / ``decode`` advance every active slot one token,
    scattering into each slot's tail page and attending through the
    plain paged attention (``kernels.decode_attention``); the pages an
    append needs are mapped first (``ensure_decode_ready``), and a dry
    pool raises :class:`~.pages.PagePoolExhausted` for the scheduler to
    evict a slot.
  - **Speculative verify** (``spec_k > 0``, paged only, as in JAX):
    ``decode_spec_submit`` / ``decode_spec_fetch`` / ``decode_spec``
    run ONE forward over each slot's ``[last token, k drafts]``
    (drafts from :func:`.spec.propose`), accept a prefix and sample one
    token (:func:`.sampling.spec_accept`, capped at ``max_len - 1 -
    length``), and advance each length by the accepted count + 1; a
    rejected draft's rows stay written past the length and the next
    step overwrites them.  The host length mirror advances at fetch,
    the step's one sync.

* **Slotted** (``paged=False``) — per-slot contiguous ``max_len``
  buffers, bucketed whole-prompt prefill (the CUDA flash forward on a
  card, one launch per layer).

The JAX engine compiles each entry once and donates the cache; PyTorch
runs the same model eagerly and the views update the cache buffers in
place.  The host keeps the page table and a mirror of the lengths: the
table is uploaded only when it changed, and ``slot_lengths`` reads the
mirror, so a scheduler iteration makes no extra device sync.  Sampling
noise comes from one ``torch.Generator`` per engine on the engine's
device; ``reseed(s)`` restarts it.  The engine reads the model's live
parameters; a paged engine drops its prefix cache when a parameter
changed since the cache was filled (``refresh_state``, checked at every
admission), so a prefix hit never serves K/V of older weights.

**Quantized KV** (``kv_dtype="int8"``, ``"fp8"`` or
``"float8_e4m3fn"``, either layout): the pools hold 1-byte codes and an
f32 scale per (row, head) (:mod:`.cache`); ``kv_row_bytes`` and what is
derived from it price codes plus scales.

The engine runs on the card unless ``device="cpu"`` is given, and moves
the model there.  Not ported yet, and raising ``NotImplementedError``
instead of running something else (ROADMAP.md §A5): tensor
parallelism.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.dtype import convert_dtype
from ..kernels.decode_attention import raw_bytes
from .cache import (DecodeView, PagedDecodeView, PagedKVCache,
                    PagedPrefillChunkView, PrefillView, SlottedKVCache,
                    _as_kv_dtypes)
from .pages import PageAllocator, PagePoolExhausted
from .sampling import TOP_K_MAX, sample, spec_accept

__all__ = ["DecodeEngine", "InflightDecode", "PagePoolExhausted",
           "PrefillTask", "prefill_buckets_for"]

def prefill_buckets_for(max_len, min_bucket=16):
    """Power-of-two prefill buckets up to ``max_len``; a non-power-of-two
    ``max_len`` is appended as the final bucket so every prompt that fits
    the cache has a bucket."""
    out = []
    b = min(int(min_bucket), int(max_len))
    while b <= int(max_len):
        out.append(b)
        b *= 2
    if not out or out[-1] < int(max_len):
        out.append(int(max_len))
    return out


@contextlib.contextmanager
def _eval_scope(model):
    """Run with the model in eval mode, then restore the caller's mode."""
    was_training = bool(model.training)
    model.eval()
    try:
        yield
    finally:
        if was_training:
            model.train()


@dataclasses.dataclass
class InflightDecode:
    """One launched decode (or speculative verify) step whose results
    are not fetched yet: device tensors only."""
    kind: str                             # "decode" | "spec"
    active: "np.ndarray"                  # (S,) bool, the step's lanes
    logits: object                        # (S, vocab) | (S, k+1, vocab)
    tok: object = None                    # (S,) int32 (decode)
    emitted: object = None                # (S, k+1) int32 (spec)
    counts: object = None                 # (S,) int32 accepted+1 (spec)
    paged_rows: int = 0                   # mapped rows at launch (spec)


@dataclasses.dataclass
class PrefillTask:
    """Host-side state of one in-flight chunked admission."""
    slot: int
    ids: "np.ndarray"                     # the full prompt, int32
    pos: int                              # next position to compute
    temperature: float
    top_k: int
    top_p: float
    shared_tokens: int = 0                # prefix-cache coverage (capped)
    shared_pages: int = 0                 # pages mapped instead of computed
    chunks_run: int = 0
    done: bool = False
    first_token: int = -1                 # sampled by the FINAL chunk
    last_logits: object = None            # (vocab,) device tensor


class DecodeEngine:
    """Serving engine for a causal LM with a ``config`` carrying the GPT
    geometry (:class:`paddle_tpu_torch.models.gpt.GPTForCausalLM`)."""

    def __init__(self, model, num_slots=4, max_len=None, cache_dtype=None,
                 min_bucket=16, seed=0, top_k_max=TOP_K_MAX, paged=True,
                 page_size=64, num_pages=None, prefill_chunk=None,
                 kv_dtype=None, spec_k=0, spec_ngram=3, tp=1, device=None):
        cfg = model.config
        self.paged = bool(paged)
        self.num_slots = int(num_slots)
        self.max_len = int(max_len or cfg.max_position_embeddings)
        if self.max_len > cfg.max_position_embeddings:
            raise ValueError(
                "max_len %d exceeds the model's position budget %d"
                % (self.max_len, cfg.max_position_embeddings))
        self.top_k_max = int(top_k_max)
        if cache_dtype is None:
            # the embedding dtype is what the residual stream (and so K/V)
            # runs in
            cache_dtype = model.gpt.wte.weight.dtype
        self._layers = cfg.num_hidden_layers
        self._heads = cfg.num_attention_heads
        self._head_dim = cfg.hidden_size // cfg.num_attention_heads
        self._cache_dtype = convert_dtype(cache_dtype)
        # the cache's own gate canonicalizes kv_dtype ("fp8" included)
        self._kv_code_dtype, _ = _as_kv_dtypes(kv_dtype)
        self.spec_k = int(spec_k)
        self.spec_ngram = int(spec_ngram)
        if self.spec_k < 0:
            raise ValueError("spec_k must be >= 0")
        if self.spec_k and not self.paged:
            raise ValueError(
                "speculative decode runs on the paged engine (spec_k "
                "with paged=False is not supported — the slotted layout "
                "is the A/B baseline)")
        if self.spec_k >= self.max_len:
            raise ValueError("spec_k %d must be < max_len %d"
                             % (self.spec_k, self.max_len))
        if int(tp) != 1:
            raise NotImplementedError(
                "tensor parallelism is not ported to paddle_tpu_torch yet "
                "(ROADMAP.md §A5)")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        # decode KV-read accounting: per decode or verify step,
        # `paged_rows` adds the rows a length-aware paged schedule reads
        # (mapped pages, one sweep a step however many tokens it commits)
        # and `flat_rows` the slotted slots * max_len sweep a token
        self.kv_stats = {"tokens": 0, "paged_rows": 0, "flat_rows": 0}
        # speculative accounting: verify steps, drafts proposed (k an
        # active lane) and accepted
        self.spec_stats = {"steps": 0, "proposed": 0, "accepted": 0}
        if self.paged:
            self._init_paged(page_size, num_pages, prefill_chunk)
        else:
            self.buckets = prefill_buckets_for(self.max_len, min_bucket)
            self.prompt_cap = self.buckets[-1]
            self.cache = SlottedKVCache.create(
                self.num_slots, self._layers, self.max_len, self._heads,
                self._head_dim, self._cache_dtype, self.device,
                kv_dtype=self.kv_dtype)
        self._state_versions = self._param_versions()
        self._generator = torch.Generator(device=self.device)
        self.reseed(seed)

    def _init_paged(self, page_size, num_pages, prefill_chunk):
        self.page_size = min(int(page_size), self.max_len)
        self.max_pages = -(-self.max_len // self.page_size)
        # default pool: capacity parity with the slotted layout (every
        # slot can reach max_len); a smaller pool saves memory where
        # lengths are short or prefixes shared
        self.num_pages = int(num_pages if num_pages is not None
                             else self.num_slots * self.max_pages)
        self.prefill_chunk = int(prefill_chunk if prefill_chunk is not None
                                 else min(64, self.max_len))
        self.prompt_cap = self.max_len
        self._alloc = PageAllocator(self.num_pages, self.num_slots,
                                    self.max_pages, self.page_size)
        self._len_host = np.zeros((self.num_slots,), np.int64)
        self.cache = PagedKVCache.create(
            self.num_pages, self._layers, self.page_size, self._heads,
            self._head_dim, self.num_slots, self.max_pages,
            self._cache_dtype, self.device, kv_dtype=self.kv_dtype)
        self.cow_copies = 0               # pages copied on write
        self.pages_used_peak = 0          # most pages mapped at once

    @property
    def kv_dtype(self):
        """The pools' code dtype (``torch.int8`` or
        ``torch.float8_e4m3fn``), or None for an unquantized pool."""
        return self._kv_code_dtype

    # -- host-side API -----------------------------------------------------

    def _param_versions(self):
        """Each parameter's identity and in-place version counter: the
        port's optimizers update parameters in place, so identity alone
        (the JAX package's change test) would never see a step."""
        return tuple((id(p), p._version) for p in self.model.parameters())

    def refresh_state(self):
        """Drop the prefix cache when any parameter changed since it was
        filled: its pages hold K/V computed under the old parameters, and
        a hash hit would splice stale cache into a fresh prompt.  Pages
        still mapped by live slots keep decoding.  Returns whether a
        change was seen.  Checked at every paged admission and on every
        cached-engine reuse (``engine_for``)."""
        versions = self._param_versions()
        if versions == self._state_versions:
            return False
        self._state_versions = versions
        if self.paged:
            self._alloc.drop_prefix_cache()
        return True

    def reset(self):
        """Free every slot (paged: pages return to the pool and the prefix
        cache is dropped; slot contents are overwritten lazily)."""
        self.kv_stats = {"tokens": 0, "paged_rows": 0, "flat_rows": 0}
        self.spec_stats = {"steps": 0, "proposed": 0, "accepted": 0}
        if self.paged:
            self._alloc.reset()
            self._len_host[:] = 0
        self.cache.lengths.zero_()

    def reseed(self, seed):
        """Restart the sampling stream: after ``reseed(s)`` the next
        prefill/decode sequence reproduces a fresh engine built with
        ``seed=s``."""
        self._generator.manual_seed(int(seed))

    def bucket_for(self, n):
        if self.paged:
            raise AttributeError("paged engines have no prefill buckets "
                                 "(one chunk size) — use prefill_chunk")
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(
            "prompt length %d exceeds the largest prefill bucket %d "
            "(max_len=%d)" % (n, self.buckets[-1], self.max_len))

    def slot_lengths(self):
        """Per-slot valid lengths.  Paged engines serve the host mirror
        (no device-to-host sync); slotted ones copy from the device."""
        if self.paged:
            return self._len_host.copy()
        return self.cache.lengths.cpu().numpy()

    def _params(self, temperature, top_k, top_p):
        dev = self.device
        return (torch.as_tensor(np.asarray(temperature, np.float32),
                                device=dev).reshape(-1),
                torch.as_tensor(np.minimum(np.asarray(top_k, np.int32),
                                           self.top_k_max),
                                device=dev).reshape(-1),
                torch.as_tensor(np.asarray(top_p, np.float32),
                                device=dev).reshape(-1))

    def _token_column(self, tokens):
        """The per-slot last committed tokens (host array or device
        tensor) as an (S, 1) int32 tensor on the engine's device."""
        toks = torch.as_tensor(np.asarray(tokens, np.int32)
                               if not isinstance(tokens, torch.Tensor)
                               else tokens, device=self.device)
        return toks.to(torch.int32).reshape(self.num_slots, 1)

    # -- paged page bookkeeping (host side) --------------------------------

    def _note_pool(self):
        self.pages_used_peak = max(self.pages_used_peak,
                                   self._alloc.pages_used())

    def _set_length(self, slot, n):
        """Host-side length write (admission bookkeeping, off the
        per-token path)."""
        self._len_host[slot] = int(n)
        self.cache.lengths[int(slot)] = int(n)

    def _sync_table(self):
        """Point the cache at the allocator's uploaded page table (a
        host-to-device copy only when the table changed)."""
        self.cache.page_table = self._alloc.device_table(self.device)

    def free_slot(self, slot):
        """Release a retired slot's pages (refcounted) and zero its
        length.  Slotted slots need no release: the next prefill
        overwrites the slot and sets its length."""
        if not self.paged:
            return
        self._alloc.free_slot(int(slot))
        self._set_length(int(slot), 0)

    def unshared_pages(self, slot):
        """Pages ONLY this slot maps — the scheduler's refcount-aware
        eviction score (freeing the max-unshared slot returns the most
        pages to the pool)."""
        return self._alloc.unshared_pages(int(slot)) if self.paged else 0

    def pages_free(self):
        return self._alloc.pages_free() if self.paged else 0

    @torch.inference_mode()
    def _cow_page(self, slot, idx):
        """Copy-on-write ``slot``'s page-table entry ``idx`` to a fresh
        private page, every layer, the scale rows of a quantized pool
        with it (raises PagePoolExhausted when the pool is dry)."""
        new_pid = self._alloc.alloc()
        old_pid = int(self._alloc.table[int(slot), int(idx)])
        c = self.cache
        for pool in (c.k, c.v, c.k_scale, c.v_scale):
            if pool is not None:
                raw_bytes(pool)[new_pid] = raw_bytes(pool)[old_pid]
        self._alloc.remap(int(slot), int(idx), new_pid)
        self.cow_copies += 1

    def _ensure_write_range(self, slot, start, stop):
        """Map (allocating) every page covering positions [start, stop)
        of ``slot`` and copy-on-write any shared page the range writes
        into.  Raises PagePoolExhausted if the pool is dry — the
        scheduler evicts a victim and retries."""
        P = self.page_size
        for idx in range(int(start) // P, (int(stop) - 1) // P + 1):
            if not self._alloc.mapped[slot, idx]:
                self._alloc.map(slot, idx, self._alloc.alloc())
            elif self._alloc.needs_cow(slot, idx):
                self._cow_page(slot, idx)
        self._note_pool()

    def ensure_decode_ready(self, active, steps=1):
        """Pre-step page bookkeeping for one batched decode (or verify:
        ``steps = spec_k + 1`` appends a slot): every active slot's
        append range must land in mapped, PRIVATE pages.  Returns
        the first slot index that could not get a page (pool dry — evict
        and retry), or None when ready."""
        if not self.paged:
            return None
        for i, on in enumerate(active):
            if not on:
                continue
            p = int(self._len_host[i])
            if p >= self.max_len:
                continue        # the scheduler retires this slot
            try:
                self._ensure_write_range(i, p, min(p + int(steps),
                                                   self.max_len))
            except PagePoolExhausted:
                return i
        return None

    # -- prefill -----------------------------------------------------------

    def prefill_begin(self, slot, token_ids, temperature=1.0, top_k=0,
                      top_p=1.0) -> PrefillTask:
        """Start admitting ``token_ids`` into ``slot``: map any
        hash-matched prefix pages (capped at n-1 tokens so the final
        token always runs through a chunk and produces the first-token
        logits), then return the task whose chunks :meth:`prefill_step`
        advances."""
        if not self.paged:
            raise RuntimeError("chunked prefill is the paged path; "
                               "slotted engines use prefill()")
        ids = np.asarray(token_ids, np.int32).reshape(-1)
        n = int(ids.size)
        slot = int(slot)
        if n < 1:
            raise ValueError("empty prompt")
        if n > self.max_len:
            raise ValueError("prompt length %d > max_len %d"
                             % (n, self.max_len))
        if self._alloc.slot_pages(slot) or self._len_host[slot]:
            raise RuntimeError("slot %d admitted without free_slot()"
                               % slot)
        self.refresh_state()
        shared_pages, covered = self._alloc.lookup_prefix(ids)
        covered = min(covered, n - 1)
        # map only the pages the capped prefix covers (a capped full hit
        # keeps its tail page: its rows [.., n-1) stay valid cache and
        # the final chunk's write copy-on-writes it)
        n_map = -(-covered // self.page_size) if covered else 0
        for idx in range(n_map):
            self._alloc.share(slot, idx, shared_pages[idx])
        self._set_length(slot, covered)
        self._note_pool()
        return PrefillTask(slot=slot, ids=ids, pos=covered,
                           temperature=float(temperature),
                           top_k=int(top_k), top_p=float(top_p),
                           shared_tokens=covered, shared_pages=n_map)

    @torch.inference_mode()
    def prefill_step(self, task: PrefillTask) -> bool:
        """Run ONE chunk of an admission; returns True when the prompt
        is fully prefilled (``task.first_token`` / ``task.last_logits``
        are then set).  Raises PagePoolExhausted when the chunk's pages
        cannot be mapped — the scheduler evicts a victim and retries."""
        if task.done:
            return True
        n = int(task.ids.size)
        n_valid = min(self.prefill_chunk, n - task.pos)
        self._ensure_write_range(task.slot, task.pos, task.pos + n_valid)
        padded = np.zeros((1, self.prefill_chunk), np.int32)
        padded[0, :n_valid] = task.ids[task.pos:task.pos + n_valid]
        self._sync_table()
        view = PagedPrefillChunkView(self.cache, task.slot, task.pos,
                                     n_valid)
        with _eval_scope(self.model):
            logits, _ = self.model(torch.as_tensor(padded,
                                                   device=self.device),
                                   cache=view)
        view.finalize()
        task.pos += n_valid
        task.chunks_run += 1
        self._len_host[task.slot] = task.pos
        if task.pos >= n:
            # only the final chunk samples, so only it draws from the
            # generator (the chunk count depends on the prefix cache)
            last = logits[:, n_valid - 1, :]
            tok = sample(last, self._generator,
                         *self._params([task.temperature], [task.top_k],
                                       [task.top_p]), self.top_k_max)[0]
            task.done = True
            task.first_token = int(tok)
            task.last_logits = last[0]
            # publish this prompt's pages for later admissions to share
            self._alloc.register_prefix(task.slot, task.ids)
        return task.done

    @torch.inference_mode()
    def prefill(self, slot, token_ids, temperature=1.0, top_k=0,
                top_p=1.0):
        """Admit ``token_ids`` (1-D) into ``slot``; returns the sampled first
        token (int) and the last-position logits ((vocab,) device tensor).
        Paged engines run every chunk back to back (the scheduler
        interleaves them with decode through :meth:`prefill_begin` /
        :meth:`prefill_step` instead)."""
        if self.paged:
            task = self.prefill_begin(slot, token_ids, temperature, top_k,
                                      top_p)
            while not self.prefill_step(task):
                pass
            return task.first_token, task.last_logits
        ids = np.asarray(token_ids, np.int32).reshape(-1)
        n = int(ids.size)
        if n < 1:
            raise ValueError("empty prompt")
        if n > self.max_len:
            raise ValueError("prompt length %d > max_len %d"
                             % (n, self.max_len))
        bucket = self.bucket_for(n)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :n] = ids
        view = PrefillView(self.cache, slot, n)
        with _eval_scope(self.model):
            logits, _ = self.model(torch.as_tensor(padded,
                                                   device=self.device),
                                   cache=view)
        last = logits[:, n - 1, :]
        tok = sample(last, self._generator,
                     *self._params([temperature], [top_k], [top_p]),
                     self.top_k_max)[0]
        view.finalize()
        return int(tok), last[0]

    # -- decode ------------------------------------------------------------

    @torch.inference_mode()
    def decode_submit(self, tokens, active, temperature, top_k,
                      top_p, pages_ready=False) -> InflightDecode:
        """Launch one batched decode step without fetching its tokens.
        ``tokens``: the per-slot last committed tokens (host array or an
        (S,) device tensor).  A paged engine first maps the pages the
        appends need (raising PagePoolExhausted when the pool is dry),
        unless the caller did so this step (``pages_ready=True``, the
        scheduler)."""
        active_np = np.asarray(active, bool).reshape(self.num_slots)
        if self.paged and not pages_ready:
            blocked = self.ensure_decode_ready(active_np)
            if blocked is not None:
                raise PagePoolExhausted(
                    "no free page for slot %d's append — evict a slot "
                    "(the scheduler does this refcount-aware)" % blocked)
        toks = self._token_column(tokens)
        active_dev = torch.as_tensor(active_np, device=self.device)
        if self.paged:
            self._sync_table()
            view = PagedDecodeView(self.cache, active=active_dev,
                                   max_len=self.max_len)
        else:
            view = DecodeView(self.cache, active=active_dev)
        with _eval_scope(self.model):
            logits, _ = self.model(toks, cache=view)
        logits = logits[:, -1, :]
        tok = sample(logits, self._generator,
                     *self._params(temperature, top_k, top_p),
                     self.top_k_max)
        view.finalize()
        self.kv_stats["tokens"] += int(active_np.sum())
        self.kv_stats["flat_rows"] += self.num_slots * self.max_len
        if self.paged:
            # mirror the view's finalize: active lanes advance, clamped
            # at max_len (an append there was dropped)
            self._len_host[active_np] += 1
            np.minimum(self._len_host, self.max_len, out=self._len_host)
            self.kv_stats["paged_rows"] += self._alloc.mapped_rows_total()
        return InflightDecode(kind="decode", active=active_np, tok=tok,
                              logits=logits)

    def decode_fetch(self, step: InflightDecode):
        """Consume a launched step: returns (next tokens as an np array,
        logits as a device tensor)."""
        if step.kind != "decode":
            raise ValueError("decode_fetch() consumes decode steps; got a "
                             "%r step (use decode_spec_fetch)" % step.kind)
        return step.tok.cpu().numpy(), step.logits

    def decode(self, tokens, active, temperature, top_k, top_p,
               pages_ready=False):
        """One batched decode step over every slot; callers ignore the
        entries of inactive slots."""
        return self.decode_fetch(self.decode_submit(
            tokens, active, temperature, top_k, top_p,
            pages_ready=pages_ready))

    # -- speculative verify (paged engines with spec_k) --------------------

    @torch.inference_mode()
    def decode_spec_submit(self, tokens, drafts, active, temperature,
                           top_k, top_p,
                           pages_ready=False) -> InflightDecode:
        """Launch one speculative verify step without fetching its
        results.  ``tokens``: the per-slot last committed tokens (host
        array or an (S,) device tensor); ``drafts``: (num_slots, spec_k)
        proposals.  One forward scores the ``spec_k + 1`` positions of
        every slot; :func:`.sampling.spec_accept` accepts a prefix
        (capped so that no length passes ``max_len``) and the device
        lengths advance by the accepted count + 1.  The host length
        mirror and the accounting wait for :meth:`decode_spec_fetch`,
        since the advance depends on the data."""
        if not self.spec_k:
            raise RuntimeError("decode_spec needs an engine built with "
                               "spec_k > 0")
        S, k = self.num_slots, self.spec_k
        drafts_np = np.asarray(drafts, np.int32).reshape(S, k)
        vocab = int(self.model.config.vocab_size)
        if drafts_np.size and (drafts_np.min() < 0
                               or drafts_np.max() >= vocab):
            raise ValueError("draft token ids must lie in [0, %d)" % vocab)
        active_np = np.asarray(active, bool).reshape(S)
        if not pages_ready:
            blocked = self.ensure_decode_ready(active_np, steps=k + 1)
            if blocked is not None:
                raise PagePoolExhausted(
                    "no free page for slot %d's speculative appends — "
                    "evict a slot (the scheduler does this "
                    "refcount-aware)" % blocked)
        step_toks = torch.cat([self._token_column(tokens),
                               torch.as_tensor(drafts_np,
                                               device=self.device)], dim=1)
        active_dev = torch.as_tensor(active_np, device=self.device)
        self._sync_table()
        # acceptance never reaches past the cache's room: position j's
        # logits hold only while length + j < max_len
        a_cap = self.max_len - 1 - self.cache.lengths
        view = PagedDecodeView(self.cache, active=active_dev,
                               max_len=self.max_len)
        with _eval_scope(self.model):
            logits, _ = self.model(step_toks, cache=view)
        logits = logits.float()                         # (S, k+1, V)
        emitted, counts = spec_accept(
            logits, step_toks, self._generator,
            *self._params(temperature, top_k, top_p), self.top_k_max,
            max_accept=a_cap)
        view.finalize(advance=counts)
        return InflightDecode(kind="spec", active=active_np,
                              logits=logits, emitted=emitted,
                              counts=counts,
                              paged_rows=self._alloc.mapped_rows_total())

    def decode_spec_fetch(self, step: InflightDecode):
        """Consume a launched verify step: fetch ``counts`` and
        ``emitted`` (the step's one sync), advance the host length mirror
        by the in-place commit and settle the spec and KV accounting.
        Returns ``(emitted, counts, logits)`` as :meth:`decode_spec`."""
        if step.kind != "spec":
            raise ValueError("decode_spec_fetch() consumes spec steps; got "
                             "a %r step (use decode_fetch)" % step.kind)
        active_np = step.active
        counts_np = step.counts.cpu().numpy().astype(np.int64)
        # mirror the view's finalize: active lanes advance by the
        # accepted count + 1, clamped at max_len
        self._len_host[active_np] += counts_np[active_np]
        np.minimum(self._len_host, self.max_len, out=self._len_host)
        n_active = int(active_np.sum())
        emitted_total = int(counts_np[active_np].sum())
        self.spec_stats["steps"] += 1
        self.spec_stats["proposed"] += self.spec_k * n_active
        self.spec_stats["accepted"] += emitted_total - n_active
        # one mapped-pages sweep serves every token the step commits; the
        # flat bound is one slots * max_len sweep a single-token step,
        # n_active tokens a sweep (the plain decode's normalization)
        self.kv_stats["tokens"] += emitted_total
        if n_active:
            self.kv_stats["flat_rows"] += (self.num_slots * self.max_len
                                           * emitted_total) / n_active
        self.kv_stats["paged_rows"] += step.paged_rows
        return step.emitted.cpu().numpy(), counts_np, step.logits

    def decode_spec(self, tokens, drafts, active, temperature, top_k,
                    top_p, pages_ready=False):
        """One speculative verify step.  Returns ``(emitted, counts,
        logits)``: emitted (num_slots, spec_k + 1) int32 whose row ``b``
        holds ``counts[b]`` usable tokens, the accepted drafts and one
        sampled or corrected token; logits (slots, k + 1, vocab) stay on
        the device.  Each slot's length advanced by ``counts[b]`` (the
        last emitted token is appended by the NEXT step, as in
        :meth:`decode`)."""
        return self.decode_spec_fetch(self.decode_spec_submit(
            tokens, drafts, active, temperature, top_k, top_p,
            pages_ready=pages_ready))

    # -- KV accounting -----------------------------------------------------

    def kv_row_bytes(self):
        """Bytes one K+V row costs a decode read: every layer and head.
        A quantized row is its 1-byte codes plus the f32 scale of each
        head."""
        if self.kv_dtype is not None:
            per_head = self._head_dim * self.kv_dtype.itemsize + 4
        else:
            per_head = self._head_dim * self._cache_dtype.itemsize
        return self._layers * self._heads * per_head * 2

    def kv_pool_bytes(self):
        """Bytes of KV the engine holds resident: paged pools price every
        page, mapped or free (the allocation is static), slotted pools
        the full ``slots * max_len`` buffer.  A paged pool's buffers hold
        one page more, the sink page (``serving/cache.py``), which is
        left out here: it is never mapped and holds nothing that is
        read."""
        rows = (self.num_pages * self.page_size if self.paged
                else self.num_slots * self.max_len)
        return rows * self.kv_row_bytes()

    def kv_bytes_per_token(self):
        """Decode KV-read accounting: bytes per generated token under (a)
        the paged true-length bound and (b) the slotted
        ``slots * max_len`` bound.  Slotted engines report only
        ``flat``."""
        row = self.kv_row_bytes()
        t = self.kv_stats["tokens"]
        out = {"flat": (float(self.num_slots * self.max_len * row)
                        if not t    # no decode yet: the static bound
                        else self.kv_stats["flat_rows"] * row / t)}
        if self.paged:
            out["paged"] = (0.0 if not t
                            else self.kv_stats["paged_rows"] * row / t)
        return out
