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
    the step's one sync, and only for lanes not freed since the launch
    (``_slot_epoch``: the overlapped loop's stale step for a retired
    slot must not revive its length).

* **Slotted** (``paged=False``) — per-slot contiguous ``max_len``
  buffers, bucketed whole-prompt prefill (the CUDA flash forward on a
  card, one launch per layer).

**Captured steps.**  The JAX engine compiles each step once and
dispatches it asynchronously.  On a card the port captures the decode
step (slotted or paged) and the verify step once each as a CUDA graph
(:mod:`.graphs`) and replays it; on the CPU it runs the same step
function eagerly.  A step reads its operands from static buffers
(``_StepIO``): ``decode_submit`` / ``decode_spec_submit`` write the
host's tokens, drafts, lane mask and sampling parameters into one pinned
block and copy it over without waiting for the stream, thread the
previous step's device-side tokens in (:class:`ThreadedTokens`), and
draw the step's uniforms from the engine's generator into a static
buffer, in the order the eager sampling draws them, so the captured
step holds no random-number state of its own.  The step's integer
outputs are copied into pinned host memory behind it, and
a CUDA event marks the copy: the fetch waits on that event alone, so
fetching step t-1 never waits for step t (the overlapped scheduler loop
keeps one step in flight).  A failed capture raises; the engine never
carries on eagerly behind the caller's back (``_capture`` is False on
the CPU; setting it False on a card runs the eager step, the A/B
baseline of ``chip_smoke.py``).

The views update the cache buffers in place.  The host keeps the page
table and a mirror of the lengths: the table is copied into its one
device tensor only when it changed, and ``slot_lengths`` reads the
mirror, so a scheduler iteration makes no extra device sync.  Sampling
noise comes from one ``torch.Generator`` per engine on the engine's
device; ``reseed(s)`` restarts it.  The engine reads the model's live
parameters; a paged engine drops its prefix cache when a parameter
changed since the cache was filled, and a card engine its captured steps
when a parameter was replaced by another tensor (``refresh_state``,
checked at every admission and every captured step), so a prefix hit
never serves K/V of older weights and a replay never reads a dropped
tensor.

**Quantized KV** (``kv_dtype="int8"``, ``"fp8"`` or
``"float8_e4m3fn"``, either layout): the pools hold 1-byte codes and an
f32 scale per (row, head) (:mod:`.cache`); ``kv_row_bytes`` and what is
derived from it price codes plus scales.

**Observability** (as in the JAX engine): the ``serving.page_pool_used``
gauge and the ``serving.cow_copies`` counter; the opt-in
``serving.kv_quant_error`` gauge (``PADDLE_TPU_METRICS_KV_QUANT_ERROR=1``
at construction, a quantized pool only), which the decode and verify
steps fill on the device with the max abs dequantization error of their
appends and which rides the step's one copy to the host, so it costs
device work and no extra sync; one engine-lane span a step launch or
prefill chunk, whose ``captures`` attr counts the graphs captured during
that call (the JAX spans' ``compiles``: nonzero on a steady-state step is
a re-capture); and a flight-recorder state summary (``flight_state``)
read from host state alone, so a dump after a CUDA error never touches
the device.

The engine runs on the card unless ``device="cpu"`` is given, and moves
the model there.  Not ported yet, and raising ``NotImplementedError``
instead of running something else (ROADMAP.md §A5): tensor
parallelism.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import numpy as np
import torch

from ..core.device import resolve_device
from ..observability import flight as _flight
from ..observability import registry as _metrics
from ..observability import tracing as _tracing
from ..core.dtype import convert_dtype
from ..kernels.decode_attention import raw_bytes
from ..utils.flags import fast_get
from .cache import (DecodeView, PagedDecodeView, PagedKVCache,
                    PagedPrefillChunkView, PrefillView, SlottedKVCache,
                    _as_kv_dtypes)
from .graphs import capture
from .pages import PageAllocator, PagePoolExhausted
from .sampling import TOP_K_MAX, draw_sample_noise, sample, spec_accept

__all__ = ["DecodeEngine", "InflightDecode", "PagePoolExhausted",
           "PrefillTask", "ThreadedTokens", "prefill_buckets_for"]

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
    are not fetched yet.  ``tok`` / ``emitted`` / ``counts`` and
    ``logits`` are device tensors of this step alone (a later step does
    not overwrite them); ``host`` receives the integer outputs (pinned
    on a card) behind the ``ready`` event (None on the CPU, where the
    copy is done at launch).  The fetch sets ``consumed``."""
    kind: str                             # "decode" | "spec"
    active: "np.ndarray"                  # (S,) bool, the step's lanes
    logits: object                        # (S, vocab) | (S, k+1, vocab)
    tok: object = None                    # (S,) int32 (decode)
    emitted: object = None                # (S, k+1) int32 (spec)
    counts: object = None                 # (S,) int32 accepted+1 (spec)
    paged_rows: int = 0                   # mapped rows at launch (spec)
    host: object = None                   # host copy of the int outputs
    ready: object = None                  # CUDA event after that copy
    consumed: bool = False                # set by the fetch
    slot_epoch: object = None             # per-slot free epoch at launch
                                          # (spec): the fetch advances
                                          # the length mirror only for
                                          # lanes not freed since


@dataclasses.dataclass
class ThreadedTokens:
    """The tokens of a step whose previous step is still in flight: lane
    ``i`` feeds ``tokens[i]`` where ``fresh[i]`` (a host-known token: a
    fresh prefill, a drained lane), else the last token ``prev``
    committed, which stays on the device (``emitted[i, counts[i] - 1]``
    for a verify step).  The engine merges the two with one ``where``
    on the device, so the host never waits for ``prev``."""
    prev: InflightDecode
    fresh: "np.ndarray"                   # (S,) bool
    tokens: "np.ndarray"                  # (S,) int32


class _StepIO:
    """The static operands of one step kind: what a captured step reads
    and writes, at addresses that never change.  ``inp`` is one int32
    block that one copy fills each step: tokens (S, k1) (column 0 the
    last committed token, then the drafts of a verify step), ``fresh``
    and ``active`` lane masks, ``top_k``, then ``temperature`` and
    ``top_p`` as f32 bits.  ``noise`` holds the step's uniforms, drawn
    from the engine's generator before each step (a decode step's
    (S, vocab); a verify step's (S, k), then (S, vocab)), so the captured
    step itself draws nothing.  ``out`` holds the step's tokens ((S,
    k1): the decode step's column 0, or a verify step's emitted run), then
    the verify step's counts, then the f32 bits of the step's
    quantization error (``out_qerr``, 0 unless the engine tracks it)."""

    def __init__(self, num_slots, k1, vocab, device, spec=False):
        S, n = int(num_slots), int(num_slots) * int(k1)
        self.inp = torch.zeros((n + 5 * S,), dtype=torch.int32,
                               device=device)
        self.tokens = self.inp[:n].view(S, k1)
        self.fresh = self.inp[n:n + S]
        self.active = self.inp[n + S:n + 2 * S]
        self.top_k = self.inp[n + 2 * S:n + 3 * S]
        self.temperature = self.inp[n + 3 * S:n + 4 * S].view(torch.float32)
        self.top_p = self.inp[n + 4 * S:].view(torch.float32)
        shapes = ((S, k1 - 1), (S, vocab)) if spec else ((S, vocab),)
        self.noise = tuple(torch.zeros(shape, dtype=torch.float32,
                                       device=device) for shape in shapes)
        self.out = torch.zeros((n + S + 1,), dtype=torch.int32,
                               device=device)
        self.out_tokens = self.out[:n].view(S, k1)
        self.out_counts = self.out[n:n + S]
        self.out_qerr = self.out[n + S:].view(torch.float32)


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
                 kv_dtype=None, spec_k=0, spec_ngram=3, tp=1, device=None,
                 tracer=None):
        cfg = model.config
        # the engine lane of the request trace: one span a step launch or
        # prefill chunk, and the allocator's page events
        self._tracer = (tracer if tracer is not None
                        else _tracing.default_tracer())
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
        # metric handles, fetched once (no-op singletons when disabled);
        # the quant-error flag is read once, here, as in the JAX engine
        self._m_pool = _metrics.gauge("serving.page_pool_used")
        self._m_cow = _metrics.counter("serving.cow_copies")
        self._m_qerr = _metrics.gauge("serving.kv_quant_error")
        self._track_qerr = bool(self.kv_dtype is not None and os.environ.get(
            "PADDLE_TPU_METRICS_KV_QUANT_ERROR", "0") == "1")
        # decode KV-read accounting: per decode or verify step,
        # `paged_rows` adds the rows a length-aware paged schedule reads
        # (mapped pages, one sweep a step however many tokens it commits)
        # and `flat_rows` the slotted slots * max_len sweep a token
        self.kv_stats = {"tokens": 0, "paged_rows": 0, "flat_rows": 0}
        # speculative accounting: verify steps, drafts proposed (k an
        # active lane) and accepted
        self.spec_stats = {"steps": 0, "proposed": 0, "accepted": 0}
        # host mirror of the device lengths (no sync to read them) and the
        # per-slot free epoch (bumped by free_slot; see decode_spec_fetch)
        self._len_host = np.zeros((self.num_slots,), np.int64)
        self._slot_epoch = np.zeros((self.num_slots,), np.int64)
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
        # the step operands (module docstring), one set per step kind
        vocab = int(cfg.vocab_size)
        self._io = {"decode": _StepIO(self.num_slots, 1, vocab,
                                      self.device)}
        if self.spec_k:
            self._io["spec"] = _StepIO(self.num_slots, self.spec_k + 1,
                                       vocab, self.device, spec=True)
        # captured steps (on a card): key -> graphs.CapturedStep
        self._capture = self.device.type == "cuda"
        self._graphs = {}
        self.graph_captures = 0
        self.graph_captures_by_kind = {"decode": 0, "spec": 0}
        # flight dumps collect this engine's state summary (a weak
        # reference: registration never pins the engine)
        _flight.register_engine(self)

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
                                    self.max_pages, self.page_size,
                                    tracer=self._tracer)
        self.cache = PagedKVCache.create(
            self.num_pages, self._layers, self.page_size, self._heads,
            self._head_dim, self.num_slots, self.max_pages,
            self._cache_dtype, self.device, kv_dtype=self.kv_dtype)
        # the allocator's one device table becomes the cache's
        self._sync_table()
        self.cow_copies = 0               # pages copied on write
        self.pages_used_peak = 0          # most pages mapped at once

    @property
    def kv_dtype(self):
        """The pools' code dtype (``torch.int8`` or
        ``torch.float8_e4m3fn``), or None for an unquantized pool."""
        return self._kv_code_dtype

    # -- host-side API -----------------------------------------------------

    def _param_versions(self):
        """Each parameter's identity, storage and in-place version
        counter: the port's optimizers update parameters in place, so
        identity alone (the JAX package's change test) would never see a
        step."""
        return tuple((id(p), p.data_ptr(), p._version)
                     for p in self.model.parameters())

    @staticmethod
    def _graph_identity(versions):
        """What a captured step holds fixed of the parameters: each
        one's identity and storage.  A replay reads every parameter at
        its address, so one updated in place is read live; a copy made
        inside the step (the LayerNorm wrapper's of a gamma / beta that
        is not 16-byte aligned) is a node of the graph that every replay
        runs again."""
        return tuple((i, ptr) for i, ptr, _v in versions)

    def refresh_state(self):
        """Drop the prefix cache when any parameter changed since it was
        filled: its pages hold K/V computed under the old parameters, and
        a hash hit would splice stale cache into a fresh prompt.  Pages
        still mapped by live slots keep decoding.  Drop the captured
        steps when a parameter was replaced by another tensor (one
        updated in place is read live by a replay).  Returns whether a
        change was seen.  Checked at every paged admission, on every
        cached-engine reuse (``engine_for``) and before every captured
        step."""
        versions = self._param_versions()
        if versions == self._state_versions:
            return False
        if self._graph_identity(versions) != \
                self._graph_identity(self._state_versions):
            self._graphs.clear()
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
            self._m_pool.set(0)
        self._len_host[:] = 0
        self._slot_epoch += 1
        self.cache.lengths.zero_()

    def reseed(self, seed):
        """Restart the sampling stream: after ``reseed(s)`` the next
        prefill/decode sequence reproduces a fresh engine built with
        ``seed=s``, captured steps or not (a step's uniforms are drawn
        from this generator just before the step)."""
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
        """Per-slot valid lengths, from the host mirror (no device sync,
        so the overlapped loop never stalls on it)."""
        return self._len_host.copy()

    def _to_device(self, arr):
        """A host array as a tensor on the engine's device.  On a card
        the copy goes through pinned memory and does not wait for the
        stream (a copy from pageable memory would wait for every step
        queued before it)."""
        host = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return host
        return host.pin_memory().to(self.device, non_blocking=True)

    def _params(self, temperature, top_k, top_p):
        return (self._to_device(np.asarray(temperature,
                                           np.float32).reshape(-1)),
                self._to_device(np.minimum(np.asarray(top_k, np.int32),
                                           self.top_k_max).reshape(-1)),
                self._to_device(np.asarray(top_p, np.float32).reshape(-1)))

    # -- paged page bookkeeping (host side) --------------------------------

    def _note_pool(self):
        used = self._alloc.pages_used()
        self.pages_used_peak = max(self.pages_used_peak, used)
        self._m_pool.set(used)

    def _set_length(self, slot, n):
        """Host-side length write (admission bookkeeping, off the
        per-token path)."""
        self._len_host[slot] = int(n)
        self.cache.lengths[int(slot)] = int(n)

    def _sync_table(self):
        """Point the cache at the allocator's device page table (one
        tensor for the engine's life, refreshed from the host table only
        when it changed)."""
        self.cache.page_table = self._alloc.device_table(self.device)

    def free_slot(self, slot):
        """Release a retired slot's pages (refcounted) and zero its
        length.  Slotted slots need no release: the next prefill
        overwrites the slot and sets its length."""
        if not self.paged:
            return
        self._alloc.free_slot(int(slot))
        self._set_length(int(slot), 0)
        self._slot_epoch[int(slot)] += 1
        self._m_pool.set(self._alloc.pages_used())

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
        tr_on = self._tracer.enabled
        if tr_on:
            c0, t0_ns = self.graph_captures, time.perf_counter_ns()
        for pool in (c.k, c.v, c.k_scale, c.v_scale):
            if pool is not None:
                raw_bytes(pool)[new_pid] = raw_bytes(pool)[old_pid]
        if tr_on:
            self._dispatch_span("engine.cow_copy", t0_ns, c0)
        self._alloc.remap(int(slot), int(idx), new_pid)
        self.cow_copies += 1
        self._m_cow.inc()

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
        tr_on = self._tracer.enabled
        if tr_on:
            c0, t0_ns = self.graph_captures, time.perf_counter_ns()
        view = PagedPrefillChunkView(self.cache, task.slot, task.pos,
                                     n_valid)
        with _eval_scope(self.model):
            logits, _ = self.model(self._to_device(padded), cache=view)
        view.finalize()
        if tr_on:
            self._dispatch_span("engine.prefill_chunk", t0_ns, c0)
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
        tr_on = self._tracer.enabled
        if tr_on:
            c0, t0_ns = self.graph_captures, time.perf_counter_ns()
        view = PrefillView(self.cache, slot, n)
        with _eval_scope(self.model):
            logits, _ = self.model(self._to_device(padded), cache=view)
        if tr_on:
            self._dispatch_span("engine.prefill", t0_ns, c0)
        last = logits[:, n - 1, :]
        tok = sample(last, self._generator,
                     *self._params([temperature], [top_k], [top_p]),
                     self.top_k_max)[0]
        view.finalize()
        self._len_host[int(slot)] = n
        return int(tok), last[0]

    # -- the step (eager function, or its captured graph) ------------------

    def _decode_step(self):
        """One batched decode step over the static operands: the model,
        sampling (from the uniforms drawn for the step) and the view's
        finalize.  Returns the last-position logits; the tokens land in
        the step's ``out`` buffer."""
        io = self._io["decode"]
        active = io.active.bool()
        qerr = self._step_qerr(io)
        if self.paged:
            view = PagedDecodeView(self.cache, active=active,
                                   max_len=self.max_len, quant_err=qerr)
        else:
            view = DecodeView(self.cache, active=active, quant_err=qerr)
        with _eval_scope(self.model):
            logits, _ = self.model(io.tokens, cache=view)
        logits = logits[:, -1, :]
        tok = sample(logits, self._generator, io.temperature, io.top_k,
                     io.top_p, self.top_k_max, noise=io.noise[0])
        view.finalize()
        io.out_tokens[:, 0].copy_(tok)
        return logits

    def _verify_step(self):
        """One speculative verify step over the static operands: one
        forward over each slot's ``[last token, drafts]``, the accept
        rule (capped so that no length passes ``max_len``: position
        ``j``'s logits hold only while ``length + j < max_len``) and the
        advance by the accepted count + 1."""
        io = self._io["spec"]
        active = io.active.bool()
        a_cap = self.max_len - 1 - self.cache.lengths
        view = PagedDecodeView(self.cache, active=active,
                               max_len=self.max_len,
                               quant_err=self._step_qerr(io))
        with _eval_scope(self.model):
            logits, _ = self.model(io.tokens, cache=view)
        logits = logits.float()                         # (S, k+1, V)
        emitted, counts = spec_accept(
            logits, io.tokens, self._generator, io.temperature, io.top_k,
            io.top_p, self.top_k_max, max_accept=a_cap, noise=io.noise)
        view.finalize(advance=counts)
        io.out_tokens.copy_(emitted)
        io.out_counts.copy_(counts)
        return logits

    def _step_qerr(self, io):
        """The step's quantization-error accumulator, zeroed (None when
        the engine does not track it)."""
        if not self._track_qerr:
            return None
        io.out_qerr.zero_()
        return io.out_qerr

    def _step_fn(self, kind):
        """The step function of ``kind`` (looked up per call: an engine
        holding its own bound methods would be a reference cycle, and its
        graphs would then be freed at some later garbage collection
        instead of when the engine is dropped)."""
        return self._verify_step if kind == "spec" else self._decode_step

    def _attn_pick(self, qlen):
        """The decode attention's autotune pick for a step of ``qlen``
        tokens a slot, resolved as the step's view resolves it (the
        ``decode_attn`` / ``decode_attn_paged`` key of its operands)."""
        from ..kernels import autotune as at
        from ..kernels import decode_attention as da
        dt = self.model.gpt.wte.weight.dtype      # q's dtype
        S, h, d = self.num_slots, self._heads, self._head_dim
        if self.paged:
            fam, key = "decode_attn_paged", da.paged_autotune_key(
                S, self.num_pages + 1, self.page_size, self.max_pages, h,
                d, qlen, dt, self.device, self.kv_dtype)
        else:
            fam, key = "decode_attn", da.autotune_key(
                S, self.max_len, h, d, qlen, dt, self.device,
                self.kv_dtype)
        cand = at.resolve(fam, key)
        return cand["variant"], tuple(sorted(cand["config"].items()))

    def _step_graph(self, kind):
        """The captured step of ``kind`` for the current routing, captured
        now if there is none.  The key holds what a replay cannot see
        change: the LayerNorm route (``use_pallas_norm``, read while the
        step runs) and the decode attention's pick; the engine's geometry
        (slots, ``max_len``, ``spec_k``, ``kv_dtype``) is fixed for its
        life, and ``refresh_state`` drops every graph once a parameter is
        replaced by another tensor.  The capture's warm-up runs with
        every lane inactive, so it commits no KV rows and no lengths."""
        self.refresh_state()
        qlen = self._io[kind].tokens.shape[1]
        key = (kind, bool(fast_get("use_pallas_norm")),
               self._attn_pick(qlen))
        graph = self._graphs.get(key)
        if graph is None:
            self._io[kind].active.zero_()
            graph = capture(self._step_fn(kind))
            self._graphs[key] = graph
            self.graph_captures += 1
            self.graph_captures_by_kind[kind] += 1
        return graph

    @torch.inference_mode()
    def capture_steps(self):
        """Capture now, on a card, the step the scheduler runs (decode,
        or verify with ``spec_k``) under the current routing, as the JAX
        engine compiles at its first call: a server calls this before it
        takes traffic, so that no capture falls inside a request.  A
        no-op on the CPU.  Returns :meth:`graph_stats`."""
        if self._capture:
            self._step_graph("spec" if self.spec_k else "decode")
        return self.graph_stats()

    def graph_stats(self):
        """Captured steps: captures made, graphs held, their replays
        and the device bytes their pools reserved."""
        graphs = self._graphs.values()
        return {"captures": self.graph_captures,
                "graphs": len(self._graphs),
                "replays": sum(g.replays for g in graphs),
                "pool_bytes": sum(g.pool_bytes for g in graphs)}

    def _stage(self, io, tokens, active_np, temperature, top_k, top_p,
               drafts=None):
        """Write one step's host operands into ``io.inp`` by ONE copy
        from pinned memory that does not wait for the stream, then
        thread device-side tokens into column 0 (``tokens`` a device
        tensor, or :class:`ThreadedTokens`)."""
        S, k1 = io.tokens.shape
        n = S * k1
        host = torch.empty(io.inp.shape, dtype=torch.int32,
                           pin_memory=self.device.type == "cuda")
        h = host.numpy()
        tok = h[:n].reshape(S, k1)
        fresh = np.zeros((S,), bool)
        if isinstance(tokens, ThreadedTokens):
            fresh[:] = np.asarray(tokens.fresh, bool).reshape(S)
            tok[:, 0] = np.where(fresh, np.asarray(tokens.tokens,
                                                   np.int32).reshape(S), 0)
        elif isinstance(tokens, torch.Tensor):
            tok[:, 0] = 0
        else:
            fresh[:] = True
            tok[:, 0] = np.asarray(tokens, np.int32).reshape(S)
        if drafts is not None:
            tok[:, 1:] = drafts
        h[n:n + S] = fresh
        h[n + S:n + 2 * S] = active_np
        h[n + 2 * S:n + 3 * S] = np.minimum(
            np.asarray(top_k, np.int32).reshape(-1), self.top_k_max)
        h[n + 3 * S:n + 4 * S].view(np.float32)[:] = np.asarray(
            temperature, np.float32).reshape(-1)
        h[n + 4 * S:].view(np.float32)[:] = np.asarray(
            top_p, np.float32).reshape(-1)
        io.inp.copy_(host, non_blocking=True)
        col = io.tokens[:, 0]
        if isinstance(tokens, ThreadedTokens):
            col.copy_(torch.where(io.fresh.bool(), col,
                                  self._last_tokens(tokens.prev)))
        elif isinstance(tokens, torch.Tensor):
            col.copy_(tokens.reshape(S))

    @staticmethod
    def _last_tokens(step: InflightDecode):
        """The last token ``step`` committed a lane, on the device:
        ``tok``, or a verify step's ``emitted[i, counts[i] - 1]``."""
        if step.kind == "spec":
            idx = (step.counts.clamp(min=1) - 1).long()[:, None]
            return step.emitted.gather(1, idx)[:, 0]
        return step.tok

    def _launch(self, kind, tokens, active_np, temperature, top_k, top_p,
                drafts=None) -> InflightDecode:
        """Stage the operands, draw the step's uniforms from the engine's
        generator, run the step (its captured graph on a card, the eager
        function on the CPU or with ``_capture`` off),
        then take the step's outputs out of the static buffers: a device
        copy of its integers and logits, and a host copy of its integers
        behind the ``ready`` event."""
        graph = self._step_graph(kind) if self._capture else None
        io = self._io[kind]
        self._stage(io, tokens, active_np, temperature, top_k, top_p,
                    drafts)
        if self.paged:
            self._sync_table()
        # the step's draws, in the order the eager sampling makes them
        S, V = io.noise[-1].shape
        draw_sample_noise(self._generator, S, V,
                          self.spec_k if kind == "spec" else None,
                          out=io.noise)
        if graph is not None:
            logits = graph.replay().clone()
        else:
            logits = self._step_fn(kind)()
        out = io.out.clone()
        host, ready = out, None
        if self.device.type == "cuda":
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        S, k1 = io.tokens.shape
        rec = InflightDecode(kind=kind, active=active_np, logits=logits,
                             host=host, ready=ready)
        if kind == "spec":
            rec.emitted = out[:S * k1].view(S, k1)
            rec.counts = out[S * k1:S * k1 + S]
        else:
            rec.tok = out[:S]
        return rec

    def _set_quant_err(self, ints):
        """Publish the fetched step's quantization error (its f32 bits
        ride the end of the step's host copy)."""
        if self._track_qerr:
            self._m_qerr.set(float(ints[-1:].view(np.float32)[0]))

    def _dispatch_span(self, name, t0_ns, c0):
        """Engine-lane span for one step launch or prefill chunk, with
        the graphs captured during it (``captures``) and in all
        (``capture_count``): a nonzero ``captures`` on a steady-state
        step is a re-capture, the bug class the JAX spans' ``compiles``
        attr exposes."""
        self._tracer.add_span(name, t0_ns, time.perf_counter_ns(),
                              capture_count=self.graph_captures,
                              captures=self.graph_captures - c0)

    @staticmethod
    def _host_ints(step: InflightDecode):
        """The step's integer outputs on the host: waits for the step's
        own copy event, never for work queued after it."""
        if step.ready is not None:
            step.ready.synchronize()
        step.consumed = True
        return step.host.numpy()

    # -- decode ------------------------------------------------------------

    @torch.inference_mode()
    def decode_submit(self, tokens, active, temperature, top_k,
                      top_p, pages_ready=False) -> InflightDecode:
        """Launch one batched decode step without fetching its tokens.
        ``tokens``: the per-slot last committed tokens (a host array, an
        (S,) device tensor, or :class:`ThreadedTokens`).  A paged engine
        first maps the pages the appends need (raising
        PagePoolExhausted when the pool is dry), unless the caller did so
        this step (``pages_ready=True``, the scheduler).  The host length
        mirror and the read accounting advance here: a decode step's
        advance does not depend on the data."""
        active_np = np.asarray(active, bool).reshape(self.num_slots)
        if self.paged and not pages_ready:
            blocked = self.ensure_decode_ready(active_np)
            if blocked is not None:
                raise PagePoolExhausted(
                    "no free page for slot %d's append — evict a slot "
                    "(the scheduler does this refcount-aware)" % blocked)
        tr_on = self._tracer.enabled
        if tr_on:
            c0, t0_ns = self.graph_captures, time.perf_counter_ns()
        rec = self._launch("decode", tokens, active_np, temperature, top_k,
                           top_p)
        self.kv_stats["tokens"] += int(active_np.sum())
        self.kv_stats["flat_rows"] += self.num_slots * self.max_len
        # mirror the view's finalize: active lanes advance (paged: clamped
        # at max_len, where an append was dropped)
        self._len_host[active_np] += 1
        if self.paged:
            np.minimum(self._len_host, self.max_len, out=self._len_host)
            self.kv_stats["paged_rows"] += self._alloc.mapped_rows_total()
        if tr_on:
            self._dispatch_span("engine.decode", t0_ns, c0)
        return rec

    def decode_fetch(self, step: InflightDecode):
        """Consume a launched step: returns (next tokens as an np array,
        logits as a device tensor).  Waits for this step's outputs only,
        not for steps launched after it."""
        if step.kind != "decode":
            raise ValueError("decode_fetch() consumes decode steps; got a "
                             "%r step (use decode_spec_fetch)" % step.kind)
        ints = self._host_ints(step)
        self._set_quant_err(ints)
        return ints[:self.num_slots].copy(), step.logits

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
        results.  ``tokens``: the per-slot last committed tokens (a host
        array, an (S,) device tensor, or :class:`ThreadedTokens`);
        ``drafts``: (num_slots, spec_k) proposals.  One forward scores
        the ``spec_k + 1`` positions of every slot;
        :func:`.sampling.spec_accept` accepts a prefix (capped so that no
        length passes ``max_len``) and the device lengths advance by the
        accepted count + 1.  The host length mirror and the accounting
        wait for :meth:`decode_spec_fetch`, since the advance depends on
        the data: a caller with a verify step in flight maps pages for
        both steps' worst case."""
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
        tr_on = self._tracer.enabled
        if tr_on:
            c0, t0_ns = self.graph_captures, time.perf_counter_ns()
        rec = self._launch("spec", tokens, active_np, temperature, top_k,
                           top_p, drafts=drafts_np)
        rec.paged_rows = self._alloc.mapped_rows_total()
        rec.slot_epoch = self._slot_epoch.copy()
        if tr_on:
            self._dispatch_span("engine.spec_verify", t0_ns, c0)
        return rec

    def decode_spec_fetch(self, step: InflightDecode):
        """Consume a launched verify step: fetch ``counts`` and
        ``emitted`` (the step's one sync), advance the host length mirror
        by the in-place commit and settle the spec and KV accounting.
        Returns ``(emitted, counts, logits)`` as :meth:`decode_spec`.

        ``spec_stats`` meter device work: an overlapped loop's stale
        verify step for a since-retired slot counts here, while the
        scheduler credits its tokens to no request."""
        if step.kind != "spec":
            raise ValueError("decode_spec_fetch() consumes spec steps; got "
                             "a %r step (use decode_fetch)" % step.kind)
        ints = self._host_ints(step)
        self._set_quant_err(ints)
        S, k1 = self.num_slots, self.spec_k + 1
        emitted = ints[:S * k1].reshape(S, k1).copy()
        counts_np = ints[S * k1:S * k1 + S].astype(np.int64)
        active_np = step.active
        # mirror the view's finalize: active lanes advance by the
        # accepted count + 1, clamped at max_len; a lane freed (and
        # perhaps admitted again) since the launch does not advance
        adv = active_np & (self._slot_epoch == step.slot_epoch)
        self._len_host[adv] += counts_np[adv]
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
        return emitted, counts_np, step.logits

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

    # -- flight-recorder state summary -------------------------------------

    def flight_state(self):
        """JSON-ready engine state for a flight dump, from host state only
        (the length mirror, the allocator, the capture counts): a dump
        taken after a CUDA error must not touch the device.  The JAX
        engine's compile counts are the graph captures by step kind."""
        st = {
            "paged": self.paged,
            "num_slots": self.num_slots,
            "max_len": self.max_len,
            "kv_dtype": str(self.kv_dtype or self._cache_dtype).replace(
                "torch.", ""),
            "spec_k": self.spec_k,
            "tp": 1,
            "slot_lengths": [int(x) for x in self._len_host],
            "graph_captures": {
                "decode": self.graph_captures_by_kind["decode"],
                "verify": self.graph_captures_by_kind["spec"]},
        }
        if self.paged:
            al = self._alloc
            st.update(
                num_pages=self.num_pages,
                page_size=self.page_size,
                pages_used=al.pages_used(),
                pages_free=al.pages_free(),
                pages_cached=al.pages_cached(),
                slot_pages={
                    str(i): [int(al.table[i, j])
                             for j in np.nonzero(al.mapped[i])[0]]
                    for i in range(self.num_slots)},
            )
        return st
