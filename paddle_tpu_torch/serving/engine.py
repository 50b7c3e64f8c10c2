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
step (slotted or paged), the verify step and the paged prefill chunk
once each as a CUDA graph (:mod:`.graphs`) and replays it; on the CPU it
runs the same step function eagerly.  The chunk (``_chunk_step``, the
JAX ``prefill_chunk_fn``) reads its tokens, ``slot``, ``n_before`` and
``n_valid`` from one static block (``_ChunkIO``) that one pinned copy
fills, takes the last real position's logits by a device index, and
leaves sampling outside the graph, on the final chunk only.  A step reads its operands from static buffers
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

**Handoff and the host tier** (paged engines, as in the JAX engine):
``export_pages`` / ``stage_handoff`` / ``import_pages`` move up to
``handoff_pages`` pool pages a chunk between two engines' pools (the
disaggregated prefill/decode pair, :mod:`.disagg`): a gather into a
persistent transfer buffer, a device copy (or host staging), a scatter
whose padding lands in the sink page; int8 and fp8 codes and their f32
scales move byte for byte.  With a host budget (``kv_host_bytes`` or
``PADDLE_TPU_KV_HOST_BYTES``) the allocator's reclaims spill refcount-0
cached pages into a :class:`~.kv_tier.HostPageTier` through a spill
buffer of their own (the handoff buffer may be mid-transfer), and
``host_fetch_plan`` / ``host_fetch_stage`` bring them back for the
scheduler to import; ``attach_cluster_index`` publishes the servable
digests to the TCP store.

**Tensor parallelism** (``tp=N``, paged only, as in the JAX engine):
every rank of a group of N ranks — the global mesh's ``mp`` axis when it
has N ranks, else a world of N — builds the engine from the same full
model and makes the same calls (SPMD).  The engine serves a copy of the
model holding the rank's Megatron shards
(``distributed.parallel_base.shard_module``: the q/k/v columns of its
``heads / N`` heads, the ``fc1`` columns and the ``out_proj`` / ``fc2``
rows that go with them, its ``vocab / N`` rows of ``wte``), the pool
holds ``heads / N`` heads (``kv_row_bytes``, ``kv_pool_bytes`` and
``kv_bytes_per_token`` report one rank's truth: 1/N of tp=1's), and the
vocab-sharded logits are all-gathered before sampling, so every rank
samples the same tokens from one seed.  ``refresh_state`` compares the
full model's parameters and re-slices a changed one into the copy.  A
tp>1 engine runs its steps uncaptured (``graph_stats()["uncaptured"]``
says why): a gloo collective cannot be captured in a CUDA graph, and
NCCL capture at tp >= 2 needs two cards to check.  The scheduler's loops
need no captured step, so both drive it.  ``overlap_comm`` turns on the
``mp_overlap`` islands (:mod:`..distributed.mp_overlap`: the row
matmuls and the LM head as permute rings, the vocab lookup as one
all-reduce), resolved once, as in the JAX engine, through the switch
(argument > scope > ``PADDLE_TPU_MP_OVERLAP``) and only at tp > 1
(``self.overlap_comm``); every step runs inside ``overlap_scope`` of
that value, so the environment changing later moves no engine.

The engine runs on the card unless ``device="cpu"`` is given, and moves
the model there.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
import time
import weakref

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
from .graphs import REPLAY_LOCK, capture
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


def _plain_copy(model):
    """A deep copy of ``model``'s modules and tensors, sharing its
    ``generator`` attributes and leaving out its cached engines (the
    copy's parameters lose their ``pspec``: ``shard_module`` has the
    model tag them again)."""
    memo = {}
    engines = model.__dict__.get("_serving_engines")
    if engines is not None:
        memo[id(engines)] = {}
    for m in model.modules():
        gen = getattr(m, "generator", None)
        if gen is not None:
            memo[id(gen)] = gen
    return copy.deepcopy(model, memo)


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


class _ChunkIO:
    """The static operands of the paged prefill chunk: one int32 block
    that one copy fills a chunk — the chunk's right-padded tokens (1, C),
    then ``slot``, ``n_before`` and ``n_valid``, each a 0-d view the
    captured chunk reads (the JAX ``prefill_chunk_fn``'s operands)."""

    def __init__(self, chunk, device):
        C = int(chunk)
        self.inp = torch.zeros((C + 3,), dtype=torch.int32, device=device)
        self.tokens = self.inp[:C].view(1, C)
        self.slot = self.inp[C]
        self.n_before = self.inp[C + 1]
        self.n_valid = self.inp[C + 2]


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
    first_token_dev: object = None        # () device tensor (sync=False)
    first_token_ready: object = None      # CUDA event after its copy home
    last_logits: object = None            # (vocab,) device tensor


#: the step kinds an engine captures, by the JAX engine's watchdog entry
#: for the same step (observability.watchdog)
_WATCHED_KINDS = {"decode": "serving.decode", "spec": "serving.spec_verify",
                  "chunk": "serving.prefill_chunk"}


class DecodeEngine:
    """Serving engine for a causal LM with a ``config`` carrying the GPT
    geometry (:class:`paddle_tpu_torch.models.gpt.GPTForCausalLM`)."""

    def __init__(self, model, num_slots=4, max_len=None, cache_dtype=None,
                 min_bucket=16, seed=0, top_k_max=TOP_K_MAX, paged=True,
                 page_size=64, num_pages=None, prefill_chunk=None,
                 kv_dtype=None, spec_k=0, spec_ngram=3, tp=1, device=None,
                 tracer=None, handoff_pages=4, kv_host_bytes=None,
                 overlap_comm=None):
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
        self.tp = int(tp)
        self._mp = self._tp_group()
        # resolved once (argument > scope > PADDLE_TPU_MP_OVERLAP), as in
        # the JAX engine: the rings need a group of two ranks or more
        from ..distributed import mp_overlap as _mpo
        self.overlap_comm = bool(_mpo.enabled(overlap_comm)
                                 and self.tp > 1)
        self._heads //= self.tp
        self.device = resolve_device(device)
        # the full model: refresh_state compares its parameters; a tp
        # engine serves a sharded copy of it
        self._source = model
        self._vocab = int(cfg.vocab_size)
        if self._mp is None:
            self.model = model.to(self.device)
        else:
            from ..distributed.parallel_base import shard_module
            self.model = shard_module(_plain_copy(model).to(self.device),
                                      self._mp)
        self._m_tp = _metrics.gauge("serving.tp_degree")
        self._m_tp.set(self.tp)
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
            self._init_paged(page_size, num_pages, prefill_chunk,
                             handoff_pages)
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
        if self.paged:
            self._chunk_io = _ChunkIO(self.prefill_chunk, self.device)
        # captured steps (on a card, tp=1): key -> graphs.CapturedStep
        self._capture = self.device.type == "cuda" and self._mp is None
        # False runs the prefill chunk eagerly beside captured decode
        # steps (the A/B baseline of chip_smoke.py's chunk_capture)
        self._capture_chunk = True
        self._graphs = {}
        self.graph_captures = 0
        self.graph_captures_by_kind = {"decode": 0, "spec": 0, "chunk": 0}
        # the copy event of the latest launched step: reset() waits for
        # it, so a step left in flight (a replica that died between
        # iterations) lands before the slots are handed out again
        self._last_ready = None
        # the tiered KV host cache: a bounded host-RAM LRU behind the
        # device pool, off unless a budget is given (the argument wins
        # over PADDLE_TPU_KV_HOST_BYTES)
        self._host_tier = None
        self._kv_index = None     # ClusterPrefixIndex, attach_cluster_index
        self._m_host_bytes = _metrics.gauge("serving.kv_host_bytes")
        self._m_host_misses = _metrics.counter("serving.kv_host_misses")
        self._m_host_spill = _metrics.counter(
            "serving.kv_host_spilled_pages")
        if self.paged:
            from .kv_tier import HostPageTier, host_bytes_default
            budget = (int(kv_host_bytes) if kv_host_bytes is not None
                      else host_bytes_default())
            if budget > 0:
                self._host_tier = HostPageTier(budget)
                # through a weak reference: the allocator holding the
                # engine's bound method would be a reference cycle, and
                # the engine's graphs would outlive it until a collection
                spill = weakref.WeakMethod(self._spill_page)

                def hook(pid, digests, spill=spill):
                    fn = spill()
                    if fn is not None:
                        fn(pid, digests)
                self._alloc.spill_hook = hook
        # flight dumps collect this engine's state summary (a weak
        # reference: registration never pins the engine); the HBM ledger
        # prices this engine's KV pool the same way
        _flight.register_engine(self)
        from ..observability import hbm as _hbm
        _hbm.register_engine(self)
        # the compile watchdog's entries: a capture of each step kind is
        # the JAX engine's compile of that entry (observability.watchdog)
        from ..observability.watchdog import watch
        self._watched = {kind: watch(name, expected=1)
                         for kind, name in _WATCHED_KINDS.items()
                         if kind == "decode"
                         or (kind == "spec" and self.spec_k)
                         or (kind == "chunk" and self.paged)}

    def _tp_group(self):
        """The tensor-parallel group (None at tp=1), with the JAX engine's
        checks in its order: the degree, the layout, then the devices
        (ranks) and the heads."""
        if self.tp < 1:
            raise ValueError("tp must be >= 1")
        if self.tp == 1:
            return None
        if not self.paged:
            raise ValueError(
                "tensor-parallel decode runs on the paged engine (tp > 1 "
                "with paged=False is not supported — the slotted layout "
                "is the single-card A/B baseline)")
        import torch.distributed as dist
        from ..distributed import mesh as _mesh
        from ..distributed.collective import Group
        mesh = _mesh.get_mesh()
        group, have = None, 1
        if mesh is not None and mesh.group("mp") is not None:
            group = mesh.group("mp")
            have = group.nranks
        elif dist.is_available() and dist.is_initialized():
            have = dist.get_world_size()
            if have == self.tp:
                group = Group("mp", list(range(have)), dist.group.WORLD)
        if group is None or group.pg is None or have != self.tp:
            raise ValueError(
                "tp=%d needs %d devices, have %d (the ranks of the mesh's "
                "mp axis, or of the torch.distributed world: "
                "distributed.init_parallel_env)" % (self.tp, self.tp, have))
        if self._heads % self.tp:
            raise ValueError(
                "tp=%d must divide num_attention_heads=%d (the KV pool is "
                "partitioned over heads)" % (self.tp, self._heads))
        return group

    @contextlib.contextmanager
    def _model_scope(self):
        """A step's model call: eval mode, and the overlap switch pinned
        to the engine's own."""
        from ..distributed import mp_overlap as _mpo
        with _eval_scope(self.model), _mpo.overlap_scope(self.overlap_comm):
            yield

    def _full_vocab(self, logits):
        """The logits over the whole vocabulary: a tp engine's model
        gives the rank's vocab shard, all-gathered here (the overlapped
        LM head gives them whole)."""
        if self._mp is None or logits.shape[-1] == self._vocab:
            return logits
        from ..distributed import collective as _coll
        return torch.cat(_coll.all_gather([], logits.contiguous(),
                                          group=self._mp), dim=-1)

    def _init_paged(self, page_size, num_pages, prefill_chunk,
                    handoff_pages=4):
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
        # the disaggregated handoff and the host tier move pages through
        # transfer buffers of `handoff_pages` pages, one fixed chunk shape
        self.handoff_pages = max(1, min(int(handoff_pages), self.max_pages))
        self._handoff_buf = None          # made at the first export
        self._spill_buf = None            # the spill's own: the handoff
                                          # buffer may be mid-transfer when
                                          # a reclaim spills
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
                     for p in self._source.parameters())

    @staticmethod
    def _graph_identity(versions):
        """What a captured step holds fixed of the parameters: each
        one's identity and storage.  A replay reads every parameter at
        its address, so one updated in place is read live; a copy made
        inside the step (the LayerNorm wrapper's of a gamma / beta that
        is not 16-byte aligned) is a node of the graph that every replay
        runs again."""
        return tuple((i, ptr) for i, ptr, _v in versions)

    def refresh_state(self, state=None):
        """Drop the prefix cache when any parameter changed since it was
        filled: its pages hold K/V computed under the old parameters, and
        a hash hit would splice stale cache into a fresh prompt.  Pages
        still mapped by live slots keep decoding.  Drop the captured
        steps when a parameter was replaced by another tensor (one
        updated in place is read live by a replay).  Returns whether a
        change was seen.  Checked at every paged admission, on every
        cached-engine reuse (``engine_for``) and before every captured
        step.

        ``state`` (``{name: tensor}``, the model's parameter and buffer
        names, as the JAX engine's ``refresh_state(state)`` takes its
        tree) is first copied in place into the live tensors, so the
        captured steps keep their addresses and read it at their next
        replay."""
        if state is not None:
            live = dict(self._source.named_parameters())
            live.update(self._source.named_buffers())
            unknown = sorted(set(state) - set(live))
            if unknown:
                raise KeyError("refresh_state: the model has no %s"
                               % unknown)
            with torch.no_grad():
                for name, value in state.items():
                    dst = live[name]
                    value = torch.as_tensor(value)
                    if tuple(value.shape) != tuple(dst.shape):
                        raise ValueError(
                            "refresh_state: %s has shape %s, the model's "
                            "%s" % (name, tuple(value.shape),
                                    tuple(dst.shape)))
                    dst.copy_(value)
        versions = self._param_versions()
        if versions == self._state_versions:
            return False
        if self._graph_identity(versions) != \
                self._graph_identity(self._state_versions):
            self._graphs.clear()
        self._state_versions = versions
        if self._mp is not None:
            from ..distributed.parallel_base import reshard_into
            reshard_into(self.model, self._source, self._mp)
        if self.paged:
            self._alloc.drop_prefix_cache()
            if self._host_tier is not None:
                # spilled rows were computed under the old parameters: a
                # host hit would splice stale cache like the device hit
                # the drop above prevents
                if self._kv_index is not None:
                    self._kv_index.withdraw(self._host_tier.digests())
                self._host_tier.clear()
                self._m_host_bytes.set(0)
        return True

    def reset(self):
        """Free every slot (paged: pages return to the pool and the prefix
        cache is dropped; slot contents are overwritten lazily).  Waits
        first for the copy of the latest launched step, so a step left in
        flight has landed before any slot is handed out again; the
        captured graphs stay (a router's respawn reuses them)."""
        if self._last_ready is not None:
            self._last_ready.synchronize()
            self._last_ready = None
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
    def prefill_step(self, task: PrefillTask, sync: bool = True) -> bool:
        """Run ONE chunk of an admission; returns True when the prompt
        is fully prefilled (``task.first_token`` / ``task.last_logits``
        are then set).  Raises PagePoolExhausted when the chunk's pages
        cannot be mapped — the scheduler evicts a victim and retries.

        On a card the chunk replays its captured graph.  ``sync=False``
        leaves the final chunk's sampled token on the device
        (``task.first_token_dev``, its copy home behind the CUDA event
        ``task.first_token_ready``) instead of waiting for it: the
        disaggregated scheduler polls the event between decode steps, so
        a prefill-engine chunk never stalls the decode loop."""
        if task.done:
            return True
        n = int(task.ids.size)
        n_valid = min(self.prefill_chunk, n - task.pos)
        self._ensure_write_range(task.slot, task.pos, task.pos + n_valid)
        padded = np.zeros((self.prefill_chunk,), np.int32)
        padded[:n_valid] = task.ids[task.pos:task.pos + n_valid]
        tr_on = self._tracer.enabled
        if tr_on:
            c0, t0_ns = self.graph_captures, time.perf_counter_ns()
        last = self._launch_chunk(padded, task.slot, task.pos, n_valid)
        if tr_on:
            self._dispatch_span("engine.prefill_chunk", t0_ns, c0)
        task.pos += n_valid
        task.chunks_run += 1
        self._len_host[task.slot] = task.pos
        if task.pos >= n:
            # only the final chunk samples, so only it draws from the
            # generator (the chunk count depends on the prefix cache)
            tok = sample(last, self._generator,
                         *self._params([task.temperature], [task.top_k],
                                       [task.top_p]), self.top_k_max)[0]
            task.done = True
            if sync:
                task.first_token = int(tok)
            else:
                task.first_token_dev = tok
                if self.device.type == "cuda":
                    host = torch.empty((), dtype=tok.dtype,
                                       pin_memory=True)
                    host.copy_(tok, non_blocking=True)
                    task.first_token_dev = host
                    task.first_token_ready = torch.cuda.Event()
                    task.first_token_ready.record()
            task.last_logits = last[0]
            # publish this prompt's pages for later admissions to share
            servable = self._alloc.register_prefix(task.slot, task.ids)
            if self._kv_index is not None and servable:
                self._kv_index.offer(servable)
        return task.done

    def _launch_chunk(self, padded, slot, n_before, n_valid):
        """Stage one chunk's operands by one copy, run the chunk (its
        captured graph on a card, the eager function on the CPU or with
        ``_capture`` off) and copy the last real position's logits out of
        the graph's buffers.  Returns them, (1, vocab) on the device."""
        graph = (self._step_graph("chunk")
                 if self._capture and self._capture_chunk else None)
        io = self._chunk_io
        host = torch.empty(io.inp.shape, dtype=torch.int32,
                           pin_memory=self.device.type == "cuda")
        h = host.numpy()
        h[:-3] = padded
        h[-3:] = (int(slot), int(n_before), int(n_valid))
        io.inp.copy_(host, non_blocking=True)
        self._sync_table()
        if graph is None:
            return self._chunk_step()
        with REPLAY_LOCK:
            return graph.replay().clone()

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
        with self._model_scope():
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
                                   max_len=self.max_len, quant_err=qerr,
                                   tp=self.tp)
        else:
            view = DecodeView(self.cache, active=active, quant_err=qerr)
        with self._model_scope():
            logits, _ = self.model(io.tokens, cache=view)
        logits = self._full_vocab(logits[:, -1, :])
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
                               quant_err=self._step_qerr(io), tp=self.tp)
        with self._model_scope():
            logits, _ = self.model(io.tokens, cache=view)
        logits = self._full_vocab(logits).float()       # (S, k+1, V)
        emitted, counts = spec_accept(
            logits, io.tokens, self._generator, io.temperature, io.top_k,
            io.top_p, self.top_k_max, max_accept=a_cap, noise=io.noise)
        view.finalize(advance=counts)
        io.out_tokens.copy_(emitted)
        io.out_counts.copy_(counts)
        return logits

    def _chunk_step(self):
        """One paged prefill chunk over the static operands
        (``_ChunkIO``): the model over the padded chunk through the chunk
        view, the writes and the slot's length update.  Returns the
        logits of the chunk's last real position, (1, vocab), taken by a
        device index (clamped at 0: the capture's warm-up runs with
        ``n_valid`` 0)."""
        io = self._chunk_io
        view = PagedPrefillChunkView(self.cache, io.slot, io.n_before,
                                     io.n_valid, tp=self.tp)
        with self._model_scope():
            logits, _ = self.model(io.tokens, cache=view)
        last = self._full_vocab(logits.index_select(
            1, (io.n_valid - 1).clamp(min=0).view(1))[:, 0, :])
        view.finalize()
        return last

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
        if kind == "chunk":
            return self._chunk_step
        return self._verify_step if kind == "spec" else self._decode_step

    def _attn_pick(self, qlen, slots=None):
        """The decode attention's autotune pick for a step of ``qlen``
        tokens a slot over ``slots`` slots (all of them by default; one
        for a prefill chunk), resolved as the step's view resolves it
        (the ``decode_attn`` / ``decode_attn_paged`` key of its
        operands)."""
        from ..kernels import autotune as at
        from ..kernels import decode_attention as da
        dt = self.model.gpt.wte.weight.dtype      # q's dtype
        S = self.num_slots if slots is None else int(slots)
        h, d = self._heads * self.tp, self._head_dim
        if self.paged:
            fam, key = "decode_attn_paged", da.paged_autotune_key(
                S, self.num_pages + 1, self.page_size, self.max_pages, h,
                d, qlen, dt, self.device, self.kv_dtype, tp=self.tp)
        else:
            fam, key = "decode_attn", da.autotune_key(
                S, self.max_len, h, d, qlen, dt, self.device,
                self.kv_dtype)
        cand = at.resolve(fam, key)
        return cand["variant"], tuple(sorted(cand["config"].items()))

    def _step_graph(self, kind):
        """The captured step of ``kind`` ("decode", "spec" or "chunk")
        for the current routing, captured now if there is none.  The key
        holds what a replay cannot see change: the LayerNorm route
        (``use_pallas_norm``, read while the step runs) and the decode
        attention's pick; the engine's geometry (slots, ``max_len``,
        ``spec_k``, ``kv_dtype``, the chunk size) is fixed for its life,
        and ``refresh_state`` drops every graph once a parameter is
        replaced by another tensor.  The capture's warm-up commits no KV
        rows and no lengths: a decode or verify step runs with every lane
        inactive, a chunk with ``n_valid`` 0 (its writes go to the sink
        page) and slot 0's own length as ``n_before``, copied on the
        device, so the length it writes back is the one there."""
        self.refresh_state()
        if kind == "chunk":
            pick = self._attn_pick(self.prefill_chunk, slots=1)
        else:
            pick = self._attn_pick(self._io[kind].tokens.shape[1])
        key = (kind, bool(fast_get("use_pallas_norm")), pick)
        graph = self._graphs.get(key)
        if graph is None:
            self._idle_operands(kind)
            graph = capture(self._step_fn(kind))
            graph.kind = kind
            self._graphs[key] = graph
            self.graph_captures += 1
            self.graph_captures_by_kind[kind] += 1
            # budget 1 a routing; strict mode raises past it
            self._watched[kind].compiled(routing=key[1:])
        return graph

    def _idle_operands(self, kind):
        """Operands under which a step of ``kind`` commits nothing: a
        decode or verify step with every lane inactive, a chunk with
        ``n_valid`` 0 (its writes go to the sink page) and slot 0's own
        length as ``n_before``, copied on the device."""
        if kind == "chunk":
            io = self._chunk_io
            io.inp.zero_()
            io.n_before.copy_(self.cache.lengths[0])
            self._sync_table()
        else:
            self._io[kind].active.zero_()

    def cost_reports(self, only=None):
        """{watchdog entry name: ProgramReport} for each step kind this
        engine captures (``serving.decode``; ``serving.spec_verify`` with
        ``spec_k``; ``serving.prefill_chunk`` when paged): one eager run
        of the step under :func:`..observability.costs.report_step`, with
        idle operands so that it commits nothing.  ``only`` (entry names)
        restricts the report; a name this engine does not watch raises
        ``ValueError``.  A cold path: call it while no step is in
        flight."""
        from ..observability import costs as _costs
        entries = [(name, kind) for kind, name in _WATCHED_KINDS.items()
                   if kind in self._watched]
        if only is not None:
            wanted = set(only)
            unknown = wanted - {name for name, _k in entries}
            if unknown:
                raise ValueError(
                    "cost_reports(only=...) names entries this engine "
                    "does not watch: %s" % sorted(unknown))
            entries = [(n, k) for n, k in entries if n in wanted]
        self.refresh_state()
        out = {}
        with torch.inference_mode():
            for name, kind in entries:
                self._idle_operands(kind)
                out[name] = _costs.report_step(name, self._step_fn(kind),
                                               self.device)
        return out

    @torch.inference_mode()
    def capture_steps(self):
        """Capture now, on a card, every step the scheduler runs under the
        current routing — the decode step (or the verify step with
        ``spec_k``) and, on a paged engine, the prefill chunk — as the
        JAX engine compiles at its first call: a server calls this before
        it takes traffic, so that no capture falls inside a request and
        none runs while another thread drives the card.  A no-op on the
        CPU.  Returns :meth:`graph_stats`."""
        if self._capture:
            self._step_graph("spec" if self.spec_k else "decode")
            if self.paged and self._capture_chunk:
                self._step_graph("chunk")
        return self.graph_stats()

    def graph_stats(self):
        """Captured steps: captures made, graphs held, their replays and
        the device bytes their pools reserved, in all and by step kind
        (``by_kind``: "decode", "spec", "chunk")."""
        graphs = list(self._graphs.values())
        uncaptured = None
        if self._mp is not None:
            uncaptured = ("tp=%d: steps run uncaptured (the collectives of "
                          "a tensor-parallel step are not captured: "
                          "ROADMAP.md §A5)" % self.tp)
        by_kind = {}
        for kind, n in self.graph_captures_by_kind.items():
            mine = [g for g in graphs if g.kind == kind]
            by_kind[kind] = {"captures": n, "graphs": len(mine),
                             "replays": sum(g.replays for g in mine),
                             "pool_bytes": sum(g.pool_bytes for g in mine)}
        return {"captures": self.graph_captures,
                "graphs": len(graphs),
                "replays": sum(g.replays for g in graphs),
                "pool_bytes": sum(g.pool_bytes for g in graphs),
                "by_kind": by_kind, "uncaptured": uncaptured}

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
            # the replay and the copies of its outputs are queued with no
            # other engine's replay between them (graphs.REPLAY_LOCK)
            with REPLAY_LOCK:
                logits = graph.replay().clone()
                out = io.out.clone()
        else:
            logits = self._step_fn(kind)()
            out = io.out.clone()
        host, ready = out, None
        if self.device.type == "cuda":
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
            self._last_ready = ready
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

    # -- disaggregated prefill/decode handoff -------------------------------

    def _require_paged(self, what):
        if not self.paged:
            raise RuntimeError("%s is a paged-engine operation (the "
                               "slotted layout has no page pool)" % what)

    def _pools(self):
        """The pool tensors a page carries, as index reads and writes take
        them (float8 as bytes): k, v, and the scale pools or None."""
        c = self.cache
        return tuple(None if t is None else raw_bytes(t)
                     for t in (c.k, c.v, c.k_scale, c.v_scale))

    def _new_handoff_buf(self):
        """A fresh transfer buffer (k, v, k_scale, v_scale) of
        ``handoff_pages`` pages, on the engine's device."""
        H = self.handoff_pages
        return [None if t is None else
                torch.zeros((H,) + tuple(t.shape[1:]), dtype=t.dtype,
                            device=self.device)
                for t in self._pools()]

    def _ids(self, page_ids, pad, what):
        """``page_ids`` padded to ``handoff_pages`` with ``pad``, an int64
        tensor on the device (one pinned copy)."""
        n = len(page_ids)
        if not 0 < n <= self.handoff_pages:
            raise ValueError("%s moves 1..%d pages per chunk, got %d"
                             % (what, self.handoff_pages, n))
        ids = np.full((self.handoff_pages,), int(pad), np.int64)
        ids[:n] = np.asarray(page_ids, np.int64)
        return self._to_device(ids)

    @torch.inference_mode()
    def export_pages(self, page_ids):
        """Gather up to ``handoff_pages`` pool pages (every layer, the
        scale rows of a quantized pool included) into the engine's
        persistent transfer buffer: the prefill side of a handoff.
        Returns the buffer's ``(k, v, k_scale, v_scale)`` (float8 pools as
        bytes); rows past ``len(page_ids)`` hold page 0's bytes, which the
        import drops.  The buffer is reused by the next export: stage it
        onto the decode engine first (a device copy queued before that
        export reads what this one wrote)."""
        return self._export_pages_into("_handoff_buf", page_ids)

    def _export_pages_into(self, buf_attr, page_ids):
        """The export body, into the persistent buffer named ``buf_attr``:
        the handoff and the host tier's spill use separate buffers, since
        a spill can fire from a reclaim while a handoff chunk is staged."""
        self._require_paged("export_pages")
        ids = self._ids(page_ids, 0, "export_pages")
        buf = getattr(self, buf_attr)
        if buf is None:
            buf = self._new_handoff_buf()
            setattr(self, buf_attr, buf)
        tr_on = self._tracer.enabled
        if tr_on:
            c0, t0_ns = self.graph_captures, time.perf_counter_ns()
        for pool, out in zip(self._pools(), buf):
            if pool is not None:
                torch.index_select(pool, 0, ids, out=out)
        if tr_on:
            self._dispatch_span("engine.kv_export", t0_ns, c0)
        return tuple(buf)

    @torch.inference_mode()
    def stage_handoff(self, bufs):
        """Place a peer engine's exported buffer (device tensors, or the
        host tensors of the host-staging transport) on this engine's
        device.  Tensors already there pass through: on one card the
        handoff is a device copy, the import's."""
        self._require_paged("stage_handoff")
        out = []
        for a in bufs:
            if a is None or a.device == self.device:
                out.append(a)
            elif a.device.type == "cpu" and self.device.type == "cuda":
                out.append(a.pin_memory().to(self.device, non_blocking=True))
            else:
                out.append(a.to(self.device))
        return tuple(out)

    @torch.inference_mode()
    def import_pages(self, bufs, dst_page_ids):
        """Scatter a staged transfer buffer into THIS pool at
        ``dst_page_ids`` (freshly allocated pages: the decode side of a
        handoff; the caller owns the allocator bookkeeping that mapped
        them).  The padding rows land in the sink page, never in a live
        one.  Queued on the stream behind any step in flight, with no
        host sync."""
        self._require_paged("import_pages")
        # the padding goes to the sink page
        ids = self._ids(dst_page_ids, self.num_pages, "import_pages")
        tr_on = self._tracer.enabled
        if tr_on:
            c0, t0_ns = self.graph_captures, time.perf_counter_ns()
        for pool, src in zip(self._pools(), bufs):
            if pool is not None:
                pool.index_copy_(0, ids, src.view(pool.dtype))
        if tr_on:
            self._dispatch_span("engine.kv_import", t0_ns, c0)

    def handoff_chunk_bytes(self, n_pages):
        """Bytes ``n_pages`` transferred pages move (K+V rows, scale rows
        included), for the handoff accounting."""
        return int(n_pages) * self.page_size * self.kv_row_bytes()

    # -- the tiered KV host cache: spill, fetch plan, staging --------------

    @torch.inference_mode()
    def _spill_page(self, pid, digests):
        """The allocator's spill hook (and the explicit cold-page path):
        export one refcount-0 page's rows, codes and scales included,
        through the spill buffer into the host tier under every chained
        digest it is reachable by, so a host hit implies exact-prefix
        equality.  The copy to the host waits for the stream: a step in
        flight lands first (the reclaim that spills is rare)."""
        tier = self._host_tier
        if tier is None or not digests:
            return
        out = self._export_pages_into("_spill_buf", [pid])
        arrays = {}
        for name, a in zip(("k", "v", "ks", "vs"), out):
            if a is not None:
                arrays[name] = a[0].to("cpu", copy=True)
        stored = False
        for d in digests:
            stored = tier.put(d, arrays) or stored
        if stored:
            self._m_host_spill.inc()
            self._m_host_bytes.set(tier.bytes_used())
            if self._kv_index is not None:
                self._kv_index.offer(digests)

    def spill_cached_pages(self, limit=None):
        """Explicit cold-page policy: spill up to ``limit`` free-but-cached
        (refcount-0, hash-reachable) pages to the host tier and return
        them to the truly-free list.  Returns the pages evicted from the
        device cache."""
        self._require_paged("spill_cached_pages")
        if self._host_tier is None:
            raise RuntimeError(
                "spill_cached_pages needs a host tier (kv_host_bytes "
                "argument or PADDLE_TPU_KV_HOST_BYTES)")
        pids = list(self._alloc._cached)
        if limit is not None:
            pids = pids[:int(limit)]
        for pid in pids:
            digests = self._alloc._page_hashes.get(pid)
            if digests:
                self._spill_page(pid, frozenset(digests))
            self._alloc.evict_cached(pid)
        return len(pids)

    def host_fetch_plan(self, ids):
        """``[(page_index, digest)]`` of the contiguous host-tier pages
        that would extend the device-resident coverage of prompt ``ids``:
        what the scheduler pulls back before admitting the request as a
        full prefix hit.  Empty when the tier is off or cold or the device
        cache already covers what the tier could add; counts one
        ``kv_host_miss`` when the tier was consulted at the coverage
        boundary and had nothing."""
        tier = self._host_tier
        if tier is None or not self.paged:
            return []
        ids = np.asarray(ids, np.int32).reshape(-1)
        full, tail = self._alloc._prompt_digests(ids)
        entries = list(enumerate(full))
        if tail is not None:
            entries.append((len(full), tail))
        plan = []
        consulted = False
        for idx, d in entries:
            if d in self._alloc._hash_to_page:
                continue            # device-resident: nothing to fetch
            consulted = True
            if d in tier:
                plan.append((idx, d))
            else:
                break               # contiguity: stop at the first hole
        if consulted and not plan:
            self._m_host_misses.inc()
        return plan

    @torch.inference_mode()
    def host_fetch_stage(self, digests, rid=None, chunk=0):
        """Stage one fetch chunk (up to ``handoff_pages`` tier entries):
        assemble a transfer-buffer-shaped host chunk from the tier, push
        it through the npz staging transport at the ``serve.kv_tier``
        faultpoint (a torn read surfaces here) and place it on this
        engine's device.  Raises ``KeyError`` when an entry vanished (an
        LRU eviction raced the fetch) or one of ``TRANSPORT_ERRORS`` on a
        torn staging read; the scheduler's abort path owns both."""
        from .kv_tier import KV_TIER_SITE, npz_roundtrip
        self._require_paged("host_fetch_stage")
        n = len(digests)
        if not 0 < n <= self.handoff_pages:
            raise ValueError("host_fetch_stage moves 1..%d pages per "
                             "chunk, got %d" % (self.handoff_pages, n))
        tier = self._host_tier
        if tier is None:
            raise RuntimeError("host_fetch_stage needs a host tier")
        H = self.handoff_pages
        bufs = [None if t is None else
                torch.zeros((H,) + tuple(t.shape[1:]), dtype=t.dtype)
                for t in self._pools()]
        for i, d in enumerate(digests):
            arrays = tier.get(d)
            if arrays is None:
                raise KeyError("host-tier entry vanished mid-fetch "
                               "(LRU eviction raced the fetch)")
            for name, b in zip(("k", "v", "ks", "vs"), bufs):
                if b is not None:
                    b[i] = arrays[name]
        bufs = npz_roundtrip(tuple(bufs), KV_TIER_SITE, rid=rid,
                             chunk=chunk)
        return self.stage_handoff(bufs)

    def kv_host_bytes_used(self):
        """Host-tier occupancy in bytes (0 with the tier off)."""
        tier = self._host_tier
        return 0 if tier is None else tier.bytes_used()

    def prefix_digest_snapshot(self):
        """Hex digests of every chained page this engine can serve a
        prefix hit from: the device pool's hash table, the host tier, and
        what the attached cluster index offers.  The router's affinity
        probe calls this from its own thread while the replica decodes; a
        concurrent change yields a slightly stale set (one bounded retry),
        which is fine for a routing hint: admission re-derives exact
        coverage."""
        from .kv_tier import _hex
        digs = set()
        if not self.paged:
            return digs
        for _ in range(4):
            try:
                digs = set(self._alloc._hash_to_page)
                tier = self._host_tier
                if tier is not None:
                    digs.update(tier.digests())
                break
            except RuntimeError:   # the dict changed under the iteration
                digs = set()
                continue
        digs = {_hex(d) for d in digs}
        if self._kv_index is not None:
            digs.update(self._kv_index.snapshot_digests())
        return digs

    def attach_cluster_index(self, store, host=None, interval=None,
                             start=True):
        """Wire a TCPStore-backed :class:`~.kv_tier.ClusterPrefixIndex`
        to this engine: every digest that becomes servable (registered on
        the device or spilled to the host tier) is offered to the
        publisher, and the tier's LRU evictions withdraw theirs at once.
        Returns the index (started as a daemon unless ``start=False``)."""
        from .kv_tier import ClusterPrefixIndex
        self._kv_index = ClusterPrefixIndex(store, host=host,
                                            interval=interval)
        if self._host_tier is not None:
            # withdraw() only changes the digest set under the index's own
            # lock (store I/O stays on the publisher thread), so it is
            # safe from the tier's hook, which runs outside the tier lock
            self._host_tier.evict_hook = self._kv_index.withdraw
        if start:
            self._kv_index.start()
        return self._kv_index

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
            "tp": self.tp,
            "slot_lengths": [int(x) for x in self._len_host],
            "graph_captures": {
                "decode": self.graph_captures_by_kind["decode"],
                "verify": self.graph_captures_by_kind["spec"],
                "prefill_chunk": self.graph_captures_by_kind["chunk"]},
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
            if self._host_tier is not None:
                st["kv_host"] = self._host_tier.state()
        return st
