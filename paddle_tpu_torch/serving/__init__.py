"""paddle_tpu_torch.serving — the serving engine (port of
``paddle_tpu.serving``): the slotted and paged KV caches
(:mod:`.cache`), the page allocator (:mod:`.pages`), the engine with
chunked prefill, prefix sharing and copy-on-write (:mod:`.engine`), whose
decode and verify steps run on a card as CUDA graphs captured once
(:mod:`.graphs`), the continuous-batching scheduler with its overlapped
loop (one step in flight, the default), recompute preemption and its
spans, metrics and liveness beacon (:mod:`.scheduler`), per-slot
sampling and the speculative accept rule (:mod:`.sampling`),
prompt-lookup drafting (:mod:`.spec`), the host-RAM KV tier and the
cluster prefix index (:mod:`.kv_tier`), disaggregated prefill/decode
(:mod:`.disagg`), the replicated fleet behind a router (:mod:`.router`),
the async streaming HTTP front end (:mod:`.frontend` — SSE per-token
streaming, bounded admission, preemption-guard drain, ``/healthz``, over
one engine, a disaggregated pair or a fleet) and the Poisson load
harness (:mod:`.loadgen`).  ``engine_for`` and ``generate`` build paged engines
unless given ``paged=False``, and ``generate`` drives the default
(overlapped) scheduler, as the JAX package's do; both pass ``spec_k``
and ``kv_dtype`` through."""
from __future__ import annotations

import numpy as np

from .cache import (DecodeView, PagedDecodeView, PagedKVCache,
                    PagedPrefillChunkView, PrefillView, SlottedKVCache,
                    dequantize_kv, is_cache_view, paged_scatter,
                    quantize_kv)
from .engine import (DecodeEngine, InflightDecode, PrefillTask,
                     ThreadedTokens, prefill_buckets_for)
from .frontend import ServingFrontend
from .pages import PageAllocator, PagePoolExhausted, prompt_digest_chain
from .cache import _as_kv_dtypes
from .sampling import TOP_K_MAX, sample, spec_accept
from .scheduler import (ContinuousBatchingScheduler, Request, RequestResult,
                        RequeueState)
from .disagg import DisaggScheduler, HandoffTask
from .kv_tier import ClusterPrefixIndex, HostPageTier, npz_roundtrip
from .router import NoHealthyReplicas, RemoteReplicaHandle, Router
from .spec import propose

__all__ = ["SlottedKVCache", "DecodeView", "PrefillView", "PagedKVCache",
           "PagedDecodeView", "PagedPrefillChunkView", "paged_scatter",
           "is_cache_view", "quantize_kv", "dequantize_kv",
           "PageAllocator", "PagePoolExhausted",
           "prompt_digest_chain", "DecodeEngine", "InflightDecode",
           "PrefillTask", "ThreadedTokens", "prefill_buckets_for",
           "sample", "spec_accept",
           "propose", "TOP_K_MAX",
           "ContinuousBatchingScheduler", "Request", "RequestResult",
           "RequeueState", "DisaggScheduler", "HandoffTask",
           "HostPageTier", "ClusterPrefixIndex", "npz_roundtrip",
           "Router", "RemoteReplicaHandle", "NoHealthyReplicas",
           "ServingFrontend", "generate", "engine_for"]

#: bound on cached engines per model: each holds a full preallocated KV
#: pool (two (slots, layers, max_len, heads, head_dim) buffers' worth)
_MAX_CACHED_ENGINES = 4


def engine_for(model, num_slots=4, max_len=None, tp=1, device=None, **kw):
    """A per-model engine cache: repeated :func:`generate` calls with the
    same geometry reuse one engine (and its cache buffers).  At most
    :data:`_MAX_CACHED_ENGINES` geometries are kept (LRU).  The seed is not
    geometry: callers reseed the cached engine.  The engine reads the
    model's live parameters, so training between calls is reflected; a
    reused paged engine drops its prefix cache when a parameter changed
    (``DecodeEngine.refresh_state``).  ``spec_k`` and ``kv_dtype`` are
    geometry, keyed canonically: ``spec_k=0`` spelled or defaulted, and
    ``"fp8"`` or ``"float8_e4m3fn"``, each map to one engine."""
    dev = str(device) if device is not None else None
    kw["kv_dtype"], _ = _as_kv_dtypes(kw.get("kv_dtype"))
    kw["spec_k"] = int(kw.get("spec_k", 0))
    key = (int(num_slots), max_len if max_len is None else int(max_len),
           int(tp), dev, tuple(sorted(kw.items())))
    cache = model.__dict__.setdefault("_serving_engines", {})
    eng = cache.pop(key, None)           # re-insert = move to LRU tail
    if eng is None:
        eng = DecodeEngine(model, num_slots=num_slots, max_len=max_len,
                           tp=tp, device=device, **kw)
        while len(cache) >= _MAX_CACHED_ENGINES:
            cache.pop(next(iter(cache)))
    else:
        eng.refresh_state()
    cache[key] = eng
    return eng


def generate(model, prompts, max_new_tokens=20, temperature=1.0, top_k=0,
             top_p=1.0, eos_token_id=None, seed=0, num_slots=None,
             max_len=None, **engine_kw):
    """Generate continuations for ``prompts`` through the engine and the
    continuous-batching scheduler's default (overlapped) loop.
    ``prompts``: a 2-D int array (one prompt per row), ONE 1-D prompt,
    or a list of 1-D prompts of ragged lengths.  Returns a list of 1-D
    int32 np arrays of generated ids, in submission order."""
    if isinstance(prompts, np.ndarray) and prompts.dtype != object:
        arr = prompts
    else:
        try:
            arr = np.asarray(prompts)
        except ValueError:                # ragged list of prompts
            arr = None
    if arr is not None and arr.dtype != object:
        if arr.ndim == 1:                 # one prompt, not N scalar ones
            arr = arr.reshape(1, -1)
        if arr.ndim != 2:
            raise ValueError("prompts must be 1-D, 2-D, or a list of 1-D "
                             "prompts; got shape %r" % (arr.shape,))
        prompt_list = [arr[i] for i in range(arr.shape[0])]
    else:
        prompt_list = [np.asarray(p).reshape(-1) for p in prompts]
    if num_slots is None:
        # power-of-two bucket (1/2/4/8): nearby batch sizes reuse one engine
        num_slots = 1
        while num_slots < min(len(prompt_list), 8):
            num_slots *= 2
    eng = engine_for(model, num_slots=num_slots, max_len=max_len,
                     **engine_kw)
    eng.reseed(seed)
    sched = ContinuousBatchingScheduler(eng)
    rids = [sched.submit(Request(
        prompt=p, max_new_tokens=max_new_tokens, temperature=temperature,
        top_k=top_k, top_p=top_p, eos_token_id=eos_token_id))
        for p in prompt_list]
    results = sched.run()
    return [results[r].tokens for r in rids]
