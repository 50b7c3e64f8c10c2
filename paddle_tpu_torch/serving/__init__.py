"""paddle_tpu_torch.serving — the slotted serving engine (port of
``paddle_tpu.serving``): the slotted KV cache (:mod:`.cache`), the
bucketed-prefill + batched-decode engine (:mod:`.engine`), the
synchronous continuous-batching scheduler (:mod:`.scheduler`) and
per-slot sampling (:mod:`.sampling`)."""
from __future__ import annotations

import numpy as np

from .cache import DecodeView, PrefillView, SlottedKVCache, is_cache_view
from .engine import DecodeEngine, InflightDecode, prefill_buckets_for
from .sampling import TOP_K_MAX, sample
from .scheduler import ContinuousBatchingScheduler, Request, RequestResult

__all__ = ["SlottedKVCache", "DecodeView", "PrefillView", "is_cache_view",
           "DecodeEngine", "InflightDecode", "prefill_buckets_for",
           "sample", "TOP_K_MAX", "ContinuousBatchingScheduler", "Request",
           "RequestResult", "generate", "engine_for"]

#: bound on cached engines per model: each holds two full preallocated
#: (slots, layers, max_len, heads, head_dim) KV buffers
_MAX_CACHED_ENGINES = 4


def engine_for(model, num_slots=4, max_len=None, tp=1, device=None, **kw):
    """A per-model engine cache: repeated :func:`generate` calls with the
    same geometry reuse one engine (and its cache buffers).  At most
    :data:`_MAX_CACHED_ENGINES` geometries are kept (LRU).  The seed is not
    geometry: callers reseed the cached engine.  The engine reads the
    model's live parameters, so training between calls is reflected."""
    dev = str(device) if device is not None else None
    key = (int(num_slots), max_len if max_len is None else int(max_len),
           int(tp), dev, tuple(sorted(kw.items())))
    cache = model.__dict__.setdefault("_serving_engines", {})
    eng = cache.pop(key, None)           # re-insert = move to LRU tail
    if eng is None:
        eng = DecodeEngine(model, num_slots=num_slots, max_len=max_len,
                           tp=tp, device=device, **kw)
        while len(cache) >= _MAX_CACHED_ENGINES:
            cache.pop(next(iter(cache)))
    cache[key] = eng
    return eng


def generate(model, prompts, max_new_tokens=20, temperature=1.0, top_k=0,
             top_p=1.0, eos_token_id=None, seed=0, num_slots=None,
             max_len=None, **engine_kw):
    """Generate continuations for ``prompts`` through the engine and the
    continuous-batching scheduler.  ``prompts``: a 2-D int array (one
    prompt per row), ONE 1-D prompt, or a list of 1-D prompts of ragged
    lengths.  Returns a list of 1-D int32 np arrays of generated ids, in
    submission order."""
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
