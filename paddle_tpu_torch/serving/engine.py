"""The slotted decode engine (port of ``paddle_tpu/serving/engine.py``,
``paged=False``): a preallocated per-slot KV cache, bucketed whole-prompt
prefill and a batched decode step over every slot.

* ``prefill`` pads the prompt to a power-of-two bucket, writes rows
  ``[0, bucket)`` of the slot, attends causally (the CUDA flash forward on
  a card, one launch per layer) and samples the first token from the last
  REAL position.
* ``decode_submit`` / ``decode_fetch`` / ``decode`` advance every slot one
  token; ``active`` gates which slots' lengths advance.

The JAX engine compiles each entry once and donates the cache; PyTorch
runs the same model eagerly and the cache views update the buffers in
place.  Sampling noise comes from one ``torch.Generator`` per engine on
the engine's device; ``reseed(s)`` restarts it.

The engine runs on the card unless ``device="cpu"`` is given, and moves
the model there.  Not ported yet, and raising ``NotImplementedError``
instead of running something else: the paged layout, speculative decode,
quantized KV and tensor parallelism (ROADMAP.md §C).
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.dtype import convert_dtype
from .cache import DecodeView, PrefillView, SlottedKVCache
from .sampling import TOP_K_MAX, sample

__all__ = ["DecodeEngine", "InflightDecode", "prefill_buckets_for"]

_NOT_PORTED = ("%s is not ported to paddle_tpu_torch yet (ROADMAP.md §C: "
               "the slotted engine is the ported layout)")


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
    """One launched decode step whose tokens are not fetched yet: the
    device tensors of the sampled tokens and the last-position logits."""
    tok: object                           # (S,) int32 device tensor
    logits: object                        # (S, vocab) device tensor


class DecodeEngine:
    """Serving engine for a causal LM with a ``config`` carrying the GPT
    geometry (:class:`paddle_tpu_torch.models.gpt.GPTForCausalLM`)."""

    def __init__(self, model, num_slots=4, max_len=None, cache_dtype=None,
                 min_bucket=16, seed=0, top_k_max=TOP_K_MAX, paged=False,
                 kv_dtype=None, spec_k=0, tp=1, device=None):
        if paged:
            raise NotImplementedError(_NOT_PORTED % "the paged engine")
        if spec_k:
            raise NotImplementedError(_NOT_PORTED % "speculative decode")
        if kv_dtype is not None:
            raise NotImplementedError(_NOT_PORTED % "quantized KV")
        if int(tp) != 1:
            raise NotImplementedError(_NOT_PORTED % "tensor parallelism")
        cfg = model.config
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.paged = False
        self.spec_k = 0
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
        self.buckets = prefill_buckets_for(self.max_len, min_bucket)
        self.prompt_cap = self.buckets[-1]
        self.cache = SlottedKVCache.create(
            self.num_slots, cfg.num_hidden_layers, self.max_len,
            cfg.num_attention_heads,
            cfg.hidden_size // cfg.num_attention_heads,
            convert_dtype(cache_dtype), self.device)
        self._generator = torch.Generator(device=self.device)
        self.reseed(seed)

    def reset(self):
        """Free every slot (contents are overwritten lazily)."""
        self.cache.lengths.zero_()

    def reseed(self, seed):
        """Restart the sampling stream: after ``reseed(s)`` the next
        prefill/decode sequence reproduces a fresh engine built with
        ``seed=s``."""
        self._generator.manual_seed(int(seed))

    def bucket_for(self, n):
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(
            "prompt length %d exceeds the largest prefill bucket %d "
            "(max_len=%d)" % (n, self.buckets[-1], self.max_len))

    def free_slot(self, slot):
        """Slotted slots need no release: the next prefill overwrites the
        slot and sets its length."""

    def slot_lengths(self):
        """Per-slot valid lengths (a device-to-host copy)."""
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

    # -- prefill -----------------------------------------------------------

    @torch.inference_mode()
    def prefill(self, slot, token_ids, temperature=1.0, top_k=0,
                top_p=1.0):
        """Admit ``token_ids`` (1-D) into ``slot``; returns the sampled first
        token (int) and the last-position logits ((vocab,) device tensor)."""
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
                      top_p) -> InflightDecode:
        """Launch one batched decode step without fetching its tokens.
        ``tokens``: the per-slot last committed tokens (host array or an
        (S,) device tensor)."""
        active_np = np.asarray(active, bool).reshape(self.num_slots)
        toks = torch.as_tensor(np.asarray(tokens, np.int32)
                               if not isinstance(tokens, torch.Tensor)
                               else tokens, device=self.device)
        toks = toks.to(torch.int32).reshape(self.num_slots, 1)
        view = DecodeView(self.cache,
                          active=torch.as_tensor(active_np,
                                                 device=self.device))
        with _eval_scope(self.model):
            logits, _ = self.model(toks, cache=view)
        logits = logits[:, -1, :]
        tok = sample(logits, self._generator,
                     *self._params(temperature, top_k, top_p),
                     self.top_k_max)
        view.finalize()
        return InflightDecode(tok=tok, logits=logits)

    def decode_fetch(self, step: InflightDecode):
        """Consume a launched step: returns (next tokens as an np array,
        logits as a device tensor)."""
        return step.tok.cpu().numpy(), step.logits

    def decode(self, tokens, active, temperature, top_k, top_p):
        """One batched decode step over every slot; callers ignore the
        entries of inactive slots."""
        return self.decode_fetch(self.decode_submit(
            tokens, active, temperature, top_k, top_p))
