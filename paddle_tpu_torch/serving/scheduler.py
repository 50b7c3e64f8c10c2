"""Continuous batching (port of ``paddle_tpu/serving/scheduler.py``, the
synchronous loop): iteration-level scheduling on the host side of the
batched decode step.

Each iteration admits waiting requests into free slots in FIFO order
(one bucketed prefill each, which samples the first token), then runs ONE
batched decode over the active slots and retires finished ones: EOS,
``max_new_tokens``, or a cache with no room for another append
(``cache_full``).  Per request it records TTFT (submit to first token,
queue wait included), ``queue_wait`` (submit to admission) and TPOT (mean
decode seconds per later token).

Not ported yet (ROADMAP.md §C): the overlapped loop (``overlap=True``
raises), chunked prefill and preemption (paged engines), speculative
verify, tracing, metrics, host-tier fetches and the requeue transfer.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

__all__ = ["Request", "RequestResult", "ContinuousBatchingScheduler"]


@dataclasses.dataclass
class Request:
    prompt: "np.ndarray"                 # 1-D int token ids
    max_new_tokens: int = 20
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    eos_token_id: Optional[int] = None
    rid: Optional[int] = None            # assigned by submit()


@dataclasses.dataclass
class RequestResult:
    rid: int
    tokens: "np.ndarray"                 # generated ids (prompt excluded)
    finish_reason: str                   # "eos" | "length" | "cache_full"
    ttft: float                          # submit -> first token, seconds
    tpot: float                          # mean secs per decoded token
    queue_wait: float = 0.0              # submit -> admission, seconds


class _ActiveSlot:
    __slots__ = ("req", "generated", "submit_t", "first_tok_t", "decode_s",
                 "decode_steps", "queue_wait", "cache_len")

    def __init__(self, req, submit_t, queue_wait):
        self.req = req
        self.generated: List[int] = []
        self.submit_t = submit_t
        self.first_tok_t = None
        self.decode_s = 0.0
        self.decode_steps = 0
        self.queue_wait = queue_wait
        self.cache_len = 0               # committed cache rows


class ContinuousBatchingScheduler:
    def __init__(self, engine, overlap=False):
        if overlap:
            raise NotImplementedError(
                "the overlapped decode loop is not ported to "
                "paddle_tpu_torch yet (ROADMAP.md §C); use overlap=False")
        if engine.paged:
            raise NotImplementedError(
                "paged engines are not ported to paddle_tpu_torch yet")
        self.engine = engine
        self.overlap = False
        self.waiting: deque = deque()
        self.slots: List[Optional[_ActiveSlot]] = [None] * engine.num_slots
        self.finished: Dict[int, RequestResult] = {}
        self._next_rid = 0
        self._submit_t: Dict[int, float] = {}
        self.decode_steps_total = 0      # batched decode steps run

    def submit(self, req: Request) -> int:
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        cap = self.engine.prompt_cap
        if prompt.size > cap:
            raise ValueError(
                "prompt length %d exceeds the engine's prompt capacity %d"
                % (prompt.size, cap))
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        rid = self._next_rid if req.rid is None else int(req.rid)
        req = dataclasses.replace(req, prompt=prompt, rid=rid)
        self._next_rid = max(self._next_rid, rid + 1)
        self._submit_t[rid] = time.perf_counter()
        self.waiting.append(req)
        return rid

    # -- slot lifecycle ----------------------------------------------------

    def _finish(self, idx: int, reason: str):
        act = self.slots[idx]
        self.slots[idx] = None
        self.engine.free_slot(idx)
        tpot = (act.decode_s / act.decode_steps) if act.decode_steps \
            else 0.0
        ttft = (act.first_tok_t - act.submit_t) \
            if act.first_tok_t is not None else 0.0
        self.finished[act.req.rid] = RequestResult(
            rid=act.req.rid, tokens=np.asarray(act.generated, np.int32),
            finish_reason=reason, ttft=ttft, tpot=tpot,
            queue_wait=act.queue_wait)

    def _check_finished(self, idx: int):
        act = self.slots[idx]
        req = act.req
        tok = act.generated[-1]
        if req.eos_token_id is not None and tok == int(req.eos_token_id):
            self._finish(idx, "eos")
        elif len(act.generated) >= req.max_new_tokens:
            self._finish(idx, "length")
        elif act.cache_len >= self.engine.max_len:
            # no room for another append — retire rather than overflow
            self._finish(idx, "cache_full")

    # -- admission ---------------------------------------------------------

    def admit(self) -> int:
        """Fill free slots from the waiting queue (FIFO), one bucketed
        prefill each.  Returns how many requests were admitted."""
        n = 0
        for idx in range(self.engine.num_slots):
            if self.slots[idx] is not None or not self.waiting:
                continue
            req = self.waiting.popleft()
            submit_t = self._submit_t.pop(req.rid)
            queue_wait = time.perf_counter() - submit_t
            tok, _logits = self.engine.prefill(
                idx, req.prompt, temperature=req.temperature,
                top_k=req.top_k, top_p=req.top_p)
            act = _ActiveSlot(req, submit_t, queue_wait)
            act.cache_len = int(req.prompt.size)
            act.generated.append(int(tok))
            act.first_tok_t = time.perf_counter()
            self.slots[idx] = act
            self._check_finished(idx)
            n += 1
        return n

    # -- decode ------------------------------------------------------------

    def decode_once(self) -> int:
        """One batched decode over the active slots; returns the number of
        tokens appended."""
        active = [a is not None for a in self.slots]
        if not any(active):
            return 0
        S = self.engine.num_slots
        tokens = np.zeros((S,), np.int32)
        temps = np.ones((S,), np.float32)
        top_ks = np.zeros((S,), np.int32)
        top_ps = np.ones((S,), np.float32)
        for i, act in enumerate(self.slots):
            if act is None:
                continue
            tokens[i] = act.generated[-1]
            temps[i] = act.req.temperature
            top_ks[i] = act.req.top_k
            top_ps[i] = act.req.top_p
        t0 = time.perf_counter()
        next_tok, _logits = self.engine.decode(tokens, active, temps,
                                               top_ks, top_ps)
        step_s = time.perf_counter() - t0
        self.decode_steps_total += 1
        n = 0
        for i, act in enumerate(self.slots):
            if act is None:
                continue
            act.generated.append(int(next_tok[i]))
            act.cache_len = min(act.cache_len + 1, self.engine.max_len)
            act.decode_s += step_s
            act.decode_steps += 1
            n += 1
            self._check_finished(i)
        return n

    def step(self) -> int:
        """One iteration: admit into free slots, then one batched decode.
        Returns the decode tokens produced (first tokens excluded)."""
        self.admit()
        return self.decode_once()

    def has_work(self) -> bool:
        return bool(self.waiting or any(a is not None for a in self.slots))

    def run(self) -> Dict[int, RequestResult]:
        """Drive to completion; returns {rid: RequestResult}."""
        while self.has_work():
            self.step()
        return self.finished
