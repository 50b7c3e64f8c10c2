"""Continuous batching (port of ``paddle_tpu/serving/scheduler.py``, the
synchronous loop): iteration-level scheduling on the host side of the
batched decode step.

Each iteration admits waiting requests into free slots in FIFO order,
advances every admitting slot by one prefill chunk (paged engines), then
runs ONE batched decode over the slots whose prefill is done and retires
finished ones: EOS, ``max_new_tokens``, or a cache with no room for
another append (``cache_full``).  Per request it records TTFT (submit to
first token, queue wait included; a request evicted before its first
token reports 0.0), ``queue_wait`` (submit to admission) and TPOT (mean
decode seconds per decode-committed token).

**Chunked prefill (paged engines, the default).**  Admission starts a
:class:`~.engine.PrefillTask`; each iteration advances it by ONE chunk
between decode steps, so a long admission costs each running request one
chunk of latency per iteration instead of a whole-prompt stall.  A
prefix-cache hit skips the shared pages (``prefix_hit_pages``; per
request ``RequestResult.prefix_hit_tokens``), and a fully cached prompt
admits in a single 1-token chunk.  Slotted engines (``paged=False``)
keep the one-shot bucketed prefill.

**Refcount-aware eviction, preemption by recompute.**  When the page
pool is dry (a decode append or a prefill chunk cannot map a page), the
victim is the occupied slot with the MOST unshared pages — freeing it
returns the most pages — ties broken oldest-admitted first.  The victim
goes back to the FRONT of the waiting queue and, on re-admission,
re-prefills ``prompt + generated-so-far`` (vLLM-style recompute
preemption), mostly prefix-hitting its own still-cached pages.  A
request evicted more than ``max_preemptions`` times, or one whose
sequence the pool cannot hold alone, finishes ``"cache_full"``.

**Speculative decode** (engines with ``spec_k > 0``): the decode
iteration becomes a verify iteration.  Each active slot drafts
``spec_k`` tokens by prompt lookup over its own ``prompt + generated``
(:func:`.spec.propose`, host-side), one verify step scores every
position, and the scheduler commits the emitted run, cut at EOS and at
``max_new_tokens`` (a cut always retires the slot).  TPOT stays seconds
per committed token: a verify step's wall time is shared by every token
it emitted.  Per request, ``spec_proposed`` and ``spec_accepted`` land
on the :class:`RequestResult` and survive preemption.

Not ported yet (ROADMAP.md §A3, §A6): the overlapped loop
(``overlap=True`` raises), tracing, metrics, host-tier fetches and the
requeue transfer.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from .pages import PagePoolExhausted
from .spec import propose

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
                                         # (0.0: evicted before one)
    tpot: float                          # mean secs per decoded token
    queue_wait: float = 0.0              # submit -> admission, seconds
    prefix_hit_tokens: int = 0           # tokens served from the prefix
                                         # cache, over all admissions
    preemptions: int = 0                 # times evicted and requeued
    spec_proposed: int = 0               # draft tokens proposed for this
                                         # request (spec_k a verify step)
    spec_accepted: int = 0               # drafts the verify steps
                                         # accepted; 0/0 with spec off


class _ActiveSlot:
    __slots__ = ("req", "generated", "submit_t", "first_tok_t", "decode_s",
                 "decode_steps", "queue_wait", "prefill_task",
                 "admit_order", "prefix_hit_tokens", "spec_proposed",
                 "spec_accepted", "cache_len")

    def __init__(self, req, submit_t, queue_wait, admit_order,
                 prefill_task=None):
        self.req = req
        self.generated: List[int] = []
        self.submit_t = submit_t
        self.first_tok_t = None
        self.decode_s = 0.0
        self.decode_steps = 0            # timed decode-committed tokens
        self.queue_wait = queue_wait
        self.prefill_task = prefill_task   # None once prefill completed
        self.admit_order = admit_order     # FIFO tie-break for eviction
        self.prefix_hit_tokens = (prefill_task.shared_tokens
                                  if prefill_task is not None else 0)
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.cache_len = 0               # committed cache rows

    def first_token(self, tok, now):
        self.generated.append(int(tok))
        # a resumed (preempted) slot's recompute prefill lands here too:
        # its first-token time stays the original one
        if self.first_tok_t is None:
            self.first_tok_t = now


class ContinuousBatchingScheduler:
    # page-pressure evictions per request before the scheduler stops
    # requeueing it and finishes it "cache_full": bounds wasted recompute
    # and keeps run()'s termination argument simple
    max_preemptions = 3

    def __init__(self, engine, overlap=False):
        if overlap:
            raise NotImplementedError(
                "the overlapped decode loop is not ported to "
                "paddle_tpu_torch yet (ROADMAP.md §A3); use overlap=False")
        self.engine = engine
        self.overlap = False
        self.waiting: deque = deque()
        self.slots: List[Optional[_ActiveSlot]] = [None] * engine.num_slots
        self.finished: Dict[int, RequestResult] = {}
        self._next_rid = 0
        self._admit_seq = 0
        self._submit_t: Dict[int, float] = {}
        # rid -> parked _ActiveSlot (evicted, waiting to resume) and
        # rid -> times evicted; see _preempt()
        self._preempted: Dict[int, _ActiveSlot] = {}
        self._preempt_count: Dict[int, int] = {}
        self.decode_steps_total = 0      # batched decode steps run
        self.prefill_chunks_total = 0    # paged prefill chunks run
        self.prefix_hit_pages = 0        # pages mapped from the cache
        self.preemptions_total = 0       # evictions requeued

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
        self.engine.free_slot(idx)     # paged: pages back to the pool
        tpot = (act.decode_s / act.decode_steps) if act.decode_steps \
            else 0.0
        # a request evicted before producing any token has no first-token
        # time: it reports 0.0, which callers leave out of TTFT figures
        ttft = (act.first_tok_t - act.submit_t) \
            if act.first_tok_t is not None else 0.0
        self.finished[act.req.rid] = RequestResult(
            rid=act.req.rid, tokens=np.asarray(act.generated, np.int32),
            finish_reason=reason, ttft=ttft, tpot=tpot,
            queue_wait=act.queue_wait,
            prefix_hit_tokens=act.prefix_hit_tokens,
            preemptions=self._preempt_count.pop(act.req.rid, 0),
            spec_proposed=act.spec_proposed,
            spec_accepted=act.spec_accepted)

    def _check_finished(self, idx: int):
        """Retire the slot if its latest token ended the request.  The
        cache-full check reads the slot's host-tracked committed length:
        no device fetch on the decode path."""
        act = self.slots[idx]
        req = act.req
        if not act.generated:
            return
        tok = act.generated[-1]
        if req.eos_token_id is not None and tok == int(req.eos_token_id):
            self._finish(idx, "eos")
        elif len(act.generated) >= req.max_new_tokens:
            self._finish(idx, "length")
        elif act.cache_len >= self.engine.max_len:
            # no room for another append — retire rather than overflow
            self._finish(idx, "cache_full")

    # -- refcount-aware eviction (page pool pressure) ----------------------

    def _preempt(self, idx: int):
        """Recompute preemption: park the slot's state, free its pages,
        and put the request back at the FRONT of the waiting queue.  On
        re-admission it re-prefills ``prompt + generated`` — greedy
        continuation is unchanged — instead of finishing with whatever it
        had (a victim evicted mid-prefill would otherwise return no
        tokens)."""
        act = self.slots[idx]
        rid = act.req.rid
        self.slots[idx] = None
        self.engine.free_slot(idx)     # pages back (shared: refcount--)
        act.prefill_task = None        # chunk state is page-bound: drop
        self.waiting.appendleft(act.req)
        self._submit_t[rid] = act.submit_t
        self._preempted[rid] = act
        self.preemptions_total += 1

    def _evict_for_pages(self, requester_idx: int) -> bool:
        """Free pages by preempting one slot.  Victim: the occupied slot
        with the MOST unshared pages, other than the requester; ties
        break oldest-admitted first.  The victim is requeued for
        recompute unless it has been evicted ``max_preemptions`` times
        already (then it finishes "cache_full").  Returns False only when
        the requester was the last occupant: a sequence the pool cannot
        hold alone finishes "cache_full", never requeued."""
        candidates = [i for i, a in enumerate(self.slots)
                      if a is not None and i != requester_idx]
        if not candidates:
            self._finish(requester_idx, "cache_full")
            return False
        victim = max(candidates,
                     key=lambda i: (self.engine.unshared_pages(i),
                                    -self.slots[i].admit_order))
        rid = self.slots[victim].req.rid
        n = self._preempt_count.get(rid, 0) + 1
        self._preempt_count[rid] = n
        if n > self.max_preemptions:
            self._finish(victim, "cache_full")
        else:
            self._preempt(victim)
        return True

    # -- admission ---------------------------------------------------------

    def _begin_paged(self, idx: int, req: Request, ids):
        task = self.engine.prefill_begin(
            idx, ids, temperature=req.temperature, top_k=req.top_k,
            top_p=req.top_p)
        self.prefix_hit_pages += task.shared_pages
        return task

    def _admit_paged(self, idx: int, req: Request):
        """One paged admission (fresh, or a preemption's resume) into slot
        ``idx``: begins its chunked prefill."""
        submit_t = self._submit_t.pop(req.rid)
        resumed = self._preempted.pop(req.rid, None)
        order = self._admit_seq
        self._admit_seq += 1
        if resumed is not None:
            # re-prefill prompt + generated so that the next sampled token
            # continues the sequence; timing state and the token list
            # survive on the parked slot, queue_wait is not re-measured
            ids = req.prompt
            if resumed.generated:
                ids = np.concatenate(
                    [ids, np.asarray(resumed.generated, np.int32)])
            task = self._begin_paged(idx, req, ids)
            resumed.prefix_hit_tokens += task.shared_tokens
            resumed.prefill_task = task
            resumed.admit_order = order
            self.slots[idx] = resumed
            return
        queue_wait = time.perf_counter() - submit_t
        task = self._begin_paged(idx, req, req.prompt)
        self.slots[idx] = _ActiveSlot(req, submit_t, queue_wait, order,
                                      prefill_task=task)

    def admit(self) -> int:
        """Fill free slots from the waiting queue (FIFO).  Paged engines
        only BEGIN the prefill here (chunks run in :meth:`prefill_once`,
        interleaved with decode); slotted engines run their one-shot
        bucketed prefill.  Returns how many requests were admitted."""
        n = 0
        for idx in range(self.engine.num_slots):
            if self.slots[idx] is not None or not self.waiting:
                continue
            req = self.waiting.popleft()
            n += 1
            if self.engine.paged:
                self._admit_paged(idx, req)
                continue
            submit_t = self._submit_t.pop(req.rid)
            queue_wait = time.perf_counter() - submit_t
            order = self._admit_seq
            self._admit_seq += 1
            tok, _logits = self.engine.prefill(
                idx, req.prompt, temperature=req.temperature,
                top_k=req.top_k, top_p=req.top_p)
            act = _ActiveSlot(req, submit_t, queue_wait, order)
            act.cache_len = int(req.prompt.size)
            act.first_token(tok, time.perf_counter())
            self.slots[idx] = act
            self._check_finished(idx)
        return n

    def prefill_once(self) -> int:
        """Advance every admitting slot by ONE chunk (the chunked-prefill
        interleave).  A chunk that cannot map pages evicts the
        max-unshared victim and retries.  Returns chunks run."""
        n = 0
        for idx, act in enumerate(self.slots):
            if act is None or act.prefill_task is None:
                continue
            task = act.prefill_task
            while True:
                try:
                    done = self.engine.prefill_step(task)
                    break
                except PagePoolExhausted:
                    if not self._evict_for_pages(idx):
                        done = None
                        break
            if done is None:
                continue
            n += 1
            self.prefill_chunks_total += 1
            if done:
                act.prefill_task = None
                act.cache_len = int(task.ids.size)
                act.first_token(task.first_token, time.perf_counter())
                self._check_finished(idx)
        return n

    # -- decode ------------------------------------------------------------

    def _active_mask(self):
        return [a is not None and a.prefill_task is None
                for a in self.slots]

    def decode_once(self) -> int:
        """One batched decode (or speculative verify) over the slots
        whose prefill is done; returns the number of tokens appended.  A
        paged engine first maps every append's page (``spec_k + 1`` a
        slot for a verify step), evicting refcount-aware while the pool
        is dry."""
        spec_k = int(self.engine.spec_k)
        active = self._active_mask()
        if not any(active):
            return 0
        if self.engine.paged:
            while True:
                blocked = self.engine.ensure_decode_ready(
                    active, steps=spec_k + 1)
                if blocked is None:
                    break
                self._evict_for_pages(blocked)
                active = self._active_mask()
                if not any(active):
                    return 0
        S = self.engine.num_slots
        tokens = np.zeros((S,), np.int32)
        temps = np.ones((S,), np.float32)
        top_ks = np.zeros((S,), np.int32)
        top_ps = np.ones((S,), np.float32)
        drafts = np.zeros((S, spec_k), np.int32)
        for i, act in enumerate(self.slots):
            if not active[i]:
                continue
            tokens[i] = act.generated[-1]
            temps[i] = act.req.temperature
            top_ks[i] = act.req.top_k
            top_ps[i] = act.req.top_p
            if spec_k:
                # prompt lookup over the slot's own history: a miss pads,
                # and the verify step then emits one token, as decode
                hist = np.concatenate(
                    [act.req.prompt, np.asarray(act.generated, np.int32)])
                drafts[i], _hit = propose(hist, spec_k,
                                          self.engine.spec_ngram)
        t0 = time.perf_counter()
        if spec_k:
            emitted, counts, _logits = self.engine.decode_spec(
                tokens, drafts, active, temps, top_ks, top_ps,
                pages_ready=True)
        else:
            next_tok, _logits = self.engine.decode(tokens, active, temps,
                                                   top_ks, top_ps,
                                                   pages_ready=True)
        step_s = time.perf_counter() - t0
        self.decode_steps_total += 1
        n = 0
        for i, act in enumerate(self.slots):
            if not active[i]:
                continue
            if spec_k:
                raw = int(counts[i])
                emit = [int(t) for t in emitted[i, :raw]]
                act.spec_proposed += spec_k
                act.spec_accepted += raw - 1
                # the device committed `raw` rows (clamped at max_len)
                act.cache_len = min(act.cache_len + raw,
                                    self.engine.max_len)
                # cut at the budget and at EOS: both retire the slot in
                # _check_finished, so a cut token list never belongs to
                # a slot that keeps decoding
                emit = emit[:max(act.req.max_new_tokens
                                 - len(act.generated), 0)]
                eos = act.req.eos_token_id
                if eos is not None and int(eos) in emit:
                    emit = emit[:emit.index(int(eos)) + 1]
            else:
                emit = [int(next_tok[i])]
                act.cache_len = min(act.cache_len + 1,
                                    self.engine.max_len)
            act.generated.extend(emit)
            act.decode_s += step_s
            act.decode_steps += len(emit)     # TPOT: seconds a token
            n += len(emit)
            self._check_finished(i)
        return n

    def step(self) -> int:
        """One iteration: admit into free slots, advance every admitting
        slot by one prefill chunk, then one batched decode.  Returns the
        decode tokens produced (first tokens excluded)."""
        self.admit()
        self.prefill_once()
        return self.decode_once()

    def has_work(self) -> bool:
        return bool(self.waiting or any(a is not None for a in self.slots))

    def run(self) -> Dict[int, RequestResult]:
        """Drive to completion; returns {rid: RequestResult}.  Always
        terminates: each iteration admits, advances every admitting
        prompt by a chunk (evicting on page pressure rather than
        blocking) and appends a token to every decoding request, each of
        which is finite; a request is requeued at most
        ``max_preemptions`` times, and a sole occupant the pool cannot
        hold is finished, never requeued."""
        while self.has_work():
            self.step()
        return self.finished
