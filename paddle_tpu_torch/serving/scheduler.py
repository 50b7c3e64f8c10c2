"""Continuous batching (port of ``paddle_tpu/serving/scheduler.py``):
iteration-level scheduling on the host side of the batched decode step.

Each iteration admits waiting requests into free slots in FIFO order,
advances every admitting slot by one prefill chunk (paged engines), then
runs ONE batched decode over the slots whose prefill is done and retires
finished ones: EOS, ``max_new_tokens``, or a cache with no room for
another append (``cache_full``).  Per request it records TTFT (submit to
first token, queue wait included; a request evicted before its first
token reports 0.0), ``queue_wait`` (submit to admission) and TPOT (mean
decode seconds per decode-committed token).

**The overlapped loop (the default, as in the JAX package).**  The loop
keeps ONE decode step in flight: iteration t launches step t, threading
step t-1's sampled tokens on the device (:class:`~.engine.ThreadedTokens`),
and only then fetches step t-1, so the host's bookkeeping for t-1 (EOS
and budget cuts, drafting, page bookkeeping, admission) overlaps the
card's work on step t.  On a card the engine replays each step from a
captured CUDA graph, and a fetch waits for its own step's copy event
alone.  One-step-stale decisions are reconciled at consume time by
IDENTITY: a lane is credited only if the same request still occupies it;
the token a stale step computed for a since-retired, preempted or
cancelled slot is dropped, its append lands in pages ``free_slot``
already reclaimed (length-masked reads never reach it), and the host
length mirror stays exact.  Greedy output is identical to the
synchronous loop (``overlap=False`` or ``PADDLE_TPU_SERVE_OVERLAP=0``,
kept for A/B); seeded sampling at temperature > 0 repeats within a mode,
not across modes (a stale step draws numbers too).  Page pressure
drains the in-flight step before evicting.  ``host_gap_seconds`` /
``decode_steps_total`` give the wall time a step during which no step
was in flight: the window where the host can starve the card.

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
(:func:`.spec.propose`, host-side; with a step in flight the history
lags by its unconsumed run, which moves throughput, never greedy
tokens), one verify step scores every position, and the scheduler
commits the emitted run, cut at EOS and at ``max_new_tokens`` (a cut
always retires the slot).  A verify step's advance depends on the data,
so with one in flight the pages of both steps' worst case are mapped.
TPOT stays seconds per committed token.  Per request, ``spec_proposed``
and ``spec_accepted`` land on the :class:`RequestResult` and survive
preemption.

**Host-facing API.**  ``cancel(rid)`` frees a running request's slot and
pages (refcount-exact) or drops a waiting or parked one, finishing it
``"cancelled"``; ``on_token(rid, [ids])`` streams every appended run
(first tokens included) and ``on_finish(result)`` every retirement, on
the scheduler's thread.

Not ported yet (ROADMAP.md §A6): tracing spans, metrics, liveness
beacons, faultpoints, host-tier fetches (and so ``cancel``'s branch for
a request whose pages are being fetched back) and the requeue transfer.
"""
from __future__ import annotations

import dataclasses
import os
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from .engine import ThreadedTokens
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
    finish_reason: str                   # "eos" | "length" |
                                         # "cache_full" | "cancelled"
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
    __slots__ = ("req", "generated", "submit_t", "first_tok_t", "last_t",
                 "decode_s", "decode_steps", "queue_wait", "prefill_task",
                 "admit_order", "prefix_hit_tokens", "spec_proposed",
                 "spec_accepted", "cache_len")

    def __init__(self, req, submit_t, queue_wait, admit_order,
                 prefill_task=None):
        self.req = req
        self.generated: List[int] = []
        self.submit_t = submit_t
        self.first_tok_t = None
        self.last_t = None
        self.decode_s = 0.0
        self.decode_steps = 0            # timed decode-committed tokens
        self.queue_wait = queue_wait
        self.prefill_task = prefill_task   # None once prefill completed
        self.admit_order = admit_order     # FIFO tie-break for eviction
        self.prefix_hit_tokens = (prefill_task.shared_tokens
                                  if prefill_task is not None else 0)
        self.spec_proposed = 0
        self.spec_accepted = 0
        # committed cache rows, advanced by each CONSUMED step (exact in
        # the overlapped loop, where the engine's mirror of a plain
        # decode runs one launched step ahead)
        self.cache_len = 0

    def first_token(self, tok, now):
        self.generated.append(int(tok))
        # a resumed (preempted) slot's recompute prefill lands here too:
        # its first-token time stays the original one
        if self.first_tok_t is None:
            self.first_tok_t = now
        self.last_t = now


class _Inflight:
    """One launched, unconsumed decode (or verify) step: the engine's
    :class:`~.engine.InflightDecode` and each lane's occupant at launch.
    The consume credits a lane only if the same :class:`_ActiveSlot`
    still occupies it."""
    __slots__ = ("rec", "lane_acts", "t0_ns")

    def __init__(self, rec, lane_acts, t0_ns):
        self.rec = rec
        self.lane_acts = lane_acts
        self.t0_ns = t0_ns


class ContinuousBatchingScheduler:
    # page-pressure evictions per request before the scheduler stops
    # requeueing it and finishes it "cache_full": bounds wasted recompute
    # and keeps run()'s termination argument simple
    max_preemptions = 3

    def __init__(self, engine, overlap=None, on_token=None,
                 on_finish=None):
        self.engine = engine
        # overlap=None reads PADDLE_TPU_SERVE_OVERLAP (default on), as the
        # JAX package's scheduler does
        if overlap is None:
            overlap = os.environ.get("PADDLE_TPU_SERVE_OVERLAP",
                                     "1") != "0"
        self.overlap = bool(overlap)
        self._inflight: Optional[_Inflight] = None
        self._drained_n = 0            # tokens consumed by implicit drains
                                       # (page pressure, cancel) since
                                       # step() last collected them
        # wall time with NO step launched and unconsumed: the windows
        # where the host can starve the card
        self.host_gap_seconds = 0.0
        self._outstanding = 0          # launched, unconsumed steps
        self._last_fetch_ns = None
        self._last_step_end_ns = None
        self._on_token = on_token
        self._on_finish = on_finish
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
        self.decode_steps_total = 0      # batched decode steps consumed
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
        self._record(RequestResult(
            rid=act.req.rid, tokens=np.asarray(act.generated, np.int32),
            finish_reason=reason, ttft=ttft, tpot=tpot,
            queue_wait=act.queue_wait,
            prefix_hit_tokens=act.prefix_hit_tokens,
            preemptions=self._preempt_count.pop(act.req.rid, 0),
            spec_proposed=act.spec_proposed,
            spec_accepted=act.spec_accepted))

    def _record(self, res: RequestResult):
        self.finished[res.rid] = res
        if self._on_finish is not None:
            self._on_finish(res)

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

    def _notify_tokens(self, rid, toks):
        if self._on_token is not None and toks:
            self._on_token(rid, [int(t) for t in toks])

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
            self._notify_tokens(req.rid, act.generated[-1:])
            self._check_finished(idx)
        return n

    def prefill_once(self) -> int:
        """Advance every admitting slot by ONE chunk (the chunked-prefill
        interleave).  A chunk that cannot map pages first drains the
        in-flight step (its retirements may free pages, and a victim
        must never carry an unconsumed step), then evicts the
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
                    if self._drain_inflight():
                        continue
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
                self._notify_tokens(act.req.rid, act.generated[-1:])
                self._check_finished(idx)
        return n

    # -- decode ------------------------------------------------------------

    def _active_mask(self):
        return [a is not None and a.prefill_task is None
                for a in self.slots]

    def _dispatch_decode(self) -> Optional[_Inflight]:
        """Launch ONE batched decode (or speculative verify) step over the
        active, fully prefilled slots, without consuming it.  With a step
        in flight, its device-side tokens feed this one
        (:class:`~.engine.ThreadedTokens`); lanes that joined since
        (fresh prefills) feed their host-known first token.  Page
        pressure drains the in-flight step FIRST, then evicts
        refcount-aware.  Returns the in-flight record, or None when
        nothing is active."""
        spec_k = int(self.engine.spec_k)
        active = self._active_mask()
        if not any(active):
            return None
        if self.engine.paged:
            # every append (spec_k + 1 a slot for a verify step) needs a
            # mapped private page; while a verify step is unconsumed the
            # engine's mirror lags its data-dependent advance, so map for
            # both steps' worst case (a decode step's mirror advanced at
            # launch)
            while True:
                slack = (spec_k + 1
                         if spec_k and self._inflight is not None else 0)
                blocked = self.engine.ensure_decode_ready(
                    active, steps=spec_k + 1 + slack)
                if blocked is None:
                    break
                if not self._drain_inflight():
                    self._evict_for_pages(blocked)
                active = self._active_mask()
                if not any(active):
                    return None
        S = self.engine.num_slots
        tokens = np.zeros((S,), np.int32)
        fresh = np.zeros((S,), bool)
        temps = np.ones((S,), np.float32)
        top_ks = np.zeros((S,), np.int32)
        top_ps = np.ones((S,), np.float32)
        drafts = np.zeros((S, spec_k), np.int32)
        prev = self._inflight
        if prev is not None and prev.rec.consumed:
            prev = None
        for i, act in enumerate(self.slots):
            if not active[i]:
                continue
            if (prev is None or not prev.rec.active[i]
                    or prev.lane_acts[i] is not act):
                # no step in flight holds this lane's next token: feed the
                # host-known last one (first launch, a fresh prefill, a
                # drained pipeline)
                tokens[i] = act.generated[-1]
                fresh[i] = True
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
        tok_in = (ThreadedTokens(prev.rec, fresh, tokens)
                  if prev is not None and not fresh.all() else tokens)
        # with nothing in flight, the whole window since the last fetch
        # starved the device (the sync loop pays it every step)
        t0_ns = time.perf_counter_ns()
        if self._outstanding == 0 and self._last_fetch_ns is not None:
            self.host_gap_seconds += (t0_ns - self._last_fetch_ns) * 1e-9
        if spec_k:
            rec = self.engine.decode_spec_submit(
                tok_in, drafts, active, temps, top_ks, top_ps,
                pages_ready=True)
        else:
            rec = self.engine.decode_submit(tok_in, active, temps, top_ks,
                                            top_ps, pages_ready=True)
        self._outstanding += 1
        return _Inflight(rec, [self.slots[i] if active[i] else None
                               for i in range(S)], t0_ns)

    def _consume_inflight(self, infl: _Inflight) -> int:
        """Consume one launched step: fetch its tokens (the iteration's
        one wait, for this step's own outputs) and do the host-side
        bookkeeping — extend token lists, cut at EOS and budget, retire
        finished slots, stream.  A lane is credited ONLY if the same
        request still occupies it; the token a stale launch computed for
        a since-retired slot is dropped here, and ``free_slot`` already
        reclaimed its rows."""
        rec = infl.rec
        spec_k = self.engine.spec_k if rec.kind == "spec" else 0
        if rec.kind == "spec":
            emitted, counts, _logits = self.engine.decode_spec_fetch(rec)
        else:
            next_tok, _logits = self.engine.decode_fetch(rec)
        t1_ns = time.perf_counter_ns()
        self._outstanding -= 1
        self._last_fetch_ns = t1_ns
        self.decode_steps_total += 1
        # the step interval, clipped at the previous consume so that
        # overlapped steps never charge one stretch of wall time twice
        # (per-request decode_s sums to the drain's wall time, not 2x)
        t0_ns = (infl.t0_ns if self._last_step_end_ns is None
                 else max(infl.t0_ns, self._last_step_end_ns))
        self._last_step_end_ns = t1_ns
        step_s = (t1_ns - t0_ns) * 1e-9
        t1 = t1_ns * 1e-9
        n = 0
        for i, act in enumerate(self.slots):
            if (not rec.active[i] or act is None
                    or infl.lane_acts[i] is not act):
                continue               # retired/preempted/cancelled since
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
            act.last_t = t1
            n += len(emit)
            self._notify_tokens(act.req.rid, emit)
            self._check_finished(i)
        return n

    def _drain_inflight(self) -> bool:
        """Consume the in-flight step now, if any (page pressure, a
        cancel, a caller needing consistent host state).  Tokens it
        credited land in ``self._drained_n`` for step() to collect;
        returns whether a step was drained."""
        infl = self._inflight
        self._inflight = None
        if infl is None or infl.rec.consumed:
            return False
        self._drained_n += self._consume_inflight(infl)
        return True

    def decode_once(self) -> int:
        """One SYNCHRONOUS batched decode (or verify) iteration over the
        active slots: launch, then consume at once (the ``overlap=False``
        loop, and the direct caller's API).  A leftover overlapped step
        is drained first; returns the tokens THIS iteration appended."""
        self._drain_inflight()
        infl = self._dispatch_decode()
        if infl is None:
            return 0
        return self._consume_inflight(infl)

    def step(self) -> int:
        """One iteration: admit into free slots, advance every admitting
        slot by one prefill chunk, then one batched decode.  Overlapped
        (the default): launch step t BEFORE consuming step t-1, so the
        host bookkeeping overlaps the card's work on step t.  Returns the
        decode tokens produced (first tokens excluded)."""
        self._drained_n = 0
        self.admit()
        self.prefill_once()
        if self.overlap:
            prev = self._inflight
            self._inflight = self._dispatch_decode()   # threads prev's
            n = 0
            if prev is not None and not prev.rec.consumed:
                n = self._consume_inflight(prev)
        else:
            n = self.decode_once()
        n += self._drained_n
        self._drained_n = 0
        if self._inflight is None and not self.has_work():
            # idle with no backlog: the wait for the next request is
            # arrival time, not host work
            self._last_fetch_ns = None
        return n

    def has_work(self) -> bool:
        """Waiting requests, occupied slots, or an unconsumed step."""
        return bool(self.waiting or any(a is not None for a in self.slots)
                    or self._inflight is not None)

    def run(self) -> Dict[int, RequestResult]:
        """Drive to completion; returns {rid: RequestResult}.  Always
        terminates: each iteration admits, advances every admitting
        prompt by a chunk (evicting on page pressure rather than
        blocking) and appends a token to every credited decoding request,
        each of which is finite; a request is requeued at most
        ``max_preemptions`` times, and a sole occupant the pool cannot
        hold is finished, never requeued.  The overlapped loop adds one
        tail iteration that only consumes the last step in flight."""
        while self.has_work():
            self.step()
        return self.finished

    def cancel(self, rid: int) -> bool:
        """Abort a request (a client that went away): free its slot AND
        its pages at once (refcount-exact: a shared prefix page only
        drops a reference), or remove it from the waiting queue or the
        preemption parking.  The tokens generated so far ride its
        ``"cancelled"`` :class:`RequestResult`.  Returns False when the
        rid is unknown or already finished.  Runs on the scheduler's
        thread.  (The JAX package's branch for a request whose pages are
        being fetched back from the host tier waits for that tier,
        ROADMAP.md §A6.)"""
        if rid in self.finished:
            return False
        # a step in flight may hold a lane of this request: drain first,
        # so the consume's identity check stays meaningful
        self._drain_inflight()
        if rid in self.finished:       # the drain itself retired it
            return True
        for idx, act in enumerate(self.slots):
            if act is not None and act.req.rid == rid:
                self._finish(idx, "cancelled")
                return True
        for req in list(self.waiting):
            if req.rid != rid:
                continue
            self.waiting.remove(req)
            parked = self._preempted.pop(rid, None)
            self._submit_t.pop(rid, None)
            preemptions = self._preempt_count.pop(rid, 0)
            if parked is None:
                res = RequestResult(rid=rid, tokens=np.zeros((0,), np.int32),
                                    finish_reason="cancelled", ttft=0.0,
                                    tpot=0.0)
            else:
                res = RequestResult(
                    rid=rid, tokens=np.asarray(parked.generated, np.int32),
                    finish_reason="cancelled",
                    ttft=((parked.first_tok_t - parked.submit_t)
                          if parked.first_tok_t is not None else 0.0),
                    tpot=((parked.decode_s / parked.decode_steps)
                          if parked.decode_steps else 0.0),
                    queue_wait=parked.queue_wait,
                    prefix_hit_tokens=parked.prefix_hit_tokens,
                    preemptions=preemptions)
            self._record(res)
            return True
        return False
