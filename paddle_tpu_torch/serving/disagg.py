"""Disaggregated prefill/decode serving (port of
``paddle_tpu/serving/disagg.py``).

Chunked prefill bounds how long one admission can stall running
requests, but prefill work still time-shares the decode engine.  Role
separation hands finished KV from a dedicated prefill engine to a decode
engine, so TTFT scales with prefill capacity while the decode steps stay
unbroken by prompt chunks:

* The **prefill engine** (its own :class:`~.engine.DecodeEngine`) runs
  the chunked prefill into its OWN paged pool and samples the first
  token: TTFT is prefill-complete, as on the colocated engine.
* The request's mapped pages then move to the **decode engine**:
  ``export_pages`` gathers them into the prefill engine's transfer
  buffer and ``import_pages`` scatters them into freshly allocated pages
  of the decode pool, ``handoff_pages`` pages a chunk, one chunk an
  iteration, between decode steps.  On one card the transfer is a device
  copy queued behind the step in flight.  The **host-staging transport**
  (``via_host=True`` or ``PADDLE_TPU_HANDOFF_HOST=1``) round-trips each
  chunk through a ``.npz`` on the host (:func:`~.kv_tier.npz_roundtrip`),
  the stand-in for engines in separate processes and the home of the
  ``serve.handoff`` site's ``TornFile``.

**Routing.**  Admission is strict FIFO: the queue head goes to the
prefill engine unless the DECODE pool's prefix cache already covers the
whole prompt (n - 1 tokens): then it admits decode-side in one 1-token
chunk, skipping prefill and transfer.  The prompt is registered in the
decode pool's prefix cache when its handoff completes, so repeated
prompts stop paying the transfer; the prefill pool keeps its own
registration, so repeated prompts also prefill in fewer chunks.

**Failures and pressure.**  A failed handoff chunk (an injected
``SocketReset`` or ``TornFile`` at ``serve.handoff``, or a real
transport error) frees the request's pages on both pools refcount-exactly
and requeues it at the queue front for recompute.  Decode-pool pressure
in the middle of a handoff picks victims as the colocated scheduler does
(refcount-aware, requeued at the front, capped by ``max_preemptions``),
and prefill-pool pressure preempts prefill-side slots the same way.  A
wedged transfer trips the ``serve.handoff`` liveness beacon.

**Parity.**  Greedy output equals the colocated engine's: the chunks run
the same code, the transfer copies page bytes exactly (int8 and fp8
codes and their scales included), and each slot's decode does not depend
on the batch.  On a card each engine captures its own graphs (the
prefill engine its chunk, the decode engine its step and chunk, for the
decode-side full-prefix-hit admissions).
"""
from __future__ import annotations

import os
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from ..observability import liveness as _liveness
from ..observability import registry as _metrics
from ..observability import tracing as _tracing
from ..robustness.faultpoints import declare as _declare, faultpoint
from .engine import PrefillTask
from .kv_tier import TRANSPORT_ERRORS, npz_roundtrip
from .pages import PagePoolExhausted
from .scheduler import ContinuousBatchingScheduler

__all__ = ["DisaggScheduler", "HandoffTask", "HANDOFF_SITE"]

#: chaos site on each handoff chunk's transfer: a SocketReset (device
#: path) or TornFile (host staging: ctx carries the spill file's
#: ``path``) tears the transport; the scheduler must requeue the request
HANDOFF_SITE = _declare(
    "serve.handoff",
    "fires once per disaggregated KV handoff chunk (device path: before "
    "the export dispatch; host-staging path: between spill write and "
    "read-back, ctx['path'] = the spill file, so TornFile models a torn "
    "transport)")

#: liveness beacon over one handoff chunk's transfer
_liveness.declare_beacon(
    "serve.handoff",
    "one disaggregated KV handoff chunk (export -> stage -> import), "
    "interleaved between decode steps", deadline=600.0)


class HandoffTask:
    """One KV page handoff in progress: the request finished prefill on
    the prefill engine and its pages are moving, chunk by chunk, into the
    decode pool.  ``dst_slot`` is None while the task waits in the
    bounded handoff queue for a free decode slot."""

    __slots__ = ("act", "ids", "src_slot", "dst_slot", "pages",
                 "n_pages", "pos", "bytes", "span")

    def __init__(self, act, ids, src_slot, pages):
        self.act = act
        self.ids = np.asarray(ids, np.int32)
        self.src_slot = int(src_slot)
        self.dst_slot: Optional[int] = None
        self.pages: List[int] = list(pages)   # prefill-pool page ids,
        self.n_pages = len(self.pages)        # page-table order
        self.pos = 0                          # pages transferred
        self.bytes = 0
        self.span = None                      # "handoff" request span


class DisaggScheduler(ContinuousBatchingScheduler):
    """Role-split continuous batching: ``engine`` decodes,
    ``prefill_engine`` prefills, and finished KV hands off between their
    pools.  Everything else (the overlapped decode loop, refcount-aware
    eviction, recompute preemption, tracing, the streaming hooks) is the
    base scheduler's, so the decode role behaves as the colocated engine
    once a request's pages have landed."""

    def __init__(self, engine, prefill_engine, handoff_limit=4,
                 via_host=None, tracer=None, overlap=None, on_token=None,
                 on_finish=None):
        if prefill_engine is engine:
            raise ValueError("disaggregated serving needs TWO engines "
                             "(prefill_engine is the decode engine)")
        for e, role in ((engine, "decode"), (prefill_engine, "prefill")):
            if getattr(e, "tp", 1) > 1:
                raise ValueError(
                    "disaggregated serving with a tensor-parallel %s "
                    "engine (tp=%d) is not supported: the pair runs in "
                    "one process, and the engine's other ranks would "
                    "never step (ROADMAP.md §A5)" % (role, e.tp))
            if not e.paged:
                raise ValueError("%s engine must be paged (the slotted "
                                 "layout has no page pool to hand off)"
                                 % role)
        if prefill_engine.spec_k:
            raise ValueError("the prefill engine never decodes — build "
                             "it with spec_k=0")
        for attr in ("page_size", "max_len", "handoff_pages",
                     "kv_dtype", "_cache_dtype", "_layers", "_heads",
                     "_head_dim"):
            a, b = getattr(prefill_engine, attr), getattr(engine, attr)
            if a != b:
                raise ValueError(
                    "prefill/decode engine geometry differs on %s: "
                    "%r vs %r (pages are copied byte-wise between the "
                    "pools)" % (attr.lstrip("_"), a, b))
        super().__init__(engine, tracer=tracer, overlap=overlap,
                         on_token=on_token, on_finish=on_finish)
        self.prefill_engine = prefill_engine
        self.handoff_limit = int(handoff_limit)
        if self.handoff_limit < 1:
            raise ValueError("handoff_limit must be >= 1")
        if via_host is None:
            via_host = os.environ.get("PADDLE_TPU_HANDOFF_HOST",
                                      "0") == "1"
        self.via_host = bool(via_host)
        self.pslots: List[Optional[object]] = \
            [None] * prefill_engine.num_slots
        self._ready: deque = deque()          # HandoffTasks, bounded
        self._handoffs: Dict[int, HandoffTask] = {}   # dst_slot -> task
        self._blocked_stamp = None            # admit()'s block memo
        # handoff accounting
        self.handoff_bytes_total = 0
        self.handoffs_total = 0
        self.handoff_chunks_total = 0
        # role accounting: every decode-side chunk must be a one-chunk
        # full-prefix-hit admission; prefill work runs on the prefill
        # engine only
        self.decode_route_admissions = 0
        self.decode_side_chunks = 0
        self.prefill_side_chunks = 0
        self._m_ho_bytes = _metrics.counter("serving.handoff_bytes")
        self._m_ho_secs = _metrics.histogram("serving.handoff_seconds")
        self._m_ho_depth = _metrics.gauge("serving.handoff_queue_depth")
        self._ho_beacon = _liveness.beacon("serve.handoff")

    # -- state -------------------------------------------------------------

    @property
    def handoff_depth(self) -> int:
        """Requests queued for or in the middle of a transfer."""
        return len(self._ready) + len(self._handoffs)

    def has_work(self) -> bool:
        return (super().has_work()
                or any(a is not None for a in self.pslots)
                or bool(self._ready))

    def _set_depth(self):
        self._m_ho_depth.set(self.handoff_depth)

    # -- admission routing -------------------------------------------------

    def _decode_covers(self, ids) -> bool:
        """True when the DECODE pool's prefix cache covers the whole
        prompt (n - 1 tokens after the cap)."""
        _pages, covered = self.engine._alloc.lookup_prefix(ids)
        return covered >= int(np.asarray(ids).size) - 1

    def _free_decode_slot(self) -> Optional[int]:
        for idx, a in enumerate(self.slots):
            if a is None:
                return idx
        return None

    def admit(self) -> int:
        """Strict-FIFO admission with role routing: the queue head goes to
        the prefill engine unless the decode pool's prefix cache covers
        it whole (then it admits decode-side).  A head whose route has no
        free slot blocks the queue: FIFO order never bends around
        capacity."""
        n = 0
        while self.waiting:
            idx = self._free_decode_slot()
            pidx = next((i for i, a in enumerate(self.pslots)
                         if a is None), None)
            if idx is None and pidx is None:
                break
            req = self.waiting[0]
            parked = self._preempted.get(req.rid)
            ids = req.prompt
            if parked is not None and parked.generated:
                ids = np.concatenate(
                    [ids, np.asarray(parked.generated, np.int32)])
            # the same head blocked last iteration with the same free
            # routes and the same decode-side prefix state: the coverage
            # lookup (O(prompt) hashing) would repeat its answer
            stamp = (req.rid, int(np.asarray(ids).size), idx is None,
                     pidx is None, self.handoffs_total,
                     self.decode_route_admissions)
            if stamp == self._blocked_stamp:
                break
            if self._decode_covers(ids):
                if idx is None:
                    self._blocked_stamp = stamp
                    break
                self.waiting.popleft()
                self.decode_route_admissions += 1
                self._admit_paged(idx, req)
            else:
                if pidx is None:
                    self._blocked_stamp = stamp
                    break
                self.waiting.popleft()
                self._admit_paged(pidx, req, engine=self.prefill_engine,
                                  slots=self.pslots)
            self._blocked_stamp = None
            n += 1
        if n:
            self._m_queue_depth.set(len(self.waiting))
            self._m_occupancy.set(sum(a is not None for a in self.slots))
        return n

    # -- prefill side ------------------------------------------------------

    def prefill_once(self) -> int:
        n = super().prefill_once()      # decode-side tasks (full hits)
        self.decode_side_chunks += n
        pn = self._prefill_side_once()
        self.prefill_side_chunks += pn
        self._handoff_advance()
        return n + pn

    def _evict_prefill_pages(self, requester_pidx: int) -> str:
        """Prefill-pool pressure: preempt the prefill-side slot with the
        most unshared pages (not the requester), requeued at the front.
        Returns ``"retry"`` (pages were freed), ``"wait"`` (the other
        occupants are mid-handoff: their pages free when the transfers
        land) or ``"retired"`` (the requester was the last occupant and
        cannot fit alone: finished cache_full)."""
        candidates = [i for i, a in enumerate(self.pslots)
                      if a is not None and i != requester_pidx
                      and isinstance(a.prefill_task, PrefillTask)]
        if not candidates:
            if any(a is not None for i, a in enumerate(self.pslots)
                   if i != requester_pidx):
                return "wait"
            self._finish_pslot(requester_pidx, "cache_full")
            return "retired"
        victim = max(candidates,
                     key=lambda i: (
                         self.prefill_engine.unshared_pages(i),
                         -self.pslots[i].admit_order))
        act = self.pslots[victim]
        rid = act.req.rid
        cnt = self._preempt_count.get(rid, 0) + 1
        self._preempt_count[rid] = cnt
        if cnt > self.max_preemptions:
            self._finish_pslot(victim, "cache_full")
            return "retry"
        self.pslots[victim] = None
        self.prefill_engine.free_slot(victim)
        act.prefill_task = None
        self._requeue_front(act, "preempted", slot=victim)
        return "retry"

    def _requeue_front(self, act, event, **attrs):
        """Park ``act`` and put its request back at the FRONT of the
        waiting queue (a preemption or a torn handoff: recompute)."""
        rid = act.req.rid
        self.waiting.appendleft(act.req)
        self._submit_t[rid] = act.submit_t
        self._preempted[rid] = act
        self.preemptions_total += 1
        root = self._req_spans.get(rid, _tracing.NOOP_SPAN)
        root.event(event, **attrs)
        self._wait_spans[rid] = self._tracer.span("requeue", parent=root,
                                                  rework=True)
        self._m_preempt.inc()
        self._m_queue_depth.set(len(self.waiting))

    def _finish_pslot(self, pidx: int, reason: str):
        """Retire a request that never reached the decode engine (EOS or
        budget at its first token, prefill-side cache_full, cancel)."""
        act = self.pslots[pidx]
        self.pslots[pidx] = None
        self.prefill_engine.free_slot(pidx)
        task = act.prefill_task
        act.prefill_task = None
        if isinstance(task, HandoffTask) and task in self._ready:
            self._ready.remove(task)
            self._set_depth()
        self._retire(act, reason)

    def _prefill_side_once(self) -> int:
        """Advance every prefill-engine admission by ONE chunk.  Chunks
        run with ``sync=False``: the final chunk's sampled token is
        polled on later iterations, never waited for, so the prefill
        engine never stalls the decode loop's next launch."""
        n = 0
        pe = self.prefill_engine
        for pidx, act in enumerate(self.pslots):
            if act is None or not isinstance(act.prefill_task,
                                             PrefillTask):
                continue
            task = act.prefill_task
            if task.done:
                # the final chunk ran on an earlier iteration: poll its
                # token, or retry a handoff the full queue refused
                self._after_final_chunk(pidx)
                continue

            def evict(pidx=pidx):
                return self._evict_prefill_pages(pidx) == "retry"

            done = self._run_prefill_chunk(act, task, pe, evict,
                                           sync=False)
            if done is None:
                continue
            n += 1
            if done:
                self._after_final_chunk(pidx)
        return n

    def _after_final_chunk(self, pidx: int):
        """Once the final chunk's sampled token has landed (its copy
        event polled between decode steps, never waited for): emit it
        (TTFT is prefill-complete) and queue the handoff, or retire at
        once when that one token ends the request."""
        act = self.pslots[pidx]
        task = act.prefill_task
        if task.first_token < 0:
            ready = task.first_token_ready
            if ready is not None and not ready.query():
                return              # not landed yet: poll next iteration
            task.first_token = int(task.first_token_dev)
            task.first_token_dev = task.first_token_ready = None
            now = time.perf_counter()
            rid = act.req.rid
            if act.first_tok_t is None:
                self._req_spans.get(rid, _tracing.NOOP_SPAN).event(
                    "first_token")
            act.first_token(task.first_token, now)
            self._notify_tokens(rid, act.generated[-1:])
            req = act.req
            tok = act.generated[-1]
            if (req.eos_token_id is not None
                    and tok == int(req.eos_token_id)):
                self._finish_pslot(pidx, "eos")
                return
            if len(act.generated) >= req.max_new_tokens:
                self._finish_pslot(pidx, "length")
                return
        self._try_queue_handoff(pidx)

    def _try_queue_handoff(self, pidx: int) -> bool:
        """Move a prefill-complete slot into the bounded handoff queue;
        False (the slot stays parked with its pages: backpressure on
        prefill capacity) when the queue is full."""
        if len(self._ready) >= self.handoff_limit:
            return False
        act = self.pslots[pidx]
        task = act.prefill_task
        al = self.prefill_engine._alloc
        pages = [int(p) for p in al.table[pidx][al.mapped[pidx]]]
        ho = HandoffTask(act, task.ids, pidx, pages)
        act.prefill_task = ho
        self._ready.append(ho)
        self._set_depth()
        return True

    # -- the handoff -------------------------------------------------------

    def _handoff_advance(self):
        """Start queued handoffs into free decode slots, then advance each
        handoff in flight by ONE chunk, between decode steps."""
        while self._ready:
            idx = self._free_decode_slot()
            if idx is None:
                break
            task = self._ready.popleft()
            task.dst_slot = idx
            self.slots[idx] = task.act
            self._handoffs[idx] = task
            root = self._req_spans.get(task.act.req.rid,
                                       _tracing.NOOP_SPAN)
            task.span = self._tracer.span("handoff", parent=root,
                                          pages=task.n_pages)
            self._set_depth()
        for idx in list(self._handoffs):
            task = self._handoffs.get(idx)
            if task is None:
                # retired earlier in this loop: a chunk's page-pressure
                # eviction picked this mid-handoff slot as its victim
                continue
            self._handoff_chunk(task)

    def _spill_roundtrip(self, bufs, rid, chunk_idx):
        """The host-staging transport: the host tier's
        :func:`~.kv_tier.npz_roundtrip`, fired through the
        ``serve.handoff`` site with this handoff's rid and chunk."""
        return npz_roundtrip(bufs, HANDOFF_SITE,
                             prefix="paddle_tpu_handoff_",
                             rid=rid, chunk=chunk_idx)

    def _handoff_chunk(self, task: HandoffTask):
        """Move ONE chunk of ``task``'s pages: export on the prefill
        engine, stage across, allocate and map decode pages, import.  A
        transport error (the ``serve.handoff`` site included) aborts the
        handoff and requeues the request at the front; decode-pool
        pressure evicts refcount-aware first."""
        pe, de = self.prefill_engine, self.engine
        rid = task.act.req.rid
        chunk = task.pages[task.pos:task.pos + pe.handoff_pages]
        chunk_idx = task.pos // pe.handoff_pages
        with self._ho_beacon:
            t0 = time.perf_counter()
            try:
                if self.via_host:
                    bufs = self._spill_roundtrip(
                        pe.export_pages(chunk), rid, chunk_idx)
                else:
                    faultpoint(HANDOFF_SITE, rid=rid, chunk=chunk_idx)
                    bufs = pe.export_pages(chunk)
                staged = de.stage_handoff(bufs)
            except TRANSPORT_ERRORS as e:
                self._handoff_abort(task, e)
                return
            dst = self._alloc_dst(task, len(chunk))
            if dst is None:
                return            # the requester retired (cache_full)
            de.import_pages(staged, dst)
            de._m_pool.set(de._alloc.pages_used())
            task.pos += len(chunk)
            moved = pe.handoff_chunk_bytes(len(chunk))
            task.bytes += moved
            self.handoff_bytes_total += moved
            self.handoff_chunks_total += 1
            self._m_ho_bytes.inc(moved)
            self._m_ho_secs.observe(time.perf_counter() - t0)
        if task.pos >= task.n_pages:
            self._handoff_finish(task)

    def _alloc_dst(self, task: HandoffTask, n: int):
        """Allocate and map ``n`` fresh decode-pool pages for the chunk,
        evicting decode-side victims under pressure (the step in flight
        drained first).  None when the handoff itself was retired."""
        de = self.engine
        while True:
            ids, failed = [], False
            try:
                for _ in range(n):
                    ids.append(de._alloc.alloc())
            except PagePoolExhausted:
                failed = True
            if not failed:
                break
            for pid in ids:
                de._alloc._release(pid)
            if self._drain_inflight():
                continue
            if not self._evict_for_pages(task.dst_slot):
                return None     # the requester finished cache_full
            if task.dst_slot not in self._handoffs:
                return None     # the eviction retired the task
        for i, pid in enumerate(ids):
            de._alloc.map(task.dst_slot, task.pos + i, pid)
        return ids

    def _handoff_finish(self, task: HandoffTask):
        """All pages landed: set the decode side's length, register the
        prompt in the decode pool's prefix cache (later identical prompts
        skip prefill and transfer), release the prefill-side slot and
        activate the decode slot."""
        de, act = self.engine, task.act
        n = int(task.ids.size)
        de._set_length(task.dst_slot, n)
        act.cache_len = n
        de._alloc.register_prefix(task.dst_slot, task.ids)
        self._handoffs.pop(task.dst_slot, None)
        act.prefill_task = None
        self.pslots[task.src_slot] = None
        self.prefill_engine.free_slot(task.src_slot)
        if task.span is not None:
            task.span.end(bytes=task.bytes, pages=task.pos)
            task.span = None
        self.handoffs_total += 1
        self._set_depth()
        self._check_finished(task.dst_slot)

    def _handoff_abort(self, task: HandoffTask, exc):
        """A chunk's transport failed: free BOTH pools refcount-exactly
        and requeue the request at the front for recompute (the
        ``max_preemptions`` cap bounds a transport that keeps tearing:
        then it finishes "cache_full")."""
        act = task.act
        rid = act.req.rid
        if task.dst_slot is not None:
            self._handoffs.pop(task.dst_slot, None)
            self.slots[task.dst_slot] = None
            self.engine.free_slot(task.dst_slot)
        self.pslots[task.src_slot] = None
        self.prefill_engine.free_slot(task.src_slot)
        act.prefill_task = None
        if task.span is not None:
            task.span.end(aborted=True, error=type(exc).__name__)
            task.span = None
        self._set_depth()
        cnt = self._preempt_count.get(rid, 0) + 1
        self._preempt_count[rid] = cnt
        if cnt > self.max_preemptions:
            self._retire(act, "cache_full")
            return
        self._requeue_front(act, "handoff_aborted",
                            error=type(exc).__name__)

    # -- lifecycle (a decode slot may be mid-handoff) ----------------------

    def _release_handoff_src(self, idx: int):
        task = self._handoffs.pop(idx, None)
        if task is None:
            return
        self.pslots[task.src_slot] = None
        self.prefill_engine.free_slot(task.src_slot)
        if task.span is not None:
            task.span.end(aborted=True)
            task.span = None
        self._set_depth()

    def _finish(self, idx: int, reason: str):
        self._release_handoff_src(idx)
        super()._finish(idx, reason)

    def _preempt(self, idx: int):
        self._release_handoff_src(idx)
        super()._preempt(idx)

    def cancel(self, rid: int) -> bool:
        if rid in self.finished:
            return False
        for pidx, act in enumerate(self.pslots):
            if act is None or act.req.rid != rid:
                continue
            task = act.prefill_task
            if isinstance(task, HandoffTask) and task.dst_slot is not None:
                break           # mid-transfer: the decode slot's cancel
                                # below cleans both sides (_finish)
            self._finish_pslot(pidx, "cancelled")
            return True
        return super().cancel(rid)
