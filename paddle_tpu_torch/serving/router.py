"""The replicated serving fleet (port of ``paddle_tpu/serving/router.py``):
a router over N data-parallel scheduler and engine replicas.

One admission point in front of N independent
:class:`~.scheduler.ContinuousBatchingScheduler` +
:class:`~.engine.DecodeEngine` pairs, each driven by its own thread
("serve-replica-<i>", the in-process stand-in for one serving process;
:class:`RemoteReplicaHandle` is the routing view of a replica in another
process).

**Routing ladder.**  Admission tries, in order:

1. *Prefix affinity* — the prompt's chained page digests
   (:func:`~.pages.prompt_digest_chain`) against each replica's
   advertised digest view (device hash table, host tier and cluster
   index, refreshed by the health probe).  The replica covering the
   longest prefix wins; ties go to the less loaded.  A view older than
   ``snapshot_ttl`` makes no claim.
2. *Least-loaded* — over replicas with a fresh snapshot (queue depth +
   active slots + command backlog) whose step beacon is not aging past
   ``route_around_after``: a stalling replica is routed around before it
   is declared dead.
3. *Round-robin* — with no fresh telemetry at all (cold start).

**Failover.**  A replica's death (the ``serve.replica`` faultpoint firing
``HardExit``, contained to its thread by ``crash_scope``, or ``Hang``; or
the probe tripping on the beacon's age) drains its requests back through
the router.  The router's own record of each request (the request, the
tokens delivered, timing, the trace lane; appended before each token is
forwarded, on the same thread, so the record equals what the stream saw)
is the source of truth: a crashed scheduler exports nothing.  Each record
becomes a :class:`~.scheduler.RequeueState` requeued onto a survivor
through the recompute-preemption path: the survivor re-prefills ``prompt
+ generated``, the stream resumes at the next token, and greedy output
equals an undisturbed run's.  ``max_requeues`` bounds the requeues (shared
with page-pressure evictions); past it the request finishes
``"failover_limit"``, a delivered finish, never a silent drop.  The dead
replica respawns (the delay doubles each death within
``healthy_interval`` of uptime and resets after a healthy run) and
rejoins the routable set after a healthy interval.  A respawn reuses the
replica's engine (``engine.reset()``, which first waits for a step left
in flight), so its captured graphs survive: captures per engine do not
change across a failover.

**On a card.**  :meth:`Router.start` captures every replica's step and
chunk graphs on the caller's thread before any replica thread exists,
then seals capturing (:func:`~.graphs.seal`) until :meth:`Router.stop`: a
capture a replica thread asks for raises instead of running under the
other threads.  Each replica thread makes its engine's card current.
Replays of several engines and their copies out of the shared graph pool
are serialized by :data:`~.graphs.REPLAY_LOCK`.

Token delivery cannot tear: the faultpoint fires BETWEEN scheduler
iterations, and within one iteration a token's notification and the
request's finish both happen inside ``step()``.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..observability import flight as _flight
from ..observability import registry as _metrics
from ..observability import tracing as _tracing
from ..robustness import faultpoints as _fp
from . import graphs as _graphs
from .kv_tier import _hex, fetch_index
from .pages import prompt_digest_chain
from .scheduler import (ContinuousBatchingScheduler, Request,
                        RequestResult, RequeueState)

__all__ = ["Router", "RemoteReplicaHandle", "NoHealthyReplicas",
           "REPLICA_SITE"]

#: chaos site inside every replica step-loop iteration: ``HardExit``
#: here is a replica crash (contained to the replica thread by the
#: faultpoints crash scope), ``Hang`` a wedged replica the health
#: probe trips on — both end in stream-preserving failover
REPLICA_SITE = _fp.declare(
    "serve.replica",
    "fires at the top of every router-tier replica step-loop iteration "
    "(HardExit = replica crash, contained to its thread by the crash "
    "scope; Hang = wedged replica for the health probe) — either way "
    "the router fails the replica's streams over to survivors")

_SNAP_FORMAT = "paddle_tpu-telemetry-v1"


class NoHealthyReplicas(RuntimeError):
    """Every replica is dead or still (re)joining — admission must shed
    (the front-end maps this to 503), it cannot queue onto nothing."""


class _Flight:
    """Router-side record of ONE accepted request — the failover source
    of truth.  ``tokens`` is appended on the owning replica's scheduler
    thread BEFORE the token callback is forwarded, so it always equals
    exactly what the downstream stream has seen."""

    __slots__ = ("req", "replica", "submit_t", "first_tok_t", "tokens",
                 "requeues", "trace_id", "root_span", "cancelled")

    def __init__(self, req, replica, submit_t, trace_id, root_span):
        self.req = req
        self.replica = replica          # owning replica idx
        self.submit_t = submit_t
        self.first_tok_t = None
        self.tokens: List[int] = []
        self.requeues = 0
        self.trace_id = trace_id
        self.root_span = root_span
        self.cancelled = False


class _Replica:
    """One in-process scheduler+engine replica and the thread that runs it.

    The thread is the replica's *scheduler thread*: the sole caller of
    its scheduler and engine.  Cross-thread intake happens
    through the command queues under ``lock`` (the front-end/router
    enqueue; the loop drains) — the disagg/front-end discipline one
    level up.  ``epoch`` guards zombies: a Hang-wedged thread that
    finally wakes after the probe declared it dead (and possibly
    respawned the replica) sees a bumped epoch and exits without
    touching the replacement scheduler."""

    def __init__(self, idx: int, engine, router: "Router"):
        self.idx = idx
        self.engine = engine
        self._router = router
        self.scheduler: Optional[ContinuousBatchingScheduler] = None
        self.thread: Optional[threading.Thread] = None
        self.lock = threading.Lock()
        self.wake = threading.Event()
        self._pending: List[Tuple[Request, tuple]] = []
        self._transfers: List[RequeueState] = []
        self._cancels: List[int] = []
        self.retiring = False           # graceful decommission flag
        self.stopping = False           # router shutdown flag
        # lifecycle (all guarded by the ROUTER lock): healthy | joining
        # | dead | stopped
        self.state = "joining"
        self.epoch = 0
        self.deaths = 0
        self.backoff = 0.0
        self.respawn_at: Optional[float] = None
        self.started_t = 0.0
        # progress + advisory views the probe refreshes (router lock)
        self.last_progress = 0.0
        self.steps_total = 0
        self.busy = False
        self.snap: Optional[dict] = None
        self.snap_ts: Optional[float] = None
        self.view_digests: Set[str] = set()
        self.view_ts: Optional[float] = None

    # -- cross-thread intake (any thread) ----------------------------------

    def enqueue_submit(self, req: Request, trace: tuple):
        with self.lock:
            self._pending.append((req, trace))
        self.wake.set()

    def enqueue_transfer(self, state: RequeueState):
        with self.lock:
            self._transfers.append(state)
        self.wake.set()

    def enqueue_cancel(self, rid: int):
        with self.lock:
            self._cancels.append(rid)
        self.wake.set()

    def backlog(self) -> int:
        with self.lock:
            return len(self._pending) + len(self._transfers)

    def clear_queues(self):
        with self.lock:
            self._pending, self._transfers, self._cancels = [], [], []

    # -- the replica thread ------------------------------------------------

    def _run(self, epoch: int):
        try:
            with _fp.crash_scope():
                self._loop(epoch)
        except _fp.CrashScopeExit as e:
            # the simulated process death: die like the process would —
            # report and stop, taking nothing else down
            self._router._replica_died(self, "crash", rc=e.rc)
        except BaseException as e:  # noqa: BLE001 — replica = process
            _flight.thread_exception_dump(
                "serve-replica-%d" % self.idx, e)
            self._router._replica_died(self, "error")

    def _loop(self, epoch: int):
        sched = self.scheduler
        if self.engine.device.type == "cuda":
            # torch's current device is per thread
            torch.cuda.set_device(self.engine.cache.lengths.device)
        while True:
            # the chaos site sits BETWEEN iterations: a Hang here wedges
            # the replica with the scheduler in a consistent state, so
            # the probe-tripped failover never races a half-applied step
            _fp.faultpoint(REPLICA_SITE, replica=self.idx,
                           scheduler=sched)
            if self.epoch != epoch or self.stopping:
                return              # declared dead (zombie) or shutdown
            with self.lock:
                pending, self._pending = self._pending, []
                transfers, self._transfers = self._transfers, []
                cancels, self._cancels = self._cancels, []
                self.wake.clear()
            for req, trace in pending:
                try:
                    sched.submit(req, trace=trace)
                except ValueError:
                    # the router pre-validates; a late mismatch (engine
                    # hot-swapped under a respawn) degrades to an error
                    # finish, never a dead replica thread
                    self._router._finish_flight(req.rid, "error")
            for state in transfers:
                sched.import_requeue(state)
            for rid in cancels:
                sched.cancel(rid)
            if self.retiring:
                # graceful decommission: commands above were drained
                # INTO the scheduler first so the export covers them
                states = sched.export_requeue_state()
                self._router._decommissioned(self, states)
                return
            if sched.has_work():
                sched.step()
                self.steps_total += 1
            else:
                self.wake.wait(0.005)
            self.busy = sched.has_work()
            self.last_progress = time.monotonic()


class RemoteReplicaHandle:
    """A replica in ANOTHER process or host, seen through the TCP store:
    its routing views are real — :meth:`refresh` reads the documents the
    fleet publishes (``kv_tier.fetch_index`` digests, the
    :mod:`..observability.aggregate` telemetry snapshots) — but its
    intake needs a cross-host request transport that neither package
    has, so every enqueue raises :class:`NotImplementedError`, as in the
    JAX package."""

    state = "remote"

    def __init__(self, host: int, store, world_size: int):
        self.idx = int(host)
        self.store = store
        self.world_size = int(world_size)
        self.snap: Optional[dict] = None
        self.snap_ts: Optional[float] = None
        self.view_digests: Set[str] = set()
        self.view_ts: Optional[float] = None

    def refresh(self, now: Optional[float] = None):
        """Pull this host's published digest set and telemetry snapshot
        from the store; missing/garbage documents leave the views stale
        (the router then routes around, exactly as for a silent local
        replica)."""
        from ..observability import aggregate as _agg
        now = time.monotonic() if now is None else now
        idx = fetch_index(self.store, self.world_size)
        if self.idx in idx:
            self.view_digests = idx[self.idx]
            self.view_ts = now
        docs, _missing = _agg.fetch_cluster(self.store, self.world_size)
        if self.idx in docs:
            self.snap = docs[self.idx]
            self.snap_ts = now

    def enqueue_submit(self, req, trace):
        raise NotImplementedError(
            "cross-host request intake is not implemented (in either "
            "package); RemoteReplicaHandle is a routing view only")

    enqueue_transfer = enqueue_cancel = enqueue_submit


class Router:
    """N-replica admission tier: prefix-affinity routing, health-driven
    fallback, stream-preserving failover (module docstring has the
    protocol).  Thread model — four roles:

    * *callers* (``submit``/``cancel``, any thread incl. the
      front-end's event loop): pure-CPU hashing + lock-scoped table
      writes, never a scheduler call, never blocking on device work;
    * *replica threads* (one per replica): sole scheduler callers;
      deliver token/finish callbacks through the router's wrappers;
    * the *health probe* ("serve-router-probe", monitor role): view
      refresh, stall tripping, respawn/rejoin — every transition under
      the router lock; ``probe_interval=None`` disables the thread and
      tests drive :meth:`probe_once` deterministically;
    * the *dying replica thread itself* runs crash failover (it owns
      the dying scheduler, so nothing races it).

    Lock discipline: the router lock guards the flight table, replica
    lifecycle and the cached views; each replica's lock guards only its
    command queues.  Neither is ever held while acquiring the other."""

    def __init__(self, engines, tracer=None, overlap=None,
                 on_token=None, on_finish=None, affinity=True,
                 snapshot_ttl=2.0, route_around_after=None,
                 stall_deadline=30.0, probe_interval=0.25,
                 max_requeues=3, respawn_delay=0.1,
                 respawn_max_delay=2.0, healthy_interval=1.0):
        if not engines:
            raise ValueError("Router needs at least one replica engine")
        self.on_token = on_token        # (rid, [ids]) — post-record
        self.on_finish = on_finish      # (RequestResult)
        self.affinity = bool(affinity)
        self.snapshot_ttl = float(snapshot_ttl)
        self.route_around_after = (float(stall_deadline) / 2.0
                                   if route_around_after is None
                                   else float(route_around_after))
        self.stall_deadline = float(stall_deadline)
        self.probe_interval = probe_interval
        self.max_requeues = int(max_requeues)
        self.respawn_delay = float(respawn_delay)
        self.respawn_max_delay = float(respawn_max_delay)
        self.healthy_interval = float(healthy_interval)
        self.prompt_cap = min(int(e.prompt_cap) for e in engines)
        self._paged = all(e.paged for e in engines)
        self._page_size = (min(int(e.page_size) for e in engines)
                           if self._paged else 0)
        self._overlap = overlap
        self._tracer = (tracer if tracer is not None
                        else _tracing.default_tracer())
        self._lock = threading.Lock()
        self._flights: Dict[int, _Flight] = {}
        self._next_rid = 0
        self._rr = 0                    # blackout round-robin cursor
        self._stop = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None
        # metric handles fetched ONCE (no-op singletons when disabled)
        self._m_routed = _metrics.counter("router.routed", ("reason",))
        self._m_healthy = _metrics.gauge("router.replicas_healthy")
        self._m_failovers = _metrics.counter("router.failovers")
        self._replicas = [_Replica(i, e, self)
                          for i, e in enumerate(engines)]
        for r in self._replicas:
            r.scheduler = self._make_scheduler(r)

    # -- wiring ------------------------------------------------------------

    def _make_scheduler(self, replica: _Replica):
        on_token, on_finish = self._make_callbacks(replica)
        return ContinuousBatchingScheduler(
            replica.engine, tracer=self._tracer, overlap=self._overlap,
            on_token=on_token, on_finish=on_finish)

    def _make_callbacks(self, replica: _Replica):
        def on_token(rid, toks):
            with self._lock:
                fl = self._flights.get(rid)
                if fl is None or fl.replica != replica.idx:
                    return          # stale emission of a moved rid
                fl.tokens.extend(int(t) for t in toks)
                if fl.first_tok_t is None:
                    fl.first_tok_t = time.perf_counter()
                cb = self.on_token
            if cb is not None:
                cb(rid, toks)

        def on_finish(result: RequestResult):
            with self._lock:
                fl = self._flights.get(result.rid)
                if fl is None or fl.replica != replica.idx:
                    return
                del self._flights[result.rid]
                cb = self.on_finish
            # the scheduler's _retire already ended the adopted root
            # span — only synthesized finishes end it router-side
            if cb is not None:
                cb(result)

        return on_token, on_finish

    def start(self) -> "Router":
        """Capture every replica engine's graphs on this thread (on a
        card), seal capturing, then start the replica threads and the
        probe."""
        for r in self._replicas:
            r.engine.capture_steps()
        _graphs.seal(self)
        now = time.monotonic()
        for r in self._replicas:
            with self._lock:
                # founding replicas are routable immediately: with no
                # survivor set yet there is nothing safer to prefer
                r.state = "healthy"
                r.started_t = now
                r.last_progress = now
                r.epoch += 1
            t = threading.Thread(target=r._run, args=(r.epoch,),
                                 name="serve-replica-%d" % r.idx,
                                 daemon=True)
            r.thread = t
            t.start()
        self._m_healthy.set(self.healthy_count())
        if self.probe_interval is not None:
            self._probe_thread = threading.Thread(
                target=self._probe_main, name="serve-router-probe",
                daemon=True)
            self._probe_thread.start()
        return self

    def stop(self, timeout: float = 10.0):
        self._stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout)
            self._probe_thread = None
        for r in self._replicas:
            r.stopping = True
            r.wake.set()
        for r in self._replicas:
            if r.thread is not None:
                r.thread.join(timeout)
            with self._lock:
                if r.state not in ("dead",):
                    r.state = "stopped"
        _graphs.unseal(self)
        self._m_healthy.set(0)

    # -- admission ---------------------------------------------------------

    def submit(self, req: Request, on_admit=None) -> int:
        """Route + dispatch one request; returns its fleet-unique rid.

        Validation mirrors ``scheduler.submit`` so a bad request fails
        HERE (the front-end 400s it) instead of on a replica thread.
        ``on_admit(rid, root_span)`` — when given — runs after the rid
        and trace root exist but BEFORE the request reaches a replica:
        the front-end registers its stream inside that window, so the
        first token can never race the registration."""
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if prompt.size > self.prompt_cap:
            raise ValueError(
                "prompt length %d exceeds the fleet's prompt capacity %d"
                % (prompt.size, self.prompt_cap))
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
        req = dataclasses.replace(req, prompt=prompt, rid=rid)
        # the trace lane is born at the ROUTER (not the replica): the
        # root must outlive any one replica for the tree to survive
        # failover; schedulers adopt it via submit(trace=...)
        tid = self._tracer.new_trace()
        root = self._tracer.span(
            "request", trace_id=tid, rid=rid,
            prompt_len=int(prompt.size),
            max_new_tokens=int(req.max_new_tokens))
        fl = _Flight(req, -1, time.perf_counter(), tid, root)
        target = None
        try:
            for _ in range(4):
                target, reason = self._route(prompt)
                with self._lock:
                    if target.state == "healthy":
                        fl.replica = target.idx
                        self._flights[rid] = fl
                        break
                    target = None       # died between route and claim
            if target is None:
                raise NoHealthyReplicas(
                    "no healthy replica to route to")
        except NoHealthyReplicas:
            root.end(reason="no_replica")
            raise
        self._tracer.span("router", trace_id=tid, parent=root,
                          replica=target.idx, reason=reason).end()
        self._m_routed.labels(reason=reason).inc()
        if on_admit is not None:
            on_admit(rid, root)
        target.enqueue_submit(req, (tid, root))
        return rid

    def cancel(self, rid: int) -> bool:
        """Forward a cancel to the owning replica (its thread applies
        it).  A rid mid-failover is flagged so the requeue synthesizes
        the ``"cancelled"`` finish instead of resuming."""
        with self._lock:
            fl = self._flights.get(rid)
            if fl is None:
                return False
            fl.cancelled = True
            target = self._replicas[fl.replica]
        target.enqueue_cancel(rid)
        return True

    # -- the routing ladder ------------------------------------------------

    def _fresh(self, r, now: float) -> bool:
        if r.snap_ts is None or now - r.snap_ts > self.snapshot_ttl:
            return False            # stale/missing snapshot: around it
        age = r.snap.get("beacon_age_s", 0.0)
        busy = r.snap.get("busy") or r.snap.get("backlog")
        return not (busy and age > self.route_around_after)

    @staticmethod
    def _load(r) -> int:
        snap = r.snap or {}
        return (int(snap.get("queue_depth", 0))
                + int(snap.get("slots_active", 0))
                + int(snap.get("backlog", 0)))

    def _route(self, prompt) -> Tuple[_Replica, str]:
        with self._lock:
            routable = [r for r in self._replicas
                        if r.state == "healthy"]
        if not routable:
            raise NoHealthyReplicas(
                "all %d replicas dead or joining" % len(self._replicas))
        now = time.monotonic()
        if self.affinity and self._paged:
            chain = [_hex(d) for d in
                     prompt_digest_chain(prompt, self._page_size)]
            best, best_cov = None, 0
            for r in routable:
                if (r.view_ts is None
                        or now - r.view_ts > self.snapshot_ttl):
                    continue        # stale view makes no affinity claim
                cov = 0
                for h in chain:
                    if h not in r.view_digests:
                        break
                    cov += 1
                if cov > best_cov or (cov == best_cov and cov
                                      and self._load(r)
                                      < self._load(best)):
                    best, best_cov = r, cov
            if best is not None and best_cov > 0:
                return best, "affinity"
        fresh = [r for r in routable if self._fresh(r, now)]
        if fresh:
            return (min(fresh, key=lambda r: (self._load(r), r.idx)),
                    "least_loaded")
        with self._lock:
            r = routable[self._rr % len(routable)]
            self._rr += 1
        return r, "least_loaded"

    # -- failover ----------------------------------------------------------

    def _replica_died(self, replica: _Replica, cause: str, rc=None):
        """Declare a replica dead and fail its streams over.  Runs on
        the dying replica thread (crash — it owns the scheduler, so
        nothing races it) or the probe (stall trip — the zombie is
        fenced by the epoch bump before anything else happens)."""
        now = time.monotonic()
        with self._lock:
            if replica.state in ("dead", "stopped"):
                return              # hang-trip raced the late crash
            replica.state = "dead"
            replica.epoch += 1      # fence any wedged zombie thread
            replica.deaths += 1
            uptime = now - replica.started_t
            if uptime >= self.healthy_interval:
                replica.backoff = self.respawn_delay
            else:
                replica.backoff = min(
                    max(replica.backoff, self.respawn_delay) * 2,
                    self.respawn_max_delay)
            replica.respawn_at = now + replica.backoff
            flights = [fl for fl in self._flights.values()
                       if fl.replica == replica.idx]
        self._m_failovers.inc()
        self._m_healthy.set(self.healthy_count())
        _flight.record("router_failover", replica=replica.idx,
                       cause=cause, rc=rc, inflight=len(flights),
                       deaths=replica.deaths,
                       respawn_backoff=round(replica.backoff, 3))
        for fl in flights:
            self._requeue_flight(fl)

    def _requeue_flight(self, fl: _Flight):
        """Move one orphaned flight to a survivor through the recompute
        path, honoring the cancel flag and the requeue budget."""
        if fl.cancelled:
            self._finish_flight(fl.req.rid, "cancelled")
            return
        fl.requeues += 1
        if fl.requeues > self.max_requeues:
            self._finish_flight(fl.req.rid, "failover_limit")
            return
        try:
            target, _ = self._route(fl.req.prompt)
        except NoHealthyReplicas:
            # total fleet death: deliver the error finish — a closed
            # stream with a reason, never a silent drop
            self._finish_flight(fl.req.rid, "error")
            return
        with self._lock:
            fl.replica = target.idx
        state = RequeueState(
            req=fl.req, generated=list(fl.tokens),
            submit_t=fl.submit_t, first_tok_t=fl.first_tok_t,
            requeues=fl.requeues, trace_id=fl.trace_id,
            root_span=fl.root_span,
            # queue_wait is scheduler-side state the router never sees:
            # None routes a token-less victim through fresh admission
            # (one queue_wait sample); a victim with delivered tokens
            # was certainly admitted — 0.0 parks it on the resume path
            # so the histogram is not re-fed
            queue_wait=0.0 if fl.tokens else None)
        self._m_routed.labels(reason="failover").inc()
        fl.root_span.event("failover", to_replica=target.idx,
                           requeues=fl.requeues,
                           tokens=len(fl.tokens))
        target.enqueue_transfer(state)

    def _finish_flight(self, rid: int, reason: str):
        """Synthesize a finish the owning scheduler can no longer (or
        should not) deliver; forwards through the normal callback."""
        with self._lock:
            fl = self._flights.pop(rid, None)
            cb = self.on_finish
        if fl is None:
            return
        got_first = fl.first_tok_t is not None
        res = RequestResult(
            rid=rid, tokens=np.asarray(fl.tokens, np.int32),
            finish_reason=reason,
            ttft=(fl.first_tok_t - fl.submit_t) if got_first else 0.0,
            tpot=0.0, trace_id=fl.trace_id)
        fl.root_span.end(reason=reason, tokens=len(fl.tokens))
        if cb is not None:
            cb(res)

    def _decommissioned(self, replica: _Replica, states):
        """Graceful retirement: the replica thread exported its whole
        unfinished intake (full-fidelity RequeueStates — timing and
        queue_wait travel exactly) and exits; the router re-places each
        on a survivor."""
        with self._lock:
            replica.state = "stopped"
            replica.epoch += 1
        self._m_healthy.set(self.healthy_count())
        for st in states:
            with self._lock:
                fl = self._flights.get(st.req.rid)
            if fl is None:
                continue
            if fl.cancelled:
                self._finish_flight(st.req.rid, "cancelled")
                continue
            st.requeues += 1
            fl.requeues = st.requeues
            if st.requeues > self.max_requeues:
                self._finish_flight(st.req.rid, "failover_limit")
                continue
            try:
                target, _ = self._route(st.req.prompt)
            except NoHealthyReplicas:
                self._finish_flight(st.req.rid, "error")
                continue
            with self._lock:
                fl.replica = target.idx
            self._m_routed.labels(reason="failover").inc()
            target.enqueue_transfer(st)

    def decommission(self, idx: int):
        """Ask replica ``idx`` to gracefully retire: it drains its
        scheduler through :meth:`~.scheduler.ContinuousBatchingScheduler.
        export_requeue_state` on its own thread and the router requeues
        every unfinished request onto survivors.  The replica leaves
        the routable set permanently."""
        r = self._replicas[idx]
        with self._lock:
            if r.state == "healthy":
                r.state = "joining"     # unroutable while draining
        r.retiring = True
        r.wake.set()

    # -- health probe ------------------------------------------------------

    def _probe_main(self):
        while not self._stop.is_set():
            try:
                self.probe_once()
            except Exception as e:  # the probe must never die silently
                _flight.thread_exception_dump("serve-router-probe", e)
            self._stop.wait(self.probe_interval)

    def probe_once(self, now: Optional[float] = None):
        """One health-probe sweep: refresh every live replica's
        telemetry snapshot + digest view, trip failover on a stalled
        step beacon, execute due respawns, and promote joined replicas.
        Deterministic under an injected ``now`` (tests drive it); the
        probe thread loops it."""
        now = time.monotonic() if now is None else now
        with self._lock:
            replicas = list(self._replicas)
        for r in replicas:
            if r.state in ("healthy", "joining"):
                self._refresh(r, now)
                backlog = r.backlog()
                wedged = ((r.busy or backlog)
                          and now - r.last_progress
                          > self.stall_deadline)
                dead_thread = (r.thread is not None
                               and not r.thread.is_alive()
                               and not r.stopping)
                if wedged or dead_thread:
                    self._replica_died(r, "stall" if wedged
                                       else "thread_death")
                    continue
                if r.state == "joining" and not r.retiring and (
                        now - r.started_t >= self.healthy_interval):
                    with self._lock:
                        if r.state == "joining":
                            r.state = "healthy"
                    _flight.record("router_rejoin", replica=r.idx,
                                   deaths=r.deaths)
            elif (r.state == "dead" and r.respawn_at is not None
                    and now >= r.respawn_at and not self._stop.is_set()):
                self._respawn(r, now)
        self._m_healthy.set(self.healthy_count())

    def _refresh(self, r: _Replica, now: float):
        sched = r.scheduler
        try:
            queue_depth = len(sched.waiting)
            slots = sum(a is not None for a in sched.slots)
        except Exception:
            return                  # scheduler mid-replacement
        backlog = r.backlog()
        snap = {"format": _SNAP_FORMAT, "host": r.idx,
                "wall_ts": time.time(), "queue_depth": queue_depth,
                "slots_active": slots, "backlog": backlog,
                "busy": r.busy, "steps_total": r.steps_total,
                "beacon_age_s": max(0.0, now - r.last_progress)}
        digests = r.engine.prefix_digest_snapshot()
        with self._lock:
            r.snap, r.snap_ts = snap, now
            r.view_digests, r.view_ts = digests, now

    def _respawn(self, r: _Replica, now: float):
        """Rebuild the replica's scheduler on its reset engine and restart
        the thread as JOINING, routable only after ``healthy_interval``.
        Reusing the engine keeps its captured graphs: captures per engine
        stay the same across the failover (``reset`` first waits for a
        step the dead thread left in flight)."""
        r.engine.reset()
        r.scheduler = self._make_scheduler(r)
        r.clear_queues()
        r.stopping = False
        r.retiring = False
        r.busy = False
        with self._lock:
            r.state = "joining"
            r.started_t = now
            r.last_progress = time.monotonic()
            r.snap = r.snap_ts = None
            r.view_digests, r.view_ts = set(), None
            r.epoch += 1
            epoch = r.epoch
        t = threading.Thread(target=r._run, args=(epoch,),
                             name="serve-replica-%d" % r.idx,
                             daemon=True)
        r.thread = t
        t.start()
        _flight.record("router_respawn", replica=r.idx,
                       deaths=r.deaths,
                       backoff=round(r.backoff, 3))

    # -- introspection -----------------------------------------------------

    def healthy_count(self) -> int:
        with self._lock:
            return sum(r.state == "healthy" for r in self._replicas)

    def replica_states(self) -> List[str]:
        with self._lock:
            return [r.state for r in self._replicas]

    def flights(self) -> int:
        with self._lock:
            return len(self._flights)

    def queue_depth(self) -> int:
        """Advisory fleet-wide backlog (healthz): waiting + command
        queues across live replicas — cross-thread reads of plain
        containers, same contract as the front-end's healthz view."""
        n = 0
        for r in self._replicas:
            if r.state in ("healthy", "joining"):
                try:
                    n += len(r.scheduler.waiting) + r.backlog()
                except Exception:
                    pass
        return n

    def slots_active(self) -> int:
        n = 0
        for r in self._replicas:
            if r.state in ("healthy", "joining"):
                try:
                    n += sum(a is not None for a in r.scheduler.slots)
                except Exception:
                    pass
        return n

    @property
    def engines(self):
        return [r.engine for r in self._replicas]

    @property
    def replicas(self):
        return list(self._replicas)
