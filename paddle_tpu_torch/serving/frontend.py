"""Async streaming HTTP front end over the continuous-batching scheduler
(port of ``paddle_tpu/serving/frontend.py``).

A stdlib-only asyncio HTTP/1.1 server that turns the in-process serving
engine into a network service:

* ``POST /v1/generate`` — body ``{"prompt": [token ids],
  "max_new_tokens", "temperature", "top_k", "top_p", "eos_token_id",
  "stream"}``.  ``stream: true`` (the default) answers with per-token
  **SSE** (``Content-Type: text/event-stream``): one
  ``data: {"tokens": [...]}`` event per appended run as the scheduler
  commits it, then a final ``data: {"done": true, ...}`` event.
  ``stream: false`` buffers and answers one JSON document.
* ``GET /healthz`` — liveness + drain state, with the watchdog's beacon
  ages (``stalled`` names any beacon past its deadline and flips
  ``status`` to ``"stalled"``), admission queue depth, active slots, and
  open-stream counts — served from the LOOP thread, so an external probe
  detects a scheduler thread that is wedged while the socket still
  accepts.

**Thread model.**  Three kinds of thread touch this object: the asyncio
*loop thread* (owns the server sockets and every stream), the
*scheduler thread* (owns the :class:`~.scheduler.ContinuousBatchingScheduler`
and the engine, and is the ONLY thread that calls either — neither is
thread-safe), and callers of :meth:`start`/:meth:`stop`.  Handlers talk
to the scheduler exclusively through two command queues (submissions,
cancels) drained at iteration boundaries; tokens travel back through
per-request ``asyncio.Queue``\\ s via ``loop.call_soon_threadsafe`` (the
scheduler's ``on_token``/``on_finish`` hooks fire on its own thread).
The scheduler runs the OVERLAPPED decode loop by default, so the
per-token HTTP fan-out below rides host time the card never sees.

**Torch state is per thread.**  The engine's entry points carry their own
``torch.inference_mode()``, and the scheduler thread makes the engine's
card its current device before its first step.  On a card, :meth:`start`
captures the engine's step on the caller's thread before the scheduler
thread exists (``DecodeEngine.capture_steps``): a CUDA graph capture
must see no other thread's CUDA calls, and after :meth:`start` only the
scheduler thread touches the card.  The loop thread never does.

**Admission control.**  ``queue_limit`` bounds the requests the front
end will hold in flight (admitted + queued).  Over the bound: **429**
and ``serving.shed_total``; while draining: **503**.  Shed requests
never reach the scheduler.

**Graceful drain.**  Pass a
:class:`~..robustness.preemption.PreemptionGuard`; when its flag flips
(SIGTERM, or chaos ``Preempt``), the front end stops admitting (503) and
keeps stepping until every in-flight AND already-queued request has
finished — requests are never dropped.  The drain completion is
observable via :meth:`wait_drained`.

**Mid-stream disconnects.**  A failed SSE write (client went away — or
the ``serve.stream`` faultpoint injected a ``SocketReset``) cancels the
request at the next scheduler iteration: the slot and ALL its pages are
freed refcount-exactly (a shared prefix page only drops a refcount),
counted as HTTP 499.  Tokens that never reached a client are excluded
from ``serving.goodput_tokens`` by construction.

Metrics: ``serving.http_requests{code}``, ``serving.shed_total``,
``serving.open_streams``, ``serving.goodput_tokens``.  Tracing: each
request's lane gains an ``http`` span (child of the scheduler's
``request`` root) from submission to finish.

**Disaggregated prefill/decode** (``prefill_engine=``): the scheduler
thread drives a :class:`~.disagg.DisaggScheduler`; admissions prefill on
the prefill engine and their KV hands off into ``engine``'s pool
(``handoff_limit`` bounds the handoff queue).  :meth:`start` captures
both engines' graphs before the scheduler thread exists.

**The replicated fleet** (``router=``): the router owns the replicas and
their threads, and the front end runs no scheduler thread of its own.
Handlers call ``router.submit`` (digest hashing and a lock-scoped enqueue,
never a scheduler call) from the event loop, and the token and finish
callbacks arrive from the replica threads.  :meth:`start` starts the
router, which captures every replica's graphs first.  A fleet drains
through :meth:`drain` / :meth:`stop`; a preemption guard is the
single-scheduler path and is refused here.
"""
from __future__ import annotations

import asyncio
import json
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..observability import liveness as _liveness
from ..observability import registry as _metrics
from ..observability import tracing as _tracing
from ..robustness.faultpoints import declare, faultpoint
from .scheduler import ContinuousBatchingScheduler, Request

__all__ = ["ServingFrontend"]

# liveness beacons over the two front-end worker threads: a
# deadlocked scheduler thread or a wedged event loop keeps sockets
# accept-able while no request progresses — exactly the hang /healthz
# must surface.  The sched-thread beacon guards every loop iteration
# (idle waits time out at 20ms, so a healthy thread pulses constantly);
# the loop thread is covered by a heartbeat task pulsing from inside
# the event loop, so a blocked loop (a callback that never returns)
# stops stamping.
_liveness.declare_beacon(
    "serve.frontend_sched",
    "one frontend scheduler-thread loop iteration (submit/cancel "
    "drain + scheduler step)", deadline=600.0)
_liveness.declare_beacon(
    "serve.frontend_loop",
    "asyncio event-loop heartbeat (pulses from a task inside the "
    "loop; a blocked loop stops stamping)", deadline=60.0)

#: chaos site: fired immediately before every SSE event write, so a
#: scheduled SocketReset simulates a mid-stream client disconnect at an
#: exact event index.
STREAM_SITE = declare(
    "serve.stream",
    "per-SSE-event client socket write (SocketReset here simulates a "
    "mid-stream client disconnect)")

#: socket errors that mean "the client went away" — everything the
#: stream-write path treats as a disconnect rather than a server bug
_DISCONNECT_ERRORS = (ConnectionResetError, ConnectionAbortedError,
                      BrokenPipeError, TimeoutError)


class _Stream:
    """Loop-thread view of one accepted request: an asyncio queue the
    scheduler thread feeds via ``call_soon_threadsafe``."""

    __slots__ = ("loop", "queue", "rid", "cancelled", "http_span")

    def __init__(self, loop):
        self.loop = loop
        self.queue: asyncio.Queue = asyncio.Queue()
        self.rid: Optional[int] = None    # set by the scheduler thread
        self.cancelled = False            # set before submit happened
        self.http_span = None

    def push(self, item):                 # scheduler thread
        self.loop.call_soon_threadsafe(self.queue.put_nowait, item)


class ServingFrontend:
    """The async serving front: HTTP in, SSE tokens out, a bounded
    admission queue, and a preemption-guarded drain.  ``port=0`` binds
    an ephemeral port (read :attr:`port` after :meth:`start`)."""

    def __init__(self, engine=None, host="127.0.0.1", port=0,
                 queue_limit=64, overlap=None, guard=None, tracer=None,
                 prefill_engine=None, handoff_limit=4, router=None):
        self.engine = engine
        self.prefill_engine = prefill_engine
        self.host = host
        self.port = int(port)
        self.queue_limit = int(queue_limit)
        self._guard = guard
        self._tracer = (tracer if tracer is not None
                        else _tracing.default_tracer())
        self._router = router
        if router is not None:
            if engine is not None or prefill_engine is not None:
                raise ValueError("pass engines THROUGH the router in "
                                 "fleet mode, not to the front end")
            if guard is not None:
                raise ValueError("preemption guard is not supported in "
                                 "fleet mode — use drain()")
            self.scheduler = None
            self._prompt_cap = router.prompt_cap
            router.on_token = self._on_token
            router.on_finish = self._on_finish
        elif prefill_engine is not None:
            from .disagg import DisaggScheduler
            self.scheduler = DisaggScheduler(
                engine, prefill_engine, handoff_limit=handoff_limit,
                tracer=tracer, overlap=overlap,
                on_token=self._on_token, on_finish=self._on_finish)
            self._prompt_cap = engine.prompt_cap
        else:
            self.scheduler = ContinuousBatchingScheduler(
                engine, tracer=tracer, overlap=overlap,
                on_token=self._on_token, on_finish=self._on_finish)
            self._prompt_cap = engine.prompt_cap
        # command queues (handler threads -> scheduler thread)
        self._lock = threading.Lock()
        self._pending = []                # [(Request, _Stream)]
        self._cancels = []                # [rid]
        self._streams: Dict[int, _Stream] = {}
        self._outstanding = 0             # accepted, not yet finished
        self._open_streams = 0
        self._wake = threading.Event()
        self._stop = False
        self._draining = False
        self._drained = threading.Event()
        self._started = threading.Event()
        self._sched_error = None
        self._loop = None
        self._server = None
        self._loop_thread = None
        self._sched_thread = None
        # metric handles, fetched once (no-op singletons when disabled)
        self._m_http = _metrics.counter("serving.http_requests", ("code",))
        self._m_shed = _metrics.counter("serving.shed_total")
        self._m_open = _metrics.gauge("serving.open_streams")
        self._m_goodput = _metrics.counter("serving.goodput_tokens")

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        """Capture the engines' steps (on a card), bind the server and
        start the worker threads (the router's replica threads in fleet
        mode); returns ``(host, port)``."""
        # the captures run here, before any other thread of this object
        # exists (module docstring); the router captures its replicas'
        if self._router is None:
            self.engine.capture_steps()
            if self.prefill_engine is not None:
                self.prefill_engine.capture_steps()
        self._loop_thread = threading.Thread(
            target=self._loop_main, name="serve-frontend-loop",
            daemon=True)
        self._loop_thread.start()
        self._started.wait(10.0)
        if not self._started.is_set():
            raise RuntimeError("frontend event loop failed to start")
        if self._router is not None:
            self._router.start()
        else:
            self._sched_thread = threading.Thread(
                target=self._sched_main, name="serve-frontend-sched",
                daemon=True)
            self._sched_thread.start()
        return self.host, self.port

    def stop(self, timeout=30.0):
        """Graceful shutdown: drain outstanding work (503 for new
        requests), stop the scheduler thread once no step is in flight,
        close the server.  Re-raises any error the scheduler thread died
        on."""
        # under the lock: the scheduler thread also writes _draining (on
        # a guard fire)
        with self._lock:
            self._draining = True
            self._stop = True
        self._wake.set()
        if self._router is not None:
            self._router.stop(timeout)
        if self._sched_thread is not None:
            self._sched_thread.join(timeout)
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)
        if self._loop_thread is not None:
            self._loop_thread.join(timeout)
        if self._sched_error is not None:
            raise self._sched_error

    def drain(self):
        """Enter drain mode programmatically (what a guard fire does):
        new requests 503, everything already accepted runs to
        completion."""
        with self._lock:
            self._draining = True
            drained = self._router is not None and self._outstanding == 0
        if drained:
            # fleet mode completes the drain from finish callbacks; an
            # already idle fleet would never see one
            self._drained.set()
        self._wake.set()

    @property
    def draining(self):
        return self._draining

    def wait_drained(self, timeout=None) -> bool:
        """Block until the drain completed (all accepted requests
        finished after :meth:`drain`/a guard fire)."""
        return self._drained.wait(timeout)

    # -- scheduler thread --------------------------------------------------

    def _sched_main(self):
        sched = self.scheduler
        if self.engine.device.type == "cuda":
            # torch's current device is per thread: the engine's buffers'
            # card (a tensor's device always names its index)
            torch.cuda.set_device(self.engine.cache.lengths.device)
        b = _liveness.beacon("serve.frontend_sched")
        b.begin()     # watched for the thread's whole lifetime
        try:
            while True:
                b.pulse()
                if (self._guard is not None and self._guard.preempted
                        and not self._draining):
                    # the guard flipped (SIGTERM / chaos Preempt): stop
                    # admitting, finish what we hold — never drop.  The
                    # scheduler's recompute preemption keeps requeueing
                    # page-pressure victims during the drain.
                    with self._lock:
                        self._draining = True
                with self._lock:
                    pending, self._pending = self._pending, []
                    cancels, self._cancels = self._cancels, []
                for req, stream in pending:
                    if stream.cancelled:      # client left pre-submit
                        with self._lock:
                            self._outstanding -= 1
                        continue
                    try:
                        rid = sched.submit(req)
                    except ValueError as e:
                        # the handler pre-validates, but a submit() rule
                        # it doesn't mirror must degrade to ONE failed
                        # stream — never kill the scheduler thread (and
                        # with it every other open stream)
                        with self._lock:
                            self._outstanding -= 1
                        stream.push(("done", {
                            "rid": None, "finish_reason": "error",
                            "error": str(e), "tokens": [],
                            "ttft_ms": 0.0, "tpot_ms": 0.0,
                            "queue_wait_ms": 0.0}))
                        continue
                    stream.rid = rid
                    with self._lock:
                        self._streams[rid] = stream
                    # the network-facing lifetime on the request lane:
                    # child of the scheduler's "request" root so the
                    # trace tree stays connected
                    stream.http_span = self._tracer.span(
                        "http", parent=sched.request_span(rid))
                    stream.push(("rid", rid))
                    if stream.cancelled:
                        # the client vanished in the window between the
                        # cancelled check above and the rid assignment:
                        # _cancel_stream saw rid=None and could queue
                        # nothing — cancel inline (same thread) so a
                        # dead client's request never holds a slot.
                        # (A post-rid disconnect queues a cancel too;
                        # the second cancel() is a no-op.)
                        sched.cancel(rid)
                for rid in cancels:
                    sched.cancel(rid)
                worked = False
                if sched.has_work():
                    # has_work() holds while a step is in flight, so the
                    # thread never ends with a step unconsumed (its
                    # pinned output buffer would be reused under a
                    # pending copy)
                    sched.step()
                    worked = True
                else:
                    with self._lock:
                        # _outstanding is incremented BEFORE a request
                        # enters _pending, so an accepted-but-not-yet-
                        # enqueued request keeps this false — the drain
                        # must never report complete with accepted work
                        # still in the handoff window
                        drained = (self._draining and not self._pending
                                   and self._outstanding == 0)
                    if drained:
                        self._drained.set()
                    if self._stop:
                        break
                    self._wake.wait(0.02)
                    self._wake.clear()
                if not worked and self._stop:
                    break
        except BaseException as e:        # surfaced by stop()
            self._sched_error = e
            # the black-box record: this catch keeps the death off
            # threading.excepthook, so the same flight dump every other
            # dying worker thread gets is fired here explicitly
            from ..observability import flight as _flight
            _flight.thread_exception_dump("serve-frontend-sched", e)
            self._drained.set()
            # never leave a connected client awaiting a queue that can
            # no longer be fed — flush an error-done to every stream
            with self._lock:
                streams = list(self._streams.values())
                self._streams.clear()
            for stream in streams:
                stream.push(("done", {"rid": stream.rid,
                                      "finish_reason": "error",
                                      "tokens": [], "ttft_ms": 0.0,
                                      "tpot_ms": 0.0,
                                      "queue_wait_ms": 0.0}))
        finally:
            b.done()      # thread exiting: stop watching this beacon

    # scheduler-thread callbacks -------------------------------------------

    def _on_token(self, rid, toks):
        with self._lock:
            stream = self._streams.get(rid)
        if stream is not None:
            stream.push(("tokens", list(toks)))

    def _on_finish(self, result):
        # the scheduler thread calls this, or in fleet mode whichever
        # replica thread owns the rid (_streams is guarded by the lock)
        with self._lock:
            stream = self._streams.pop(result.rid, None)
            self._outstanding -= 1
            # fleet mode has no scheduler loop to see quiescence: the
            # drain completes at the last finish callback
            drained = (self._router is not None and self._draining
                       and self._outstanding == 0)
        if drained:
            self._drained.set()
        if stream is None:
            return
        if stream.http_span is not None:
            stream.http_span.end(reason=result.finish_reason,
                                 tokens=int(result.tokens.size))
        stream.push(("done", {
            "rid": int(result.rid),
            "finish_reason": result.finish_reason,
            "tokens": [int(t) for t in result.tokens],
            "ttft_ms": round(1e3 * result.ttft, 3),
            "tpot_ms": round(1e3 * result.tpot, 3),
            "queue_wait_ms": round(1e3 * result.queue_wait, 3),
        }))

    # -- loop thread -------------------------------------------------------

    async def _heartbeat(self):
        """Loop-thread liveness: pulse from INSIDE the event loop, so a
        loop blocked by a wedged callback stops stamping and the
        monitor attributes the stall to ``serve.frontend_loop``."""
        b = _liveness.beacon("serve.frontend_loop")
        interval = max(min(
            _liveness.deadline_for("serve.frontend_loop") / 4.0, 1.0),
            0.01)
        b.begin()
        try:
            while True:
                await asyncio.sleep(interval)
                b.pulse()
        finally:
            b.done()

    def _loop_main(self):
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)

        async def _boot():
            self._server = await asyncio.start_server(
                self._handle, self.host, self.port)
            self.port = self._server.sockets[0].getsockname()[1]

        self._loop.run_until_complete(_boot())
        self._started.set()
        # liveness heartbeat only when a monitor is armed: a disabled
        # stack schedules nothing on the loop
        hb = (self._loop.create_task(self._heartbeat())
              if _liveness.active() is not None else None)
        try:
            self._loop.run_forever()
        finally:
            if hb is not None:
                hb.cancel()
                try:
                    self._loop.run_until_complete(hb)
                except (asyncio.CancelledError, Exception):
                    pass
            self._server.close()
            self._loop.run_until_complete(self._server.wait_closed())
            self._loop.close()

    async def _handle(self, reader, writer):
        try:
            try:
                method, path, headers, body = await self._read_request(
                    reader)
            except (asyncio.IncompleteReadError, ValueError,
                    *_DISCONNECT_ERRORS):
                return
            if method == "GET" and path == "/healthz":
                # liveness-enriched health: an external probe
                # must be able to tell "socket alive but not
                # progressing" from healthy.  Beacon ages come from
                # liveness.state() (computed on read — the stall shows
                # as soon as age crosses the deadline, no monitor poll
                # needed), and this handler runs on the LOOP thread, so
                # it still answers while the scheduler thread is wedged
                # — which is exactly the scenario.
                beacons = _liveness.state()
                stalled = sorted(n for n, s in beacons.items()
                                 if s["stalled"])
                doc = {
                    "status": ("stalled" if stalled else
                               "draining" if self._draining else "ok"),
                    "stalled": stalled,
                    "beacons": beacons,
                    "open_streams": self._open_streams,
                    "outstanding": self._outstanding,
                }
                if self._router is not None:
                    # fleet view: depths summed across replicas, and each
                    # replica's lifecycle state (a respawn in flight)
                    doc.update({
                        "queue_depth": self._router.queue_depth(),
                        "slots_active": self._router.slots_active(),
                        "handoff_depth": 0,
                        "replicas": self._router.replica_states(),
                        "replicas_healthy": self._router.healthy_count(),
                    })
                else:
                    doc.update({
                        "queue_depth": len(self.scheduler.waiting),
                        "slots_active": sum(
                            a is not None for a in self.scheduler.slots),
                        # a disaggregated scheduler's handoff queue and
                        # transfers in flight (0 without one)
                        "handoff_depth": getattr(self.scheduler,
                                                 "handoff_depth", 0),
                    })
                await self._respond_json(writer, 200, doc)
                return
            if method != "POST" or path != "/v1/generate":
                await self._respond_json(writer, 404,
                                         {"error": "not found"})
                return
            await self._generate(writer, body)
        except _DISCONNECT_ERRORS:
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _generate(self, writer, body):
        try:
            payload = json.loads(body.decode("utf-8"))
            prompt = np.asarray(payload["prompt"], np.int32).reshape(-1)
            req = Request(
                prompt=prompt,
                max_new_tokens=int(payload.get("max_new_tokens", 20)),
                temperature=float(payload.get("temperature", 1.0)),
                top_k=int(payload.get("top_k", 0)),
                top_p=float(payload.get("top_p", 1.0)),
                eos_token_id=payload.get("eos_token_id"))
            if prompt.size < 1:
                raise ValueError("empty prompt")
            if prompt.size > self._prompt_cap:
                raise ValueError("prompt length %d exceeds capacity %d"
                                 % (prompt.size, self._prompt_cap))
            if req.max_new_tokens < 1:
                raise ValueError("max_new_tokens must be >= 1")
            stream_mode = bool(payload.get("stream", True))
        except (KeyError, TypeError, ValueError,
                json.JSONDecodeError) as e:
            await self._respond_json(writer, 400, {"error": str(e)})
            return
        # -- admission control: 503 while draining, 429 over the bound --
        if self._draining or self._stop:
            self._m_shed.inc()
            await self._respond_json(writer, 503, {"error": "draining"})
            return
        with self._lock:
            if self._outstanding >= self.queue_limit:
                shed = True
            else:
                shed = False
                self._outstanding += 1
        if shed:
            self._m_shed.inc()
            await self._respond_json(writer, 429, {"error": "overloaded"})
            return
        stream = _Stream(asyncio.get_running_loop())
        if self._router is not None:
            # fleet mode: route now, on the loop thread (router.submit is
            # hashing and a lock-scoped enqueue, never a scheduler call);
            # on_admit registers the stream before any replica thread can
            # emit a token for the rid
            def admitted(rid, root):
                stream.rid = rid
                with self._lock:
                    self._streams[rid] = stream
                stream.http_span = self._tracer.span("http", parent=root)
            from .router import NoHealthyReplicas
            try:
                self._router.submit(req, on_admit=admitted)
            except NoHealthyReplicas:
                with self._lock:
                    self._outstanding -= 1
                self._m_shed.inc()
                await self._respond_json(
                    writer, 503, {"error": "no healthy replicas"})
                return
            except ValueError as e:
                with self._lock:
                    self._outstanding -= 1
                await self._respond_json(writer, 400, {"error": str(e)})
                return
        else:
            with self._lock:
                self._pending.append((req, stream))
            self._wake.set()
        if stream_mode:
            await self._stream_response(writer, stream)
        else:
            await self._buffered_response(writer, stream)

    async def _stream_response(self, writer, stream):
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: text/event-stream\r\n"
                     b"Cache-Control: no-cache\r\n"
                     b"Connection: close\r\n\r\n")
        self._open_streams += 1
        self._m_open.inc(1)
        try:
            await writer.drain()
            while True:
                kind, item = await stream.queue.get()
                if kind == "rid":
                    continue
                # the chaos disconnect site: a SocketReset scheduled
                # here is indistinguishable from the client vanishing
                faultpoint(STREAM_SITE, rid=stream.rid)
                if kind == "tokens":
                    writer.write(b"data: " + json.dumps(
                        {"tokens": item}).encode() + b"\n\n")
                    await writer.drain()
                    self._m_goodput.inc(len(item))
                elif kind == "done":
                    writer.write(b"data: " + json.dumps(
                        dict(item, done=True)).encode() + b"\n\n")
                    await writer.drain()
                    # 200 means the stream COMPLETED: a cut stream
                    # counts once, as 499 — the code buckets partition
                    # requests (OBSERVABILITY.md documents them as
                    # mutually exclusive outcomes)
                    self._m_http.labels(code="200").inc()
                    return
        except _DISCONNECT_ERRORS:
            self._m_http.labels(code="499").inc()
            self._cancel_stream(stream)
        finally:
            self._open_streams -= 1
            self._m_open.inc(-1)

    async def _buffered_response(self, writer, stream):
        while True:
            kind, item = await stream.queue.get()
            if kind == "done":
                break
        try:
            await self._respond_json(writer, 200, item)
        except _DISCONNECT_ERRORS:
            # the client left before the buffered answer was written:
            # its tokens were never delivered — not goodput, not a 200
            self._m_http.labels(code="499").inc()
            return
        self._m_goodput.inc(len(item["tokens"]))
        self._m_http.labels(code="200").inc()

    def _cancel_stream(self, stream):
        """Client went away mid-stream: route a cancel to the scheduler
        thread (slot + pages freed refcount-exactly at the next
        iteration boundary).  Pre-submit, just mark the stream."""
        stream.cancelled = True
        if stream.rid is not None:
            if self._router is not None:
                # forwarded to the owning replica's command queue
                self._router.cancel(stream.rid)
            else:
                with self._lock:
                    self._cancels.append(stream.rid)
        self._wake.set()

    # -- http plumbing -----------------------------------------------------

    @staticmethod
    async def _read_request(reader):
        line = (await reader.readline()).decode("latin1").rstrip("\r\n")
        parts = line.split(" ")
        if len(parts) < 3:
            raise ValueError("malformed request line: %r" % line)
        method, path = parts[0].upper(), parts[1]
        headers = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            k, _, v = h.decode("latin1").partition(":")
            headers[k.strip().lower()] = v.strip()
        n = int(headers.get("content-length", "0") or 0)
        body = await reader.readexactly(n) if n else b""
        return method, path, headers, body

    async def _respond_json(self, writer, code, obj):
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  429: "Too Many Requests",
                  503: "Service Unavailable"}.get(code, "Error")
        if code != 200:
            self._m_http.labels(code=str(code)).inc()
        body = json.dumps(obj).encode()
        writer.write(("HTTP/1.1 %d %s\r\n"
                      "Content-Type: application/json\r\n"
                      "Content-Length: %d\r\n"
                      "Connection: close\r\n\r\n"
                      % (code, reason, len(body))).encode() + body)
        await writer.drain()
