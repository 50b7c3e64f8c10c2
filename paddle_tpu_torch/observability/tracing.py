"""Request-scoped span tracing (port of
``paddle_tpu/observability/tracing.py``) — the per-request layer the
aggregate metrics registry cannot express.

A single request's lifecycle — queue wait, chunked prefill interleaved
with decode, prefix-cache hits, copy-on-write, verify steps, recompute
preemption and re-admission — is not reconstructable from histograms: a
p99 TTFT outlier is unattributable to its cause.  This module is the
cheap host-side span API the scheduler/engine thread a ``trace_id``
through:

* a **trace** is one request's lane, minted at ``submit()``
  (:meth:`Tracer.new_trace`); ``trace_id 0`` is the shared engine lane
  (step dispatch spans, page-allocator events);
* a **span** has a name, parent link, monotonic ``perf_counter_ns``
  timestamps, structured attrs, and point-in-time **events**
  (prefix-hit, preempted, first-token);
* exports: JSONL (one span per line, via the same append/atexit
  discipline as the metrics ``flush()``) and chrome-trace JSON (request
  lanes as named threads, span events as instants).

Discipline (same as the registry):

* **Disabled by default** (``PADDLE_TPU_TRACING=0``): the default
  tracer is the module-level :data:`NOOP_TRACER` — every ``span()``
  returns the shared :data:`NOOP_SPAN` by identity, so instrumented hot
  loops pay one attribute load and an empty method call.
* **Host values only.**  Every span attr value is checked up front: a
  ``torch.Tensor`` is refused with a ``TypeError`` (``float()`` of a
  CUDA tensor is a hidden sync), and anything else must have a concrete
  ``float()``.
* **Bounded.**  The span buffer is capped (``PADDLE_TPU_TRACE_CAP``);
  overflow drops oldest-first and counts the drops — tracing a
  multi-hour serving run degrades to a tail window, never to OOM.

The analyzer half (:func:`build_report`, :func:`build_sli`) reconstructs
per-request timelines from a trace file and attributes TTFT/TPOT across
queue vs prefill vs decode vs preemption-rework.  The span names, the
JSONL format and the report are the JAX package's, so its ``python -m
paddle_tpu.observability trace-report`` reads the port's files too.  The
JAX package's chrome export also merges its host profiler's spans and
its HBM-ledger lanes; the port has neither yet.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch

from . import flight as _flight

__all__ = [
    "Span", "NoopSpan", "Tracer", "NoopTracer",
    "NOOP_SPAN", "NOOP_TRACER",
    "default_tracer", "load_trace", "build_report", "format_report",
    "build_sli", "format_sli", "chrome_events", "write_chrome",
]

#: default bound on buffered spans+events per tracer (drop-oldest past it)
TRACE_CAP_DEFAULT = 200_000

#: the engine lane: spans/events that belong to the shared engine (one
#: compiled step serves every request), not to any single request's trace
ENGINE_LANE = 0


def _attr_value(name: str, v: Any):
    """The host-value guard (the registry's ``_to_float`` discipline):
    span attrs must be plain host values.  A tensor is refused before
    ``float()`` would sync the device for it."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, torch.Tensor):
        raise TypeError(
            "span attr %r got a torch.Tensor (%s on %s) — span attrs take "
            "host values only: float() of a device tensor is a hidden "
            "sync" % (name, v.dtype, v.device))
    try:
        return float(v)
    except Exception as e:
        raise RuntimeError(
            "span attr %r got a value with no concrete float() (%r) — "
            "span attrs take host values only"
            % (name, type(v).__name__)) from e


def _attrs(kv: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _attr_value(k, v) for k, v in kv.items()}


class Span:
    """One timed operation in a request's lane.  Created started; call
    :meth:`end` (or use as a context manager) to close it.  ``event()``
    attaches a timestamped point event (prefix-hit, preempted, ...)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start_ns",
                 "end_ns", "attrs", "events", "_tracer")

    def __init__(self, tracer, name, trace_id, span_id, parent_id,
                 start_ns, attrs):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start_ns = start_ns
        self.end_ns = None
        self.attrs = attrs
        self.events: List[Dict[str, Any]] = []

    def set_attr(self, **kv):
        self.attrs.update(_attrs(kv))
        return self

    def event(self, name: str, **attrs):
        self.events.append({"name": name,
                            "ts_ns": time.perf_counter_ns(),
                            "attrs": _attrs(attrs)})
        return self

    def end(self, end_ns: Optional[int] = None, **attrs):
        if self.end_ns is not None:    # idempotent: first end wins
            return self
        if attrs:
            self.attrs.update(_attrs(attrs))
        self.end_ns = int(end_ns if end_ns is not None
                          else time.perf_counter_ns())
        self._tracer._on_end(self)
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()
        return False

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": "span", "name": self.name,
                "trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id, "start_ns": self.start_ns,
                "end_ns": self.end_ns, "attrs": self.attrs,
                "events": self.events}


class NoopSpan:
    """The disabled-path span: every method is a constant no-op returning
    self (so chained/context-manager use costs nothing)."""

    __slots__ = ()
    name = ""
    trace_id = 0
    span_id = 0
    parent_id = None
    start_ns = 0
    end_ns = 0
    attrs: Dict[str, Any] = {}
    events: List[Dict[str, Any]] = []

    def set_attr(self, **kv):
        return self

    def event(self, name, **attrs):
        return self

    def end(self, end_ns=None, **attrs):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


#: the singleton a disabled tracer hands out — instrumented code can
#: assert the fast path by identity.
NOOP_SPAN = NoopSpan()


class Tracer:
    """A live span collector.  Thread-safe; bounded (drop-oldest)."""

    enabled = True

    def __init__(self, capacity: Optional[int] = None):
        cap = capacity if capacity is not None else int(os.environ.get(
            "PADDLE_TPU_TRACE_CAP", TRACE_CAP_DEFAULT))
        self._cap = max(int(cap), 1)
        self._lock = threading.Lock()
        # deques: drop-oldest past the cap stays O(1) per append — a
        # list.pop(0) here would turn every hot-loop span O(cap) once a
        # long run fills the buffer
        self._spans: "deque[Span]" = deque()
        self._events: "deque[Dict[str, Any]]" = deque()  # instants
        self._next_trace = 0
        self._next_span = 0
        self.dropped = 0
        # perf_counter_ns <-> wall-clock anchor for cross-file alignment
        self._anchor = {"wall_ts": time.time(),
                        "perf_ns": time.perf_counter_ns()}

    # -- minting -----------------------------------------------------------

    def new_trace(self) -> int:
        """Mint a request lane id (> 0; 0 is the engine lane)."""
        with self._lock:
            self._next_trace += 1
            return self._next_trace

    def _new_span_id(self) -> int:
        with self._lock:
            self._next_span += 1
            return self._next_span

    # -- recording ---------------------------------------------------------

    def span(self, name: str, trace_id: Optional[int] = None,
             parent: Optional[Span] = None, **attrs) -> Span:
        """Open a span (started now).  ``parent`` links it into a trace
        tree and supplies the ``trace_id`` when not given explicitly."""
        if trace_id is None:
            trace_id = parent.trace_id if parent is not None else ENGINE_LANE
        s = Span(self, name, int(trace_id), self._new_span_id(),
                 parent.span_id if parent is not None else None,
                 time.perf_counter_ns(), _attrs(attrs))
        self._append(self._spans, s)
        return s

    def add_span(self, name: str, start_ns: int, end_ns: int,
                 trace_id: Optional[int] = None,
                 parent: Optional[Span] = None, **attrs) -> Span:
        """Record an already-timed span (closed-interval constructor —
        the decode hot loop measures once and stamps every involved
        request's span with the same interval)."""
        if trace_id is None:
            trace_id = parent.trace_id if parent is not None else ENGINE_LANE
        s = Span(self, name, int(trace_id), self._new_span_id(),
                 parent.span_id if parent is not None else None,
                 int(start_ns), _attrs(attrs))
        self._append(self._spans, s)
        s.end(end_ns=int(end_ns))
        return s

    def instant(self, name: str, trace_id: int = ENGINE_LANE, **attrs):
        """A standalone point event (page reclaim, CoW remap, ...) on a
        lane, not attached to any span."""
        self._append(self._events, {
            "kind": "event", "name": name, "trace_id": int(trace_id),
            "ts_ns": time.perf_counter_ns(), "attrs": _attrs(attrs)})

    def _append(self, buf, item):
        with self._lock:
            buf.append(item)
            if len(self._spans) + len(self._events) > self._cap:
                # true drop-OLDEST across both buffers: evicting spans
                # whenever any exist would let accumulated instants
                # squeeze the span window to nothing on long runs
                if not self._events:
                    victim = self._spans
                elif not self._spans:
                    victim = self._events
                else:
                    victim = (self._spans
                              if self._spans[0].start_ns
                              <= self._events[0]["ts_ns"]
                              else self._events)
                victim.popleft()
                self.dropped += 1

    def _on_end(self, span: Span):
        # feed the flight recorder's ring (one global None-check when the
        # recorder is inactive)
        if _flight.active() is not None:
            _flight.record("span", name=span.name, trace_id=span.trace_id,
                           span_id=span.span_id,
                           dur_ns=(span.end_ns or span.start_ns)
                           - span.start_ns, attrs=dict(span.attrs))

    # -- readout -----------------------------------------------------------

    @property
    def span_count(self) -> int:
        with self._lock:
            return len(self._spans)

    def spans(self) -> List[Dict[str, Any]]:
        with self._lock:
            spans = list(self._spans)
        return [s.to_dict() for s in spans]

    def instants(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(e) for e in self._events]

    def span_counts(self) -> Dict[int, int]:
        """{trace_id: spans recorded} — the bench's per-request counts."""
        out: Dict[int, int] = {}
        with self._lock:
            for s in self._spans:
                out[s.trace_id] = out.get(s.trace_id, 0) + 1
        return out

    def reset(self):
        """Drop recorded spans/events (the bench does this after warmup
        so the exported trace describes the timed drain only).  Trace and
        span id counters keep advancing — ids never repeat."""
        with self._lock:
            self._spans.clear()
            self._events.clear()
            self.dropped = 0
            self._anchor = {"wall_ts": time.time(),
                            "perf_ns": time.perf_counter_ns()}

    # -- export ------------------------------------------------------------

    def export_jsonl(self, path: str, mode: str = "w") -> str:
        """Write the trace as JSONL: one meta line (the wall-clock anchor
        for ``perf_counter_ns`` timestamps), then one line per span and
        per instant event."""
        with self._lock:
            spans = [s.to_dict() for s in self._spans]
            events = [dict(e) for e in self._events]
            meta = {"kind": "meta", "format": "paddle_tpu-trace-v1",
                    "pid": os.getpid(), "dropped": self.dropped,
                    **self._anchor}
        with open(path, mode) as f:
            for doc in [meta] + spans + events:
                f.write(json.dumps(doc, sort_keys=True) + "\n")
        return path

    def export_chrome(self, path: str) -> str:
        """Write a chrome://tracing JSON of this tracer's spans (request
        lanes as named threads)."""
        return write_chrome(path, self.spans(), self.instants())

    def flush(self, path: Optional[str] = None) -> Optional[str]:
        """Append-export to ``path`` or ``$PADDLE_TPU_TRACE_FILE`` (the
        atexit hook of the default tracer); None when unconfigured."""
        path = path or os.environ.get("PADDLE_TPU_TRACE_FILE")
        if not path:
            return None
        return self.export_jsonl(path, mode="a")


class NoopTracer:
    """The disabled default tracer: identity no-ops everywhere."""

    enabled = False
    dropped = 0
    span_count = 0

    def new_trace(self) -> int:
        return 0

    def span(self, name, trace_id=None, parent=None, **attrs):
        return NOOP_SPAN

    def add_span(self, name, start_ns, end_ns, trace_id=None, parent=None,
                 **attrs):
        return NOOP_SPAN

    def instant(self, name, trace_id=ENGINE_LANE, **attrs):
        pass

    def spans(self):
        return []

    def instants(self):
        return []

    def span_counts(self):
        return {}

    def reset(self):
        pass

    def export_jsonl(self, path, mode="w"):
        raise RuntimeError(
            "tracing is disabled (PADDLE_TPU_TRACING=0) — nothing to "
            "export; enable it or pass a live Tracer to the engine/"
            "scheduler")

    def export_chrome(self, path):
        self.export_jsonl(path)

    def flush(self, path=None):
        return None


#: the singleton :func:`default_tracer` returns while disabled —
#: assertable by identity.
NOOP_TRACER = NoopTracer()


_DEFAULT: Optional[Tracer] = None
_DEFAULT_LOCK = threading.Lock()


def default_tracer():
    """The process-wide tracer.  Disabled (the default,
    ``PADDLE_TPU_TRACING`` unset/0) it is :data:`NOOP_TRACER` by
    identity; enabled (``PADDLE_TPU_TRACING=1``) it is one live
    :class:`Tracer`, with an atexit JSONL flush when
    ``PADDLE_TPU_TRACE_FILE`` is set.  Like the registry, the decision
    is made once: components fetch their tracer at construction."""
    global _DEFAULT
    if _DEFAULT is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                on = os.environ.get("PADDLE_TPU_TRACING", "0") not in (
                    "0", "", "false", "off")
                if not on:
                    _DEFAULT = NOOP_TRACER
                else:
                    _DEFAULT = Tracer()
                    if os.environ.get("PADDLE_TPU_TRACE_FILE"):
                        import atexit
                        atexit.register(_DEFAULT.flush)
    return _DEFAULT


# ---------------------------------------------------------------------------
# chrome-trace export
# ---------------------------------------------------------------------------

def chrome_events(spans: Iterable[Dict[str, Any]],
                  events: Iterable[Dict[str, Any]] = (),
                  pid: Optional[int] = None) -> List[Dict[str, Any]]:
    """Chrome-trace event list for span/event dicts.  Each trace lane is
    a named synthetic thread (``request <id>``; lane 0 is ``engine``),
    so Perfetto renders one swimlane per request; span events and
    standalone instants become thread-scoped ``"i"`` events."""
    pid = os.getpid() if pid is None else pid
    out: List[Dict[str, Any]] = []
    lanes = set()

    def lane(tid):
        if tid not in lanes:
            lanes.add(tid)
            out.append({"name": "thread_name", "ph": "M", "pid": pid,
                        "tid": tid,
                        "args": {"name": ("engine" if tid == ENGINE_LANE
                                          else "request %d" % tid)}})
            out.append({"name": "thread_sort_index", "ph": "M", "pid": pid,
                        "tid": tid, "args": {"sort_index": tid}})
        return tid

    for s in spans:
        tid = lane(int(s["trace_id"]))
        end = s["end_ns"] if s["end_ns"] is not None else s["start_ns"]
        out.append({"name": s["name"], "ph": "X", "pid": pid, "tid": tid,
                    "ts": s["start_ns"] / 1000.0,
                    "dur": max(end - s["start_ns"], 0) / 1000.0,
                    "cat": "request" if tid != ENGINE_LANE else "engine",
                    "args": dict(s.get("attrs") or {})})
        for ev in s.get("events") or ():
            out.append({"name": ev["name"], "ph": "i", "s": "t",
                        "pid": pid, "tid": tid,
                        "ts": ev["ts_ns"] / 1000.0, "cat": "event",
                        "args": dict(ev.get("attrs") or {})})
    for ev in events:
        tid = lane(int(ev.get("trace_id", ENGINE_LANE)))
        out.append({"name": ev["name"], "ph": "i", "s": "t", "pid": pid,
                    "tid": tid, "ts": ev["ts_ns"] / 1000.0, "cat": "event",
                    "args": dict(ev.get("attrs") or {})})
    return out


def write_chrome(path: str, spans, events=()) -> str:
    """Write chrome://tracing JSON of span and instant dicts."""
    with open(path, "w") as f:
        json.dump({"traceEvents": chrome_events(spans, events)}, f)
    return path


# ---------------------------------------------------------------------------
# trace file loading + per-request reconstruction (the analyzer)
# ---------------------------------------------------------------------------

def load_trace(path: str) -> Tuple[List[dict], List[dict], List[dict]]:
    """(spans, events, metas) from a JSONL trace file; malformed lines
    are skipped (a torn tail from a crashed writer must not kill the
    post-mortem that needs it most).

    Appended multi-run files (the atexit ``flush(mode="a")`` path) are
    handled: every ``meta`` line starts a new run segment, and each
    segment's trace/span ids — which restart at 1 in every process —
    are renumbered into one shared namespace, so two runs' requests can
    never merge into one trace or alias span ids across runs.  Each
    returned span/event carries its 0-based ``run`` index."""
    spans, events, metas = [], [], []
    run = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                doc = json.loads(line)
            except json.JSONDecodeError:
                continue
            kind = doc.get("kind")
            if kind == "meta":
                if spans or events or metas:
                    run += 1
                metas.append(doc)
            elif kind == "span":
                doc["run"] = run
                spans.append(doc)
            elif kind == "event":
                doc["run"] = run
                events.append(doc)
    if run:    # multi-run file: renumber ids into one namespace
        trace_map: Dict[Tuple[int, int], int] = {}
        span_map: Dict[Tuple[int, int], int] = {}

        def tid_for(r, tid):
            if tid == ENGINE_LANE:    # the engine lane is shared
                return ENGINE_LANE
            return trace_map.setdefault((r, tid), len(trace_map) + 1)

        def sid_for(r, sid):
            return span_map.setdefault((r, sid), len(span_map) + 1)

        for s in spans:
            s["trace_id"] = tid_for(s["run"], s["trace_id"])
            s["span_id"] = sid_for(s["run"], s["span_id"])
            if s.get("parent_id") is not None:
                s["parent_id"] = sid_for(s["run"], s["parent_id"])
        for e in events:
            e["trace_id"] = tid_for(e["run"], e["trace_id"])
    return spans, events, metas


_PREFILL_NAMES = ("prefill", "prefill_chunk")
_DECODE_NAMES = ("decode", "spec_verify")


def build_report(spans: List[dict], events: List[dict] = ()) -> dict:
    """Reconstruct per-request timelines from span dicts.

    For every trace with a ``request`` root span: verify the span tree
    is CONNECTED (every span of the trace reaches the root via parent
    links), recover TTFT (root start -> ``first_token`` event) and TPOT
    (decode time / decode-committed tokens — the scheduler's own
    definition), and attribute the request's wall time across **queue**
    (initial admission wait) / **prefill** (first-admission chunks) /
    **decode** (decode + spec-verify iterations) / **rework**
    (preemption requeue wait + recompute-prefill chunks)."""
    by_trace: Dict[int, List[dict]] = {}
    for s in spans:
        by_trace.setdefault(int(s["trace_id"]), []).append(s)

    requests = []
    for tid, group in sorted(by_trace.items()):
        roots = [s for s in group if s["name"] == "request"]
        if tid == ENGINE_LANE or not roots:
            continue
        root = roots[0]
        by_id = {s["span_id"]: s for s in group}
        # connectivity: walk parents up to the root
        connected = True
        for s in group:
            seen, cur = set(), s
            while cur is not None and cur["span_id"] != root["span_id"]:
                if cur["span_id"] in seen:       # cycle: broken trace
                    cur = None
                    break
                seen.add(cur["span_id"])
                cur = by_id.get(cur["parent_id"])
            if cur is None:
                connected = False

        def dur(s):
            end = s["end_ns"] if s["end_ns"] is not None else s["start_ns"]
            return (end - s["start_ns"]) * 1e-9

        queue_s = sum(dur(s) for s in group if s["name"] == "queue")
        rework_wait_s = sum(dur(s) for s in group
                            if s["name"] == "requeue")
        prefill_s = rework_prefill_s = 0.0
        for s in group:
            if s["name"] in _PREFILL_NAMES:
                if (s.get("attrs") or {}).get("rework"):
                    rework_prefill_s += dur(s)
                else:
                    prefill_s += dur(s)
        decode_s = decode_tokens = 0
        spec_iters = 0
        for s in group:
            if s["name"] in _DECODE_NAMES:
                decode_s += dur(s)
                decode_tokens += int((s.get("attrs") or {}
                                      ).get("tokens", 0))
                if s["name"] == "spec_verify":
                    spec_iters += 1
        root_events = [e for s in group for e in (s.get("events") or ())]
        first_tok = [e for e in root_events if e["name"] == "first_token"]
        ttft_s = ((min(e["ts_ns"] for e in first_tok)
                   - root["start_ns"]) * 1e-9) if first_tok else None
        prefix_hits = [e for e in root_events if e["name"] == "prefix_hit"]
        preemptions = sum(1 for e in root_events
                          if e["name"] == "preempted")
        rework_s = rework_wait_s + rework_prefill_s
        total = queue_s + prefill_s + decode_s + rework_s
        attribution = {k: (v / total if total > 0 else 0.0)
                       for k, v in (("queue", queue_s),
                                    ("prefill", prefill_s),
                                    ("decode", decode_s),
                                    ("rework", rework_s))}
        attrs = root.get("attrs") or {}
        requests.append({
            "trace_id": tid,
            "rid": attrs.get("rid"),
            "finish_reason": attrs.get("reason"),
            "spans": len(group),
            "connected": connected,
            "ttft_s": ttft_s,
            "tpot_s": (decode_s / decode_tokens) if decode_tokens else 0.0,
            "queue_s": queue_s,
            "prefill_s": prefill_s,
            "decode_s": decode_s,
            "decode_tokens": decode_tokens,
            "spec_verify_iterations": spec_iters,
            "rework_s": rework_s,
            "rework_wait_s": rework_wait_s,
            "rework_prefill_s": rework_prefill_s,
            "prefix_hit_tokens": sum(int(e["attrs"].get("tokens", 0))
                                     for e in prefix_hits),
            "preemptions": preemptions,
            "attribution": attribution,
        })

    with_ttft = [r for r in requests if r["ttft_s"] is not None]
    # standalone instants (pages.prefix_share / cow_remap / reclaim)
    # summarized by name — the page-lifecycle side of the timeline
    instants: Dict[str, int] = {}
    for e in events:
        instants[e["name"]] = instants.get(e["name"], 0) + 1
    totals = {
        "requests": len(requests),
        "spans": sum(len(g) for t, g in by_trace.items()
                     if t != ENGINE_LANE),
        "engine_spans": len(by_trace.get(ENGINE_LANE, [])),
        "instants": instants,
        "connected": all(r["connected"] for r in requests),
        "ttft_sum_s": sum(r["ttft_s"] for r in with_ttft),
        "ttft_count": len(with_ttft),
        "tpot_mean_s": (sum(r["tpot_s"] for r in requests
                            if r["decode_tokens"])
                        / max(sum(1 for r in requests
                                  if r["decode_tokens"]), 1)),
        "decode_tokens": sum(r["decode_tokens"] for r in requests),
        "preemptions": sum(r["preemptions"] for r in requests),
    }
    return {"requests": requests, "totals": totals}


def _pct(sorted_vals: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile over exact per-request values (the SLI
    table's statistic — not the registry histogram's bucketed
    interpolation, which it is cross-checked against in tests)."""
    if not sorted_vals:
        return None
    idx = max(int(-(-q * len(sorted_vals) // 1)) - 1, 0)
    return sorted_vals[min(idx, len(sorted_vals) - 1)]


def build_sli(report: dict) -> Dict[str, Dict[str, Any]]:
    """Per-finish-reason SLI rollup from a :func:`build_report` result:
    request count plus p50/p99 TTFT and TPOT (seconds; ``None`` when no
    request of that reason carries the statistic — a mid-prefill
    eviction has no TTFT)."""
    by_reason: Dict[str, List[dict]] = {}
    for r in report["requests"]:
        by_reason.setdefault(str(r["finish_reason"] or "unknown"),
                             []).append(r)
    out: Dict[str, Dict[str, Any]] = {}
    for reason, rs in sorted(by_reason.items()):
        ttfts = sorted(r["ttft_s"] for r in rs if r["ttft_s"] is not None)
        tpots = sorted(r["tpot_s"] for r in rs if r["decode_tokens"])
        out[reason] = {
            "requests": len(rs),
            "ttft_p50_s": _pct(ttfts, 0.50), "ttft_p99_s": _pct(ttfts, 0.99),
            "tpot_p50_s": _pct(tpots, 0.50), "tpot_p99_s": _pct(tpots, 0.99),
        }
    return out


def format_sli(sli: Dict[str, Dict[str, Any]]) -> str:
    """Human table for ``trace-report --sli``."""
    lines = ["%-16s %8s %12s %12s %12s %12s"
             % ("finish_reason", "requests", "ttft_p50_ms", "ttft_p99_ms",
                "tpot_p50_ms", "tpot_p99_ms")]

    def ms(v):
        return "%.3f" % (1e3 * v) if v is not None else "-"

    for reason, row in sli.items():
        lines.append("%-16s %8d %12s %12s %12s %12s"
                     % (reason, row["requests"], ms(row["ttft_p50_s"]),
                        ms(row["ttft_p99_s"]), ms(row["tpot_p50_s"]),
                        ms(row["tpot_p99_s"])))
    return "\n".join(lines)


def format_report(report: dict) -> str:
    """Human table for the ``trace-report`` CLI."""
    lines = ["%-4s %-5s %-6s %-9s %-9s %-24s %s"
             % ("rid", "trace", "spans", "ttft_ms", "tpot_ms",
                "queue/prefill/decode/rework", "notes")]
    for r in report["requests"]:
        att = r["attribution"]
        shares = "/".join("%.0f%%" % (100 * att[k])
                          for k in ("queue", "prefill", "decode", "rework"))
        notes = []
        if not r["connected"]:
            notes.append("DISCONNECTED")
        if r["prefix_hit_tokens"]:
            notes.append("prefix_hit=%d" % r["prefix_hit_tokens"])
        if r["preemptions"]:
            notes.append("preempted=%d" % r["preemptions"])
        if r["spec_verify_iterations"]:
            notes.append("spec_iters=%d" % r["spec_verify_iterations"])
        if r["finish_reason"]:
            notes.append(str(r["finish_reason"]))
        ttft = ("%.3f" % (1e3 * r["ttft_s"])
                if r["ttft_s"] is not None else "-")
        lines.append("%-4s %-5d %-6d %-9s %-9.3f %-24s %s"
                     % (r["rid"], r["trace_id"], r["spans"], ttft,
                        1e3 * r["tpot_s"], shares, " ".join(notes)))
    t = report["totals"]
    lines.append("%d request(s), %d request spans + %d engine spans; "
                 "%d preemption(s); trees %s"
                 % (t["requests"], t["spans"], t["engine_spans"],
                    t["preemptions"],
                    "connected" if t["connected"] else "BROKEN"))
    return "\n".join(lines)
