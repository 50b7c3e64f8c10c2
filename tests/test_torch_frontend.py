"""paddle_tpu_torch.serving.ServingFrontend on the CPU (``device="cpu"``),
real HTTP through real sockets, each case against the JAX package where
it has one:

* greedy tokens over HTTP, streamed and buffered, equal the JAX engine's
  through its scheduler on the same weights and prompts (exact);
* the JAX front end and the port's answer one script with the same
  statuses, SSE event keys, ``done`` keys and ``/healthz`` keys;
* a 429 over ``queue_limit`` (counted by ``serving.shed_total``), a
  mid-stream disconnect that frees the slot and its pages refcount-exact
  (499), a guard drain that drops nothing and then answers 503;
* ``/healthz`` reports ``"stalled"`` under a shortened deadline, and a
  scheduler-thread death leaves a flight record and error-done events;
* ``router=`` and ``prefill_engine=`` raise ``NotImplementedError``.

Every socket and wait has a timeout, so a fault fails instead of
hanging."""
import json
import socket
import time

import numpy as np
import pytest
import torch

from paddle_tpu.serving.engine import DecodeEngine as JaxEngine
from paddle_tpu.serving.frontend import ServingFrontend as JaxFrontend
from paddle_tpu.serving.scheduler import \
    ContinuousBatchingScheduler as JaxScheduler
from paddle_tpu.serving.scheduler import Request as JaxRequest
from paddle_tpu_torch.observability import flight, liveness, registry
from paddle_tpu_torch.robustness import PreemptionGuard
from paddle_tpu_torch.robustness.faultpoints import (FaultPlan, Hang, Raise,
                                                     SocketReset, chaos)
from paddle_tpu_torch.serving import (ContinuousBatchingScheduler,
                                      DecodeEngine, Request,
                                      ServingFrontend)
from test_torch_paged import _pair

TIMEOUT = 60.0


def _http(fe, method, path, payload=None, read_all=True):
    """One request; returns (status, head, body), or the open socket when
    ``read_all`` is False."""
    s = socket.create_connection((fe.host, fe.port), timeout=TIMEOUT)
    body = b"" if payload is None else json.dumps(payload).encode()
    s.sendall(b"%s %s HTTP/1.1\r\nHost: t\r\nContent-Type: "
              b"application/json\r\nContent-Length: %d\r\n\r\n"
              % (method.encode(), path.encode(), len(body)) + body)
    if not read_all:
        return s
    raw = _read_all(s)
    head, _, rest = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), head, rest


def _read_all(s):
    raw = b""
    while True:
        chunk = s.recv(65536)
        if not chunk:
            break
        raw += chunk
    s.close()
    return raw


def _events(rest):
    return [json.loads(line[6:]) for line in rest.split(b"\n\n")
            if line.startswith(b"data: ")]


def _gen(prompt, n, **kw):
    return dict({"prompt": [int(t) for t in prompt], "max_new_tokens": n,
                 "temperature": 0.0}, **kw)


def _wait(pred, what):
    t0 = time.perf_counter()
    while not pred():
        assert time.perf_counter() - t0 < TIMEOUT, "timed out: " + what
        time.sleep(0.01)


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.fixture(scope="module")
def engine(pair):
    return DecodeEngine(pair[1], num_slots=2, max_len=64, page_size=8,
                        seed=0, device="cpu")


@pytest.fixture()
def frontend(engine):
    engine.reset()
    fe = ServingFrontend(engine, queue_limit=8)
    fe.start()
    yield fe
    fe.stop()


def _prompts():
    rng = np.random.default_rng(4)
    return [rng.integers(0, 512, (n,)).astype(np.int32)
            for n in (8, 13, 5, 21)]


def test_http_tokens_equal_the_jax_engine_streamed_and_buffered(pair,
                                                                frontend):
    jm, _tm = pair
    prompts = _prompts()
    sched = JaxScheduler(JaxEngine(jm, num_slots=2, max_len=64, page_size=8,
                                   seed=0))
    rids = [sched.submit(JaxRequest(prompt=p, max_new_tokens=6,
                                    temperature=0.0)) for p in prompts]
    res = sched.run()
    want = [res[r].tokens.tolist() for r in rids]
    for i, p in enumerate(prompts):
        status, head, rest = _http(frontend, "POST", "/v1/generate",
                                   _gen(p, 6))
        assert status == 200 and b"text/event-stream" in head
        evs = _events(rest)
        streamed = [t for e in evs if not e.get("done")
                    for t in e["tokens"]]
        done = [e for e in evs if e.get("done")]
        assert len(done) == 1 and done[0]["finish_reason"] == "length"
        assert streamed == done[0]["tokens"] == want[i]
        status, _head, rest = _http(frontend, "POST", "/v1/generate",
                                    _gen(p, 6, stream=False))
        assert status == 200 and json.loads(rest)["tokens"] == want[i]
    assert frontend._open_streams == 0


def _script(fe_cls, engine, shed_engine):
    """A fixed script of requests against a front end of ``fe_cls``:
    each reply as (status, SSE event key sets or JSON key set)."""
    out = []
    fe = fe_cls(engine, queue_limit=8)
    fe.start()
    try:
        for method, path, payload in (
                ("GET", "/healthz", None),
                ("POST", "/v1/generate", _gen([3, 1, 4, 1, 5], 3)),
                ("POST", "/v1/generate", _gen([3, 1, 4], 2, stream=False)),
                ("GET", "/nope", None),
                ("POST", "/v1/generate", {"prompt": []}),
                ("POST", "/v1/generate", {"prompt": list(range(200))}),
                ("POST", "/v1/generate", {"max_new_tokens": 2}),
                ("POST", "/v1/generate", _gen([1, 2], 0))):
            status, head, rest = _http(fe, method, path, payload)
            if b"text/event-stream" in head:
                keys = [sorted(e) for e in _events(rest)]
            else:
                keys = sorted(json.loads(rest))
            out.append((status, keys))
    finally:
        fe.stop()
    shed = fe_cls(shed_engine, queue_limit=0)
    shed.start()
    try:
        status, _head, rest = _http(shed, "POST", "/v1/generate",
                                    _gen([1, 2, 3], 2))
        out.append((status, sorted(json.loads(rest))))
    finally:
        shed.stop()
    return out


def test_replies_match_the_jax_front_end(pair, engine):
    jm, _tm = pair
    jax_engine = JaxEngine(jm, num_slots=2, max_len=64, page_size=8, seed=0)
    engine.reset()
    got = _script(ServingFrontend, engine, engine)
    want = _script(JaxFrontend, jax_engine, jax_engine)
    assert got == want
    assert [st for st, _k in got] == [200, 200, 200, 404, 400, 400, 400,
                                      400, 429]
    assert "done" in got[1][1][-1] and "ttft_ms" in got[1][1][-1]


def test_shed_429_over_queue_limit(engine):
    engine.reset()
    fe = ServingFrontend(engine, queue_limit=0)
    fe.start()
    try:
        shed0 = registry.counter("serving.shed_total").value
        status, _head, rest = _http(fe, "POST", "/v1/generate",
                                    _gen([1, 2, 3], 2))
        assert status == 429 and json.loads(rest)["error"] == "overloaded"
        assert registry.counter("serving.shed_total").value == shed0 + 1
        fe.queue_limit = 8
        status, _head, _rest = _http(fe, "POST", "/v1/generate",
                                     _gen([1, 2, 3], 2))
        assert status == 200
    finally:
        fe.stop()
    assert len(fe.scheduler.finished) == 1     # the shed one never got in


@pytest.mark.parametrize("how", ["client_close", "socket_reset"])
def test_disconnect_frees_slot_and_pages_refcount_exact(engine, how):
    engine.reset()
    fe = ServingFrontend(engine, queue_limit=8)
    fe.start()
    c499 = registry.counter("serving.http_requests",
                            ("code",)).labels(code="499")
    before = c499.value
    # a shared prefix page: the cut request's pages include one that the
    # other request also maps
    shared = list(range(1, 17))
    plan = FaultPlan().inject("serve.stream", SocketReset(), at=1)
    try:
        first = _http(fe, "POST", "/v1/generate", _gen(shared + [40], 2))
        assert first[0] == 200
        if how == "client_close":
            s = _http(fe, "POST", "/v1/generate", _gen(shared + [41], 50),
                      read_all=False)
            buf = b""
            while b"data: " not in buf:    # the request holds a slot
                buf += s.recv(4096)
            s.close()
        else:
            with chaos(plan):
                status, _head, rest = _http(fe, "POST", "/v1/generate",
                                            _gen(shared + [41], 50))
            assert status == 200 and not any(e.get("done")
                                             for e in _events(rest))
        _wait(lambda: engine._alloc.pages_used() == 0
              and not fe.scheduler.has_work(), "pages back")
    finally:
        fe.stop()
    if how == "socket_reset":
        plan.assert_all_fired()
    assert int(engine._alloc.refcount.sum()) == 0
    assert all(a is None for a in fe.scheduler.slots)
    cut = [r for r in fe.scheduler.finished.values()
           if r.finish_reason == "cancelled"]
    assert len(cut) == 1 and c499.value == before + 1
    assert fe._open_streams == 0
    assert engine._alloc.pages_cached() > 0   # the prefix stays cached


def test_cancel_of_a_request_queued_behind_another(pair):
    """The front end's cancel of a waiting request that is not the head
    of the queue: the port removes it by position (comparing Request
    dataclasses field by field raises on two prompt arrays)."""
    eng = DecodeEngine(pair[1], num_slots=1, max_len=64, page_size=8,
                       device="cpu")
    sched = ContinuousBatchingScheduler(eng)
    rids = [sched.submit(Request(prompt=np.arange(1, n, dtype=np.int32),
                                 max_new_tokens=4, temperature=0.0))
            for n in (9, 7, 12)]
    sched.step()
    assert [r.rid for r in sched.waiting] == rids[1:]
    assert sched.cancel(rids[2])
    res = sched.run()
    assert res[rids[2]].finish_reason == "cancelled"
    assert [res[r].finish_reason for r in rids[:2]] == ["length"] * 2


def test_guard_drain_finishes_everything_then_503(engine):
    engine.reset()
    guard = PreemptionGuard(install=False)
    fe = ServingFrontend(engine, queue_limit=8, guard=guard)
    fe.start()
    try:
        socks = [_http(fe, "POST", "/v1/generate", _gen([9, 8, 7, i], 12),
                       read_all=False) for i in range(4)]
        _wait(lambda: json.loads(_http(fe, "GET", "/healthz")[2])[
            "outstanding"] + len(fe.scheduler.finished) >= 4, "accepted")
        guard.set()
        for s in socks:
            evs = _events(_read_all(s).partition(b"\r\n\r\n")[2])
            done = [e for e in evs if e.get("done")]
            assert done and done[0]["finish_reason"] == "length"
            assert len(done[0]["tokens"]) == 12
        assert fe.wait_drained(TIMEOUT)
        assert fe.draining
        status, _head, rest = _http(fe, "POST", "/v1/generate",
                                    _gen([1], 1))
        assert status == 503 and json.loads(rest)["error"] == "draining"
        health = json.loads(_http(fe, "GET", "/healthz")[2])
        assert health["status"] == "draining"
    finally:
        guard.clear()
        fe.stop()


def test_healthz_reports_stalled_under_a_short_deadline(engine,
                                                       monkeypatch):
    monkeypatch.setenv(
        "PADDLE_TPU_LIVENESS_DEADLINE_SERVE_SCHEDULER_STEP", "0.05")
    liveness.enable(start=False)
    try:
        engine.reset()
        fe = ServingFrontend(engine, queue_limit=8)
        fe.start()
        try:
            base = json.loads(_http(fe, "GET", "/healthz")[2])
            assert base["status"] == "ok" and base["stalled"] == []
            assert {"serve.frontend_sched", "serve.frontend_loop",
                    "serve.scheduler_step"} <= set(base["beacons"])
            plan = FaultPlan().inject("serve.step", Hang(3.0), at=0)
            with chaos(plan):
                s = _http(fe, "POST", "/v1/generate", _gen([3, 1, 4], 3),
                          read_all=False)
                stalled = None
                t0 = time.perf_counter()
                while stalled is None and time.perf_counter() - t0 < 10:
                    doc = json.loads(_http(fe, "GET", "/healthz")[2])
                    if doc["status"] == "stalled":
                        stalled = doc
                assert stalled, "healthz never reported the stall"
                assert "serve.scheduler_step" in stalled["stalled"]
                evs = _events(_read_all(s).partition(b"\r\n\r\n")[2])
            plan.assert_all_fired()
            assert [e for e in evs if e.get("done")]
            assert json.loads(_http(fe, "GET", "/healthz")[2])[
                "status"] == "ok"
        finally:
            fe.stop()
    finally:
        liveness.disable()


def test_scheduler_thread_death_leaves_a_flight_record(engine, tmp_path):
    flight.enable(dir=str(tmp_path))
    try:
        engine.reset()
        fe = ServingFrontend(engine, queue_limit=8)
        fe.start()
        plan = FaultPlan().inject(
            "serve.step", Raise(RuntimeError("injected sched death")), at=0)
        with chaos(plan):
            status, _head, rest = _http(fe, "POST", "/v1/generate",
                                        _gen([1, 2, 3], 3))
        plan.assert_all_fired()
        assert status == 200
        done = [e for e in _events(rest) if e.get("done")]
        assert done and done[0]["finish_reason"] == "error"
        doc = json.load(open(flight.last_dump_path()))
        assert doc["trigger"]["kind"] == "thread_exception"
        assert doc["trigger"]["thread"] == "serve-frontend-sched"
        assert "injected sched death" in doc["trigger"]["error"]
        # the engine's summary, from host state alone
        states = [e for e in doc["engines"] if e.get("num_slots") == 2
                  and e.get("paged")]
        assert states and "pages_used" in states[0]
        assert "graph_captures" in states[0]
        with pytest.raises(RuntimeError, match="injected sched death"):
            fe.stop()
    finally:
        flight.disable()


def test_router_and_prefill_engine_raise(engine):
    """Since the fleet and the disaggregated pair are ported, the front
    end serves over both (tests/test_torch_router.py,
    tests/test_torch_disagg.py); what still raises is a misuse of them:
    an engine beside a router, a guard on a fleet, and one engine as both
    roles of a pair."""
    from paddle_tpu_torch.serving import DisaggScheduler, Router
    router = Router([engine], probe_interval=None)
    with pytest.raises(ValueError, match="fleet mode"):
        ServingFrontend(engine, router=router)
    with pytest.raises(ValueError, match="guard"):
        ServingFrontend(router=router, guard=object())
    with pytest.raises(ValueError, match="TWO engines"):
        ServingFrontend(engine, prefill_engine=engine)
    fe = ServingFrontend(router=router)
    assert fe.scheduler is None and router.on_finish == fe._on_finish
    other = DecodeEngine(engine.model, num_slots=engine.num_slots,
                         max_len=engine.max_len,
                         page_size=engine.page_size, device="cpu")
    fe = ServingFrontend(engine, prefill_engine=other)
    assert isinstance(fe.scheduler, DisaggScheduler)


def test_front_end_without_a_device_raises_on_a_cpu_only_machine(pair):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingFrontend(DecodeEngine(pair[1], num_slots=2, max_len=64))
