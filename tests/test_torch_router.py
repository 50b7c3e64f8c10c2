"""paddle_tpu_torch's replicated fleet against ``paddle_tpu``'s, after
``tests/test_router.py``: the crash scope, the replica site and the
routing ladder (affinity to the cache owner, a stale view falling back
to least-loaded then round-robin, a stalling replica routed around), and
failover — a ``HardExit`` crash at a hit index or in a chosen phase, two
kills, a ``Hang`` the probe trips on with its zombie fenced, a graceful
decommission — each with greedy tokens equal to an undisturbed run's and
to the JAX fleet's, requeues counted, the replica rejoining and the
captures of each engine unchanged; the requeue budget ending in
``"failover_limit"``, a cancel during failover, the scheduler's
export/import of requeue state, the remote handle reading the store's
views, and the HTTP front end over ``router=`` dropping no stream
through a kill.  The tiny GPT in f32 on the same numpy weights in both
packages."""
import json
import socket
import threading
import time

import numpy as np
import pytest

from paddle_tpu.serving.engine import DecodeEngine as JaxEngine
from paddle_tpu.serving.router import Router as JaxRouter
from paddle_tpu.serving.scheduler import Request as JaxRequest
from paddle_tpu_torch.distributed.store import TCPStore
from paddle_tpu_torch.observability import aggregate
from paddle_tpu_torch.observability import registry as obs
from paddle_tpu_torch.robustness import faultpoints as fp
from paddle_tpu_torch.serving import (ContinuousBatchingScheduler,
                                      DecodeEngine, NoHealthyReplicas,
                                      RemoteReplicaHandle, Request, Router,
                                      ServingFrontend, prompt_digest_chain)
from paddle_tpu_torch.serving.kv_tier import ClusterPrefixIndex, _hex

from _torch_pair import pair

PROMPTS = [[1, 2, 3, 4], [5, 6, 7, 8], [2, 3, 4, 5], [7, 8, 9, 10]]
MAX_NEW = 12


@pytest.fixture(scope="module")
def models():
    return pair(seed=2)


@pytest.fixture(scope="module")
def engines(models):
    # three engines for the module: routers come and go, engines (and on
    # a card their graphs) stay
    _jm, tm = models
    return [DecodeEngine(tm, num_slots=2, max_len=64, seed=0, page_size=8,
                         device="cpu") for _ in range(3)]


def _collect(router, n):
    lock = threading.Lock()
    toks, results = {}, {}
    done = threading.Event()

    def on_token(rid, t):
        with lock:
            toks.setdefault(rid, []).extend(int(x) for x in t)

    def on_finish(res):
        with lock:
            results[res.rid] = res
            if len(results) == n:
                done.set()

    router.on_token = on_token
    router.on_finish = on_finish
    return toks, results, done


def _drive(router, prompts, max_new=MAX_NEW, timeout=90.0, req=Request):
    """Submit ``prompts`` greedy through a started router and wait for
    all of them; returns (tokens by index, results by index)."""
    toks, results, done = _collect(router, len(prompts))
    rids = [router.submit(req(prompt=np.asarray(p, np.int32),
                              max_new_tokens=max_new, temperature=0.0))
            for p in prompts]
    assert done.wait(timeout), "fleet did not finish %d requests" \
        % len(prompts)
    return ({i: toks.get(rid, []) for i, rid in enumerate(rids)},
            {i: results[rid] for i, rid in enumerate(rids)})


@pytest.fixture(scope="module")
def baseline(engines):
    """Undisturbed greedy tokens of PROMPTS through a one-replica
    fleet."""
    engines[2].reset()
    router = Router([engines[2]], probe_interval=None).start()
    try:
        toks, results = _drive(router, PROMPTS)
    finally:
        router.stop()
    assert all(r.finish_reason == "length" for r in results.values())
    assert all(len(t) == MAX_NEW for t in toks.values())
    return toks


def _reset(engs):
    for e in engs:
        e.reset()


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------

def test_crash_scope_contains_hardexit():
    act = fp.HardExit(rc=7)
    with pytest.raises(fp.CrashScopeExit) as ei:
        with fp.crash_scope():
            act.fire({}, fp.FaultPlan())
    assert ei.value.rc == 7 and not isinstance(ei.value, Exception)


def test_replica_site_declared():
    assert "serve.replica" in fp.SITES


def test_prompt_digest_chain_prefix_property():
    ids = np.arange(1, 33, dtype=np.int32)
    chain = prompt_digest_chain(ids, 8)
    assert len(chain) == 4
    assert prompt_digest_chain(ids[:16], 8) == chain[:2]
    other = prompt_digest_chain(np.r_[ids[:7], 99, ids[8:]], 8)
    assert all(a != b for a, b in zip(chain, other))
    assert prompt_digest_chain(ids[:7], 8) == []


def test_remote_handle_reads_the_store_views():
    """A remote replica's routing view comes from the store: its
    published digests and its telemetry snapshot; intake raises."""
    master = TCPStore("127.0.0.1", 0, is_master=True, world_size=2)
    idx = ClusterPrefixIndex(TCPStore("127.0.0.1", master.port), host=1)
    idx.offer([b"\x05" * 8])
    idx.publish_once()
    aggregate.HostPublisher(TCPStore("127.0.0.1", master.port),
                            host=1).publish_once()
    h = RemoteReplicaHandle(1, TCPStore("127.0.0.1", master.port), 2)
    assert h.state == "remote" and h.snap is None
    h.refresh()
    assert h.view_digests == {(b"\x05" * 8).hex()}
    assert h.snap["host"] == 1 and h.snap_ts is not None
    for call in (h.enqueue_submit, h.enqueue_transfer, h.enqueue_cancel):
        with pytest.raises(NotImplementedError):
            call(None, None)


def test_requeue_state_export_import_round_trip(models):
    """export_requeue_state drains a scheduler mid-run into portable
    records (pages freed refcount-exactly); import_requeue on another
    scheduler resumes each request to the undisturbed tokens."""
    _jm, tm = models
    ps = [np.asarray(p, np.int32) for p in PROMPTS]
    ref = DecodeEngine(tm, num_slots=2, max_len=64, page_size=8,
                       device="cpu")
    sched = ContinuousBatchingScheduler(ref)
    rids = [sched.submit(Request(prompt=p, max_new_tokens=MAX_NEW,
                                 temperature=0.0)) for p in ps]
    want = sched.run()
    a = DecodeEngine(tm, num_slots=2, max_len=64, page_size=8,
                     device="cpu")
    sa = ContinuousBatchingScheduler(a)
    for p, rid in zip(ps, rids):
        sa.submit(Request(prompt=p, max_new_tokens=MAX_NEW,
                          temperature=0.0, rid=rid))
    for _ in range(6):
        sa.step()
    states = sa.export_requeue_state()
    assert sorted(s.req.rid for s in states) == sorted(rids)
    assert any(s.generated for s in states)
    assert not sa.has_work() and a._alloc.pages_used() == 0
    b = DecodeEngine(tm, num_slots=2, max_len=64, page_size=8,
                     device="cpu")
    sb = ContinuousBatchingScheduler(b)
    for st in states:
        sb.import_requeue(st)
    got = sb.run()
    for rid in rids:
        assert got[rid].tokens.tolist() == want[rid].tokens.tolist()


# ---------------------------------------------------------------------------
# the routing ladder
# ---------------------------------------------------------------------------

def test_unstarted_fleet_routes_nothing(engines):
    router = Router(engines[:2], probe_interval=None)
    with pytest.raises(NoHealthyReplicas):
        router._route(np.arange(1, 9, dtype=np.int32))
    with pytest.raises(NoHealthyReplicas):
        router.submit(Request(prompt=np.arange(1, 9, dtype=np.int32),
                              max_new_tokens=4, temperature=0.0))


def test_submit_validates_before_routing(engines):
    _reset(engines[:2])
    router = Router(engines[:2], probe_interval=None).start()
    try:
        for bad in (dict(prompt=np.asarray([], np.int32)),
                    dict(prompt=np.arange(1000, dtype=np.int32)),
                    dict(prompt=np.arange(1, 5, dtype=np.int32),
                         max_new_tokens=0)):
            with pytest.raises(ValueError):
                router.submit(Request(**dict(dict(max_new_tokens=4),
                                             **bad)))
        assert router.flights() == 0
    finally:
        router.stop()


def test_affinity_routes_to_cache_owner(engines):
    """After one replica served a prompt, the probe's view of its pages
    routes the same prefix (and a longer prompt sharing it) back to that
    owner; an unrelated prompt makes no affinity claim."""
    _reset(engines[:2])
    router = Router(engines[:2], probe_interval=None).start()
    try:
        warm = np.arange(1, 17, dtype=np.int32)
        _drive(router, [warm], max_new=4)
        router.probe_once()
        chain0 = prompt_digest_chain(warm, 8)[0]
        owners = [i for i, e in enumerate(engines[:2])
                  if _hex(chain0) in e.prefix_digest_snapshot()]
        assert len(owners) == 1
        r, reason = router._route(warm)
        assert reason == "affinity" and r.idx == owners[0]
        r, reason = router._route(np.r_[warm, 40, 41, 42])
        assert reason == "affinity" and r.idx == owners[0]
        _, reason = router._route(np.arange(100, 116, dtype=np.int32))
        assert reason == "least_loaded"
        routed = obs.counter("router.routed", ("reason",))
        assert routed.labels(reason="least_loaded").value >= 1
    finally:
        router.stop()


def test_stale_view_degrades_to_least_loaded(engines):
    _reset(engines[:2])
    router = Router(engines[:2], probe_interval=None,
                    snapshot_ttl=0.5).start()
    try:
        warm = np.arange(1, 17, dtype=np.int32)
        _drive(router, [warm], max_new=4)
        router.probe_once()
        assert router._route(warm)[1] == "affinity"
        for r in router.replicas:
            r.view_ts = time.monotonic() - 99.0
        target, reason = router._route(warm)
        assert reason == "least_loaded" and target.state == "healthy"
        for r in router.replicas:
            r.snap_ts = time.monotonic() - 99.0
        seen = {router._route(warm)[0].idx for _ in range(4)}
        assert seen == {0, 1}            # the blackout round-robin
    finally:
        router.stop()


def test_stalling_replica_routed_around_before_death(engines):
    _reset(engines[:2])
    router = Router(engines[:2], probe_interval=None,
                    stall_deadline=30.0).start()
    try:
        now = time.monotonic()
        r0, r1 = router.replicas
        r0.snap = {"queue_depth": 3, "slots_active": 2, "busy": True,
                   "beacon_age_s": 20.0}
        r0.snap_ts = now
        r1.snap = {"queue_depth": 5, "slots_active": 2,
                   "beacon_age_s": 0.0}
        r1.snap_ts = now
        target, reason = router._route(np.arange(1, 9, dtype=np.int32))
        assert reason == "least_loaded" and target.idx == 1
        assert router.replica_states() == ["healthy", "healthy"]
    finally:
        router.stop()


# ---------------------------------------------------------------------------
# failover
# ---------------------------------------------------------------------------

def test_undisturbed_fleet_equals_jax_fleet(models, baseline):
    """The port's fleet and the JAX package's fleet (two replicas each)
    give the same greedy tokens."""
    jm, _tm = models
    jengines = [JaxEngine(jm, num_slots=2, max_len=64, seed=0, page_size=8)
                for _ in range(2)]
    router = JaxRouter(jengines, probe_interval=None, overlap=False)
    router.start()
    try:
        toks, results = _drive(router, PROMPTS, req=JaxRequest)
    finally:
        router.stop()
    assert toks == baseline
    assert all(r.finish_reason == "length" for r in results.values())


def _when(base):
    """``base`` (a HardExit or Hang class of either package) fired once,
    at the first ``serve.replica`` hit whose context satisfies ``pred``:
    the fault lands in a chosen state of a replica, not at a hit index
    that idle iterations also advance.  Injected with ``every=1``."""
    class When(base):
        def __init__(self, pred, *args):
            super().__init__(*args)
            self.pred = pred
            self.fired_once = False
            self._lk = threading.Lock()

        def fire(self, ctx, plan):
            with self._lk:
                if self.fired_once or not self.pred(ctx):
                    return
                self.fired_once = True
            super().fire(ctx, plan)
    return When


_KillWhen = _when(fp.HardExit)
_HangWhen = _when(fp.Hang)


def _captures(engs):
    return [e.graph_stats()["captures"] for e in engs]


def test_hardexit_failover_bit_identical(engines, baseline):
    """A replica crashes mid-stream: every request it held requeues onto
    the survivor and finishes with the undisturbed tokens; the dead
    replica respawns and rejoins on its own engine."""
    _reset(engines[:2])
    router = Router(engines[:2], respawn_delay=0.05,
                    healthy_interval=0.2, probe_interval=0.05).start()
    f0 = obs.counter("router.failovers").value
    c0 = _captures(engines[:2])
    try:
        kill = _KillWhen(_victim_mid_decode)
        plan = fp.FaultPlan().inject("serve.replica", kill, every=1)
        with fp.chaos(plan):
            toks, results = _drive(router, PROMPTS)
        assert kill.fired_once
        assert obs.counter("router.failovers").value == f0 + 1
        for i in range(len(PROMPTS)):
            assert results[i].finish_reason == "length"
            assert toks[i] == baseline[i]
            assert [int(t) for t in results[i].tokens] == baseline[i]
        deadline = time.monotonic() + 10
        while (router.healthy_count() < 2
               and time.monotonic() < deadline):
            time.sleep(0.02)
        assert router.replica_states() == ["healthy", "healthy"]
        assert _captures(engines[:2]) == c0
    finally:
        router.stop()


def _victim_mid_prefill(ctx):
    return len(ctx["scheduler"].waiting) > 0


def _victim_mid_decode(ctx):
    return any(a is not None and len(a.generated) >= 2
               for a in ctx["scheduler"].slots)


@pytest.mark.parametrize("pred", [_victim_mid_prefill, _victim_mid_decode],
                         ids=["mid_prefill", "mid_decode"])
def test_kill_victim_by_phase_bit_identical(engines, baseline, pred):
    _reset(engines[:2])
    router = Router(engines[:2], respawn_delay=0.05,
                    healthy_interval=0.2, probe_interval=0.05).start()
    try:
        act = _KillWhen(pred)
        plan = fp.FaultPlan().inject("serve.replica", act, every=1)
        with fp.chaos(plan):
            toks, results = _drive(router, PROMPTS)
        assert act.fired_once
        for i in range(len(PROMPTS)):
            assert results[i].finish_reason == "length"
            assert toks[i] == baseline[i]
    finally:
        router.stop()


def test_double_kill_respects_requeue_budget(engines, baseline):
    _reset(engines[:3])
    router = Router(engines[:3], respawn_delay=0.05,
                    healthy_interval=0.2, probe_interval=0.05,
                    max_requeues=3).start()
    f0 = obs.counter("router.failovers").value
    try:
        # replica 0 dies holding a request; then replica 1 dies decoding
        # (perhaps a request replica 0's death moved to it)
        first = _KillWhen(lambda ctx: ctx["replica"] == 0 and any(
            a is not None for a in ctx["scheduler"].slots))
        second = _KillWhen(lambda ctx: first.fired_once
                           and ctx["replica"] == 1
                           and _victim_mid_decode(ctx))
        plan = fp.FaultPlan()
        plan.inject("serve.replica", first, every=1)
        plan.inject("serve.replica", second, every=1)
        with fp.chaos(plan):
            toks, results = _drive(router, PROMPTS)
        assert first.fired_once and second.fired_once
        assert obs.counter("router.failovers").value == f0 + 2
        for i in range(len(PROMPTS)):
            assert results[i].finish_reason == "length"
            assert toks[i] == baseline[i]
    finally:
        router.stop()


def test_requeue_budget_exhaustion_finishes_failover_limit(engines):
    """max_requeues=0: a crash victim finishes "failover_limit" with its
    delivered tokens, never a silent drop."""
    engines[0].reset()
    router = Router([engines[0]], probe_interval=None,
                    max_requeues=0).start()
    try:
        kill = _KillWhen(_victim_mid_decode)
        plan = fp.FaultPlan().inject("serve.replica", kill, every=1)
        with fp.chaos(plan):
            toks, results = _drive(router, PROMPTS, timeout=30.0)
        assert kill.fired_once
        reasons = {results[i].finish_reason for i in range(len(PROMPTS))}
        assert "failover_limit" in reasons
        assert reasons <= {"failover_limit", "length"}
        for i in range(len(PROMPTS)):
            assert [int(t) for t in results[i].tokens] == toks[i]
    finally:
        router.stop()


def test_hang_failover_probe_trips_and_zombie_is_fenced(engines,
                                                        baseline):
    """A wedged replica: the probe trips on its aging beacon and fails
    its streams over; the zombie thread wakes into a bumped epoch and
    leaves the replacement alone."""
    _reset(engines[:2])
    router = Router(engines[:2], probe_interval=None, stall_deadline=0.4,
                    respawn_delay=0.05, healthy_interval=0.2).start()
    f0 = obs.counter("router.failovers").value
    try:
        hang = _HangWhen(_victim_mid_decode, 1.5)
        plan = fp.FaultPlan().inject("serve.replica", hang, every=1)
        with fp.chaos(plan):
            toks, results, done = _collect(router, len(PROMPTS))
            rids = [router.submit(Request(
                prompt=np.asarray(p, np.int32), max_new_tokens=MAX_NEW,
                temperature=0.0)) for p in PROMPTS]
            deadline = time.monotonic() + 30
            while not done.is_set() and time.monotonic() < deadline:
                router.probe_once()
                time.sleep(0.05)
            assert done.is_set()
        assert hang.fired_once
        assert obs.counter("router.failovers").value == f0 + 1
        for i, rid in enumerate(rids):
            assert results[rid].finish_reason == "length"
            assert toks[rid] == baseline[i]
        time.sleep(1.2)
        deadline = time.monotonic() + 10
        while (router.healthy_count() < 2
               and time.monotonic() < deadline):
            router.probe_once()
            time.sleep(0.05)
        assert router.replica_states() == ["healthy", "healthy"]
        _drive(router, [[3, 1, 4, 1]], max_new=4)
    finally:
        router.stop()


def test_decommission_exports_streams_to_survivor(engines, baseline):
    _reset(engines[:2])
    router = Router(engines[:2], probe_interval=None).start()
    try:
        toks, results, done = _collect(router, len(PROMPTS))
        first = threading.Event()
        inner = router.on_token

        def on_token(rid, t):
            inner(rid, t)
            first.set()

        router.on_token = on_token
        rids = [router.submit(Request(prompt=np.asarray(p, np.int32),
                                      max_new_tokens=MAX_NEW,
                                      temperature=0.0))
                for p in PROMPTS]
        assert first.wait(30)
        with router._lock:
            owners = {fl.replica for fl in router._flights.values()}
        victim = min(owners)
        router.decommission(victim)
        assert done.wait(60)
        for i, rid in enumerate(rids):
            assert results[rid].finish_reason == "length"
            assert toks[rid] == baseline[i]
        states = router.replica_states()
        assert states[victim] == "stopped" and "healthy" in states
        _drive(router, [[9, 9, 9, 9]], max_new=4)
    finally:
        router.stop()


def test_cancel_during_failover_finishes_cancelled(engines):
    """A rid cancelled just as its replica dies comes back "cancelled",
    not resumed on the survivor."""
    _reset(engines[:2])
    router = Router(engines[:2], probe_interval=None,
                    max_requeues=3).start()
    try:
        results = {}
        done = threading.Event()

        def on_finish(res):
            results[res.rid] = res
            done.set()

        router.on_finish = on_finish
        rid = router.submit(Request(prompt=np.asarray(PROMPTS[0], np.int32),
                                    max_new_tokens=MAX_NEW,
                                    temperature=0.0))
        with router._lock:
            fl = router._flights[rid]
            fl.cancelled = True
            owner = router.replicas[fl.replica]
        router._replica_died(owner, "crash")
        assert done.wait(30)
        assert results[rid].finish_reason == "cancelled"
        assert router.cancel(rid) is False
    finally:
        router.stop()


# ---------------------------------------------------------------------------
# the HTTP front end over a fleet
# ---------------------------------------------------------------------------

def _fleet_get(host, port, path):
    s = socket.create_connection((host, port), timeout=10)
    s.sendall(b"GET %s HTTP/1.1\r\nHost: t\r\n\r\n" % path)
    buf = b""
    while True:
        b = s.recv(65536)
        if not b:
            break
        buf += b
    s.close()
    return json.loads(buf.partition(b"\r\n\r\n")[2])


def _fleet_post(host, port, payload):
    s = socket.create_connection((host, port), timeout=60)
    body = json.dumps(payload).encode()
    s.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: t\r\n"
              b"Content-Length: %d\r\n\r\n" % len(body) + body)
    buf = b""
    while True:
        b = s.recv(65536)
        if not b:
            break
        buf += b
    s.close()
    head, _, rest = buf.partition(b"\r\n\r\n")
    events = [json.loads(line[6:]) for line in rest.split(b"\n\n")
              if line.startswith(b"data: ")]
    return int(head.split()[1]), events


def test_fleet_frontend_kill_mid_drive_drops_no_stream(engines, baseline):
    """SSE streams ride through a replica kill: every stream completes
    with the undisturbed tokens, and /healthz shows the fleet."""
    _reset(engines[:2])
    router = Router(engines[:2], respawn_delay=0.05, healthy_interval=0.2,
                    probe_interval=0.05)
    with pytest.raises(ValueError, match="fleet mode"):
        ServingFrontend(engines[0], router=router)
    fe = ServingFrontend(router=router, queue_limit=16)
    host, port = fe.start()
    try:
        doc = _fleet_get(host, port, b"/healthz")
        assert doc["replicas_healthy"] == 2
        assert doc["replicas"] == ["healthy", "healthy"]
        kill = _KillWhen(_victim_mid_decode)
        plan = fp.FaultPlan().inject("serve.replica", kill, every=1)
        outs = [None] * len(PROMPTS)

        def drive(i):
            outs[i] = _fleet_post(host, port, {
                "prompt": PROMPTS[i], "max_new_tokens": MAX_NEW,
                "temperature": 0.0})

        with fp.chaos(plan):
            ths = [threading.Thread(target=drive, args=(i,))
                   for i in range(len(PROMPTS))]
            for t in ths:
                t.start()
            for t in ths:
                t.join(60)
        assert kill.fired_once
        for i, (status, events) in enumerate(outs):
            assert status == 200
            dones = [e for e in events if e.get("done")]
            assert len(dones) == 1
            assert dones[0]["finish_reason"] == "length"
            got = [t for e in events if "tokens" in e
                   and not e.get("done") for t in e["tokens"]]
            assert got == baseline[i]
        fe.drain()
        assert fe.wait_drained(10)
    finally:
        fe.stop()
