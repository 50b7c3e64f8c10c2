"""paddle_tpu_torch's host KV tier against ``paddle_tpu``'s, after
``tests/test_kv_tier.py``: the LRU's byte honesty, the npz staging
transport (bit for bit, torn and bit-flipped reads surfacing as transport
errors), spill -> device eviction -> host fetch -> resume with greedy
tokens equal to the JAX tiered engine's and to the port's tier-off
engine (int8 and speculative decoding composed), the repeat admission as
one 1-token chunk, a fetch interleaved with decode, torn fetches
recomputing to the same tokens, a cancel during a fetch, the allocator's
``adopt_page`` / ``evict_cached`` against the JAX allocator, and the
cluster prefix index over a loopback TCPStore (both packages' stores
and indexes reading each other), with its evict hook outside the tier's
lock and a wedged store that never stalls a spill.  The tiny GPT in f32
on the same numpy weights in both packages."""
import json
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu.distributed.store import TCPStore as JaxStore
from paddle_tpu.serving.engine import DecodeEngine as JaxEngine
from paddle_tpu.serving.kv_tier import ClusterPrefixIndex as JaxIndex
from paddle_tpu.serving.kv_tier import HostPageTier as JaxTier
from paddle_tpu.serving.kv_tier import fetch_index as jax_fetch_index
from paddle_tpu.serving.pages import PageAllocator as JaxAllocator
from paddle_tpu.serving.scheduler import \
    ContinuousBatchingScheduler as JaxScheduler
from paddle_tpu.serving.scheduler import Request as JaxRequest
from paddle_tpu_torch.distributed.store import TCPStore
from paddle_tpu_torch.observability import flight
from paddle_tpu_torch.observability import registry as obs
from paddle_tpu_torch.observability.liveness import BEACONS
from paddle_tpu_torch.robustness.faultpoints import (SITES, BitFlip,
                                                     FaultPlan, TornFile,
                                                     chaos)
from paddle_tpu_torch.serving import (ContinuousBatchingScheduler,
                                      DecodeEngine, PageAllocator, Request)
from paddle_tpu_torch.serving.kv_tier import (TRANSPORT_ERRORS,
                                              ClusterPrefixIndex,
                                              HostPageTier, fetch_index,
                                              npz_roundtrip)

from _torch_pair import drive, pair, prompts

BUDGET = 16 << 20


@pytest.fixture(scope="module")
def models():
    return pair(seed=3)


def _engine(tm, tier=True, **kw):
    kw.setdefault("num_slots", 3)
    kw.setdefault("max_len", 128)
    kw.setdefault("page_size", 16)
    # kv_host_bytes=0 pins the tier off whatever the env says
    return DecodeEngine(tm, seed=0, device="cpu",
                        kv_host_bytes=BUDGET if tier else 0, **kw)


def _drive(eng, ps, max_new=6):
    return drive(ContinuousBatchingScheduler(eng), Request, ps, max_new)[0]


def _arrays(nbytes):
    return {"k": np.zeros(nbytes, np.uint8)}


# ---------------------------------------------------------------------------
# the tier and its transport, host-side
# ---------------------------------------------------------------------------

def test_host_tier_lru_budget_honesty():
    """The same operations on the port's tier and the JAX package's leave
    the same entries, bytes and counters."""
    tiers = (HostPageTier(budget_bytes=1000), JaxTier(budget_bytes=1000))
    for tier in tiers:
        assert tier.enabled and len(tier) == 0 and tier.bytes_used() == 0
        assert tier.put("a", _arrays(400)) and tier.put("b", _arrays(400))
        assert tier.bytes_used() == 800 and len(tier) == 2
        assert tier.put("c", _arrays(400))     # evicts the oldest, a
        assert "a" not in tier and "b" in tier and "c" in tier
        assert tier.get("b") is not None       # b becomes the hottest
        assert tier.put("d", _arrays(400))
        assert "c" not in tier and "b" in tier
        before = tier.digests()
        assert not tier.put("huge", _arrays(2000))   # refused, none evicted
        assert tier.digests() == before
        tier.discard("b")
        assert tier.bytes_used() == 400
    assert tiers[0].state() == tiers[1].state()
    assert tiers[0].digests() == tiers[1].digests()
    st = tiers[0].state()
    assert st["spilled"] == 4 and st["lru_evicted"] == 2
    tiers[0].clear()
    assert tiers[0].bytes_used() == 0 and len(tiers[0]) == 0
    off = HostPageTier(budget_bytes=0)
    assert not off.enabled and not off.put("a", _arrays(8))
    assert off.get("a") is None


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn,
                                   torch.int8, torch.float32])
def test_npz_roundtrip_is_bit_exact(dtype):
    """Torch tensors of dtypes numpy lacks cross the staging file as
    their bytes and come back bit for bit, in dtype and shape."""
    g = torch.Generator().manual_seed(0)
    k = (torch.randn((2, 3, 4, 2, 8), generator=g) * 3).to(dtype)
    v = (torch.randn((2, 3, 4, 2, 8), generator=g) * 3).to(dtype)
    s = torch.rand((2, 3, 4, 2), generator=g)
    out = npz_roundtrip((k, v, s, None), "serve.kv_tier")
    assert out[3] is None
    for a, b in zip((k, v, s), out[:3]):
        assert b.dtype == a.dtype and b.shape == a.shape
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.parametrize("action", [TornFile, BitFlip],
                         ids=["torn", "bitflip"])
def test_torn_staging_read_is_a_transport_error(action):
    k = torch.arange(4096, dtype=torch.float32).reshape(4, 1024)
    with chaos(FaultPlan().inject("serve.kv_tier", action(), at=0)):
        with pytest.raises(TRANSPORT_ERRORS):
            npz_roundtrip((k, k, None, None), "serve.kv_tier")


def test_chaos_site_and_beacon_declared():
    assert "serve.kv_tier" in SITES and "serve.kv_tier" in BEACONS


def test_allocator_adopt_and_evict_match_jax():
    """adopt_page and evict_cached, beside a reclaim that spills, leave
    the port's allocator in the JAX allocator's state, and the spill hook
    sees the same pages and digests."""
    states, spills = [], []
    for cls in (PageAllocator, JaxAllocator):
        al = cls(num_pages=4, num_slots=2, max_pages=4, page_size=4)
        seen = []
        al.spill_hook = lambda pid, d, seen=seen: seen.append(
            (pid, sorted(d)))
        ids = np.arange(8, dtype=np.int32)
        for i in range(2):
            al.map(0, i, al.alloc())
        al.register_prefix(0, ids)
        al.free_slot(0)                          # both pages cached
        pid = al.alloc()
        al.adopt_page(pid, [b"x" * 8])            # fetched page, cached
        al.evict_cached(pid)
        for _ in range(3):                        # drains free, reclaims
            al.alloc()
        states.append((al.refcount.tolist(), list(al._free),
                       list(al._cached), sorted(al._hash_to_page.items())))
        spills.append(seen)
    assert states[0] == states[1]
    assert spills[0] == spills[1] and spills[0]


# ---------------------------------------------------------------------------
# spill -> evict -> fetch -> resume: tokens against JAX and the tier off
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(kv_dtype="int8"), dict(spec_k=2),
                                dict(spec_k=2, kv_dtype="int8")],
                         ids=["plain", "int8", "spec", "spec_int8"])
def test_spill_fetch_greedy_parity_with_jax(models, kw):
    """Wave 1 fills the device prefix cache; spill_cached_pages pushes
    every cached page to host RAM; wave 2 admits the same prompts
    through the host tier.  Both waves' greedy tokens equal the port's
    tier-off engine's and the JAX tiered engine's waves."""
    jm, tm = models
    ps = prompts(4, seed=1)
    baseline = _drive(_engine(tm, tier=False, **kw), ps)
    eng = _engine(tm, **kw)
    hits = obs.counter("serving.kv_host_hits")
    wave1 = _drive(eng, ps)
    spilled = eng.spill_cached_pages()
    assert spilled > 0 and eng.kv_host_bytes_used() > 0
    h0 = hits.value
    wave2 = _drive(eng, ps)
    assert wave1 == baseline and wave2 == baseline
    assert hits.value > h0
    assert eng._alloc.pages_used() == 0
    je = JaxEngine(jm, seed=0, num_slots=3, max_len=128, page_size=16,
                   kv_host_bytes=BUDGET, **kw)
    jw1 = drive(JaxScheduler(je, overlap=False), JaxRequest, ps)[0]
    assert je.spill_cached_pages() == spilled
    jw2 = drive(JaxScheduler(je, overlap=False), JaxRequest, ps)[0]
    assert jw1 == wave1 and jw2 == wave2


def test_repeat_admission_is_full_prefix_hit(models):
    """A repeat prompt that misses the device cache but hits the host
    tier runs ONE prefill chunk (the final 1-token chunk); kv_host_hits
    counts the landed pages and the fetch histogram one fetch."""
    _jm, tm = models
    p = prompts(1, seed=3, plen=(40, 41))[0]
    eng = _engine(tm)
    chunks = obs.histogram("serving.prefill_chunk_seconds")
    hits = obs.counter("serving.kv_host_hits")
    fetch_s = obs.histogram("serving.kv_tier_fetch_seconds")
    wave1 = _drive(eng, [p])
    assert eng.spill_cached_pages() > 0
    c0, h0, f0 = chunks.count, hits.value, fetch_s.count
    wave2 = _drive(eng, [p])
    assert wave2 == wave1
    assert chunks.count - c0 == 1
    assert hits.value - h0 == 3                 # 40 tokens: 2 full + tail
    assert fetch_s.count - f0 == 1
    assert obs.gauge("serving.kv_host_bytes").value == \
        eng.kv_host_bytes_used()


def test_fetch_interleaves_with_decode(models):
    """While request B's pages come back from the tier (several chunks,
    several iterations), request A keeps generating."""
    _jm, tm = models
    pb = prompts(1, seed=4, plen=(96, 97))[0]
    pa = prompts(1, seed=5, plen=(24, 25))[0]
    eng = _engine(tm)
    wave1 = _drive(eng, [pb])
    assert eng.spill_cached_pages() > 0
    sched = ContinuousBatchingScheduler(eng)
    ra = sched.submit(Request(prompt=pa.copy(), max_new_tokens=24,
                              temperature=0.0))
    rb = sched.submit(Request(prompt=pb.copy(), max_new_tokens=6,
                              temperature=0.0))
    during = []
    while sched.has_work():
        sched.step()
        if rb in sched._fetches:
            a = next((s for s in sched.slots
                      if s is not None and s.req.rid == ra), None)
            during.append(0 if a is None else len(a.generated))
    assert len(during) >= 2 and during[-1] > during[0]
    assert tuple(int(t) for t in sched.finished[rb].tokens) == wave1[0]
    assert len(sched.finished[ra].tokens) == 24
    assert eng._alloc.pages_used() == 0


# ---------------------------------------------------------------------------
# torn fetches recompute; cancel mid-fetch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("action", [TornFile, BitFlip],
                         ids=["torn", "bitflip"])
def test_chaos_torn_fetch_degrades_to_recompute(models, action, tmp_path):
    """A torn staging read at ``serve.kv_tier``: the fetch aborts, its
    digests leave the tier, pages free refcount-exactly, the flight
    recorder dumps, and the request completes by recompute with the same
    greedy tokens."""
    _jm, tm = models
    p = prompts(1, seed=7, plen=(40, 41))[0]
    eng = _engine(tm)
    hits = obs.counter("serving.kv_host_hits")
    wave1 = _drive(eng, [p])
    assert eng.spill_cached_pages() > 0
    rec = flight.enable(dir=str(tmp_path))
    h0 = hits.value
    try:
        plan = FaultPlan().inject("serve.kv_tier", action(), at=0)
        with chaos(plan):
            wave2 = _drive(eng, [p])
        plan.assert_all_fired()
    finally:
        flight.disable()
    assert wave2 == wave1
    assert hits.value == h0
    assert eng._alloc.pages_used() == 0
    dump = json.loads(open(rec.dumps[-1]).read())
    assert dump["trigger"]["kind"] == "kv_tier_abort"
    assert _drive(eng, [p]) == wave1


def test_chaos_persistent_tear_still_completes(models):
    _jm, tm = models
    ps = prompts(2, seed=8)
    eng = _engine(tm)
    wave1 = _drive(eng, ps)
    assert eng.spill_cached_pages() > 0
    plan = FaultPlan().inject("serve.kv_tier", TornFile(), every=1)
    with chaos(plan):
        wave2 = _drive(eng, ps)
    plan.assert_all_fired()
    assert wave2 == wave1 and eng._alloc.pages_used() == 0


def test_import_tear_releases_pages_and_recomputes(models):
    """A raise out of ``import_pages`` after a clean staging releases the
    fresh destination pages and recomputes."""
    _jm, tm = models
    p = prompts(1, seed=21, plen=(40, 41))[0]
    eng = _engine(tm)
    wave1 = _drive(eng, [p])
    assert eng.spill_cached_pages() > 0
    calls = {"n": 0}

    def torn(bufs, pids):
        calls["n"] += 1
        raise RuntimeError("injected import tear")

    eng.import_pages = torn
    wave2 = _drive(eng, [p])
    assert calls["n"] >= 1 and wave2 == wave1
    assert eng._alloc.pages_used() == 0
    del eng.import_pages
    assert _drive(eng, [p]) == wave1


def test_cancel_during_fetch_finishes_cancelled(models):
    """A request cancelled while its pages come back finishes
    ``"cancelled"`` with no tokens; pages already adopted stay cached
    content and the pool is whole."""
    _jm, tm = models
    pb = prompts(1, seed=4, plen=(96, 97))[0]
    eng = _engine(tm)
    wave1 = _drive(eng, [pb])
    assert eng.spill_cached_pages() > 0
    seen = []
    sched = ContinuousBatchingScheduler(eng, on_finish=seen.append)
    rb = sched.submit(Request(prompt=pb.copy(), max_new_tokens=6,
                              temperature=0.0))
    while rb not in sched._fetches:
        sched.step()
    sched.step()
    assert rb in sched._fetches and sched.cancel(rb)
    assert rb not in sched._fetches and not sched.has_work()
    res = sched.finished[rb]
    assert res.finish_reason == "cancelled" and res.tokens.size == 0
    assert [r.rid for r in seen] == [rb]
    assert eng._alloc.pages_used() == 0
    assert _drive(eng, [pb]) == wave1


# ---------------------------------------------------------------------------
# the engine's tier state
# ---------------------------------------------------------------------------

def test_tier_off_is_inert(models):
    _jm, tm = models
    eng = _engine(tm, tier=False)
    assert eng._host_tier is None and eng.kv_host_bytes_used() == 0
    assert eng.host_fetch_plan(np.arange(40, dtype=np.int32)) == []
    with pytest.raises(RuntimeError, match="host tier"):
        eng.spill_cached_pages()
    assert "kv_host" not in eng.flight_state()
    assert all(len(t) == 6 for t in _drive(eng, prompts(2, seed=9)))


def test_budget_from_the_environment(models, monkeypatch):
    _jm, tm = models
    monkeypatch.setenv("PADDLE_TPU_KV_HOST_BYTES", str(1 << 20))
    eng = DecodeEngine(tm, num_slots=2, max_len=64, page_size=16,
                       device="cpu")
    assert eng._host_tier.budget_bytes == 1 << 20
    monkeypatch.setenv("PADDLE_TPU_KV_HOST_BYTES", "lots")
    eng = DecodeEngine(tm, num_slots=2, max_len=64, page_size=16,
                       device="cpu")
    assert eng._host_tier is None


def test_flight_state_carries_host_tier(models):
    _jm, tm = models
    eng = _engine(tm)
    _drive(eng, prompts(2, seed=10))
    assert eng.spill_cached_pages() > 0
    st = eng.flight_state()["kv_host"]
    assert st["entries"] > 0 and st["bytes"] == eng.kv_host_bytes_used()
    assert st["budget_bytes"] == BUDGET
    assert obs.counter("serving.kv_host_spilled_pages").value > 0


def test_refresh_state_clears_stale_tier(models):
    """A changed parameter clears the host tier too: its rows were
    computed under the old weights."""
    _jm, tm = models
    eng = _engine(tm)
    _drive(eng, prompts(2, seed=11))
    assert eng.spill_cached_pages() > 0
    w = tm.gpt.wte.weight
    with torch.no_grad():
        w.mul_(1.0)                   # bumps the version counter
    assert eng.refresh_state()
    assert eng.kv_host_bytes_used() == 0
    assert obs.gauge("serving.kv_host_bytes").value == 0


def test_kv_tier_span_keeps_request_tree_connected(models):
    from paddle_tpu_torch.observability.tracing import Tracer, build_report
    _jm, tm = models
    p = prompts(1, seed=12, plen=(40, 41))[0]
    tr = Tracer()
    eng = _engine(tm, tracer=tr)
    for _ in range(2):
        sched = ContinuousBatchingScheduler(eng, tracer=tr)
        sched.submit(Request(prompt=p.copy(), max_new_tokens=4,
                             temperature=0.0))
        sched.run()
        eng.spill_cached_pages()
    rep = build_report(tr.spans(), tr.instants())
    assert rep["totals"]["connected"]
    spans = tr.spans()
    by_id = {s["span_id"]: s for s in spans}
    kvt = [s for s in spans if s["name"] == "kv_tier"]
    assert len(kvt) == 1
    assert by_id[kvt[0]["parent_id"]]["name"] == "request"
    assert kvt[0]["attrs"].get("pages", 0) > 0


# ---------------------------------------------------------------------------
# the cluster prefix index over a loopback TCPStore
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("master_pkg,client_pkg",
                         [("torch", "torch"), ("jax", "torch"),
                          ("torch", "jax")])
def test_cluster_index_roundtrip_two_hosts(master_pkg, client_pkg):
    """Two publishers round-trip their digest sets through one store
    master; a withdrawn digest disappears at the next publish; a host
    that never published is absent.  Either package's index and store
    on either side."""
    stores = {"torch": TCPStore, "jax": JaxStore}
    index = {"torch": ClusterPrefixIndex, "jax": JaxIndex}
    fetch = {"torch": fetch_index, "jax": jax_fetch_index}
    master = stores[master_pkg]("127.0.0.1", 0, is_master=True,
                                world_size=1)
    Store, Index = stores[client_pkg], index[client_pkg]
    i0 = Index(Store("127.0.0.1", master.port), host=0)
    i1 = Index(Store("127.0.0.1", master.port), host=1)
    i0.offer([b"\x01" * 8, b"\x02" * 8])
    i1.offer([b"\x03" * 8])
    i0.publish_once()
    i1.publish_once()
    reader = fetch[master_pkg]
    idx = reader(stores[master_pkg]("127.0.0.1", master.port), 3)
    assert set(idx) == {0, 1}
    assert idx[0] == {(b"\x01" * 8).hex(), (b"\x02" * 8).hex()}
    assert idx[1] == {(b"\x03" * 8).hex()}
    i0.withdraw([b"\x01" * 8])
    i0.publish_once()
    idx = reader(stores[master_pkg]("127.0.0.1", master.port), 2)
    assert idx[0] == {(b"\x02" * 8).hex()}


def test_cluster_index_publisher_thread():
    master = TCPStore("127.0.0.1", 0, is_master=True, world_size=1)
    idx = ClusterPrefixIndex(TCPStore("127.0.0.1", master.port), host=4,
                             interval=0.02)
    idx.offer([b"\xaa" * 8])
    idx.start()
    deadline = time.time() + 5.0
    while idx.published < 2 and time.time() < deadline:
        time.sleep(0.01)
    idx.stop()                       # publishes the exit snapshot too
    assert idx.published >= 2
    got = fetch_index(TCPStore("127.0.0.1", master.port), 5)
    assert got[4] == {(b"\xaa" * 8).hex()}


def test_engine_attach_cluster_index_offers_and_withdraws(models):
    """Prefill registrations and spills offer their digests; a parameter
    change withdraws what the tier held."""
    _jm, tm = models
    master = TCPStore("127.0.0.1", 0, is_master=True, world_size=1)
    eng = _engine(tm)
    eng.attach_cluster_index(TCPStore("127.0.0.1", master.port), host=0,
                             start=False)
    assert eng._host_tier.evict_hook == eng._kv_index.withdraw
    _drive(eng, prompts(2, seed=13))
    eng._kv_index.publish_once()
    idx = fetch_index(TCPStore("127.0.0.1", master.port), 1)
    assert idx.get(0)
    assert idx[0] <= eng.prefix_digest_snapshot()
    eng.spill_cached_pages()
    tiered = {d.hex() for d in eng._host_tier.digests()}
    assert tiered and tiered <= eng._kv_index.snapshot_digests()
    with torch.no_grad():
        tm.gpt.wte.weight.mul_(1.0)
    assert eng.refresh_state()
    eng._kv_index.publish_once()
    idx = fetch_index(TCPStore("127.0.0.1", master.port), 1)
    assert not (idx.get(0, set()) & tiered)


def test_evict_hook_fires_outside_lock_and_is_best_effort():
    tier = HostPageTier(budget_bytes=1000)
    seen = []

    def hook(digests):
        assert not tier._lock.locked(), "hook ran under the tier lock"
        seen.append(list(digests))
        raise RuntimeError("dead index")

    tier.evict_hook = hook
    assert tier.put("a", _arrays(400)) and tier.put("b", _arrays(400))
    assert tier.put("c", _arrays(400))          # evicts a; hook raises
    assert seen == [["a"]]
    assert "a" not in tier and "c" in tier


class _WedgedStore:
    """A store whose ``set`` blocks until released: a master wedged in
    the middle of a publish."""

    def __init__(self, inner):
        self._inner = inner
        self.entered = threading.Event()
        self.release = threading.Event()

    def set(self, key, value):
        self.entered.set()
        self.release.wait(10.0)
        self._inner.set(key, value)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def test_eviction_withdraw_survives_wedged_store():
    """With the publisher wedged inside ``store.set``, an over-budget
    ``put()`` (eviction -> hook -> withdraw) completes at once; once the
    store recovers, the next publish holds the truth."""
    master = TCPStore("127.0.0.1", 0, is_master=True, world_size=1)
    wedged = _WedgedStore(TCPStore("127.0.0.1", master.port))
    idx = ClusterPrefixIndex(wedged, host=0, interval=0.01)
    tier = HostPageTier(budget_bytes=1000)
    tier.evict_hook = idx.withdraw
    d1, d2, d3 = b"\x01" * 8, b"\x02" * 8, b"\x03" * 8
    assert tier.put(d1, _arrays(400)) and tier.put(d2, _arrays(400))
    idx.offer([d1, d2])
    idx.start()
    try:
        assert wedged.entered.wait(5.0)
        t0 = time.time()
        assert tier.put(d3, _arrays(400))
        assert time.time() - t0 < 2.0, "eviction blocked on the store"
        assert d1 not in tier
    finally:
        wedged.release.set()
        idx.stop()
    got = fetch_index(TCPStore("127.0.0.1", master.port), 1)
    assert got[0] == {d2.hex()}


def test_serving_never_stalls_on_a_wedged_index_store(models):
    """An engine whose cluster index publishes into a wedged store keeps
    serving: offers and withdrawals take only the index's own lock."""
    _jm, tm = models
    master = TCPStore("127.0.0.1", 0, is_master=True, world_size=1)
    wedged = _WedgedStore(TCPStore("127.0.0.1", master.port))
    eng = _engine(tm)
    eng.attach_cluster_index(wedged, host=0, interval=0.01)
    try:
        assert wedged.entered.wait(5.0)
        t0 = time.time()
        ps = prompts(3, seed=14)
        wave1 = _drive(eng, ps)
        eng.spill_cached_pages()
        assert _drive(eng, ps) == wave1
        assert time.time() - t0 < 30.0
        assert eng._kv_index.snapshot_digests()
    finally:
        wedged.release.set()
        eng._kv_index.stop()
