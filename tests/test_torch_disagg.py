"""paddle_tpu_torch's disaggregated prefill/decode serving against
``paddle_tpu``'s, after ``tests/test_disagg.py``: greedy tokens equal to
the JAX disaggregated pair's and to the port's colocated engine through
admission churn, host staging (f32 and a bf16 pool), int8, fp8 and a
speculative decode engine, a prefix hit that skips prefill and transfer,
single-token requests that never hand off, decode-pool preemption,
``handoff_limit`` backpressure and torn transports (a reset, a torn or
bit-flipped staging file) that requeue and recompute; a handoff moves
page bytes exactly and pads into the sink page; validation, spans,
metrics, a cancel mid-transfer, and the HTTP front end over
``prefill_engine=``.  The tiny GPT in f32 on the same numpy weights in
both packages, on one device (the JAX engines meshless)."""
import json
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu.serving.disagg import DisaggScheduler as JaxDisagg
from paddle_tpu.serving.engine import DecodeEngine as JaxEngine
from paddle_tpu.serving.scheduler import \
    ContinuousBatchingScheduler as JaxScheduler
from paddle_tpu.serving.scheduler import Request as JaxRequest
from paddle_tpu_torch.kernels.decode_attention import raw_bytes
from paddle_tpu_torch.observability import registry as obs
from paddle_tpu_torch.observability.liveness import BEACONS
from paddle_tpu_torch.robustness.faultpoints import (SITES, BitFlip,
                                                     FaultPlan, SocketReset,
                                                     TornFile, chaos)
from paddle_tpu_torch.serving import (ContinuousBatchingScheduler,
                                      DecodeEngine, DisaggScheduler,
                                      Request, ServingFrontend)

from _torch_pair import VOCAB, pair


@pytest.fixture(scope="module")
def models():
    return pair(seed=5)


def _requests(n=6, seed=0, max_new=(3, 9), plen=(4, 40), eos=None):
    rng = np.random.default_rng(seed)
    return [dict(prompt=rng.integers(0, VOCAB, (int(rng.integers(
        plen[0], plen[1])),)).astype(np.int32),
        max_new_tokens=int(rng.integers(*max_new)), temperature=0.0,
        eos_token_id=eos) for _ in range(n)]


def _engines(Engine, model, slots=3, pslots=2, max_len=64, page_size=8,
             cpu=True, **kw):
    dev = dict(device="cpu") if cpu else {}
    de = Engine(model, num_slots=slots, max_len=max_len, seed=0,
                page_size=page_size, **dev, **kw)
    pkw = {k: v for k, v in kw.items() if k != "spec_k"}
    pe = Engine(model, num_slots=pslots, max_len=max_len, seed=0,
                page_size=page_size, **dev, **pkw)
    return de, pe


def _pair(tm, **kw):
    return _engines(DecodeEngine, tm, **kw)


def _drive(sched, reqs, req_cls=Request):
    rids = [sched.submit(req_cls(**dict(r, prompt=r["prompt"].copy())))
            for r in reqs]
    res = sched.run()
    return [(tuple(int(t) for t in res[r].tokens), res[r].finish_reason)
            for r in rids]


def _colocated(tm, reqs, slots=3, max_len=64, page_size=8, **kw):
    eng = DecodeEngine(tm, num_slots=slots, max_len=max_len, seed=0,
                       page_size=page_size, device="cpu", **kw)
    return _drive(ContinuousBatchingScheduler(eng), reqs)


def _jax_disagg(jm, reqs, handoff_limit=4, via_host=False, **kw):
    de, pe = _engines(JaxEngine, jm, cpu=False, **kw)
    return _drive(JaxDisagg(de, pe, handoff_limit=handoff_limit,
                            via_host=via_host, overlap=False), reqs,
                  JaxRequest)


# ---------------------------------------------------------------------------
# greedy tokens: the JAX pair's and the colocated engine's
# ---------------------------------------------------------------------------

def test_disagg_greedy_parity_with_admission_churn(models):
    """6 requests through 3 decode and 2 prefill slots: admissions churn
    through both roles, every request hands off, and the tokens equal
    the colocated engine's and the JAX disaggregated pair's; both pools
    drain."""
    jm, tm = models
    reqs = _requests()
    colo = _colocated(tm, reqs)
    de, pe = _pair(tm)
    sched = DisaggScheduler(de, pe)
    got = _drive(sched, reqs)
    assert got == colo == _jax_disagg(jm, reqs)
    assert sched.handoffs_total > 0 and sched.handoff_bytes_total > 0
    assert sched.handoff_chunks_total >= sched.handoffs_total
    assert de._alloc.pages_used() == 0 and pe._alloc.pages_used() == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_disagg_parity_via_host_staging(models, dtype):
    """The host-staging transport (npz round trip) gives the device
    path's tokens; a bf16 pool crosses the npz file byte for byte."""
    jm, tm = models
    reqs = _requests(4, seed=3)
    kw = {} if dtype == "float32" else dict(cache_dtype="bfloat16")
    de, pe = _pair(tm, **kw)
    sched = DisaggScheduler(de, pe, via_host=True)
    got = _drive(sched, reqs)
    assert got == _colocated(tm, reqs, **kw)
    if dtype == "float32":
        assert got == _jax_disagg(jm, reqs, via_host=True)
    assert sched.handoffs_total == len(reqs)


def test_via_host_from_the_environment(models, monkeypatch):
    _jm, tm = models
    de, pe = _pair(tm)
    monkeypatch.setenv("PADDLE_TPU_HANDOFF_HOST", "1")
    assert DisaggScheduler(de, pe).via_host
    monkeypatch.setenv("PADDLE_TPU_HANDOFF_HOST", "0")
    assert not DisaggScheduler(de, pe).via_host


@pytest.mark.parametrize("kw", [dict(kv_dtype="int8"), dict(kv_dtype="fp8"),
                                dict(spec_k=2),
                                dict(spec_k=2, kv_dtype="int8")],
                         ids=["int8", "fp8", "spec", "spec_int8"])
def test_disagg_parity_quantized_and_spec(models, kw):
    """Codes and their scales hand off byte for byte, and a speculative
    decode engine serves the handed-off requests: tokens equal the
    colocated engine of the same kind and the JAX pair's."""
    jm, tm = models
    reqs = _requests(4, seed=4)
    de, pe = _pair(tm, **kw)
    got = _drive(DisaggScheduler(de, pe), reqs)
    assert got == _colocated(tm, reqs, **kw)
    assert got == _jax_disagg(jm, reqs, **kw)


def test_disagg_prefix_hit_skips_prefill_and_transfer(models):
    """A prompt the DECODE pool already holds admits decode-side in one
    1-token chunk: the same tokens, no second transfer."""
    _jm, tm = models
    de, pe = _pair(tm)
    sched = DisaggScheduler(de, pe)
    prompt = np.arange(24, dtype=np.int32) % VOCAB
    req = dict(prompt=prompt, max_new_tokens=4, temperature=0.0)
    first = _drive(sched, [req])
    assert sched.handoffs_total == 1
    assert sched.decode_route_admissions == 0
    second = _drive(sched, [req])
    assert second == first
    assert sched.handoffs_total == 1
    assert sched.decode_route_admissions == 1
    assert sched.decode_side_chunks == 1
    res = sched.finished[list(sched.finished)[-1]]
    assert res.prefix_hit_tokens > 0


def test_disagg_single_token_requests_never_hand_off(models):
    _jm, tm = models
    reqs = _requests(3, seed=5, max_new=(1, 2))
    de, pe = _pair(tm)
    sched = DisaggScheduler(de, pe)
    assert _drive(sched, reqs) == _colocated(tm, reqs)
    assert sched.handoffs_total == 0
    assert de._alloc.pages_used() == 0 and pe._alloc.pages_used() == 0


def test_disagg_preemption_under_decode_pool_pressure(models):
    """A decode pool too small for the load preempts (perhaps in the
    middle of a handoff): the port's tokens and finish reasons equal the
    JAX pair's at the same pressure, every normal completion equals the
    roomy colocated engine's, and both pools drain."""
    jm, tm = models
    reqs = _requests(5, seed=6, plen=(16, 40), max_new=(4, 8))
    de = DecodeEngine(tm, num_slots=3, max_len=64, seed=0, page_size=8,
                      num_pages=10, device="cpu")
    pe = DecodeEngine(tm, num_slots=2, max_len=64, seed=0, page_size=8,
                      device="cpu")
    sched = DisaggScheduler(de, pe)
    out = _drive(sched, reqs)
    jde = JaxEngine(jm, num_slots=3, max_len=64, seed=0, page_size=8,
                    num_pages=10)
    jpe = JaxEngine(jm, num_slots=2, max_len=64, seed=0, page_size=8)
    assert out == _drive(JaxDisagg(jde, jpe, overlap=False), reqs,
                         JaxRequest)
    assert sched.preemptions_total >= 1
    roomy = _colocated(tm, reqs)
    for got, want in zip(out, roomy):
        if got[1] in ("eos", "length"):
            assert got == want
    assert de._alloc.pages_used() == 0 and pe._alloc.pages_used() == 0


def test_disagg_handoff_limit_backpressure(models):
    """handoff_limit=1 bounds the ready queue: prefill-complete slots
    park with their pages until it drains; tokens unchanged."""
    jm, tm = models
    reqs = _requests(6, seed=7)
    de, pe = _pair(tm, slots=2, pslots=2)
    sched = DisaggScheduler(de, pe, handoff_limit=1)
    depths = []
    for r in reqs:
        sched.submit(Request(**dict(r, prompt=r["prompt"].copy())))
    while sched.has_work():
        sched.step()
        depths.append(len(sched._ready))
    got = [(tuple(int(t) for t in sched.finished[i].tokens),
            sched.finished[i].finish_reason) for i in range(len(reqs))]
    assert max(depths) <= 1
    assert got == _colocated(tm, reqs, slots=2)
    assert got == _jax_disagg(jm, reqs, handoff_limit=1, slots=2)
    assert sched.handoff_depth == 0


def test_disagg_seeded_first_tokens_reproducible(models):
    _jm, tm = models
    reqs = _requests(4, seed=8)
    for r in reqs:
        r["temperature"] = 0.9

    def run():
        de, pe = _pair(tm)
        return [t[0][0] for t in _drive(DisaggScheduler(de, pe), reqs)]

    assert run() == run()


# ---------------------------------------------------------------------------
# the handoff itself
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
def test_handoff_moves_page_bytes_exactly(models, kv_dtype):
    """export -> stage -> import copies every layer's rows of each page
    (codes and f32 scales of a quantized pool) bit for bit into the
    destination pages; the padding of a partial chunk lands in the sink
    page and no live page moves."""
    _jm, tm = models
    de, pe = _pair(tm, kv_dtype=kv_dtype)
    pe.prefill(0, np.arange(30, dtype=np.int32) % VOCAB, temperature=0.0)
    src = [int(p) for p in pe._alloc.table[0][pe._alloc.mapped[0]]][:3]
    assert len(src) == 3 < de.handoff_pages
    before = [None if t is None else t.clone() for t in de._pools()]
    dst = [5, 1, 7]
    de.import_pages(de.stage_handoff(pe.export_pages(src)), dst)
    for a, b, old in zip(pe._pools(), de._pools(), before):
        if a is None:
            continue
        for s, d in zip(src, dst):
            assert torch.equal(raw_bytes(a[s]), raw_bytes(b[d]))
        untouched = [i for i in range(de.num_pages) if i not in dst]
        assert torch.equal(b[untouched], old[untouched])
    assert de.handoff_chunk_bytes(3) == 3 * de.page_size * \
        de.kv_row_bytes()


# ---------------------------------------------------------------------------
# torn transports
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("via_host,action", [
    (False, SocketReset), (True, TornFile), (True, BitFlip)],
    ids=["device-reset", "host-torn", "host-bitflip"])
def test_chaos_mid_handoff_requeues_and_stays_serviceable(
        models, via_host, action):
    """A transport fault on a handoff chunk requeues the request at the
    front (recompute), frees both pools refcount-exactly and completes
    every request with the undisturbed tokens."""
    _jm, tm = models
    reqs = _requests(3, seed=9, plen=(16, 40), max_new=(4, 5))
    de, pe = _pair(tm, slots=2, pslots=2)
    sched = DisaggScheduler(de, pe, via_host=via_host)
    plan = FaultPlan().inject("serve.handoff", action(), at=2)
    with chaos(plan):
        out = _drive(sched, reqs)
    plan.assert_all_fired()
    assert out == _colocated(tm, reqs, slots=2)
    assert de._alloc.pages_used() == 0 and pe._alloc.pages_used() == 0
    assert sched.handoffs_total == len(reqs)
    assert sched.preemptions_total >= 1
    again = _drive(sched, reqs[:1])
    assert again == out[:1]


def test_chaos_persistent_torn_transport_caps_at_cache_full(models):
    """A transport that tears every chunk: a long request finishes
    "cache_full" after 1 + max_preemptions prefill-sampled tokens, a
    short one completes "length" without a handoff."""
    _jm, tm = models
    rng = np.random.default_rng(10)
    prompt = rng.integers(0, VOCAB, (24,)).astype(np.int32)
    de, pe = _pair(tm, slots=2, pslots=2)
    sched = DisaggScheduler(de, pe)
    plan = FaultPlan().inject("serve.handoff", SocketReset(), every=1)
    with chaos(plan):
        long_out = _drive(sched, [dict(prompt=prompt, max_new_tokens=8,
                                       temperature=0.0)])
        short_out = _drive(sched, [dict(prompt=prompt[:16],
                                        max_new_tokens=3,
                                        temperature=0.0)])
    plan.assert_all_fired()
    assert long_out[0][1] == "cache_full"
    assert len(long_out[0][0]) == 1 + sched.max_preemptions
    assert short_out[0][1] == "length" and len(short_out[0][0]) == 3
    assert sched.handoffs_total == 0
    assert de._alloc.pages_used() == 0 and pe._alloc.pages_used() == 0
    ok = _drive(sched, [dict(prompt=prompt, max_new_tokens=4,
                             temperature=0.0)])
    assert ok[0][1] == "length" and len(ok[0][0]) == 4


def test_handoff_advance_tolerates_mid_loop_retirement(models):
    """A chunk's eviction can preempt ANOTHER mid-handoff slot while the
    advance loop walks a snapshot of them: the loop skips it."""
    _jm, tm = models
    rng = np.random.default_rng(13)
    de, pe = _pair(tm, slots=3, pslots=2, handoff_pages=1)
    sched = DisaggScheduler(de, pe)
    for _ in range(2):
        sched.submit(Request(prompt=rng.integers(0, VOCAB, (24,)),
                             max_new_tokens=3, temperature=0.0))
    sched.admit()
    for _ in range(50):
        if len(sched._handoffs) == 2:
            break
        sched.prefill_once()
    assert len(sched._handoffs) == 2
    first, second = list(sched._handoffs)
    orig = sched._handoff_chunk
    fired = []

    def chunk_with_eviction(task):
        if task.dst_slot == first and not fired:
            fired.append(True)
            sched._preempt(second)
        orig(task)

    sched._handoff_chunk = chunk_with_eviction
    sched._handoff_advance()
    assert fired and second not in sched._handoffs
    sched._handoff_chunk = orig
    res = sched.run()
    assert len(res) == 2 and all(len(r.tokens) == 3 for r in res.values())
    assert de._alloc.pages_used() == 0 and pe._alloc.pages_used() == 0


def test_cancel_mid_handoff_frees_both_pools(models):
    _jm, tm = models
    de, pe = _pair(tm, slots=2, pslots=2, handoff_pages=1)
    sched = DisaggScheduler(de, pe)
    rid = sched.submit(Request(prompt=np.arange(40, dtype=np.int32),
                               max_new_tokens=4, temperature=0.0))
    while not sched._handoffs:
        sched.step()
    assert sched.cancel(rid)
    assert sched.finished[rid].finish_reason == "cancelled"
    assert not sched.has_work()
    assert de._alloc.pages_used() == 0 and pe._alloc.pages_used() == 0


def test_chaos_site_and_beacon_declared():
    assert "serve.handoff" in SITES and "serve.handoff" in BEACONS


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

def test_disagg_constructor_validation(models):
    _jm, tm = models
    de, pe = _pair(tm)
    with pytest.raises(ValueError, match="TWO engines"):
        DisaggScheduler(de, de)
    with pytest.raises(ValueError, match="spec_k=0"):
        DisaggScheduler(de, DecodeEngine(tm, num_slots=2, max_len=64,
                                         page_size=8, spec_k=2,
                                         device="cpu"))
    with pytest.raises(ValueError, match="geometry"):
        DisaggScheduler(de, DecodeEngine(tm, num_slots=2, max_len=64,
                                         page_size=16, device="cpu"))
    slotted = DecodeEngine(tm, num_slots=2, max_len=64, paged=False,
                           device="cpu")
    with pytest.raises(ValueError, match="paged"):
        DisaggScheduler(slotted, pe)
    with pytest.raises(ValueError, match="handoff_limit"):
        DisaggScheduler(de, pe, handoff_limit=0)


def test_engine_export_import_validation(models):
    _jm, tm = models
    de, _pe = _pair(tm)
    with pytest.raises(ValueError, match="export_pages"):
        de.export_pages([])
    with pytest.raises(ValueError, match="export_pages"):
        de.export_pages(list(range(de.handoff_pages + 1)))
    with pytest.raises(ValueError, match="import_pages"):
        de.import_pages(de.export_pages([0]), [])
    slotted = DecodeEngine(tm, num_slots=2, max_len=64, paged=False,
                           device="cpu")
    with pytest.raises(RuntimeError, match="paged-engine"):
        slotted.export_pages([0])
    with pytest.raises(RuntimeError, match="paged-engine"):
        slotted.import_pages((None,) * 4, [0])


# ---------------------------------------------------------------------------
# observability and the front end
# ---------------------------------------------------------------------------

def test_handoff_span_keeps_request_tree_connected(models):
    from paddle_tpu_torch.observability.tracing import Tracer, build_report
    _jm, tm = models
    tr = Tracer()
    de, pe = _pair(tm, tracer=tr)
    sched = DisaggScheduler(de, pe, tracer=tr)
    _drive(sched, _requests(3, seed=11))
    rep = build_report(tr.spans(), tr.instants())
    assert rep["totals"]["connected"] and len(rep["requests"]) == 3
    spans = tr.spans()
    by_id = {s["span_id"]: s for s in spans}
    handoffs = [s for s in spans if s["name"] == "handoff"]
    assert len(handoffs) == 3
    for s in handoffs:
        assert by_id[s["parent_id"]]["name"] == "request"
        assert s["attrs"].get("bytes", 0) > 0
    assert any(s["name"] == "engine.kv_export" for s in spans)
    assert any(s["name"] == "engine.kv_import" for s in spans)


def test_handoff_metrics_fire(models):
    _jm, tm = models
    b0 = obs.counter("serving.handoff_bytes").value
    n0 = obs.histogram("serving.handoff_seconds").count
    de, pe = _pair(tm)
    sched = DisaggScheduler(de, pe)
    _drive(sched, _requests(3, seed=12))
    assert obs.counter("serving.handoff_bytes").value - b0 == \
        sched.handoff_bytes_total > 0
    assert obs.histogram("serving.handoff_seconds").count - n0 == \
        sched.handoff_chunks_total
    assert obs.gauge("serving.handoff_queue_depth").value == 0


def test_frontend_disagg_healthz_and_stream(models):
    """The HTTP surface over a role-split scheduler: /healthz carries the
    handoff depth, and a buffered generate gives the colocated tokens."""
    _jm, tm = models
    de, pe = _pair(tm)
    fe = ServingFrontend(de, prefill_engine=pe)
    host, port = fe.start()
    try:
        assert isinstance(fe.scheduler, DisaggScheduler)
        h = json.loads(urllib.request.urlopen(
            "http://%s:%d/healthz" % (host, port), timeout=10).read())
        assert h["status"] == "ok" and h["handoff_depth"] == 0
        body = json.dumps({"prompt": list(range(12)),
                           "max_new_tokens": 3, "temperature": 0.0,
                           "stream": False}).encode()
        req = urllib.request.Request(
            "http://%s:%d/v1/generate" % (host, port), data=body,
            headers={"Content-Type": "application/json"})
        out = json.loads(urllib.request.urlopen(req, timeout=30).read())
    finally:
        fe.stop()
    want = _colocated(tm, [dict(prompt=np.arange(12, dtype=np.int32),
                                max_new_tokens=3, temperature=0.0)])
    assert tuple(out["tokens"]) == want[0][0]
    assert fe.scheduler.handoffs_total == 1
