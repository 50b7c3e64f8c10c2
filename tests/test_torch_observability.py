"""paddle_tpu_torch.observability and .robustness against the JAX
package's: the registry, its catalog, the fault plan and the liveness
watchdog.

* the same observations into both registries give equal snapshots and
  percentiles, exactly (both are host Python over the same bucket
  geometry), and equal Prometheus text;
* every entry of the port's catalog is the JAX entry of that name, and
  the catalog is two-way: a serving run that drives every instrumented
  path (the host tier, a disaggregated handoff, a fleet's failover, a
  retried op and a cluster merge included) emits exactly the catalog's
  names;
* the opt-in ``serving.kv_quant_error`` gauge equals the JAX engine's on
  the same weights and script (1e-5 absolute);
* a seeded ``FaultPlan`` fires at the same indices in both packages;
* a beacon past its deadline is reported stalled, counted and dumped;
* a tensor handed to a metric or a span attr raises ``TypeError``.
"""
import json
import time

import numpy as np
import pytest
import torch

from paddle_tpu.observability import catalog as jax_catalog
from paddle_tpu.observability import exporters as jax_exporters
from paddle_tpu.observability import registry as jax_registry
from paddle_tpu.robustness import faultpoints as jax_fp
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.observability import (CATALOG, NOOP_COUNTER,
                                            NOOP_GAUGE, NOOP_HISTOGRAM,
                                            NOOP_TRACER, Tracer, exporters,
                                            flight, liveness, registry)
from paddle_tpu_torch.observability.liveness import NOOP_BEACON
from paddle_tpu_torch.robustness import faultpoints as fp
from paddle_tpu_torch.serving import (ContinuousBatchingScheduler,
                                      DecodeEngine, Request)


def _feed(mod, seed):
    """A private registry of ``mod`` fed one seeded stream of counter,
    gauge and histogram observations, labeled and not, with the
    histogram's edge cases (zero, negative, past the last bucket)."""
    reg = mod.Registry(catalog=None)
    rng = np.random.default_rng(seed)
    c = reg.counter("c", ("code",))
    g = reg.gauge("g")
    h = reg.histogram("h")
    h2 = reg.histogram("h2", ("kind",))
    for i in range(400):
        c.labels(code=str(i % 3)).inc(float(rng.integers(1, 5)))
        g.set(float(rng.normal()))
        g.inc(0.5)
        h.observe(float(rng.lognormal(-4.0, 2.0)))
        h2.labels(kind="ab"[i % 2]).observe(float(rng.uniform(0, 1e6)))
    for v in (0.0, -1.0, 1e13, 1e-12):
        h.observe(v)
    return reg


def test_registry_snapshots_and_percentiles_equal_jax():
    jax_reg, reg = _feed(jax_registry, 0), _feed(registry, 0)
    assert reg.snapshot() == jax_reg.snapshot()
    for name, labels in (("h", {}), ("h2", {"kind": "a"})):
        a, b = jax_reg.histogram(name), reg.histogram(name)
        if labels:
            a, b = a.labels(**labels), b.labels(**labels)
        for q in np.linspace(0.0, 1.0, 41):
            assert b.percentile(float(q)) == a.percentile(float(q))
    assert exporters.to_prometheus(reg) == jax_exporters.to_prometheus(
        jax_reg)
    line = json.loads(exporters.snapshot_line(reg))
    assert line["metrics"] == jax_reg.snapshot()
    # reset zeroes in place: handles stay live, in both
    handle = reg.counter("c", ("code",)).labels(code="0")
    reg.reset()
    handle.inc(2)
    assert reg.snapshot()["c"]["series"][0]["value"] == 2.0


def test_catalog_entries_equal_jax_name_by_name():
    assert CATALOG
    for name, spec in CATALOG.items():
        assert spec == jax_catalog.CATALOG[name], name


def test_host_values_only_tensors_raise():
    reg = registry.Registry(catalog=None)
    for fn in (reg.counter("c").inc, reg.gauge("g").set,
               reg.histogram("h").observe):
        with pytest.raises(TypeError, match="torch.Tensor"):
            fn(torch.tensor(1.0))
        fn(np.float32(1.0))           # a host scalar is fine
    tr = Tracer()
    with pytest.raises(TypeError, match="torch.Tensor"):
        tr.span("x", n=torch.tensor(1))
    with pytest.raises(RuntimeError, match="concrete float"):
        reg.counter("c").inc(object())


def test_disabled_paths_hand_out_noop_singletons():
    reg = registry.Registry(catalog=CATALOG, enabled=False)
    assert reg.counter("serving.cow_copies") is NOOP_COUNTER
    assert reg.gauge("serving.queue_depth") is NOOP_GAUGE
    assert reg.histogram("serving.ttft_seconds") is NOOP_HISTOGRAM
    with pytest.raises(ValueError, match="not declared"):
        reg.counter("serving.nope")
    # tracing and liveness are off by default: the scheduler holds the
    # no-op tracer and beacon by identity
    eng = DecodeEngine(GPTForCausalLM(GPTConfig.tiny()), num_slots=2,
                       max_len=32, page_size=8, device="cpu")
    sched = ContinuousBatchingScheduler(eng)
    assert sched._tracer is NOOP_TRACER and not sched._tron
    assert eng._tracer is NOOP_TRACER and eng._alloc._tracer is NOOP_TRACER
    if liveness.active() is None:
        assert sched._beacon is NOOP_BEACON


class _Mark(fp.FaultAction):
    def fire(self, ctx, plan):
        ctx["fired"] = True


class _JaxMark(jax_fp.FaultAction):
    def fire(self, ctx, plan):
        ctx["fired"] = True

    def __repr__(self):
        return "_Mark"


def _schedule(mod, action):
    mod.declare("test.fp_parity", "test-local site")
    plan = mod.FaultPlan(seed=7)
    plan.inject("test.fp_parity", action, at=5)
    plan.inject("test.fp_parity", action, every=4, times=3)
    plan.inject("test.fp_parity", action, first_n=2)
    plan.inject("test.fp_parity", action, prob=0.3)
    with mod.chaos(plan):
        hits = [bool((mod.faultpoint("test.fp_parity") or {}).get("fired"))
                for _ in range(60)]
    return plan, hits


def test_seeded_fault_plan_fires_at_the_jax_indices():
    jax_plan, jax_hits = _schedule(jax_fp, _JaxMark())
    plan, hits = _schedule(fp, _Mark())
    assert plan.fired == jax_plan.fired and hits == jax_hits
    assert plan.fired_at("test.fp_parity")[:3] == [0, 0, 1]
    assert plan.hits("test.fp_parity") == 60
    plan.assert_all_fired()
    assert fp.faultpoint("test.fp_parity") is None    # no plan: no-op


def test_beacon_past_its_deadline_is_stalled_counted_and_dumped(
        monkeypatch, tmp_path):
    liveness.declare_beacon("test.stall", "test-local beacon")
    monkeypatch.setenv("PADDLE_TPU_LIVENESS_DEADLINE_TEST_STALL", "0.01")
    stalls = registry.counter("liveness.stalls", ("beacon",)).labels(
        beacon="test.stall")
    before = stalls.value
    flight.enable(dir=str(tmp_path))
    mon = liveness.enable(start=False)
    try:
        b = liveness.beacon("test.stall")
        assert b is not NOOP_BEACON
        with b:
            time.sleep(0.05)
            assert liveness.state()["test.stall"]["stalled"]
            fired = mon.check_now()
            assert [f["beacon"] for f in fired] == ["test.stall"]
            assert mon.check_now() == []      # one report per hang
        assert not liveness.state()["test.stall"]["stalled"]   # idle
        doc = json.load(open(fired[0]["dump"]))
        assert doc["trigger"]["kind"] == "stall"
        assert doc["trigger"]["beacon"] == "test.stall"
        assert "most recent call first" in doc["trigger"]["stacks"]
        assert doc["format"] == "paddle_tpu_torch-flight-v1"
    finally:
        liveness.disable()
        flight.disable()
    assert stalls.value == before + 1
    assert liveness.beacon("test.stall") is NOOP_BEACON


def _serve(sched, prompts, max_new=4):
    for p in prompts:
        sched.submit(Request(prompt=p, max_new_tokens=max_new,
                             temperature=0.0))
    return sched.run()


def test_catalog_is_two_way_over_a_serving_run(monkeypatch, tmp_path):
    """Every instrumented path driven once: the names emitted are the
    catalog's, no more and no fewer."""
    import socket

    from paddle_tpu_torch.serving import ServingFrontend
    emitted = set()
    for cls, meths in ((registry.Counter, ("inc",)),
                       (registry.Gauge, ("set", "inc")),
                       (registry.Histogram, ("observe",))):
        for m in meths:
            orig = getattr(cls, m)

            def rec(self, *a, _orig=orig, **kw):
                emitted.add(self.name)
                return _orig(self, *a, **kw)
            monkeypatch.setattr(cls, m, rec)
    assert registry.default_registry().enabled
    model = GPTForCausalLM(GPTConfig.tiny(),
                           generator=torch.Generator().manual_seed(0))
    model.eval()
    rng = np.random.default_rng(0)
    # slotted: bucketed prefill
    slotted = DecodeEngine(model, num_slots=2, max_len=64, paged=False,
                           device="cpu")
    _serve(ContinuousBatchingScheduler(slotted),
           [rng.integers(0, 512, (8,)) for _ in range(3)])
    # paged, speculative, int8 with the opt-in quant error: a prefix hit,
    # then a copy-on-write of a live shared tail page
    monkeypatch.setenv("PADDLE_TPU_METRICS_KV_QUANT_ERROR", "1")
    paged = DecodeEngine(model, num_slots=2, max_len=64, page_size=8,
                         spec_k=2, kv_dtype="int8", device="cpu")
    monkeypatch.delenv("PADDLE_TPU_METRICS_KV_QUANT_ERROR")
    shared = rng.integers(0, 512, (12,))
    for _ in range(2):
        _serve(ContinuousBatchingScheduler(paged), [shared])
    paged.reset()
    paged.prefill(0, shared, temperature=0.0)
    paged.prefill(1, shared, temperature=0.0)
    assert paged.cow_copies >= 1
    # recompute preemption under page pressure
    tight = DecodeEngine(model, num_slots=2, max_len=48, page_size=8,
                         num_pages=6, prefill_chunk=8, device="cpu")
    tight_sched = ContinuousBatchingScheduler(tight)
    _serve(tight_sched, [rng.integers(0, 512, (24,)) for _ in range(2)], 8)
    assert tight_sched.preemptions_total >= 1
    # the front end: a 429 over queue_limit=0, then a streamed 200
    paged.reset()
    fe = ServingFrontend(paged, queue_limit=0)
    fe.start()
    try:
        for limit in (0, 4):
            fe.queue_limit = limit
            body = json.dumps({"prompt": [1, 2, 3], "max_new_tokens": 2,
                               "temperature": 0.0}).encode()
            with socket.create_connection((fe.host, fe.port),
                                          timeout=60) as s:
                s.sendall(b"POST /v1/generate HTTP/1.1\r\nContent-Length:"
                          b" %d\r\n\r\n" % len(body) + body)
                raw = b""
                while True:
                    chunk = s.recv(65536)
                    if not chunk:
                        break
                    raw += chunk
            assert raw.split()[1] == (b"429" if limit == 0 else b"200")
    finally:
        fe.stop()
    # the host tier: a spill, a fetch that lands, a miss
    tiered = DecodeEngine(model, num_slots=2, max_len=64, page_size=8,
                          kv_host_bytes=1 << 20, device="cpu")
    again = rng.integers(0, 512, (20,))
    _serve(ContinuousBatchingScheduler(tiered), [again], 2)
    assert tiered.spill_cached_pages() > 0
    _serve(ContinuousBatchingScheduler(tiered), [again], 2)
    assert tiered.host_fetch_plan(rng.integers(0, 512, (20,))) == []
    # a disaggregated handoff
    from paddle_tpu_torch.serving import DisaggScheduler, Router
    de = DecodeEngine(model, num_slots=2, max_len=64, page_size=8,
                      device="cpu")
    pe = DecodeEngine(model, num_slots=2, max_len=64, page_size=8,
                      device="cpu")
    assert _serve(DisaggScheduler(de, pe), [shared], 2)
    # a fleet: routed admissions, then a replica crash past the requeue
    # budget (a failover and a "failover_limit" finish)
    import threading
    done = threading.Event()
    router = Router([de], probe_interval=None, max_requeues=0)
    router.on_finish = lambda res: done.set()
    router.start()
    try:
        with fp.chaos(fp.FaultPlan().inject("serve.replica",
                                            fp.HardExit(), at=1)):
            router.submit(Request(prompt=shared, max_new_tokens=8,
                                  temperature=0.0))
            assert done.wait(30)
    finally:
        router.stop()
    # a retried store op and a cluster merge with a straggler
    from paddle_tpu_torch.observability import aggregate
    from paddle_tpu_torch.robustness.retry import retry_call
    flaky = iter([ConnectionResetError("injected"), None])

    def once_flaky():
        exc = next(flaky)
        if exc is not None:
            raise exc
    retry_call(once_flaky, base_delay=0.0, sleep=lambda d: None)
    step = {"count": 4, "sum": 0.4, "p95": 0.1, "p99": 0.1}
    aggregate.merge_docs({h: {"wall_ts": time.time(), "step_times": {
        "serving.decode_step_seconds": dict(step, p50=p50)}}
        for h, p50 in ((0, 0.1), (1, 0.1), (2, 0.5))}, 3)
    # a fired faultpoint, and a liveness stall
    with fp.chaos(fp.FaultPlan().inject("serve.step", fp.Hang(0.0))):
        _serve(ContinuousBatchingScheduler(tight), [shared], 1)
    # the overlap islands' chunk counter (an island's chunk resolve; the
    # islands themselves need a group of two ranks:
    # tests/test_torch_mp_overlap.py)
    from paddle_tpu_torch.distributed import mp_overlap
    with mp_overlap.overlap_scope(True, 2):
        mp_overlap._resolve_chunks("row", 8, 64, 32, 2, torch.float32, 16)
    # a checkpoint saved and restored
    from paddle_tpu_torch.incubate.checkpoint import CheckpointManager
    mgr = CheckpointManager(str(tmp_path / "ckpt"), async_save=False)
    mgr.save(1, {"w": torch.arange(4.0)})
    assert torch.equal(mgr.restore()["w"], torch.arange(4.0))
    mgr.close()
    # training: a TrainStep under the grad-norm opt-in inside a hapi fit,
    # an fp16 update the scaler skips, a sentinel rewind
    from paddle_tpu_torch import amp, hapi
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import SGD, AdamW
    from paddle_tpu_torch.robustness.sentinel import DivergenceSentinel
    monkeypatch.setenv("PADDLE_TPU_METRICS_GRAD_NORM", "1")
    net = hapi.Model(GPTForCausalLM(GPTConfig.tiny()))
    net.prepare(AdamW(parameters=net.parameters()),
                GPTPretrainingCriterion(), device="cpu")
    ids = rng.integers(0, 512, (2, 8))
    net.fit(TensorDataset([ids, ids]), batch_size=2, shuffle=False,
            verbose=0)
    monkeypatch.delenv("PADDLE_TPU_METRICS_GRAD_NORM")
    lin = torch.nn.Linear(2, 2)
    scaler = amp.GradScaler(init_loss_scaling=2.0)
    scaler.scale(lin(torch.ones(1, 2)).sum()).backward()
    with fp.chaos(fp.FaultPlan().inject("amp.found_inf",
                                        fp.ForceFoundInf())):
        scaler.step(SGD(parameters=list(lin.parameters())))
    sentinel = DivergenceSentinel(net._train_step, snapshot_every=1,
                                  min_history=1)
    sentinel.observe(1, 1.0)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sentinel.observe(2, float("nan"))
    # the autotuner: a timed selection, then a memo hit and a miss
    from paddle_tpu_torch.kernels import autotune as at
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE_CACHE", "")
    key = {"n": 8, "platform": "cpu"}
    at.register_family("catalog_fake", lambda k: [
        {"variant": "base", "config": {"rows": r}} for r in (8, 16)],
        lambda cand, k: (lambda: None))
    at.tune("catalog_fake", key, persist=False)
    at.resolve("catalog_fake", key)
    at.resolve("catalog_fake", {"n": 16, "platform": "cpu"})
    # the HBM ledger, a card's device standing in on the CPU (the engines
    # above register their pools)
    from paddle_tpu_torch.observability import hbm
    monkeypatch.setattr(hbm, "_live_per_device", lambda: {"cuda:0": 1.0})
    hbm.enable().sample("catalog")
    hbm.disable()
    liveness.declare_beacon("test.catalog_stall", "test-local beacon")
    monkeypatch.setenv("PADDLE_TPU_LIVENESS_DEADLINE_TEST_CATALOG_STALL",
                       "0.0")
    mon = liveness.enable(start=False)
    try:
        with liveness.beacon("test.catalog_stall"):
            time.sleep(0.005)
            assert mon.check_now()
    finally:
        liveness.disable()
    assert emitted == set(CATALOG), (
        "emitted, not declared: %s; declared, never emitted: %s"
        % (sorted(emitted - set(CATALOG)), sorted(set(CATALOG) - emitted)))


def test_kv_quant_error_gauge_equals_jax(monkeypatch):
    """The opt-in gauge after the same prefill and decode steps of a
    paged int8 engine in each package (1e-5 absolute: the error is
    continuous in K/V, which agree to f32 rounding)."""
    from paddle_tpu.observability import registry as jreg
    from paddle_tpu.serving.engine import DecodeEngine as JaxEngine
    from test_torch_paged import _pair
    jm, tm = _pair(seed=3)
    monkeypatch.setenv("PADDLE_TPU_METRICS_KV_QUANT_ERROR", "1")
    kw = dict(num_slots=2, max_len=64, page_size=8, kv_dtype="int8",
              seed=0)
    je, te = JaxEngine(jm, **kw), DecodeEngine(tm, device="cpu", **kw)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 512, (n,)).astype(np.int32)
               for n in (11, 6)]
    gauges = (jreg.gauge("serving.kv_quant_error"),
              registry.gauge("serving.kv_quant_error"))
    seen = []
    for eng in (je, te):
        toks = [eng.prefill(i, p, temperature=0.0)[0]
                for i, p in enumerate(prompts)]
        vals = []
        for _ in range(3):
            nxt, _l = eng.decode(toks, [True, True], [0.0, 0.0], [0, 0],
                                 [1.0, 1.0])
            toks = [int(t) for t in nxt]
            vals.append(gauges[eng is te].value)
        seen.append(vals)
    assert min(seen[1]) > 0
    np.testing.assert_allclose(seen[1], seen[0], rtol=0, atol=1e-5)


def test_registry_keeps_every_update_under_thread_contention():
    """More threads than cores hammer one counter, one labeled counter
    and one histogram with a short switch interval: no update is lost."""
    import sys
    import threading
    reg = registry.Registry(catalog=None)
    c, lab, h = (reg.counter("c"), reg.counter("l", ("k",)),
                 reg.histogram("h"))
    n_threads, n = 32, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for j in range(n):
                c.inc()
                lab.labels(k=str(j % 4)).inc(2)
                h.observe(1e-3 * (i + 1))
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert c.value == n_threads * n
    assert sum(lab.labels(k=str(k)).value for k in range(4)) == \
        2 * n_threads * n
    assert h.count == n_threads * n
