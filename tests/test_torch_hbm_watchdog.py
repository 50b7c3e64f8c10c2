"""paddle_tpu_torch's HBM ledger and compile watchdog on the CPU, against
paddle_tpu's where both run: the ledger off by default (``maybe_sample``
is one ``None`` check), its sampling cadence and mark cap, ``kv_pool_bytes``
equal to the JAX ledger's on the same engine configs (and to the pool
tensors' bytes without the sink page), the restore transient, the chrome
``"C"`` lanes, the strict and warning modes of ``watch``, the serving
engine's captures counted under the JAX entry names (a stand-in capture
on the CPU), ``jit.train_step``'s one count, and the flight dump's
``compile_counts`` on a strict recompile."""
import json

import pytest
import torch

import _torch_pair as P
from _torch_capture import stand_in_capture
from paddle_tpu.observability import hbm as jhbm
from paddle_tpu.serving import DecodeEngine as JaxEngine
from paddle_tpu_torch.observability import flight, hbm, registry, tracing
from paddle_tpu_torch.observability import watchdog as wd
from paddle_tpu_torch.serving import (ContinuousBatchingScheduler,
                                      DecodeEngine, Request)
from paddle_tpu_torch.serving import engine as engine_mod


@pytest.fixture
def ledger():
    led = hbm.enable()
    try:
        yield led
    finally:
        hbm.disable()


def test_ledger_is_off_by_default_and_a_noop():
    assert hbm.active() is None
    assert hbm.maybe_sample("serving.iteration") is None
    assert hbm.sample() is None and hbm.counter_marks() == []
    jm, tm = P.pair()
    eng = DecodeEngine(tm, num_slots=2, max_len=64, page_size=8,
                       device="cpu")
    calls = []
    orig = hbm.HbmLedger.sample
    try:
        hbm.HbmLedger.sample = lambda self, tag="": calls.append(tag)
        P.drive(ContinuousBatchingScheduler(eng), Request, P.prompts(2),
                max_new=3)
    finally:
        hbm.HbmLedger.sample = orig
    assert calls == []


def test_sampling_cadence_and_mark_cap():
    led = hbm.enable(sample_every=3)
    try:
        got = [hbm.maybe_sample("t") for _ in range(7)]
        assert [g is not None for g in got] == [False, False, True,
                                                False, False, True, False]
        for _ in range(hbm.MARKS_CAP + 10):
            led.sample("cap")
        marks = hbm.counter_marks()
        assert len(marks) == hbm.MARKS_CAP
        assert all(name == "hbm.kv_pool_bytes" for name, _t, _v in marks)
        # no card: no device is sampled
        assert led.last["devices"] == {} and led.last["tag"] == "cap"
    finally:
        hbm.disable()


def _pool_tensors(engine):
    out = []
    for name in ("k", "v", "k_scale", "v_scale"):
        t = getattr(engine.cache, name, None)
        if t is None:
            continue
        out.extend(t if isinstance(t, (list, tuple)) else [t])
    return out


@pytest.mark.parametrize("kw", [dict(page_size=8),
                                dict(page_size=8, kv_dtype="int8"),
                                dict(paged=False)])
def test_kv_pool_bytes_equal_jax_ledger(kw):
    jm, tm = P.pair()
    j0, t0 = jhbm._kv_pool_total(), hbm._kv_pool_total()
    je = JaxEngine(jm, num_slots=2, max_len=64, **kw)
    te = DecodeEngine(tm, num_slots=2, max_len=64, device="cpu", **kw)
    jdelta = jhbm._kv_pool_total() - j0
    tdelta = hbm._kv_pool_total() - t0
    assert tdelta == jdelta == je.kv_pool_bytes() == te.kv_pool_bytes()
    held = sum(t.numel() * t.element_size() for t in _pool_tensors(te))
    if te.paged:
        # the pool's buffers hold one sink page past num_pages
        held = held * te.num_pages // (te.num_pages + 1)
    assert held == te.kv_pool_bytes()
    led = hbm.enable()
    try:
        assert led.sample("x")["kv_pool_bytes"] == hbm._kv_pool_total()
    finally:
        hbm.disable()


def test_restore_transient_is_noted_and_cleared(tmp_path, ledger):
    from paddle_tpu_torch.incubate.checkpoint import CheckpointManager
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"w": torch.arange(16.0)})
    seen = []
    orig = hbm.note_restore

    def note(nbytes):
        seen.append(nbytes)
        orig(nbytes)
    hbm.note_restore = note
    try:
        assert torch.equal(mgr.restore()["w"], torch.arange(16.0))
    finally:
        hbm.note_restore = orig
        mgr.close()
    assert seen == [64]
    marks = [v for n, _t, v in hbm.counter_marks()
             if n == "hbm.restore_transient_bytes"]
    assert marks == [64.0, 0.0]
    assert registry.gauge("hbm.restore_transient_bytes").value == 0.0


def test_chrome_trace_carries_hbm_lanes_and_profiler_spans(tmp_path,
                                                           ledger):
    from paddle_tpu_torch import profiler
    ledger.sample("a")
    with profiler.RecordEvent("span.in.trace"):
        ledger.sample("b")
    tr = tracing.Tracer()
    path = tr.export_chrome(str(tmp_path / "t.json"), include_profiler=True)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    lanes = [e for e in events if e.get("cat") == "hbm"]
    assert len(lanes) == 2 and all(e["ph"] == "C" for e in lanes)
    assert {e["name"] for e in lanes} == {"hbm.kv_pool_bytes"}
    assert any(e["name"] == "span.in.trace" and e["cat"] == "host"
               for e in events)
    profiler._recorder.drain()
    path = tr.export_chrome(str(tmp_path / "u.json"),
                            include_profiler=False)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert [e["cat"] for e in events] == ["hbm", "hbm"]


def test_watch_warns_then_raises_in_strict_mode(monkeypatch, tmp_path):
    flight.enable(dir=str(tmp_path))
    try:
        entry = wd.watch("test.entry", expected=1)
        before = registry.counter("compile.count", ("entry",)).labels(
            entry="test.entry").value
        entry.compiled(routing="a")
        entry.compiled(routing="b")    # a new routing: a budget of its own
        assert entry.budget == 2 and wd.compile_counts()["test.entry"] == 2
        with pytest.warns(wd.RecompileWarning, match="test.entry"):
            entry.compiled(routing="a")
        assert registry.counter("compile.count", ("entry",)).labels(
            entry="test.entry").value == before + 3
        monkeypatch.setenv("PADDLE_TPU_STRICT_COMPILE", "1")
        with pytest.raises(wd.RecompileError, match="budget 2"):
            entry.compiled(routing="b")
        with open(flight.last_dump_path()) as f:
            doc = json.load(f)
    finally:
        flight.disable()
    assert doc["trigger"] == {"kind": "recompile", "entry": "test.entry",
                              "compile_count": 4, "expected": 2}
    assert doc["compile_counts"]["test.entry"] == 4
    # every build is metered into the ring
    assert sum(e["kind"] == "recompile" for e in doc["ring"]) == 4
    del entry
    import gc
    gc.collect()
    assert "test.entry" not in wd.compile_counts()


def test_engine_captures_count_under_jax_entry_names(monkeypatch):
    monkeypatch.setattr(engine_mod, "capture", stand_in_capture)
    _jm, tm = P.pair()
    before = wd.compile_counts()
    eng = DecodeEngine(tm, num_slots=2, max_len=64, page_size=8, spec_k=2,
                       device="cpu")
    eng._capture = True
    eng.capture_steps()
    P.drive(ContinuousBatchingScheduler(eng), Request, P.prompts(3),
            max_new=4)
    stats = eng.graph_stats()["by_kind"]
    counts = wd.compile_counts()
    for kind, name in (("spec", "serving.spec_verify"),
                       ("chunk", "serving.prefill_chunk")):
        assert stats[kind]["captures"] == 1
        assert counts[name] - before.get(name, 0) == 1
    assert counts["serving.decode"] - before.get("serving.decode", 0) == 0
    monkeypatch.setenv("PADDLE_TPU_STRICT_COMPILE", "1")
    eng._graphs.clear()            # a forced second capture of a routing
    with pytest.raises(wd.RecompileError, match="serving.spec_verify"):
        eng.capture_steps()


def test_train_step_counts_one_compile():
    import _torch_guard as G
    _jstep, tstep = G.steps()
    before = wd.compile_counts().get("jit.train_step", 0)
    for b in G.batches(2):
        tstep(*G.port_batch(b))
    assert wd.compile_counts()["jit.train_step"] == before + 1
    assert tstep._watch.compile_count == 1
