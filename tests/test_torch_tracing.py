"""paddle_tpu_torch's request tracing against paddle_tpu's: one request
script (admission churn through two slots, a prefix hit, a recompute
preemption of a decoding request, a cancel of a waiting one) through the
JAX scheduler and the port's, on the tiny GPT with one set of numpy
weights (``_pair`` of ``tests/test_torch_paged.py``), each with a live
tracer.  The span trees are equal in names, parentage, attr names and
event names, the engine lanes hold the same dispatch spans and page
events, and ``build_report`` gives each request the same phases (exact:
no timing is compared, only what the script fixes).  Then the report's
timings against the port's own results and histograms."""
import collections

import numpy as np
import pytest

from paddle_tpu.observability import tracing as jax_tracing
from paddle_tpu.serving.engine import DecodeEngine as JaxEngine
from paddle_tpu.serving.scheduler import \
    ContinuousBatchingScheduler as JaxScheduler
from paddle_tpu.serving.scheduler import Request as JaxRequest
from paddle_tpu_torch.observability import registry, tracing
from paddle_tpu_torch.serving import (ContinuousBatchingScheduler,
                                      DecodeEngine, Request)
from test_torch_paged import _pair


def _script(sched_cls, req_cls, eng, tracer, spec_k):
    """The script, identical in both packages; returns (scheduler, the
    preempted rid, the cancelled rid, the results)."""
    sched = sched_cls(eng, tracer=tracer)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, 512, (24,)).astype(np.int32)
    budget = 8 + 8 * spec_k
    # run 1 registers the prompt's pages in the prefix cache
    sched.submit(req_cls(prompt=prompt, max_new_tokens=2, temperature=0.0))
    sched.run()
    # run 2: X prefix-hits, Y and Z churn through the two slots, W waits
    # at the head of the queue and is cancelled there (the JAX
    # scheduler's cancel compares Request dataclasses when W is not the
    # head, and two prompt arrays do not compare to a bool)
    rx = sched.submit(req_cls(prompt=prompt, max_new_tokens=budget,
                              temperature=0.0))
    sched.submit(req_cls(prompt=rng.integers(0, 512, (16,)),
                         max_new_tokens=budget, temperature=0.0))
    rw = sched.submit(req_cls(prompt=rng.integers(0, 512, (9,)),
                              max_new_tokens=4, temperature=0.0))
    sched.submit(req_cls(prompt=rng.integers(0, 512, (12,)),
                         max_new_tokens=budget, temperature=0.0))
    for _ in range(3):
        sched.step()
    assert sched.cancel(rw)
    idx = next(i for i, a in enumerate(sched.slots)
               if a is not None and a.req.rid == rx)
    assert sched.slots[idx].generated
    # a deterministic preemption through the page-pressure path's own
    # bookkeeping (its count tags the resume's chunks as rework)
    sched._preempt_count[rx] = sched._preempt_count.get(rx, 0) + 1
    sched._preempt(idx)
    return sched, rx, rw, sched.run()


def _trees(spans, instants):
    """Per request (by rid): its spans as sorted (name, parent's name,
    attr names, event names); the engine lane's span names; the page
    events' names."""
    by_id = {s["span_id"]: s for s in spans}
    roots = {s["trace_id"]: s["attrs"]["rid"] for s in spans
             if s["name"] == "request"}
    trees = collections.defaultdict(list)
    for s in spans:
        if s["trace_id"] == 0:
            continue
        parent = by_id.get(s["parent_id"])
        trees[roots[s["trace_id"]]].append((
            s["name"], parent["name"] if parent else None,
            tuple(sorted(s["attrs"])),
            tuple(e["name"] for e in s["events"])))
    engine = collections.Counter(s["name"] for s in spans
                                 if s["trace_id"] == 0)
    pages = collections.Counter(e["name"] for e in instants)
    return ({rid: sorted(t) for rid, t in trees.items()}, engine, pages)


_PHASES = ("rid", "finish_reason", "spans", "connected", "decode_tokens",
           "spec_verify_iterations", "prefix_hit_tokens", "preemptions")


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.mark.parametrize("spec_k", [0, 2], ids=["decode", "spec"])
def test_span_trees_and_report_equal_jax(pair, spec_k):
    jm, tm = pair
    kw = dict(num_slots=2, max_len=64, page_size=8, seed=0, spec_k=spec_k)
    jax_tr, tr = jax_tracing.Tracer(), tracing.Tracer()
    jax_sched, jx, jw, jax_res = _script(
        JaxScheduler, JaxRequest, JaxEngine(jm, tracer=jax_tr, **kw),
        jax_tr, spec_k)
    sched, rx, rw, res = _script(
        ContinuousBatchingScheduler, Request,
        DecodeEngine(tm, tracer=tr, device="cpu", **kw), tr, spec_k)
    assert (rx, rw) == (jx, jw)
    for rid, r in jax_res.items():
        assert res[rid].tokens.tolist() == r.tokens.tolist()
        assert res[rid].finish_reason == r.finish_reason
    trees, engine, pages = _trees(tr.spans(), tr.instants())
    jax_trees, jax_engine, jax_pages = _trees(jax_tr.spans(),
                                              jax_tr.instants())
    assert trees == jax_trees
    assert engine == jax_engine and pages == jax_pages
    assert pages["pages.prefix_share"] > 0
    report = tracing.build_report(tr.spans(), tr.instants())
    jax_report = jax_tracing.build_report(jax_tr.spans(), jax_tr.instants())
    phases = [{k: r[k] for k in _PHASES} for r in report["requests"]]
    assert phases == [{k: r[k] for k in _PHASES}
                      for r in jax_report["requests"]]
    for got, want in zip(report["requests"], jax_report["requests"]):
        # which phases a request spent time in: the same ones
        for k in ("queue_s", "prefill_s", "decode_s", "rework_s",
                  "rework_prefill_s"):
            assert (got[k] > 0) == (want[k] > 0), (got["rid"], k)
        assert (got["ttft_s"] is None) == (want["ttft_s"] is None)
    assert report["totals"]["connected"]
    x = {r["rid"]: r for r in report["requests"]}[rx]
    assert x["preemptions"] == 1 and x["prefix_hit_tokens"] > 0
    assert {r["rid"]: r for r in report["requests"]}[rw][
        "finish_reason"] == "cancelled"
    assert {r.trace_id for r in res.values()} == {
        r.trace_id for r in jax_res.values()}
    assert sched.request_span(rx) is tracing.NOOP_SPAN    # retired
    # engine lane: no step captured on the CPU, so no span shows one
    assert all(s["attrs"]["captures"] == 0 for s in tr.spans()
               if s["trace_id"] == 0)


def test_report_timings_match_results_and_histograms(pair):
    """TTFT and TPOT per request from the trace against the port's own
    ``RequestResult`` and the ``serving.*`` histograms of the same run."""
    _jm, tm = pair
    registry.default_registry().reset()
    tr = tracing.Tracer()
    eng = DecodeEngine(tm, num_slots=2, max_len=64, page_size=8, seed=0,
                       tracer=tr, device="cpu")
    sched, rx, _rw, res = _script(ContinuousBatchingScheduler, Request, eng,
                                  tr, 0)
    report = tracing.build_report(tr.spans(), tr.instants())
    by_rid = {r["rid"]: r for r in report["requests"]}
    x = by_rid[rx]
    assert x["decode_tokens"] == res[rx].tokens.size - 1 - x["preemptions"]
    assert x["tpot_s"] == pytest.approx(res[rx].tpot, rel=1e-6)
    assert x["ttft_s"] == pytest.approx(res[rx].ttft, abs=0.05)
    h_tpot = registry.histogram("serving.tpot_seconds")
    tpots = [r["tpot_s"] for r in report["requests"] if r["decode_tokens"]]
    assert h_tpot.count == len(tpots)
    assert h_tpot.sum == pytest.approx(sum(tpots), rel=1e-6)
    h_ttft = registry.histogram("serving.ttft_seconds")
    ttfts = [r["ttft_s"] for r in report["requests"]
             if r["ttft_s"] is not None
             and r["finish_reason"] != "cancelled"]
    assert h_ttft.count == len(ttfts)
    sli = tracing.build_sli(report)
    assert sli["cancelled"]["requests"] == 1
    assert "request" in tracing.format_report(report)
    assert "finish_reason" in tracing.format_sli(sli)
